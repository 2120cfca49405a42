"""Co-optimize one SRAM IMC accelerator for the assigned LM architecture
set (the registry's ``sram_lm_archs`` scenario), then run one qwen3-4b
QKV projection through the winning crossbar geometry on the bit-serial
crossbar GEMM; counterpart of ``examples/codesign_lm_archs.py``.

  python -m repro_torch.examples.codesign_lm_archs [--full]
      [--device cuda|cpu]

By default the scenario runs at its smoke budget without specific
baselines; ``--full`` uses the registry budget with them (as
``python -m repro_torch.experiments run --scenario sram_lm_archs``).
The projection takes ``x (16, d_model)`` activation codes and
``w = 0.25 * normal (d_model, 3 * n_heads * head_dim)`` from one key and
pushes them through ``kernels/ops.imc_gemm`` (the ``imc_matmul`` Hopper
kernel on the GPU) with the winning ``xbar_rows``: at the full qwen3-4b
width (d_model 2560, N 12288) on the GPU, and at the reduced config on
the CPU, as the JAX example does there (the full product would take
minutes on the CPU).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict

import torch

from .. import random as jr
from ..api import SMOKE_BUDGET, get_scenario, run_scenario
from ..configs import get_config
from ..device import resolve_device
from ..kernels.ops import imc_gemm


def qkv_projection(xbar_rows: int, *, reduced: bool, device="cuda"
                   ) -> Dict:
    """The qwen3-4b fused QKV projection through the bit-serial crossbar
    GEMM at ``xbar_rows``: its output, the exact product and their
    relative error (Frobenius norm)."""
    dev = resolve_device(device)
    cfg = get_config("qwen3_4b", reduced=reduced)
    key = jr.PRNGKey(1, dev)
    x = jr.randint(key, (16, cfg.d_model), 0, 256)
    w = jr.normal(key, (cfg.d_model, 3 * cfg.n_heads * cfg.head_dim))
    w = w * 0.25
    y = imc_gemm(x, w, xbar_rows=xbar_rows)
    exact = x.float() @ w
    rel = float(torch.linalg.norm(y - exact) / torch.linalg.norm(exact))
    return {"x": x, "w": w, "y": y, "exact": exact, "rel_err": rel,
            "shape": (x.shape[0], x.shape[1], w.shape[1]),
            "xbar_rows": int(xbar_rows)}


def run(full: bool = False, device="cuda") -> Dict:
    """The example end to end on ``device``: the scenario's result dict,
    its wall time, and the projection (``qkv_projection``) at the
    winning design's ``xbar_rows``, full width on the GPU."""
    dev = resolve_device(device)
    scenario = get_scenario("sram_lm_archs")
    if not full:
        scenario = dataclasses.replace(scenario, budget=SMOKE_BUDGET,
                                       specific_baselines=False)
    t0 = time.perf_counter()
    res = run_scenario(scenario, write=False, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    rows = int(res["generalized"]["design"]["xbar_rows"])
    proj = qkv_projection(rows, reduced=dev.type == "cpu", device=dev)
    return {"result": res, "scenario_wall_s": wall, "projection": proj}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="registry budget with specific baselines")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        out = run(full=args.full, device=args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    res, proj = out["result"], out["projection"]
    print("generalized LM-serving IMC design:", res["generalized"]["design"])
    for name, m in res["generalized"]["per_workload"].items():
        print(f"  {name:18s}",
              f"E {m['energy_mJ']:9.2f} mJ  L {m['latency_ms']:9.2f} ms")
    print(f"  area {res['generalized']['area_mm2']:.1f} mm^2")
    if "gap" in res:
        print(f"  mean specific-vs-generalized EDAP gap: "
              f"{res['gap']['mean_pct']:.1f}%")
    print(f"sram_lm_archs on {res['device']['name']}: "
          f"{out['scenario_wall_s']:.2f} s")
    M, K, N = proj["shape"]
    print(f"bit-serial IMC GEMM ({M}x{K} @ {K}x{N}) on "
          f"Xbar_rows={proj['xbar_rows']}: rel err {proj['rel_err']:.4f} "
          f"(8-bit ADC)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
