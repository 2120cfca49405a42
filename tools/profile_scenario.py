"""Profile one registry scenario of the port on the GPU.

    python3 tools/profile_scenario.py [--scenario rram_accuracy] [--smoke]

Runs the scenario once to build and warm up, then again under
``torch.profiler`` (CPU and CUDA activities). Prints the card's name and
power limit, the host wall time of the profiled run (ending in a
synchronize), the device busy time (union of the CUDA kernels'
intervals) and the device's idle share of the wall time, the number of
kernel launches, and the kernels with the most device time, as one
JSON object. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="rram_accuracy")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_scenario: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
    from repro_torch.experiments import get_scenario, run_scenario
    from repro_torch.kernels.imc_fused import imc_fused_gemm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    sc = get_scenario(args.scenario)
    if args.smoke:
        sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    run_scenario(sc, write=False, device="cuda")       # build + warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    imc_fused_gemm.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run_scenario(sc, write=False, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy_us += cur[1] - cur[0]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
    summary = {
        "card": card, "scenario": args.scenario, "smoke": args.smoke,
        "best_score": res["best_score"], "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s
                              if kernels else None),
        "kernel_launches": len(kernels),
        "imc_fused_launches": imc_fused_gemm.launches,
        "top_kernels": [{"name": n[:120], "count": c, "total_ms": t / 1e3}
                        for n, (c, t) in top],
    }
    if not kernels:
        summary["note"] = "the profiler recorded no device time"
    print(card)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
