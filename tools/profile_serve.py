"""Profile the port's LM serving path on the GPU.

    python3 tools/profile_serve.py [--arch qwen3_4b] [--requests 8]
        [--kv-quant]

Builds the architecture at full width from a seeded init on the card and
serves the request set of ``chip_smoke.py`` phase 12 (prompt lengths
drawn in 256..4096 by ``numpy.random.default_rng(seed)``, 16 new tokens
each, 4 slots, 4352 cache positions) three times: a warm-up, an
unprofiled run (the wall time without profiler overhead), then under
``torch.profiler`` with the engine's prefills and decode steps marked as
ranges. Prints the card's name and power limit, then one JSON object:
the engine's counters and tokens/s of both runs, and for the prefill and
decode ranges of the profiled run their host time, device busy time
(union of the kernels' intervals inside the ranges), idle share, kernel
launches and the kernels with the most device time, and the launches of
the port's flash, decode attention, RG-LRU, mLSTM and sLSTM scan kernels
in the profiled run. ``--kv-quant`` serves on the int8 KV cache
(``dataclasses.replace(cfg, kv_quant=True)``, as the reference sets it);
``--arch recurrentgemma_9b`` serves the hybrid, ``--arch xlstm_350m``
the xLSTM stack. Needs a CUDA device.
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


def _union_us(spans):
    busy, cur = 0.0, None
    for s, e in sorted(spans):
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    return busy + (cur[1] - cur[0] if cur is not None else 0.0)


def _rates(stats, wall):
    return {"wall_s": wall, **stats,
            "prefill_tok_s": stats["prefill_tokens"] / stats["prefill_s"],
            "decode_tok_s": stats["decode_tokens"] / stats["decode_s"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3_4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=4352)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--kv-quant", action="store_true")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.models import init_params
    from repro_torch.serve import LMRequest, ServeEngine

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    cfg = get_config(args.arch)
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    eng = ServeEngine(init_params(gen, cfg), cfg, n_slots=args.slots,
                      max_len=args.max_len, device="cuda")

    counters = (fa.flash_attention, dk.decode_attention_kernel,
                rs.rglru_scan, ms.mlstm_scan, ss.slstm_scan)

    def serve():
        eng.done.clear()
        eng.stats = dict.fromkeys(eng.stats, 0)
        rng = np.random.default_rng(args.seed)
        for i, n in enumerate(rng.integers(256, 4097, args.requests)):
            eng.submit(LMRequest(rid=i,
                                 prompt=rng.integers(0, cfg.vocab_size, n),
                                 max_new_tokens=args.max_new))
        for kernel in counters:
            kernel.launches = 0
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    serve()                                          # build + warm-up
    wall = serve()
    plain_run = _rates(dict(eng.stats), wall)
    admit, step = eng._admit, eng._step

    def marked_admit():
        with torch.profiler.record_function("serve.prefill"):
            admit()

    def marked_step():
        with torch.profiler.record_function("serve.decode"):
            step()
    eng._admit, eng._step = marked_admit, marked_step
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = serve()
    profiled_run = _rates(dict(eng.stats), wall)
    events = prof.events()
    # device events, less the ranges' own annotations on the GPU timeline
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and
               not e.name.startswith("serve.")]
    phases = {}
    for name in ("serve.prefill", "serve.decode"):
        ranges = [(e.time_range.start, e.time_range.end) for e in events
                  if e.name == name and
                  e.device_type == torch.autograd.DeviceType.CPU]
        spans, by_name = [], collections.defaultdict(lambda: [0, 0.0])
        for k in kernels:
            s, e = k.time_range.start, k.time_range.end
            if any(lo <= s < hi for lo, hi in ranges):
                spans.append((s, e))
                by_name[k.name][0] += 1
                by_name[k.name][1] += e - s
        host_us = sum(hi - lo for lo, hi in ranges)
        busy_us = _union_us(spans)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
        phases[name] = {
            "ranges": len(ranges), "host_s": host_us / 1e6,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / host_us if host_us else None,
            "kernel_launches": len(spans),
            "top_kernels": [{"name": n[:100], "count": c,
                             "total_ms": t / 1e3} for n, (c, t) in top]}
    summary = {"card": card, "arch": cfg.name, "dtype": cfg.dtype,
               "kv_quant": cfg.kv_quant,
               "requests": args.requests, "max_new": args.max_new,
               "unprofiled": plain_run, "profiled": profiled_run,
               "flash_launches": fa.flash_attention.launches,
               "decode_attention_launches":
                   dk.decode_attention_kernel.launches,
               "rglru_scan_launches": rs.rglru_scan.launches,
               "mlstm_scan_launches": ms.mlstm_scan.launches,
               "slstm_scan_launches": ss.slstm_scan.launches,
               "device_busy_s": _union_us(
                   (k.time_range.start, k.time_range.end) for k in kernels)
               / 1e6, "kernel_launches": len(kernels), "phases": phases}
    if not kernels:
        summary["note"] = "the profiler recorded no device time"
    print(card)
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
