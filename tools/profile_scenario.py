"""Profile one registry scenario of the port on the GPU.

    python3 tools/profile_scenario.py [--scenario rram_accuracy] [--smoke]
                                      [--src DIR]

Runs the scenario once to build and warm up, then again under
``torch.profiler`` (CPU and CUDA activities). Prints the card's name and
power limit, the host wall time of the profiled run (ending in a
synchronize), the device busy time (union of the CUDA kernels'
intervals) and the device's idle share of the wall time, the number of
kernel launches, the device time of the port's own kernels, the
kernels with the most device time, and the accuracy model's share of
the run, as one JSON object. Needs a CUDA device.

The accuracy model's share: every function ``make_accuracy_model``
returns runs inside a ``torch.profiler.record_function("accuracy_model")``
range; the tool counts the calls, their host time, the kernel-launch
calls of the CUDA runtime inside them, and the device kernels the
profiler attributes to them with their device time. SRES's ranking
(``core/baselines.stochastic_rank``, a host loop after one copy from
the card) runs inside a ``sres_ranking`` range, counted the same way.
``--src`` profiles
the ``repro_torch`` package of another checkout (for example the parent
commit unpacked beside this one), so two versions can be compared by
the same tool in one run.
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
RANGE = "accuracy_model"
RANK_RANGE = "sres_ranking"
# the port's hand-written kernels, by a part of their device names
PORT_KERNELS = ("imc_fused_kernel", "imc_matmul_kernel", "flash_kernel",
                "flash_wgmma_kernel")


def trace_accuracy_model(torch, nonideal) -> None:
    """Wrap every accuracy model built from now on in the RANGE range."""
    make = nonideal.make_accuracy_model

    def make_traced(*args, **kwargs):
        fn = make(*args, **kwargs)

        def accuracy(genomes):
            with torch.profiler.record_function(RANGE):
                return fn(genomes)
        accuracy.backend = fn.backend
        return accuracy
    nonideal.make_accuracy_model = make_traced


def trace_ranking(torch, baselines) -> None:
    """Run SRES's stochastic ranking in the RANK_RANGE range (the ES
    step calls it by its module-level name)."""
    rank = baselines.stochastic_rank

    def rank_traced(*args, **kwargs):
        with torch.profiler.record_function(RANK_RANGE):
            return rank(*args, **kwargs)
    baselines.stochastic_rank = rank_traced


def accuracy_share(torch, events, name=RANGE) -> dict:
    """Calls, host time, the operations called directly inside (the
    range's child events), runtime launch calls, and the attributed
    device kernels with their time, inside the ``name`` ranges."""
    ranges = [e for e in events if e.name == name
              and e.device_type == torch.autograd.DeviceType.CPU]
    launch_calls, kernels, kernel_us = 0, 0, 0.0
    stack = list(ranges)
    while stack:
        e = stack.pop()
        stack.extend(e.cpu_children)
        if "LaunchKernel" in e.name:
            launch_calls += 1
        kernels += len(e.kernels)
        kernel_us += sum(k.duration for k in e.kernels)
    return {"calls": len(ranges),
            "host_s": sum(e.time_range.elapsed_us() for e in ranges) / 1e6,
            "ops": sum(len(e.cpu_children) for e in ranges),
            "runtime_launch_calls": launch_calls,
            "kernels": kernels, "device_s": kernel_us / 1e6}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="rram_accuracy")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--src", default=os.path.join(os.path.dirname(HERE),
                                                  "src"),
                    help="the src/ directory whose repro_torch to profile")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_scenario: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import baselines, nonideal
    from repro_torch.experiments import get_scenario, run_scenario
    from repro_torch.kernels import imc_fused

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    trace_accuracy_model(torch, nonideal)
    trace_ranking(torch, baselines)
    sc = get_scenario(args.scenario)
    if args.smoke:
        sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    run_scenario(sc, write=False, device="cuda")       # build + warm-up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    wrappers = [w for w in ("imc_fused_gemm", "imc_fused_gemm_keyed")
                if hasattr(imc_fused, w)]
    for w in wrappers:
        getattr(imc_fused, w).launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run_scenario(sc, write=False, device="cuda")
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.events()
    # device kernels: the device-side copy of a record_function range is
    # not one
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in (RANGE, RANK_RANGE)]
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
    port = {}
    for n, (c, t) in by_name.items():
        for k in PORT_KERNELS:
            if k in n:
                port[k] = {"count": port.get(k, {}).get("count", 0) + c,
                           "total_ms": port.get(k, {}).get("total_ms", 0.0)
                           + t / 1e3}
    for v in port.values():
        v["mean_ms"] = v["total_ms"] / v["count"]
    acc = accuracy_share(torch, events)
    rank = accuracy_share(torch, events, RANK_RANGE)
    summary = {
        "card": card, "scenario": args.scenario, "smoke": args.smoke,
        "src": os.path.abspath(args.src),
        "best_score": res["best_score"], "wall_s": wall_s,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall_s
                              if kernels else None),
        "kernel_launches": len(kernels),
        "wrapper_launches": {w: getattr(imc_fused, w).launches
                             for w in wrappers},
        "accuracy_model": {
            **acc,
            "share_of_wall": acc["host_s"] / wall_s,
            "share_of_launches": (acc["kernels"] / len(kernels)
                                  if kernels else None),
            "share_of_device_time": (acc["device_s"] / (busy_us / 1e6)
                                     if busy_us else None)},
        "sres_ranking": {"calls": rank["calls"], "host_s": rank["host_s"],
                         "share_of_wall": rank["host_s"] / wall_s,
                         "kernels": rank["kernels"]},
        "port_kernels": port,
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
