"""Quickstart: the paper's joint hardware-workload co-optimization in
about forty lines; counterpart of ``examples/quickstart.py``. Finds a
generalized RRAM IMC design for four CNN workloads with the 4-phase GA +
Hamming sampling (Algorithm 1) and prints the winning hardware
configuration and its per-workload metrics.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and exits 2
without one.
"""
from __future__ import annotations

import argparse
import sys

import torch

from .. import random as jr
from ..api import (Objective, PAPER_4, get_space, get_workload_set,
                   joint_search, make_evaluator, pack)
from ..device import resolve_device


def run(device="cuda"):
    """The quickstart's search on ``device``: (space, workloads,
    evaluator, SearchResult)."""
    dev = resolve_device(device)
    space = get_space("rram")
    workloads = get_workload_set(PAPER_4)
    evaluate = make_evaluator(space, pack(workloads), device=dev)
    objective = Objective("edap", aggregation="mean")  # mJ * ms * mm^2

    def score_fn(genomes):
        return objective(evaluate(genomes))

    def capacity_filter(genomes):  # RRAM: all weights must fit on-chip
        return evaluate(genomes).feasible.cpu().numpy()

    result = joint_search(
        jr.PRNGKey(0, dev), space, score_fn,
        p_h=400, p_e=160, p_ga=24, generations_per_phase=5,
        capacity_filter=capacity_filter)
    return space, workloads, evaluate, result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"quickstart: {e}", file=sys.stderr)
        return 2
    space, workloads, evaluate, result = run(dev)

    print(f"search space size : {space.size:,}")
    print(f"best joint score  : {result.best_score:.4g} mJ*ms*mm^2")
    print(f"search time       : {result.wall_time_s:.1f}s "
          f"(sampling {result.sampling_time_s:.1f}s)")
    print("best design       :", space.describe(result.best_genome))

    metrics = evaluate(torch.as_tensor(result.best_genome[None],
                                       device=dev))
    print(f"chip area         : {float(metrics.area[0]):.1f} mm^2")
    for i, w in enumerate(workloads):
        print(f"  {w.name:14s} energy "
              f"{float(metrics.energy[0, i]) * 1e3:8.3f} mJ"
              f"  latency {float(metrics.latency[0, i]) * 1e3:8.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
