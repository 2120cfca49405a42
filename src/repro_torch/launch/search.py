"""Run the paper's joint hardware-workload co-optimization; counterpart
of ``repro/launch/search.py``, with the same flags plus ``--device``.

A thin CLI over the experiment runner (``repro_torch/experiments/``):
flags are assembled into an ad-hoc Scenario and executed by
``run_scenario``, so searches launched here get the same lane-batched
search, caching and JSON/markdown artifacts as named scenarios.

  python -m repro_torch.launch.search --scenario rram_small_set
  python -m repro_torch.launch.search --mem rram --objective edap \\
      --agg max --workloads paper4 [--algorithm fourphase|plain|random] \\
      [--generations 10] [--pga 40] [--out DIR] [--device cuda|cpu]

Workload sets: paper4, paper9, archs (the assigned LM architectures),
or an explicit comma list. It runs on the GPU unless ``--device cpu``
is given, and exits 2 without one. The same seed gives a bit-identical
``best_score`` here and through ``python -m repro_torch.experiments
run``. For the named design points prefer the latter.
"""
from __future__ import annotations

import argparse
import json
import sys

from ..api import (DEFAULT_OUT_DIR, PAPER_4, PAPER_9, Budget, Scenario,
                   get_scenario, run_scenario)
from ..configs import ARCH_IDS
from ..device import resolve_device


def build_workload_spec(spec: str):
    """CLI spec -> (workload names, source) for the Scenario."""
    if spec == "paper4":
        return PAPER_4, "paper"
    if spec == "paper9":
        return PAPER_9, "paper"
    if spec == "archs":
        return ARCH_IDS, "archs"
    names = tuple(spec.split(","))
    if all(n in ARCH_IDS for n in names):
        return names, "archs"
    return names, "paper"


def scenario_from_args(args) -> Scenario:
    workloads, source = build_workload_spec(args.workloads)
    # every flag that changes the result is part of the cache key
    name = (f"cli_{args.mem}_{args.workloads.replace(',', '+')}"
            f"_{args.algorithm}_{args.objective}_{args.agg}"
            f"_g{args.generations}_p{args.pga}-{args.ph}-{args.pe}"
            f"_s{args.seq}" + ("_tech" if args.tech_variable else ""))
    return Scenario(
        name=name, mem=args.mem, workloads=tuple(workloads),
        algorithm=args.algorithm,
        objective=f"{args.objective}:{args.agg}",
        budget=Budget(p_h=args.ph, p_e=args.pe, p_ga=args.pga,
                      generations=args.generations),
        seed=args.seed, seq=args.seq, tech_variable=args.tech_variable,
        workload_source=source,
        specific_baselines=args.specific_baselines,
        description="ad-hoc CLI scenario (launch/search.py)",
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default=None,
                    help="run a named registry scenario instead of flags")
    ap.add_argument("--mem", default="rram", choices=["rram", "sram"])
    ap.add_argument("--objective", default="edap")
    ap.add_argument("--agg", default="max", choices=["max", "mean", "all"])
    ap.add_argument("--workloads", default="paper4")
    ap.add_argument("--algorithm", default="fourphase",
                    choices=["fourphase", "plain", "random"])
    ap.add_argument("--tech-variable", action="store_true")
    ap.add_argument("--generations", type=int, default=10)
    ap.add_argument("--pga", type=int, default=40)
    ap.add_argument("--ph", type=int, default=1000)
    ap.add_argument("--pe", type=int, default=500)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--specific-baselines", action="store_true",
                    help="also run per-workload specific searches (gap)")
    ap.add_argument("--out", default=None,
                    help="results directory (default: print only)")
    ap.add_argument("--force", action="store_true",
                    help="ignore cached results under --out")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"search: {e}", file=sys.stderr)
        return 2
    if args.scenario is not None:
        sc = get_scenario(args.scenario)
    else:
        sc = scenario_from_args(args)
    res = run_scenario(sc, out_dir=args.out or DEFAULT_OUT_DIR,
                       force=args.force, write=args.out is not None,
                       device=dev)

    g = res["generalized"]
    report = {
        "scenario": res["scenario"],
        "workloads": res["workloads"],
        "mem": res["mem"], "objective": res["objective"],
        "best_score": res["best_score"],
        "best_design": g["design"],
        "per_workload_energy_mJ": [
            m["energy_mJ"] for m in g["per_workload"].values()],
        "per_workload_latency_ms": [
            m["latency_ms"] for m in g["per_workload"].values()],
        "area_mm2": g["area_mm2"],
        "wall_time_s": res["wall_time_s"],
        "sampling_time_s": res["sampling_time_s"],
    }
    if "gap" in res:
        report["gap_mean_pct"] = res["gap"]["mean_pct"]
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
