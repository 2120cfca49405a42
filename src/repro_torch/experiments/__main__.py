"""CLI for the port's experiment registry.

  python -m repro_torch.experiments list [--verbose]
  python -m repro_torch.experiments show --scenario rram_accuracy
  python -m repro_torch.experiments run --scenario rram_accuracy \\
      [--out DIR] [--seed N] [--seeds S] [--force] [--smoke]
      [--backend auto|cuda|ref|jnp] [--device cuda|cpu]
      [--campaign] [--compile-cache DIR]
  python -m repro_torch.experiments run --all [--out DIR] [--sequential]
  python -m repro_torch.experiments report [--out DIR]

``run`` executes a named scenario on ``--device`` (default ``cuda``;
without a CUDA device it fails rather than falling back to the CPU)
and writes ``result.json`` + ``report.md`` under ``--out``; ``report``
aggregates every cached result into ``summary.md``.

``run --all`` goes through the campaign engine (``campaign.py``):
shape-bucketed lane batches with pipelined dispatch, and with
``--compile-cache DIR`` the CUDA kernels built into (and loaded from)
DIR. Results equal sequential execution's modulo timing fields;
``--sequential`` runs the scenarios one at a time instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from . import report, runner
from .scenarios import REGISTRY, get_scenario


def cmd_list(args) -> int:
    rows = [("name", "mem", "W", "algorithm", "paper ref")]
    rows += [(s.name, s.mem, str(len(s.workloads)), s.algorithm,
              s.paper_ref) for s in REGISTRY.values()]
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for i, r in enumerate(rows):
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            print("  ".join("-" * w for w in widths))
    if args.verbose:
        print()
        for s in REGISTRY.values():
            print(f"{s.name}: {s.description}")
    return 0


def cmd_show(args) -> int:
    d = dataclasses.asdict(get_scenario(args.scenario))
    d["workloads"] = list(d["workloads"])
    print(json.dumps(d, indent=1))
    return 0


def _prepare(args, name):
    sc = get_scenario(name)
    if args.smoke:
        sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    if args.backend:
        sc = dataclasses.replace(sc, backend=args.backend)
    return sc


def _print_campaign_stats(stats, out) -> None:
    kc, pc = stats["kernel_cache"], stats["persistent_cache"]
    line = (f"campaign: {stats['n_bucketed']} scenarios in "
            f"{stats['n_buckets']} buckets "
            f"({stats['lanes_total']} lanes, "
            f"{stats['lanes_padded']} pad), "
            f"{stats['n_cached']} cached, "
            f"{stats['n_fallback']} sequential; "
            f"{stats['scenarios_per_sec']:.2f} scenarios/s; "
            f"bucket cache {kc['hits']}h/{kc['misses']}m")
    if pc["enabled"]:
        line += (f"; kernel-build cache {pc['signature_hits']}h/"
                 f"{pc['signature_misses']}m sigs, "
                 f"{pc['entries_after'] - pc['entries_before']} libraries "
                 f"built")
    print(line)
    print(f"  -> {out}/campaign_stats.json")


def cmd_run(args) -> int:
    if not args.all and args.scenario is None:
        print("run: pass --scenario NAME or --all", file=sys.stderr)
        return 2
    names = list(REGISTRY) if args.all else [args.scenario]
    if (args.all or args.campaign) and not args.sequential:
        from . import campaign
        results, stats = campaign.run_campaign(
            [_prepare(args, n) for n in names], out_dir=args.out,
            force=args.force, seed=args.seed, n_seeds=args.seeds,
            compile_cache=args.compile_cache, device=args.device)
        for name, res in zip(names, results):
            _print_result(name, res, args.out)
        _print_campaign_stats(stats, args.out)
        return 0
    if args.compile_cache:
        from . import campaign
        campaign.enable_persistent_cache(args.compile_cache)
    for name in names:
        res = runner.run_scenario(
            _prepare(args, name), out_dir=args.out, force=args.force,
            seed=args.seed, n_seeds=args.seeds, device=args.device)
        _print_result(name, res, args.out)
    return 0


def _print_result(name, res, out) -> None:
    tag = "cached" if res.get("cached") else f"{res['wall_time_s']:.1f}s"
    if res.get("algorithm") == "alg_compare":
        hits = ", ".join(f"{n} {a['hit_rate']}"
                         for n, a in res["algorithms"].items())
        print(f"[{tag}] {name} on {res['device']['name']}: best "
              f"{res['objective']} score {res['best_score']:.4g} by "
              f"{res['best_algorithm']}; hits: {hits}")
        print(f"  -> {out}/{name}/result.json (+ report.md)")
        return
    gap = res.get("gap", {}).get("mean_pct")
    gap_s = f", mean gap {gap:.1f}%" if gap is not None else ""
    seeds = res.get("seeds")
    seed_s = ""
    if seeds and seeds.get("count", 1) > 1:
        bs = seeds["best_score"]
        seed_s = (f" [{seeds['count']} seeds: "
                  f"{bs['mean']:.4g} ± {bs['std']:.3g}]")
    print(f"[{tag}] {name} on {res['device']['name']}: best "
          f"{res['objective']} score {res['best_score']:.4g}, area "
          f"{res['generalized']['area_mm2']:.1f} mm²{gap_s}{seed_s}")
    print(f"  -> {out}/{name}/result.json (+ report.md)")


def cmd_report(args) -> int:
    results = report.load_results(args.out)
    if not results:
        print(f"no cached results under {args.out!r}; run scenarios "
              "first (python -m repro_torch.experiments run --scenario "
              "...)", file=sys.stderr)
        return 1
    text = report.write_summary(args.out)
    print(text, end="")
    print(f"\n-> {os.path.join(args.out, 'summary.md')}", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("list", help="list named scenarios")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("show", help="print one scenario's full config")
    p.add_argument("--scenario", required=True)
    p.set_defaults(fn=cmd_show)

    p = sub.add_parser("run", help="run a scenario end to end")
    p.add_argument("--scenario", default=None)
    p.add_argument("--all", action="store_true",
                   help="run every registered scenario (through the "
                        "campaign engine)")
    p.add_argument("--out", default=runner.DEFAULT_OUT_DIR)
    p.add_argument("--seed", type=int, default=None,
                   help="override the scenario's seed")
    p.add_argument("--seeds", type=int, default=None,
                   help="run N independent seeds as one lane batch and "
                        "report mean±std EDAP/gap")
    p.add_argument("--force", action="store_true",
                   help="ignore cached results")
    p.add_argument("--smoke", action="store_true",
                   help="run with the scenario's smoke budget")
    p.add_argument("--backend", default=None,
                   choices=["auto", "cuda", "ref", "jnp"],
                   help="accuracy-model crossbar-GEMM route (default: the "
                        "scenario's, usually 'auto' = 'cuda' on a GPU, "
                        "'jnp' on the CPU)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where to run (default cuda; no silent CPU "
                        "fallback)")
    p.add_argument("--campaign", action="store_true",
                   help="route a single-scenario run through the campaign "
                        "engine too (--all uses it by default)")
    p.add_argument("--sequential", action="store_true",
                   help="run the scenarios one at a time, without the "
                        "campaign engine (results are identical modulo "
                        "timing fields)")
    p.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="build the CUDA kernels into DIR and load them "
                        "from there: a later run given the same DIR runs "
                        "no nvcc")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("report", help="aggregate results into summary.md")
    p.add_argument("--out", default=runner.DEFAULT_OUT_DIR)
    p.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, ValueError, NotImplementedError, RuntimeError) as e:
        # unknown names, unported engines, a missing CUDA device: one
        # clean line instead of a traceback
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
