"""Run one registry scenario with the JAX reference and with the port,
both on the CPU, and compare what they found.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/compare_scenario.py \\
        --scenario rram_accuracy [--smoke] [--backend jnp|ref]

Prints one JSON object: each package's wall time, best objective score
and generalized design, whether the generalized and every
workload-specific design agree (and, where the result has them, the
joint co-search's chosen architecture and every Pareto-front design),
and the largest relative difference of the best score and of the
specific EDAPs. For a Table 3 scenario (``alg_compare``) it compares,
per algorithm, the per-seed best scores, the best design, ``hits``,
``n_feasible`` and ``evaluations``, and the ground truth, the best
algorithm and the best score. The port's GPU run of the same scenario
is in ``chip_smoke.py``'s output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def _rel(x: float, y: float) -> float:
    return abs(x - y) / abs(x)


def compare_alg(a: dict, b: dict) -> dict:
    """The Table 3 schema: per algorithm, the per-seed best scores'
    largest relative difference, and whether the best design, hits,
    feasible seeds and evaluations agree; the ground truth, the best
    algorithm and the best score."""
    algs = {}
    for name, x in a["algorithms"].items():
        y = b["algorithms"][name]
        algs[name] = {
            "best_scores_max_rel_diff": max(
                _rel(p, q) for p, q in zip(x["best_scores"],
                                           y["best_scores"])),
            "same_best_design": x["best_design"] == y["best_design"],
            **{f"same_{k}": x[k] == y[k]
               for k in ("hits", "n_feasible", "evaluations")},
            "hits": y["hit_rate"]}
    ga, gb = a["ground_truth"], b["ground_truth"]
    return {
        "algorithms": algs,
        "same_ground_truth_design": ga.get("global_design")
        == gb.get("global_design"),
        "ground_truth_rel_diff": (_rel(ga["global_min"], gb["global_min"])
                                  if ga["exhaustive"] else None),
        "same_best_algorithm": a["best_algorithm"] == b["best_algorithm"],
        "best_score_rel_diff": _rel(a["best_score"], b["best_score"]),
        "all_agree": (all(v["same_best_design"] and v["same_hits"]
                          and v["same_n_feasible"] and v["same_evaluations"]
                          and v["best_scores_max_rel_diff"] <= 1e-5
                          for v in algs.values())
                      and ga.get("global_design") == gb.get("global_design")
                      and a["best_algorithm"] == b["best_algorithm"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="rram_accuracy")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", default="jnp", choices=["jnp", "ref"])
    args = ap.parse_args(argv)

    import torch
    from repro.experiments import get_scenario as ref_scenario
    from repro.experiments import run_scenario as ref_run
    from repro_torch.experiments import get_scenario, run_scenario

    out = {"scenario": args.scenario, "smoke": args.smoke,
           "backend": args.backend, "torch_threads": torch.get_num_threads()}
    runs = {}
    for pkg, get, run, kw in (("jax", ref_scenario, ref_run, {}),
                              ("torch", get_scenario, run_scenario,
                               {"device": "cpu"})):
        sc = get(args.scenario)
        if args.smoke:
            sc = dataclasses.replace(sc, budget=sc.smoke_budget)
        sc = dataclasses.replace(sc, backend=args.backend)
        t0 = time.perf_counter()
        res = run(sc, write=False, **kw)
        runs[pkg] = res
        out[pkg] = {"wall_s": time.perf_counter() - t0,
                    "best_score": res["best_score"],
                    "design": (res["generalized"]["design"]
                               if "generalized" in res else
                               res["algorithms"][res["best_algorithm"]][
                                   "best_design"])}
    a, b = runs["jax"], runs["torch"]
    if a["algorithm"] == "alg_compare":
        out.update(compare_alg(a, b))
        print(json.dumps(out, indent=1))
        return 0
    out["same_generalized_design"] = (a["generalized"]["design"]
                                      == b["generalized"]["design"])
    out["same_specific_designs"] = all(
        a["specific"][w]["design"] == b["specific"][w]["design"]
        for w in a.get("specific", {}))
    out["same_joint"] = a.get("joint") == b.get("joint")
    out["same_front_designs"] = (
        [p["design"] for p in a.get("pareto", {}).get("front", [])]
        == [p["design"] for p in b.get("pareto", {}).get("front", [])])
    out["front_size"] = len(b.get("pareto", {}).get("front", []))
    out["best_score_rel_diff"] = abs(a["best_score"] - b["best_score"]) / abs(
        a["best_score"])
    out["specific_edap_max_rel_diff"] = max(
        (abs(a["specific"][w]["edap"] - b["specific"][w]["edap"])
         / abs(a["specific"][w]["edap"]) for w in a.get("specific", {})),
        default=0.0)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
