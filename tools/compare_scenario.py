"""Run one registry scenario with the JAX reference and with the port,
both on the CPU, and compare what they found.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/compare_scenario.py \\
        --scenario rram_accuracy [--smoke] [--backend jnp|ref]

Prints one JSON object: each package's wall time, best objective score
and generalized design, whether the generalized and every
workload-specific design agree (and, where the result has them, the
joint co-search's chosen architecture and every Pareto-front design),
and the largest relative difference of the best score and of the
specific EDAPs. The port's GPU run of the
same scenario is in ``chip_smoke.py``'s output.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


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
                    "design": res["generalized"]["design"]}
    a, b = runs["jax"], runs["torch"]
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
