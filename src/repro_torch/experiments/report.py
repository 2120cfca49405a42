"""Artifact/report layer: result dicts -> JSON + markdown tables;
counterpart of ``repro/experiments/report.py``.

  EDAP               — energy(mJ) x delay(ms) x area(mm^2), per workload
  generalization gap — % EDAP excess of the generalized (joint) design
                       over each workload-specific design (Fig. 5)
  baseline reduction — % EDAP reduction of the 4-phase search vs the
                       plain-GA / random-search baselines (Tables 1-2)

``write_artifacts`` emits ``result.json`` + ``report.md`` per scenario,
with the chosen architecture of a joint co-search and the EDAP × cost
(or EDAP × accuracy-loss) Pareto front where the result has them;
``render_summary`` tabulates every cached result into ``summary.md``
with the Table 3 algorithm comparison (``render_table3``), the
searched-vs-post-hoc front comparison (``render_front_comparison``) and
the Fig. 4 convergence section, and ``write_summary`` appends the
campaign engine's execution stats (``render_campaign_stats``) when the
output directory holds a ``campaign_stats.json``. JSON is written with
sorted keys.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.pareto import front_coverage, hypervolume_2d


def compute_gap(result: Dict) -> Dict:
    """Workload-specific vs generalized EDAP gap percentages.

    gap_pct[w] = 100 * (EDAP_generalized(w) / EDAP_specific(w) - 1);
    0% means the joint design matches the specialized one on w.
    """
    per = result["generalized"]["per_workload"]
    spec = result["specific"]
    gaps = {}
    for w, s in spec.items():
        g_edap = per[w]["edap"]
        s_edap = s["edap"]
        gaps[w] = (100.0 * (g_edap / s_edap - 1.0)
                   if s_edap > 0 else float("inf"))
    vals = [v for v in gaps.values() if np.isfinite(v)]
    return {
        "per_workload_pct": gaps,
        "mean_pct": float(np.mean(vals)) if vals else float("nan"),
        "max_pct": float(np.max(vals)) if vals else float("nan"),
    }


def aggregate_seeds(seed_list: Sequence[int], best_scores: np.ndarray,
                    gap_mean_pcts: Optional[np.ndarray] = None) -> Dict:
    """Cross-seed statistics block for the result dict.

    best_scores: (S,) best objective (EDAP) score per seed;
    gap_mean_pcts: optional (S,) per-seed mean generalization gap.
    std is population std (ddof=0), 0.0 for a single seed.
    """
    scores = np.asarray(best_scores, float)
    out: Dict = {
        "count": len(seed_list),
        "list": [int(s) for s in seed_list],
        "best_seed": int(seed_list[int(np.argmin(scores))]),
        "best_score": {
            "per_seed": [float(s) for s in scores],
            "mean": float(np.mean(scores)),
            "std": float(np.std(scores)),
        },
    }
    if gap_mean_pcts is not None:
        gaps = np.asarray(gap_mean_pcts, float)
        finite = gaps[np.isfinite(gaps)]
        out["gap_mean_pct"] = {
            "per_seed": [float(g) for g in gaps],
            "mean": float(np.mean(finite)) if finite.size else
            float("nan"),
            "std": float(np.std(finite)) if finite.size else float("nan"),
        }
    return out


def _fmt(x: float, nd: int = 3) -> str:
    if x is None or not np.isfinite(x):
        return "—"
    return f"{x:.{nd}g}"


# Canonical Table 3 row order (JSON artifacts sort keys, so display
# order must be re-imposed on load; unknown names render last).
TABLE3_ROW_ORDER = ("GA", "PSO", "ES", "SRES", "CMA-ES", "G3PCX")


def _table3_rows(algorithms: Dict[str, Dict]) -> List[str]:
    names = [n for n in TABLE3_ROW_ORDER if n in algorithms]
    names += sorted(set(algorithms) - set(names))
    rows = []
    for n in names:
        a = algorithms[n]
        feas = f"{a.get('n_feasible', a['n_seeds'])}/{a['n_seeds']}"
        rows.append(
            f"| {n} | {a['hit_rate']} | {feas} "
            f"| {_fmt(a['mean_best'], 4)} "
            f"| {_fmt(a['std_best'], 3)} | {_fmt(a['best_score'], 4)} "
            f"| {_fmt(a['mean_wall_time_s'], 3)} "
            f"| {a['evaluations']} |")
    return rows


# mean/std are over the feasible seeds only (a 1e30 penalty score is a
# failure marker, not a statistic); the feasible column shows how many
# seeds found any feasible design.
_TABLE3_HEADER = [
    "| algorithm | global-min hits | feasible | mean best | std | best "
    "| mean wall (s) | evals/seed |",
    "|---|---|---|---|---|---|---|---|",
]


def render_table3_markdown(result: Dict) -> str:
    """One algorithm-comparison scenario -> a Table 3 markdown report."""
    gt = result["ground_truth"]
    lines = [
        f"# Scenario `{result['scenario']}`",
        "",
        result.get("description", ""),
        "",
        f"- memory: **{result['mem'].upper()}**  ·  study: "
        f"**algorithm comparison (Table 3 / §III-C1)**  ·  objective "
        f"landscape: `{result['objective']}`  ·  seeds: "
        f"{result['seeds']['list']}",
        f"- paper ref: {result.get('paper_ref') or '—'}  ·  space "
        f"size: {result['space_size']}  ·  device: "
        f"{result.get('device', {}).get('name', '—')}  ·  wall time: "
        f"{_fmt(result.get('wall_time_s'), 3)} s",
        "",
    ]
    if gt["exhaustive"]:
        lines += [
            f"Exhaustive ground truth: global minimum "
            f"**{_fmt(gt['global_min'], 4)}** over "
            f"{gt['n_enumerated']} enumerated designs; a seed *hits* "
            f"when its best score is within 0.01% of it.",
        ]
    else:
        lines += [
            f"The space ({result['space_size']} designs) is too large "
            "to enumerate; hits are measured against the best design "
            "any algorithm found "
            f"(**{_fmt(result['best_score'], 4)}**, by "
            f"{result['best_algorithm']}).",
        ]
    lines += ["", "## Algorithm comparison (Table 3)", ""]
    lines += _TABLE3_HEADER + _table3_rows(result["algorithms"])
    lines += [
        "",
        f"Best design found by **{result['best_algorithm']}** (score "
        f"{_fmt(result['best_score'], 4)}). All seeds of each "
        "algorithm executed as one lane batch on the device.",
    ]
    return "\n".join(lines) + "\n"


def render_table3(results: List[Dict]) -> str:
    """Cross-scenario Table 3 section for summary.md: one block per
    cached algorithm-comparison scenario."""
    blocks = []
    for r in sorted(results, key=lambda r: r["scenario"]):
        if r.get("algorithm") != "alg_compare":
            continue
        gt = r["ground_truth"]
        how = (f"exhaustive ground truth over {gt['n_enumerated']} "
               f"designs, global min {_fmt(gt['global_min'], 4)}"
               if gt["exhaustive"] else
               f"hits vs best found ({_fmt(r['best_score'], 4)} by "
               f"{r['best_algorithm']})")
        blocks += [
            "",
            f"### `{r['scenario']}` — {r.get('paper_ref') or ''}",
            "",
            f"{len(r['seeds']['list'])} seeds, {how}.",
            "",
        ]
        blocks += _TABLE3_HEADER + _table3_rows(r["algorithms"])
    if not blocks:
        return ""
    return "\n".join([
        "",
        "## Algorithm comparison (Table 3 / §III-C1)",
        "",
        "GA vs PSO / (µ+λ)-ES / SRES / CMA-ES / G3PCX — the study "
        "behind choosing the GA the co-optimization framework builds "
        "on. Every optimizer runs its seeds as one lane batch "
        "(core/baselines.py); hit = best score within 0.01% of the "
        "reference minimum.",
    ] + blocks) + "\n"


def render_markdown(result: Dict) -> str:
    """One scenario -> a self-contained markdown report."""
    if result.get("algorithm") == "alg_compare":
        return render_table3_markdown(result)
    g = result["generalized"]
    lines = [
        f"# Scenario `{result['scenario']}`",
        "",
        result.get("description", ""),
        "",
        f"- memory: **{result['mem'].upper()}**  ·  algorithm: "
        f"**{result['algorithm']}**  ·  objective: "
        f"`{result['objective']}`  ·  seed: {result['seed']}",
        f"- paper ref: {result.get('paper_ref') or '—'}  ·  device: "
        f"{result.get('device', {}).get('name', '—')}",
        f"- best objective score: **{_fmt(result['best_score'], 4)}**  ·  "
        f"area: {_fmt(g['area_mm2'], 4)} mm²  ·  "
        f"wall time: {_fmt(result.get('wall_time_s'), 3)} s",
        "",
        "## Optimized design",
        "",
        "| parameter | value |",
        "|---|---|",
    ]
    lines += [f"| {k} | {v:g} |" for k, v in g["design"].items()]
    joint = result.get("joint")
    if joint:
        lines += [
            "",
            "## Chosen workload architecture",
            "",
            "Joint co-search: the genome's trailing "
            f"{joint['n_arch_dims']} dimensions select the workload "
            "architecture (families: "
            f"{', '.join(joint['families'])}); the values below are "
            "what the search chose *together with* the hardware above.",
            "",
            "| arch parameter | value |",
            "|---|---|",
        ]
        lines += [f"| {k} | {v:g} |"
                  for k, v in joint["arch_params"].items()]
        lines += [""]
        lines += [f"- `{fam}` resolves to model **{model}**"
                  for fam, model in joint["chosen_models"].items()]
    gap = result.get("gap")
    has_acc = any("accuracy" in m for m in g["per_workload"].values())
    lines += ["", "## Per-workload breakdown", ""]
    hdr = "| workload | energy (mJ) | latency (ms) | EDAP (mJ·ms·mm²) |"
    sep = "|---|---|---|---|"
    if has_acc:
        hdr += " accuracy |"
        sep += "---|"
    if gap:
        hdr += " specific EDAP | gap (%) |"
        sep += "---|---|"
    lines += [hdr, sep]
    for w in sorted(g["per_workload"]):
        m = g["per_workload"][w]
        row = (f"| {w} | {_fmt(m['energy_mJ'])} | {_fmt(m['latency_ms'])} "
               f"| {_fmt(m['edap'])} |")
        if has_acc:
            row += f" {_fmt(m.get('accuracy'))} |"
        if gap:
            s_edap = result["specific"][w]["edap"]
            row += (f" {_fmt(s_edap)} | "
                    f"{_fmt(gap['per_workload_pct'][w])} |")
        lines.append(row)
    pareto = result.get("pareto")
    if pareto:
        lines += _render_pareto(pareto)
    if gap:
        lines += [
            "",
            f"**Workload-specific vs generalized EDAP gap:** "
            f"mean {_fmt(gap['mean_pct'])}%, max {_fmt(gap['max_pct'])}% "
            f"(0% = generalized design matches each specialized one).",
        ]
    seeds = result.get("seeds")
    if seeds and seeds.get("count", 1) > 1:
        bs = seeds["best_score"]
        lines += [
            "",
            f"## Seed robustness (n={seeds['count']})",
            "",
            f"- best EDAP score: **{_fmt(bs['mean'], 4)} ± "
            f"{_fmt(bs['std'], 3)}** over seeds "
            f"{seeds['list']} (best: seed {seeds['best_seed']})",
        ]
        gs = seeds.get("gap_mean_pct")
        if gs:
            lines.append(
                f"- mean generalization gap: **{_fmt(gs['mean'])}% ± "
                f"{_fmt(gs['std'])}%**")
        lines.append(
            "- all seeds executed as one lane batch on the device")
    return "\n".join(lines) + "\n"


def _render_pareto(pareto: Dict) -> List[str]:
    """The Pareto-front section of a scenario report (Fig. 9)."""
    axes = pareto.get("axes", ["edap", "cost"])
    searched = pareto.get("searched", False)
    how = ("searched **directly** by the NSGA-II engine (rank-0 designs "
           "of every seed's final population, pooled and re-filtered)"
           if searched else
           "filtered *post hoc* from the designs the scalarized search "
           "visited (final populations, all seeds)")
    lines = [
        "",
        f"## {axes[0]} × {axes[1]} Pareto front (paper Fig. 9, "
        f"{'direct search' if searched else 'post hoc'})",
        "",
        f"{len(pareto['front'])} non-dominated designs out of "
        f"{pareto['n_candidates']} feasible candidates, {how}; cost is "
        "the technology-normalized fabrication cost alpha(tech) × area "
        "(Table 7).",
        "",
        f"| {axes[1]} | {axes[0]} | tech (nm) | design |",
        "|---|---|---|---|",
    ]
    for p in pareto["front"]:
        summary = ", ".join(
            f"{k}={v:g}" for k, v in p["design"].items()
            if k in ("xbar_rows", "xbar_cols", "c_per_tile", "g_per_chip",
                     "bits_cell")
            or "." in k)  # joint arch dims ("<family>.<param>")
        lines.append(f"| {_fmt(p[axes[1]])} | {_fmt(p[axes[0]])} "
                     f"| {p['tech_nm']:g} | {summary} |")
    if pareto.get("hypervolume") is not None:
        ref = pareto.get("ref_point") or []
        lines += [
            "",
            f"Hypervolume {_fmt(pareto['hypervolume'], 4)} at reference "
            f"point ({', '.join(_fmt(r, 4) for r in ref)}) — 1.05 × the "
            "candidate cloud's per-axis maximum; the cross-scenario "
            "summary recomputes searched and post-hoc fronts under one "
            "shared reference.",
        ]
    if searched and pareto.get("front_sizes_per_seed"):
        lines.append(
            f"Per-seed rank-0 front sizes: "
            f"{pareto['front_sizes_per_seed']} (all seeds run as one lane "
            "batch of the NSGA-II engine).")
    return lines


def write_artifacts(result: Dict, out_dir: str) -> None:
    """Write result.json + report.md for one scenario.

    JSON keys are sorted so re-runs and CI artifact comparisons diff
    cleanly (insertion order never leaks into the artifact)."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump(result, f, indent=1, sort_keys=True, default=float)
    with open(os.path.join(out_dir, "report.md"), "w") as f:
        f.write(render_markdown(result))


def load_results(out_dir: str) -> List[Dict]:
    """Load every cached scenario result under ``out_dir``."""
    out = []
    if not os.path.isdir(out_dir):
        return out
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name, "result.json")
        if os.path.exists(path):
            with open(path) as f:
                out.append(json.load(f))
    return out


def baseline_reductions(results: List[Dict]) -> Dict[str, Dict]:
    """Pair each 4-phase scenario with its plain/random counterparts
    (name + '_plain' / '_random') and compute the EDAP reduction %
    — the paper's Tables 1-2 construction."""
    by_name = {r["scenario"]: r for r in results}
    out: Dict[str, Dict] = {}
    for name, r in by_name.items():
        if r["algorithm"] != "fourphase":
            continue
        row = {}
        for alg in ("plain", "random"):
            b = by_name.get(f"{name}_{alg}")
            if b is None:
                continue
            s_opt, s_base = r["best_score"], b["best_score"]
            if s_base > 0 and np.isfinite(s_base):
                row[alg] = 100.0 * (1.0 - s_opt / s_base)
        if row:
            out[name] = row
    return out


def _front_points(block: Dict) -> np.ndarray:
    """(N, D) array of a pareto block's front coordinates."""
    axes = block.get("axes", ["edap", "cost"])
    return np.asarray([[p[a] for a in axes] for p in block["front"]],
                      np.float64).reshape(-1, len(axes))


def render_front_comparison(results: List[Dict]) -> str:
    """Searched (NSGA-II) vs post-hoc Pareto fronts, head to head: each
    ``<name>_mo`` result with a pareto block beside its single-objective
    sibling ``<name>`` run at the same budget and seed count, both
    fronts under ONE reference point (1.05 × the union's per-axis
    maximum): hypervolume (larger = better) and Zitzler's coverage
    C(A, B), the fraction of B's points weakly dominated by A."""
    by_name = {r["scenario"]: r for r in results}
    rows = []
    for name in sorted(by_name):
        if not name.endswith("_mo"):
            continue
        r_mo, r_ph = by_name[name], by_name.get(name[:-len("_mo")])
        if r_ph is None or "pareto" not in r_mo or "pareto" not in r_ph:
            continue
        if (r_mo.get("budget") != r_ph.get("budget")
                or r_mo.get("n_seeds") != r_ph.get("n_seeds")):
            continue  # fronts of different budgets are not comparable
        f_mo, f_ph = (_front_points(r_mo["pareto"]),
                      _front_points(r_ph["pareto"]))
        if (f_mo.shape[1] != 2 or f_ph.shape[1] != 2
                or not (f_mo.size and f_ph.size)):
            continue
        ref = 1.05 * np.max(np.concatenate([f_mo, f_ph]), axis=0)
        rows.append(
            f"| {name} | {f_mo.shape[0]} | {f_ph.shape[0]} "
            f"| {_fmt(hypervolume_2d(f_mo, ref), 4)} "
            f"| {_fmt(hypervolume_2d(f_ph, ref), 4)} "
            f"| {_fmt(100.0 * front_coverage(f_mo, f_ph))} "
            f"| {_fmt(100.0 * front_coverage(f_ph, f_mo))} |")
    if not rows:
        return ""
    return "\n".join([
        "",
        "## Searched vs post-hoc EDAP × cost fronts (Fig. 9)",
        "",
        "The `*_mo` scenarios search the front directly (NSGA-II); their "
        "single-objective siblings reconstruct it post hoc from visited "
        "designs. Hypervolume (HV) under one shared reference point; "
        "C(A,B) = % of B's front weakly dominated by A.",
        "",
        "| scenario | searched front | post-hoc front | HV searched "
        "| HV post-hoc | C(searched→post-hoc) % | "
        "C(post-hoc→searched) % |",
        "|---|---|---|---|---|---|---|",
    ] + rows) + "\n"


# budget fractions at which the Fig. 4 convergence table samples each
# algorithm's best-so-far history (every algorithm has its own history
# length — GA generations vs random-search batches — so sampling by
# fraction keeps the comparison budget-fair).
_CONV_FRACTIONS = (0.0, 0.25, 0.5, 0.75, 1.0)


def _history_band(result: Dict, frac: float) -> str:
    """min–max band over seeds of best-score-so-far at a budget
    fraction (a single value when seeds agree / only one seed ran)."""
    hists = result.get("histories") or [result["history"]]
    vals = []
    for h in hists:
        if not h:
            return "—"
        vals.append(h[min(len(h) - 1, round(frac * (len(h) - 1)))])
    lo, hi = float(np.min(vals)), float(np.max(vals))
    if _fmt(lo) == _fmt(hi):
        return _fmt(lo)
    return f"{_fmt(lo)}–{_fmt(hi)}"


def render_convergence(results: List[Dict]) -> str:
    """Fig. 4: per-scenario convergence of the optimized 4-phase GA vs
    the plain GA vs random search, as best-EDAP-so-far bands (min–max
    across seeds) at fractions of the evaluation budget."""
    by_name = {r["scenario"]: r for r in results}
    blocks = []
    for name in sorted(by_name):
        r = by_name[name]
        if r["algorithm"] != "fourphase" or "history" not in r:
            continue
        siblings = {alg: by_name.get(f"{name}_{alg}")
                    for alg in ("plain", "random")}
        if not any(s and "history" in s for s in siblings.values()):
            continue
        rows = []
        for frac in _CONV_FRACTIONS:
            cells = [_history_band(r, frac)]
            for alg in ("plain", "random"):
                s = siblings[alg]
                cells.append(_history_band(s, frac)
                             if s and "history" in s else "—")
            rows.append(f"| {100 * frac:.0f}% | " + " | ".join(cells)
                        + " |")
        blocks += [
            "",
            f"### `{name}`",
            "",
            "| budget | 4-phase GA | plain GA | random search |",
            "|---|---|---|---|",
        ] + rows
    if not blocks:
        return ""
    return "\n".join([
        "",
        "## Convergence (Fig. 4)",
        "",
        "Best objective score so far at fractions of the evaluation "
        "budget; min–max band across seeds where more than one seed "
        "ran. The 4-phase schedule should dominate the plain GA and "
        "random search at every fraction (paper Fig. 4).",
    ] + blocks) + "\n"


def render_summary(results: List[Dict]) -> str:
    """Cross-scenario markdown table (the regenerated paper tables),
    plus the Table 3 algorithm comparison, the searched-vs-post-hoc
    front comparison and the Fig. 4 convergence section when the cached
    results support them."""
    reductions = baseline_reductions(results)
    lines = [
        "# Experiment summary",
        "",
        "EDAP in mJ·ms·mm² (objective-aggregated best score); gap = mean "
        "workload-specific vs generalized EDAP gap; reductions compare "
        "the 4-phase search to the plain-GA / random baselines on the "
        "same cell.",
        "",
        "| scenario | paper ref | mem | W | algorithm | best EDAP score "
        "| area (mm²) | gap (%) | vs plain (%) | vs random (%) |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        if r.get("algorithm") == "alg_compare":
            continue  # rendered in the dedicated Table 3 section
        gap = r.get("gap", {}).get("mean_pct")
        red = reductions.get(r["scenario"], {})
        lines.append(
            f"| {r['scenario']} | {r.get('paper_ref') or '—'} "
            f"| {r['mem']} | {len(r['workloads'])} | {r['algorithm']} "
            f"| {_fmt(r['best_score'], 4)} "
            f"| {_fmt(r['generalized']['area_mm2'], 4)} "
            f"| {_fmt(gap)} | {_fmt(red.get('plain'))} "
            f"| {_fmt(red.get('random'))} |")
    text = "\n".join(lines) + "\n"
    text += render_table3(results)
    text += render_front_comparison(results)
    text += render_convergence(results)
    return text


def load_campaign_stats(out_dir: str) -> Optional[Dict]:
    """The last campaign run's stats (campaign.run_campaign writes
    ``<out_dir>/campaign_stats.json``), or None."""
    path = os.path.join(out_dir, "campaign_stats.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def render_campaign_stats(stats: Dict) -> str:
    """Markdown section for the campaign engine's execution stats:
    bucketing, throughput and the cache counters."""
    kc, pc = stats["kernel_cache"], stats["persistent_cache"]
    lines = [
        "", "## Campaign execution", "",
        f"- {stats['n_bucketed']} scenarios mega-batched into "
        f"{stats['n_buckets']} shape buckets "
        f"({stats['lanes_total']} search lanes, "
        f"{stats['lanes_padded']} padding); "
        f"{stats['n_cached']} served from the result cache, "
        f"{stats['n_fallback']} ran sequentially",
        f"- sustained throughput: "
        f"{stats['scenarios_per_sec']:.2f} scenarios/s "
        f"({stats['wall_time_s']:.1f}s wall)",
        f"- in-process bucket-callable cache: {kc['hits']} hits / "
        f"{kc['misses']} misses / {kc['evictions']} evictions",
    ]
    if pc["enabled"]:
        lines.append(
            f"- kernel-build cache ({pc['dir']}): "
            f"{pc['signature_hits']} bucket-signature hits / "
            f"{pc['signature_misses']} misses, "
            f"{pc['entries_after'] - pc['entries_before']} kernel "
            f"libraries built ({pc['entries_after']} in the cache)")
    else:
        lines.append("- kernel-build cache: disabled "
                     "(pass --compile-cache DIR)")
    lines += [
        "",
        "| bucket | engine | scenarios | lanes | gen tier | "
        "dispatch (s) | drain (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for b in stats.get("buckets", []):
        lines.append(
            f"| {b['signature'][:8]} | {b['engine']} "
            f"| {', '.join(b['scenarios'])} "
            f"| {b['lanes']}→{b['lanes_padded_to']} "
            f"| {b['gen_tier']} | {b['dispatch_s']:.2f} "
            f"| {b['drain_s']:.2f} |")
    return "\n".join(lines) + "\n"


def write_summary(out_dir: str, path: Optional[str] = None) -> str:
    """Aggregate cached results into ``summary.md`` (appending the
    campaign-execution section when campaign stats exist); returns the
    text."""
    text = render_summary(load_results(out_dir))
    stats = load_campaign_stats(out_dir)
    if stats is not None:
        text += render_campaign_stats(stats)
    path = path or os.path.join(out_dir, "summary.md")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return text
