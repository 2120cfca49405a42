"""Scenario runner: registry entry -> search -> metrics -> artifacts;
counterpart of ``repro/experiments/runner.py`` for the ``fourphase``,
``plain`` and ``random`` algorithms with single objectives.

A scenario's searches run as lane batches on one device
(``core/genetic.py``): the S seeds of the generalized search are one
batch, and the (S seeds x W workloads) workload-specific baselines —
the normalization behind the paper's gap claims — are another, each
lane scoring through the full workload-set evaluator restricted to its
own workload column (``Scorer.score_w``), which is arithmetically
identical to packing that workload alone. The random-search baseline
loops seeds on the host, as in the reference.

Results cache per scenario under ``<out_dir>/<scenario>/``:
  result.json          — full metrics (report.py schema), sorted keys
  report.md            — human-readable table
  specific_<wl>.json   — per-workload specific-search sub-results
with the reference's schema (``RESULT_SCHEMA_VERSION``) and cache-key
fields, plus a ``device`` block naming where the run happened. The
campaign engine, the mesh and the multi-objective, Table 3 and joint
paths are not ported yet (ROADMAP Queue 1 items 7-10).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import random as jr
from ..core import nonideal
from ..core.genetic import (FOUR_PHASES, PLAIN_PHASE, MultiSearchResult,
                            batched_joint_search, cards_of, phase_schedule,
                            random_search, search_kernel)
from ..core.objectives import (INFEASIBLE_PENALTY, Objective, make_objective,
                               per_workload_scores)
from ..core.scoring import Calib, Scorer, ScorerSpec, build_scorer
from ..core.search_space import SearchSpace
from ..core.workloads import WorkloadArrays, pack
from ..device import resolve_device
from . import report
from .scenarios import Scenario, check_ported

DEFAULT_OUT_DIR = os.path.join("experiments", "results")

# Result-cache schema version, part of every result.json and of the
# cache key (the reference's value: the schemas line up).
RESULT_SCHEMA_VERSION = 3


def cache_key_fields(scenario: Scenario, seed: int, n_seeds: int,
                     device="cuda") -> Dict:
    """The fields a cached result.json must match to be served
    (JSON-stable: lists, not tuples)."""
    dev = resolve_device(device)
    return {
        "schema_version": RESULT_SCHEMA_VERSION,
        "seed": seed,
        "n_seeds": n_seeds,
        "budget": dataclasses.asdict(scenario.budget),
        "calib": {"n_calib": scenario.n_calib,
                  "calib_k": scenario.calib_k},
        "backend": nonideal.resolve_backend(scenario.backend, dev),
        "scenario_key": {
            "mem": scenario.mem,
            "workloads": list(scenario.workloads),
            "algorithm": scenario.algorithm,
            "objective": scenario.objective,
            "seed": scenario.seed,
            "seq": scenario.seq,
            "tech_variable": scenario.tech_variable,
            "workload_source": scenario.workload_source,
            "specific_baselines": scenario.specific_baselines,
            "reduced_space": scenario.reduced_space,
            "min_accuracy": scenario.min_accuracy,
        },
    }


def device_info(device) -> Dict:
    """The device a result was computed on (recorded in result.json)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count()}
    return {"type": "cpu", "name": "cpu", "count": 1}


def load_cached_result(scenario: Scenario, out_dir: str, seed: int,
                       n_seeds: int, device="cuda") -> Optional[Dict]:
    """Serve ``<out_dir>/<scenario>/result.json`` when its cache-key
    fields match, else None."""
    cache = os.path.join(out_dir, scenario.name, "result.json")
    if not os.path.exists(cache):
        return None
    with open(cache) as f:
        cached = json.load(f)
    want = cache_key_fields(scenario, seed, n_seeds, device)
    if all(cached.get(k) == v for k, v in want.items()):
        cached["cached"] = True
        return cached
    return None


def _keys(seeds: List[int], device) -> torch.Tensor:
    return torch.stack([jr.PRNGKey(s, device) for s in seeds])


def run_search_batched(scenario: Scenario, space: SearchSpace,
                       traced: Scorer, seeds: List[int]
                       ) -> MultiSearchResult:
    """All seeds of the scenario's generalized search as one lane batch
    (GA algorithms); random search loops seeds on the host."""
    b = scenario.budget
    dev = traced.device
    feas = traced.feasible if scenario.mem == "rram" else None
    if scenario.algorithm == "fourphase":
        return batched_joint_search(
            _keys(seeds, dev), space, traced.score, p_h=b.p_h, p_e=b.p_e,
            p_ga=b.p_ga, generations_per_phase=b.generations,
            feasible_fn=feas)
    if scenario.algorithm == "plain":
        return batched_joint_search(
            _keys(seeds, dev), space, traced.score,
            p_h=max(4 * b.p_ga, 200), p_e=b.p_ga, p_ga=b.p_ga,
            generations_per_phase=b.total_generations,
            phases=(PLAIN_PHASE,), hamming_sampling=False,
            feasible_fn=feas)
    if scenario.algorithm == "random":
        rs = [random_search(jr.PRNGKey(s, dev), space, traced.score,
                            n_evals=b.n_evaluations, capacity_filter=feas)
              for s in seeds]
        return MultiSearchResult(
            best_genomes=np.stack([r.best_genome for r in rs]),
            best_scores=np.asarray([r.best_score for r in rs]),
            histories=np.stack([r.history for r in rs]),
            populations=np.stack([r.population for r in rs]),
            scores=np.stack([r.scores for r in rs]),
            wall_time_s=sum(r.wall_time_s for r in rs),
            sampling_time_s=0.0)
    raise ValueError(f"unknown algorithm {scenario.algorithm!r}")


def _specific_budget(scenario: Scenario):
    """(schedule, p_h, p_e, hamming) of one specific-baseline search —
    the same algorithm/budget as the generalized search."""
    b = scenario.budget
    if scenario.algorithm == "plain":
        sched = phase_schedule((PLAIN_PHASE,), b.total_generations)
        return sched, max(4 * b.p_ga, 200), b.p_ga, False
    sched = phase_schedule(FOUR_PHASES, b.generations)
    return sched, b.p_h, b.p_e, True


def run_specific_fanout(scenario: Scenario, space: SearchSpace,
                        traced: Scorer, seeds: List[int],
                        n_workloads: int) -> Dict[str, np.ndarray]:
    """The (S seeds x W workloads) specific-baseline searches as one
    lane batch. Returns 'genomes' (S, W, n), 'best_scores' (S, W) and
    'edap' (S, W): each specific design's EDAP on its own workload.
    Lane keys match the reference: seed + 1000 + workload index."""
    S, W = len(seeds), n_workloads
    dev = traced.device
    sched, p_h, p_e, hamming = _specific_budget(scenario)
    keys = _keys([s + 1000 + i for s in seeds for i in range(W)], dev)
    ws = torch.tensor([i for _ in seeds for i in range(W)],
                      dtype=torch.int64, device=dev)

    def lane_rows(fn: Callable) -> Callable:
        def lane_fn(g: torch.Tensor) -> torch.Tensor:
            L, P, n = g.shape
            return fn(g.reshape(L * P, n),
                      ws.repeat_interleave(P)).reshape(L, P)
        return lane_fn

    feas = lane_rows(traced.feasible_w) if scenario.mem == "rram" else None
    best_g, best_s, _, _, _ = search_kernel(
        keys, cards_of(space, dev), torch.as_tensor(sched, device=dev),
        lane_rows(traced.score_w), feas, p_h=p_h, p_e=p_e,
        p_ga=scenario.budget.p_ga, hamming_sampling=hamming)
    genomes = best_g.cpu().numpy().reshape(S, W, -1)
    return {"genomes": genomes,
            "best_scores": best_s.cpu().numpy().reshape(S, W),
            "edap": specific_edap(traced, genomes)}


def specific_edap(traced: Scorer, genomes: np.ndarray) -> np.ndarray:
    """Each specific design's EDAP on its own workload: (S, W, n)
    genomes -> (S, W)."""
    S, W = genomes.shape[:2]
    g = torch.as_tensor(genomes.reshape(S * W, -1), device=traced.device)
    edap_all = per_workload_scores(traced.metrics(g), "edap")
    edap_all = edap_all.cpu().numpy().reshape(S, W, W)
    return edap_all[:, np.arange(W), np.arange(W)]


def run_specific_sequential(scenario: Scenario, space: SearchSpace,
                            objective: Objective, workloads,
                            seeds: List[int], device
                            ) -> Dict[str, np.ndarray]:
    """Specific baselines of the random-search algorithm: one search
    per (seed, workload), each with its own single-workload pack."""
    S, W = len(seeds), len(workloads)
    genomes, best_scores, edap = None, np.zeros((S, W)), np.zeros((S, W))
    for i, w in enumerate(workloads):
        sub = build_scorer(space, ScorerSpec(objective, workloads=pack([w])),
                           calib=Calib(scenario.n_calib, scenario.calib_k),
                           backend=scenario.backend, device=device)
        cap = sub.feasible if scenario.mem == "rram" else None
        for si, s in enumerate(seeds):
            r = random_search(jr.PRNGKey(s + 1000 + i, sub.device), space,
                              sub.score,
                              n_evals=scenario.budget.n_evaluations,
                              capacity_filter=cap)
            if genomes is None:
                genomes = np.zeros((S, W, r.best_genome.shape[0]),
                                   r.best_genome.dtype)
            genomes[si, i] = r.best_genome
            best_scores[si, i] = r.best_score
            msub = sub.metrics(torch.as_tensor(r.best_genome[None],
                                               device=sub.device))
            edap[si, i] = float(per_workload_scores(msub, "edap")[0, 0])
    return {"genomes": genomes, "best_scores": best_scores, "edap": edap}


def _design_metrics(space: SearchSpace, traced: Scorer,
                    genome: np.ndarray, names) -> Dict:
    g = torch.as_tensor(np.asarray(genome)[None], device=traced.device)
    m = traced.metrics(g)
    edap = per_workload_scores(m, "edap").cpu().numpy()[0]
    acc = (traced.accuracy(g).cpu().numpy()[0]
           if traced.accuracy is not None else None)
    energy, latency = m.energy.cpu().numpy(), m.latency.cpu().numpy()
    per = {}
    for i, n in enumerate(names):
        per[n] = {"energy_mJ": float(energy[0, i]) * 1e3,
                  "latency_ms": float(latency[0, i]) * 1e3,
                  "edap": float(edap[i])}
        if acc is not None:
            per[n]["accuracy"] = float(acc[i])
    return {
        "design": space.decode(genome),
        "objective_score": float(traced.score(g).cpu()[0]),
        "area_mm2": float(m.area.cpu()[0]),
        "feasible": bool(m.feasible.cpu()[0]),
        "per_workload": per,
    }


@dataclasses.dataclass(frozen=True)
class ScenarioSetup:
    """Host-side scenario state: the search space, resolved workloads,
    their packed arrays and the objective."""
    space: SearchSpace
    workloads: tuple
    wa: WorkloadArrays
    wl_names: tuple
    objective: Objective


def setup_scenario(scenario: Scenario) -> ScenarioSetup:
    """Resolve a scenario's space/workloads/objective (no device work);
    raises ``NotImplementedError`` for engines not ported yet."""
    check_ported(scenario)
    space = scenario.space()
    workloads = scenario.resolve_workloads()
    wa = pack(workloads)
    objective = make_objective(scenario.objective,
                               min_accuracy=scenario.min_accuracy)
    return ScenarioSetup(space=space, workloads=tuple(workloads), wa=wa,
                         wl_names=tuple(wa.names), objective=objective)


def build_scenario_scorer(scenario: Scenario, st: ScenarioSetup,
                          device="cuda") -> Scorer:
    """The scenario's Scorer on ``device``."""
    return build_scorer(
        st.space, ScorerSpec(st.objective, workloads=st.wa),
        calib=Calib(scenario.n_calib, scenario.calib_k),
        backend=scenario.backend, device=device)


def run_scenario(scenario: Scenario, out_dir: str = DEFAULT_OUT_DIR,
                 force: bool = False, seed: Optional[int] = None,
                 write: bool = True, n_seeds: Optional[int] = None,
                 device="cuda") -> Dict:
    """Execute one scenario end to end on ``device``; returns the result
    dict. Seeds ``seed, seed+1, ...`` run as one lane batch; top-level
    fields report the best seed, the ``seeds`` block mean±std. A
    completed scenario loads from cache unless ``force``; ``write=False``
    skips all filesystem I/O."""
    dev = resolve_device(device)
    seed = scenario.seed if seed is None else seed
    n_seeds = scenario.budget.n_seeds if n_seeds is None else n_seeds
    seeds = [seed + j for j in range(n_seeds)]
    if write and not force:
        cached = load_cached_result(scenario, out_dir, seed, n_seeds, dev)
        if cached is not None:
            return cached

    t0 = time.perf_counter()
    st = setup_scenario(scenario)
    traced = build_scenario_scorer(scenario, st, dev)
    res = run_search_batched(scenario, st.space, traced, seeds)
    return finalize_result(scenario, st, traced, res, seeds,
                           out_dir=out_dir, write=write, t0=t0)


def finalize_result(scenario: Scenario, st: ScenarioSetup, traced: Scorer,
                    res: MultiSearchResult, seeds: List[int], *,
                    out_dir: str = DEFAULT_OUT_DIR, write: bool = True,
                    t0: Optional[float] = None) -> Dict:
    """Search results -> result dict (+ artifacts), with the
    workload-specific baselines and the generalization gap."""
    if t0 is None:
        t0 = time.perf_counter()
    seed, n_seeds = seeds[0], len(seeds)
    dev = traced.device
    sdir = os.path.join(out_dir, scenario.name)
    space, objective = st.space, st.objective
    workloads, wl_names = st.workloads, st.wl_names
    best_scores = np.asarray(res.best_scores)
    if float(np.min(best_scores)) >= INFEASIBLE_PENALTY:
        raise RuntimeError(
            f"scenario {scenario.name!r}: every seed converged to an "
            "infeasible design — the capacity/area constraints reject "
            "(almost) the whole space; raise the sampling oversample "
            "or shrink the workloads")
    j_best = int(np.argmin(best_scores))
    best = res.seed_result(j_best)
    result: Dict = {
        "scenario": scenario.name,
        "mem": scenario.mem,
        "algorithm": scenario.algorithm,
        "objective": scenario.objective,
        "paper_ref": scenario.paper_ref,
        "description": scenario.description,
        **cache_key_fields(scenario, seed, n_seeds, dev),
        "device": device_info(dev),
        "workloads": list(wl_names),
        "best_score": float(best_scores[j_best]),
        "generalized": _design_metrics(space, traced, best.best_genome,
                                       wl_names),
        "history": np.asarray(best.history).tolist(),
        "histories": np.asarray(res.histories).tolist(),
        "search_wall_time_s": res.wall_time_s,
        "sampling_time_s": res.sampling_time_s,
        "cached": False,
    }

    gap_means = None
    if scenario.specific_baselines and len(workloads) > 1:
        if scenario.algorithm == "random":
            spec = run_specific_sequential(scenario, space, objective,
                                           workloads, seeds, dev)
        else:
            spec = run_specific_fanout(scenario, space, traced, seeds,
                                       len(workloads))

        # per-seed generalized EDAPs -> per-seed gap
        m_gen = traced.metrics(torch.as_tensor(res.best_genomes,
                                               device=dev))
        gen_edap = per_workload_scores(m_gen, "edap").cpu().numpy()
        with np.errstate(divide="ignore", invalid="ignore"):
            gap_pct = 100.0 * (gen_edap / spec["edap"] - 1.0)
        gap_means = np.mean(gap_pct, axis=1)

        names = [w.name for w in workloads]
        result["specific"] = {
            n: {"design": space.decode(spec["genomes"][j_best, i]),
                "edap": float(spec["edap"][j_best, i])}
            for i, n in enumerate(names)
        }
        result["gap"] = report.compute_gap(result)

        if write:
            os.makedirs(sdir, exist_ok=True)
            m_spec = traced.metrics(torch.as_tensor(
                spec["genomes"][j_best], device=dev))
            area = m_spec.area.cpu().numpy()
            feas_w = m_spec.feasible_w.cpu().numpy()
            energy = m_spec.energy.cpu().numpy()
            latency = m_spec.latency.cpu().numpy()
            for i, n in enumerate(names):
                sub = {
                    "design": space.decode(spec["genomes"][j_best, i]),
                    "objective_score": float(
                        spec["best_scores"][j_best, i]),
                    "area_mm2": float(area[i]),
                    "feasible": bool(feas_w[i, i]),
                    "per_workload": {
                        n: {"energy_mJ": float(energy[i, i]) * 1e3,
                            "latency_ms": float(latency[i, i]) * 1e3,
                            "edap": float(spec["edap"][j_best, i])}},
                    "best_score": float(spec["best_scores"][j_best, i]),
                    "seed": seed,
                }
                with open(os.path.join(sdir, f"specific_{n}.json"),
                          "w") as f:
                    json.dump(sub, f, indent=1, sort_keys=True,
                              default=float)

    result["seeds"] = report.aggregate_seeds(seeds, best_scores, gap_means)
    result["wall_time_s"] = time.perf_counter() - t0
    if write:
        report.write_artifacts(result, sdir)
    return result
