"""Scenario runner: registry entry -> search -> metrics -> artifacts;
counterpart of ``repro/experiments/runner.py``.

A scenario's searches run as lane batches (``core/genetic.py``): the S
seeds of the generalized search are one batch, and the (S seeds x W
workloads) workload-specific baselines —
the normalization behind the paper's gap claims — are another, each
lane scoring through the full workload-set evaluator restricted to its
own workload column (``Scorer.score_w``), which is arithmetically
identical to packing that workload alone. The random-search baseline
loops seeds on the host, as in the reference.

Multi-objective scenarios ('+'-joined objective specs) run the NSGA-II
engine (``core/nsga.py``) with the seeds as lanes; every seed's rank-0
designs pool into the searched Pareto front (``_searched_front_block``).
Single-objective ``edap_cost`` scenarios get the post-hoc front of the
designs their search visited (``_pareto_block``). Joint co-search
scenarios (``workload_source="family"``) search a genome with trailing
architecture columns, scored through a ``WorkloadBuilder``, and report
the architecture chosen (the ``joint`` block). ``alg_compare``
scenarios run the Table 3 study (``run_alg_compare``): the GA and the
five baseline optimizers of ``core/baselines.py``, each with its seeds
as one lane batch, scored against an exhaustive ground truth where the
space is small enough.

Results cache per scenario under ``<out_dir>/<scenario>/``:
  result.json          — full metrics (report.py schema), sorted keys
  report.md            — human-readable table
  specific_<wl>.json   — per-workload specific-search sub-results
with the reference's schema (``RESULT_SCHEMA_VERSION``) and cache-key
fields, plus a ``device`` block naming where the run happened.

Every lane batch goes through ``core.distributed.compile_batched_search``:
on a CUDA device with several GPUs present whose count divides the lane
count, the lanes split over them (``search_devices``, the reference's
``_search_mesh`` rule), else they run on the one device. The lane
functions (``lane_search``) are the ones the campaign engine
(``campaign.py``) runs its buckets with, and ``finalize_result`` is
shared with it, so a campaign's result.json equals the sequential one's
modulo timing fields.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .. import random as jr
from ..core import nonideal
from ..core.baselines import batched_baseline_search
from ..core.cost_model import CostTables, HWConstants, evaluate_population
from ..core.distributed import compile_batched_search, search_devices
from ..core.genetic import (FOUR_PHASES, PLAIN_PHASE, MultiSearchResult,
                            SearchResult, batched_joint_search, cards_of,
                            joint_search, lanes_of, phase_schedule,
                            plain_ga_search, random_search, search_kernel)
from ..core.nsga import (MultiMOSearchResult, lanes_of_vec,
                         nsga_search_kernel)
from ..core.objectives import (INFEASIBLE_PENALTY, MultiObjective, Objective,
                               aggregate_scores, make_objective,
                               per_workload_scores)
from ..core.pareto import edap_cost_front, hypervolume_2d
from ..core.scoring import Calib, Scorer, ScorerSpec, build_scorer
from ..core.search_space import TECH_32NM_INDEX, TECH_NODES_NM, SearchSpace
from ..core.tracing import traced_closure
from ..core.workloads import (WorkloadArrays, WorkloadBuilder,
                              WorkloadFamily, make_workload_builder, pack)
from ..device import resolve_device
from . import report
from .scenarios import Scenario

DEFAULT_OUT_DIR = os.path.join("experiments", "results")

# Result-cache schema version, part of every result.json and of the
# cache key (the reference's value: the schemas line up).
RESULT_SCHEMA_VERSION = 3

# Scenario fields that may change without invalidating a cached result:
# display/provenance strings and the CLI's smoke-budget template (the
# budget actually run is keyed through ``scenario.budget``). Every other
# Scenario field must be read by ``cache_key_fields`` below: rule R002
# (``python -m repro_torch.analysis``) fails when a new field is neither
# read there nor listed here. The reference's set.
CACHE_KEY_EXEMPT_FIELDS = frozenset({
    "name", "paper_ref", "description", "smoke_budget",
})


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


def search_budget(scenario: Scenario):
    """(schedule (T, 4), p_h, p_e, hamming) of the scenario's GA or
    NSGA-II search, and of each of its specific-baseline searches (the
    same algorithm and budget)."""
    b = scenario.budget
    if scenario.algorithm == "plain":
        sched = phase_schedule((PLAIN_PHASE,), b.total_generations)
        return sched, max(4 * b.p_ga, 200), b.p_ga, False
    sched = phase_schedule(FOUR_PHASES, b.generations)
    return sched, b.p_h, b.p_e, True


def lane_search(space: SearchSpace, traced: Scorer, *, engine: str,
                part: str, p_h: int, p_e: int, p_ga: int, hamming: bool,
                rram: bool) -> Callable:
    """The lane function of one search flavor, for
    ``compile_batched_search``: ``(device, keys (L, 2), schedule
    (L, T, 4), active (L, T) or None)`` for the generalized GA
    (``engine="ga"``, ``part="main"``, scoring with ``traced.score``)
    and NSGA-II (``engine="nsga"``, ``traced.score_vec``), and ``(device,
    keys, ws (L,), schedule, active)`` for the specific baselines
    (``part="spec"``: lane l scores ``traced.score_w`` on workload
    column ``ws[l]``). Each device scores with ``traced.on(device)``.
    The sequential runner and the campaign's buckets run these same
    functions."""
    def spec_rows(fn: Callable, ws: torch.Tensor) -> Callable:
        def lane_fn(g: torch.Tensor) -> torch.Tensor:
            L, P, n = g.shape
            return fn(g.reshape(L * P, n),
                      ws.repeat_interleave(P)).reshape(L, P)
        return lane_fn

    if engine == "nsga":
        @traced_closure
        def one(dev, keys, schedule, active):
            sc = traced.on(dev)
            return nsga_search_kernel(
                keys, cards_of(space, dev), schedule,
                lanes_of_vec(sc.score_vec),
                lanes_of(sc.feasible) if rram else None, p_h=p_h, p_e=p_e,
                p_ga=p_ga, hamming_sampling=hamming, active=active)
    elif part == "spec":
        @traced_closure
        def one(dev, keys, ws, schedule, active):
            sc = traced.on(dev)
            return search_kernel(
                keys, cards_of(space, dev), schedule,
                spec_rows(sc.score_w, ws),
                spec_rows(sc.feasible_w, ws) if rram else None, p_h=p_h,
                p_e=p_e, p_ga=p_ga, hamming_sampling=hamming, active=active)
    else:
        @traced_closure
        def one(dev, keys, schedule, active):
            sc = traced.on(dev)
            return search_kernel(
                keys, cards_of(space, dev), schedule, lanes_of(sc.score),
                lanes_of(sc.feasible) if rram else None, p_h=p_h, p_e=p_e,
                p_ga=p_ga, hamming_sampling=hamming, active=active)
    return one


def _run_lanes(one: Callable, dev: torch.device, *lanes):
    """``lanes`` (lane-major, L first) through ``one`` on the devices
    ``search_devices`` picks for L lanes."""
    return compile_batched_search(
        one, search_devices(lanes[0].shape[0], dev))(*lanes)


def _lane_schedule(sched: np.ndarray, n_lanes: int,
                   dev: torch.device) -> torch.Tensor:
    s = torch.as_tensor(sched, device=dev)
    return s.expand(n_lanes, *s.shape)


def make_scorer(*_args, **_kwargs):
    """Removed, as in the reference: build through ``core.scoring.
    build_scorer`` and read ``.score`` / ``.evaluator``."""
    raise ImportError(
        "runner.make_scorer was removed; use core.scoring.build_scorer"
        "(space, ScorerSpec(objective, workloads=wa)) and read .score / "
        ".evaluator (or import build_scorer from repro_torch.api)")


def make_traced_scorer(*_args, **_kwargs):
    """Removed, as in the reference: ``build_scorer`` returns the Scorer
    directly; the joint genome-slice path is ``ScorerSpec(objective,
    builder=...)``."""
    raise ImportError(
        "runner.make_traced_scorer was removed; use core.scoring."
        "build_scorer(space, ScorerSpec(objective, workloads=wa, "
        "builder=builder), calib=Calib(n_calib, calib_k)) (or import "
        "build_scorer from repro_torch.api)")


def run_search(scenario: Scenario, space: SearchSpace,
               score_fn: Callable, capacity_filter, seed: int,
               device="cuda") -> SearchResult:
    """One host-driven search of the scenario's algorithm. With a
    host-side ``capacity_filter`` ((N, n) genomes -> (N,) bools) the GA
    algorithms draw their initial pool by the reference's host rejection
    loop (``sampling.sample_initial``)."""
    b = scenario.budget
    key = jr.PRNGKey(seed, resolve_device(device))
    if scenario.algorithm == "fourphase":
        return joint_search(key, space, score_fn, p_h=b.p_h, p_e=b.p_e,
                            p_ga=b.p_ga,
                            generations_per_phase=b.generations,
                            capacity_filter=capacity_filter)
    if scenario.algorithm == "plain":
        return plain_ga_search(key, space, score_fn, p_ga=b.p_ga,
                               total_generations=b.total_generations,
                               capacity_filter=capacity_filter)
    if scenario.algorithm == "random":
        return random_search(key, space, score_fn,
                             n_evals=b.n_evaluations,
                             capacity_filter=capacity_filter)
    raise ValueError(f"unknown algorithm {scenario.algorithm!r}")


def run_search_batched(scenario: Scenario, space: SearchSpace,
                       traced: Scorer, seeds: List[int]
                       ) -> MultiSearchResult:
    """All seeds of the scenario's generalized search as one lane batch
    (GA algorithms); random search loops seeds on the host."""
    b = scenario.budget
    dev = traced.device
    if scenario.algorithm in ("fourphase", "plain"):
        t0 = time.perf_counter()
        sched, p_h, p_e, hamming = search_budget(scenario)
        one = lane_search(space, traced, engine="ga", part="main", p_h=p_h,
                          p_e=p_e, p_ga=b.p_ga, hamming=hamming,
                          rram=scenario.mem == "rram")
        S = len(seeds)
        best_g, best_s, hist, pops, scores = _run_lanes(
            one, dev, _keys(seeds, dev), _lane_schedule(sched, S, dev), None)
        return MultiSearchResult(
            best_genomes=best_g.cpu().numpy(),
            best_scores=best_s.cpu().numpy(), histories=hist.cpu().numpy(),
            populations=pops.cpu().numpy(), scores=scores.cpu().numpy(),
            wall_time_s=time.perf_counter() - t0, sampling_time_s=0.0)
    if scenario.algorithm == "random":
        feas = traced.feasible if scenario.mem == "rram" else None
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


def run_mo_search_batched(scenario: Scenario, space: SearchSpace,
                          traced: Scorer, seeds: List[int]
                          ) -> MultiMOSearchResult:
    """All seeds of a multi-objective scenario's NSGA-II search as one
    lane batch, with the 4-phase schedule's crossover/mutation
    parameters (no other algorithm has a multi-objective counterpart)."""
    if scenario.algorithm != "fourphase":
        raise ValueError(
            f"multi-objective scenarios run the NSGA-II engine with the "
            f"4-phase schedule; algorithm {scenario.algorithm!r} has no "
            "multi-objective counterpart")
    t0 = time.perf_counter()
    dev = traced.device
    sched, p_h, p_e, hamming = search_budget(scenario)
    one = lane_search(space, traced, engine="nsga", part="main", p_h=p_h,
                      p_e=p_e, p_ga=scenario.budget.p_ga, hamming=hamming,
                      rram=scenario.mem == "rram")
    S = len(seeds)
    pops, scores, ranks, hists = _run_lanes(
        one, dev, _keys(seeds, dev), _lane_schedule(sched, S, dev), None)
    return MultiMOSearchResult(
        populations=pops.cpu().numpy(), scores=scores.cpu().numpy(),
        ranks=ranks.cpu().numpy(), histories=hists.cpu().numpy(),
        wall_time_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Table 3 / §III-C1: the algorithm-comparison study
# ---------------------------------------------------------------------------

# Canonical Table 3 row order: the paper's GA first, then the baseline
# optimizers of core/baselines.py (display name -> engine name).
TABLE3_ALGORITHMS = (("GA", "ga"), ("PSO", "pso"), ("ES", "es"),
                     ("SRES", "sres"), ("CMA-ES", "cmaes"),
                     ("G3PCX", "g3pcx"))

# Spaces up to this size get an exhaustive-enumeration ground truth
# (the reduced §III-C1 space has 240 designs); larger spaces measure
# hits against the best design any algorithm found.
EXHAUSTIVE_ENUM_LIMIT = 4096


def make_landscape_scorer(space: SearchSpace, wa: WorkloadArrays,
                          objective: Objective,
                          constants: HWConstants = HWConstants(),
                          device="cuda") -> Callable:
    """Unpenalized scorer on ``device``: the objective's per-workload
    scores aggregated with its scheme, WITHOUT the feasibility/area
    wall. The §III-C1 reduced-space study probes optimizer behaviour on
    the multi-modal utilization landscape, not constraint handling."""
    dev = resolve_device(device)
    tables = CostTables.of(space, wa, dev)

    @traced_closure
    def score(genomes: torch.Tensor) -> torch.Tensor:
        m = evaluate_population(space, wa, genomes.to(dev), constants,
                                tables)
        return aggregate_scores(per_workload_scores(m, objective.kind),
                                objective.aggregation)

    return score


def make_infeasibility_penalty(traced: Scorer,
                               objective: Objective) -> Callable:
    """Graded penalty channel for SRES's stochastic ranking: (N, n)
    genomes to ((N,) scores, (N,) penalties), the penalty the fraction
    of capacity-infeasible workloads plus the relative area excess,
    exactly 0 for a feasible design. One cost-model pass serves the
    penalty and the score (``Scorer.score``'s value, bit for bit),
    where the reference relies on XLA merging its two passes."""
    ac = objective.area_constraint
    inv_ac = float(np.float32(1.0) / np.float32(ac))

    @traced_closure
    def evaluate(genomes: torch.Tensor):
        m = traced.metrics(genomes)
        if traced.accuracy is None:
            s = objective(m)
        else:
            s = objective(m, accuracy=traced.accuracy(genomes))
        W = m.feasible_w.shape[1]
        infeas = ((1.0 - m.feasible_w.float()).sum(dim=1)
                  * float(np.float32(1.0) / np.float32(W)))
        over = torch.clamp(m.area - ac, min=0.0) * inv_ac
        return s, infeas + over

    return evaluate


def enumerate_ground_truth(space: SearchSpace, score_fn: Callable,
                           device="cuda") -> Tuple[float, np.ndarray, int]:
    """Score the whole space in one call on ``device`` (the caller gates
    on EXHAUSTIVE_ENUM_LIMIT): (global_min, argmin genome, N). Raises
    when every design scores infeasible or non-finite."""
    combos = np.asarray(list(itertools.product(
        *[range(len(v)) for v in space.values])), np.int64)
    scores = score_fn(torch.as_tensor(combos, device=device)).cpu().numpy()
    finite = np.isfinite(scores) & (scores < INFEASIBLE_PENALTY)
    if not finite.any():
        raise RuntimeError(
            f"exhaustive enumeration of the {space.mem_type} space "
            f"({combos.shape[0]} designs): every design scores "
            "infeasible, so the ground-truth global minimum is "
            "undefined — check the workload set / area constraint "
            "before regenerating Table 3")
    j = int(np.argmin(np.where(finite, scores, np.inf)))
    return float(scores[j]), combos[j], int(combos.shape[0])


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_alg_compare(scenario: Scenario, space: SearchSpace,
                    wa: WorkloadArrays, objective: Objective,
                    seeds: List[int], device="cuda") -> Dict:
    """The §III-C1 / Table 3 study: GA vs PSO/ES/SRES/CMA-ES/G3PCX on
    ``device``, every algorithm's seeds as one lane batch. The
    reduced-space scenario scores the unpenalized landscape against an
    exhaustive ground truth; the full-space one keeps the real
    constrained objective and feeds SRES the graded infeasibility
    penalty channel. Wall times are steady state: each algorithm runs
    once untimed, then again, timed, between device synchronizations
    (the reference's protocol, whose first run compiles). Each
    algorithm's lanes go through ``compile_batched_search``, scored on
    each device by that device's scorer."""
    if isinstance(objective, MultiObjective):
        raise TypeError("the algorithm-comparison study is single-"
                        "objective; got a multi-objective spec")
    dev = resolve_device(device)
    b = scenario.budget
    pop, iters = b.p_ga, b.total_generations
    per_device: Dict[torch.device, Tuple] = {}
    if scenario.reduced_space:
        def build_on(d):
            return make_landscape_scorer(space, wa, objective, device=d), None
    else:
        traced = build_scorer(space, ScorerSpec(objective, workloads=wa),
                              calib=Calib(scenario.n_calib,
                                          scenario.calib_k),
                              backend=scenario.backend, device=dev)

        def build_on(d):
            sc = traced.on(d)
            return sc.score, make_infeasibility_penalty(sc, objective)

    def score_on(d: torch.device) -> Tuple:
        """(score, SRES penalty channel or None) on device ``d``."""
        if d not in per_device:
            per_device[d] = build_on(d)
        return per_device[d]
    score = score_on(dev)[0]

    gt: Dict = {"exhaustive": False, "global_min": None,
                "criterion": "best found across all algorithms"}
    if space.size <= EXHAUSTIVE_ENUM_LIMIT:
        gmin, gdesign, n_enum = enumerate_ground_truth(space, score, dev)
        gt = {"exhaustive": True, "global_min": gmin,
              "global_design": space.decode(gdesign),
              "n_enumerated": n_enum,
              "criterion": "score <= global_min * (1 + 1e-4)"}

    keys = _keys(seeds, dev)
    raw: Dict[str, Tuple] = {}
    for name, alg in TABLE3_ALGORITHMS:
        if alg == "ga":
            # plain GA, random init (the §III-C1 protocol predates the
            # 4-phase schedule and Hamming sampling): the kernel draws
            # exactly p_ga uniform genomes, so the evaluations are the
            # whole budget
            def one(d, k):
                return batched_joint_search(
                    k, space, score_on(d)[0], p_h=pop, p_e=pop, p_ga=pop,
                    generations_per_phase=iters, phases=(PLAIN_PHASE,),
                    hamming_sampling=False)
            evals = pop * (iters + 1)
        else:
            def one(d, k, alg=alg):
                sc, penalty = score_on(d)
                return batched_baseline_search(
                    k, space, sc, alg, pop=pop, iters=iters,
                    penalty_fn=penalty if alg == "sres" else None)
            evals = None

        def dispatch(one=one):
            return _run_lanes(one, dev, keys)
        dispatch()
        _sync(dev)
        t0 = time.perf_counter()
        r = dispatch()
        _sync(dev)
        wall = time.perf_counter() - t0
        raw[name] = (np.asarray(r.best_scores), np.asarray(r.best_genomes),
                     wall, evals if evals is not None else r.evaluations)

    best_found = min(float(np.min(s)) for s, _, _, _ in raw.values())
    if best_found >= INFEASIBLE_PENALTY:
        raise RuntimeError(
            f"scenario {scenario.name!r}: no algorithm found a feasible "
            "design at this budget — raise the budget or check the "
            "constraints")
    ref = gt["global_min"] if gt["exhaustive"] else best_found
    algorithms: Dict[str, Dict] = {}
    for name, _ in TABLE3_ALGORITHMS:
        s, g, wall, evals = raw[name]
        hits = int(np.sum(s <= ref * (1 + 1e-4)))
        j = int(np.argmin(s))
        # mean/std over the seeds that found a feasible design: a 1e30
        # penalty score is a failure marker, not a statistic
        feas = s[s < INFEASIBLE_PENALTY]
        algorithms[name] = {
            "hits": hits,
            "n_seeds": len(seeds),
            "n_feasible": int(feas.shape[0]),
            "hit_rate": f"{hits}/{len(seeds)}",
            "best_scores": [float(x) for x in s],
            "mean_best": float(np.mean(feas)) if feas.size else
            float("nan"),
            "std_best": float(np.std(feas)) if feas.size else float("nan"),
            "best_score": float(s[j]),
            "best_design": space.decode(g[j]),
            "mean_wall_time_s": wall / len(seeds),
            "evaluations": int(evals),
        }
    winner = min(algorithms, key=lambda n: algorithms[n]["best_score"])
    return {
        "space_size": int(space.size),
        "ground_truth": gt,
        "algorithms": algorithms,
        "best_algorithm": winner,
        "best_score": algorithms[winner]["best_score"],
    }


def run_specific_fanout(scenario: Scenario, space: SearchSpace,
                        traced: Scorer, seeds: List[int],
                        n_workloads: int) -> Dict[str, np.ndarray]:
    """The (S seeds x W workloads) specific-baseline searches as one
    lane batch. Returns 'genomes' (S, W, n), 'best_scores' (S, W) and
    'edap' (S, W): each specific design's EDAP on its own workload.
    Lane keys match the reference: seed + 1000 + workload index."""
    S, W = len(seeds), n_workloads
    dev = traced.device
    sched, p_h, p_e, hamming = search_budget(scenario)
    one = lane_search(space, traced, engine="ga", part="spec", p_h=p_h,
                      p_e=p_e, p_ga=scenario.budget.p_ga, hamming=hamming,
                      rram=scenario.mem == "rram")
    keys = _keys([s + 1000 + i for s in seeds for i in range(W)], dev)
    ws = torch.tensor([i for _ in seeds for i in range(W)],
                      dtype=torch.int64, device=dev)
    best_g, best_s, _, _, _ = _run_lanes(
        one, dev, keys, ws, _lane_schedule(sched, S * W, dev), None)
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


def _single_workload(scenario: Scenario, wl_name: str) -> Scenario:
    """The workload-specific counterpart of a multi-workload scenario."""
    return dataclasses.replace(
        scenario, name=f"{scenario.name}/specific_{wl_name}",
        workloads=(wl_name,), specific_baselines=False)


def run_specific_sequential(scenario: Scenario, space: SearchSpace,
                            objective: Objective, workloads,
                            seeds: List[int], device
                            ) -> Dict[str, np.ndarray]:
    """Specific baselines one host-driven search per (seed, workload)
    (``run_search``), each with its own single-workload pack: the
    random-search algorithm's, and any algorithm's with
    ``specific_fanout=False``. RRAM searches take the host capacity
    filter, so their initial pools are the reference's rejection-loop
    draws (the fan-out masks on the device instead, and its per-seed
    trajectories differ)."""
    S, W = len(seeds), len(workloads)
    genomes, best_scores, edap = None, np.zeros((S, W)), np.zeros((S, W))
    for i, w in enumerate(workloads):
        sub_sc = _single_workload(scenario, w.name)
        sub = build_scorer(space, ScorerSpec(objective, workloads=pack([w])),
                           calib=Calib(scenario.n_calib, scenario.calib_k),
                           backend=scenario.backend, device=device)
        cap = sub.feasible if scenario.mem == "rram" else None
        for si, s in enumerate(seeds):
            r = run_search(sub_sc, space, sub.score, cap, seed=s + 1000 + i,
                           device=sub.device)
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


def _hv_of(points: np.ndarray) -> Tuple[Optional[float], Optional[List]]:
    """Hypervolume of a 2-D minimize-front with the reference point at
    1.05 × the per-axis maximum of the candidate cloud."""
    if points.ndim != 2 or points.shape[1] != 2 or points.shape[0] == 0:
        return None, None
    ref = 1.05 * np.max(points, axis=0)
    return hypervolume_2d(points, ref), [float(r) for r in ref]


def _tech_nm_of(space: SearchSpace, genome: np.ndarray) -> float:
    ti = (int(genome[space.index("tech_idx")])
          if "tech_idx" in space.names else TECH_32NM_INDEX)
    return float(TECH_NODES_NM[ti])


def _pareto_block(space: SearchSpace, traced: Scorer, res: MultiSearchResult,
                  objective: Objective) -> Dict:
    """EDAP × fabrication-cost Pareto front over the designs the search
    visited (final populations of every seed), Fig. 9's construction
    *post hoc*. EDAP keeps the objective's aggregation without the cost
    factor, so the two axes are the paper's."""
    cand = np.unique(
        np.asarray(res.populations).reshape(-1, space.n_params), axis=0)
    m = traced.metrics(torch.as_tensor(cand, device=traced.device))
    edap = Objective("edap", objective.aggregation,
                     objective.area_constraint)(m).cpu().numpy()
    cost = m.cost.cpu().numpy()
    ok = np.isfinite(edap) & (edap < INFEASIBLE_PENALTY)
    cand, edap, cost = cand[ok], edap[ok], cost[ok]
    idx, e_f, c_f = edap_cost_front(edap, cost)
    front = []
    for j, e, c in zip(idx, e_f, c_f):
        front.append({"edap": float(e), "cost": float(c),
                      "tech_nm": _tech_nm_of(space, cand[j]),
                      "design": space.decode(cand[j])})
    hv, ref = _hv_of(np.stack([edap, cost], axis=1)
                     if edap.shape[0] else np.zeros((0, 2)))
    return {
        "searched": False,
        "axes": ["edap", "cost"],
        "n_candidates": int(edap.shape[0]),
        "points": [{"edap": float(e), "cost": float(c)}
                   for e, c in zip(edap, cost)],
        "front": front,
        "hypervolume": hv,
        "ref_point": ref,
    }


def _axis_labels(objective: MultiObjective) -> List[str]:
    """Unique short labels per component (kind, suffixed on clashes)."""
    labels, seen = [], {}
    for o in objective.components:
        k = o.kind
        if k in seen:
            seen[k] += 1
            k = f"{k}_{seen[o.kind]}"
        else:
            seen[k] = 0
        labels.append(k)
    return labels


def _searched_front_block(space: SearchSpace, res: MultiMOSearchResult,
                          objective: MultiObjective
                          ) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """The searched front: every seed's rank-0 designs pooled and
    re-filtered to the global non-dominated subset
    (``MultiMOSearchResult.union_front``), with the score matrix the
    search optimized, keyed by the component kinds. Returns (block,
    genomes, scores) of the feasible front designs."""
    labels = _axis_labels(objective)
    genomes, scores = res.union_front()
    ok = np.all(scores < INFEASIBLE_PENALTY, axis=1)
    genomes, scores = genomes[ok], scores[ok]
    # every feasible candidate of the final populations (the cloud
    # behind the front)
    d = scores.shape[1] if scores.ndim == 2 else len(labels)
    all_scores = np.asarray(res.scores).reshape(-1, d)
    all_scores = all_scores[np.all(all_scores < INFEASIBLE_PENALTY,
                                   axis=1)]
    order = np.argsort(scores[:, -1], kind="stable")  # by cost, Fig. 9
    front = []
    for j in order:
        entry = {lab: float(v) for lab, v in zip(labels, scores[j])}
        entry["tech_nm"] = _tech_nm_of(space, genomes[j])
        entry["design"] = space.decode(genomes[j])
        front.append(entry)
    hv, ref = (_hv_of(all_scores) if d == 2 else (None, None))
    block = {
        "searched": True,
        "axes": labels,
        "n_candidates": int(all_scores.shape[0]),
        "points": [{lab: float(v) for lab, v in zip(labels, row)}
                   for row in all_scores],
        "front": front,
        "front_sizes_per_seed": [int(np.sum(res.ranks[s] == 0))
                                 for s in range(res.n_seeds)],
        "hypervolume": hv,
        "ref_point": ref,
    }
    return block, genomes, scores


@dataclasses.dataclass(frozen=True)
class ScenarioSetup:
    """Host-side scenario state: the search space, resolved workloads
    (with the joint co-search's families and builder, else the packed
    arrays) and the objective."""
    space: SearchSpace
    workloads: tuple
    families: tuple
    builder: Optional[WorkloadBuilder]
    wa: Optional[WorkloadArrays]
    wl_names: tuple
    objective: Union[Objective, MultiObjective]

    @property
    def is_joint(self) -> bool:
        return bool(self.families)

    @property
    def is_mo(self) -> bool:
        return isinstance(self.objective, MultiObjective)


def setup_scenario(scenario: Scenario) -> ScenarioSetup:
    """Resolve a scenario's space/workloads/objective (no device
    work)."""
    space = scenario.space()
    workloads = scenario.resolve_workloads()
    families = [w for w in workloads if isinstance(w, WorkloadFamily)]
    if families:
        if scenario.algorithm in ("random", "alg_compare"):
            raise ValueError(
                f"scenario {scenario.name!r}: joint co-search scenarios "
                f"run the GA/NSGA-II engines; algorithm "
                f"{scenario.algorithm!r} has no joint-genome path")
        builder = make_workload_builder(space, workloads)
        wa = None
        wl_names = builder.names
    else:
        builder = None
        wa = pack(workloads)
        wl_names = wa.names
    objective = make_objective(scenario.objective,
                               min_accuracy=scenario.min_accuracy)
    return ScenarioSetup(space=space, workloads=tuple(workloads),
                         families=tuple(families), builder=builder, wa=wa,
                         wl_names=tuple(wl_names), objective=objective)


def build_scenario_scorer(scenario: Scenario, st: ScenarioSetup,
                          device="cuda") -> Scorer:
    """The scenario's Scorer on ``device``."""
    return build_scorer(
        st.space, ScorerSpec(st.objective, workloads=st.wa,
                             builder=st.builder),
        calib=Calib(scenario.n_calib, scenario.calib_k),
        backend=scenario.backend, device=device)


def run_scenario(scenario: Scenario, out_dir: str = DEFAULT_OUT_DIR,
                 force: bool = False, seed: Optional[int] = None,
                 write: bool = True, n_seeds: Optional[int] = None,
                 specific_fanout: bool = True, device="cuda") -> Dict:
    """Execute one scenario end to end on ``device``; returns the result
    dict. Seeds ``seed, seed+1, ...`` run as one lane batch; top-level
    fields report the best seed, the ``seeds`` block mean±std. A
    completed scenario loads from cache unless ``force``; ``write=False``
    skips all filesystem I/O. ``specific_fanout=False`` runs the
    specific baselines one search at a time (``run_specific_sequential``)
    instead of as one lane batch."""
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
    if scenario.algorithm == "alg_compare":
        # Table 3 / §III-C1: six algorithms, per-algorithm hit-rate
        # statistics — its own result schema, the same cache/artifact
        # plumbing (report.render_markdown branches on the algorithm)
        result = {
            "scenario": scenario.name,
            "mem": scenario.mem,
            "algorithm": scenario.algorithm,
            "objective": scenario.objective,
            "paper_ref": scenario.paper_ref,
            "description": scenario.description,
            "workloads": list(st.wl_names),
            "seeds": {"count": n_seeds, "list": seeds},
            "cached": False,
            "device": device_info(dev),
            **cache_key_fields(scenario, seed, n_seeds, dev),
        }
        result.update(run_alg_compare(scenario, st.space, st.wa,
                                      st.objective, seeds, dev))
        result["wall_time_s"] = time.perf_counter() - t0
        if write:
            report.write_artifacts(result,
                                   os.path.join(out_dir, scenario.name))
        return result
    traced = build_scenario_scorer(scenario, st, dev)
    if st.is_mo:
        res = run_mo_search_batched(scenario, st.space, traced, seeds)
    else:
        res = run_search_batched(scenario, st.space, traced, seeds)
    return finalize_result(scenario, st, traced, res, seeds,
                           specific_fanout=specific_fanout,
                           out_dir=out_dir, write=write, t0=t0)


def result_best_scores(res, is_mo: bool) -> np.ndarray:
    """Per-seed scalar best score: the GA's best scores, or for NSGA-II
    the last row of the ideal-point history (first objective)."""
    if is_mo:
        return np.asarray(res.histories[:, -1, 0])
    return np.asarray(res.best_scores)


def finalize_result(scenario: Scenario, st: ScenarioSetup, traced: Scorer,
                    res, seeds: List[int], *, spec: Optional[Dict] = None,
                    specific_fanout: bool = True,
                    out_dir: str = DEFAULT_OUT_DIR, write: bool = True,
                    t0: Optional[float] = None) -> Dict:
    """Search results (``MultiSearchResult`` or ``MultiMOSearchResult``)
    -> result dict (+ artifacts), with the workload-specific baselines
    and the generalization gap, the searched or post-hoc Pareto front
    and the joint co-search's chosen architecture. Shared by the
    sequential path and the campaign engine, so both write the same
    JSON modulo timing fields. ``spec`` injects specific-baseline arrays
    already searched (``run_specific_fanout``'s schema, the campaign's
    spec lanes); without it they are searched here."""
    if t0 is None:
        t0 = time.perf_counter()
    seed, n_seeds = seeds[0], len(seeds)
    dev = traced.device
    sdir = os.path.join(out_dir, scenario.name)
    space, objective, is_mo = st.space, st.objective, st.is_mo
    workloads, wl_names = st.workloads, st.wl_names
    best_scores = result_best_scores(res, is_mo)
    if float(np.min(best_scores)) >= INFEASIBLE_PENALTY:
        raise RuntimeError(
            f"scenario {scenario.name!r}: every seed converged to an "
            "infeasible design — the capacity/area constraints reject "
            "(almost) the whole space; raise the sampling oversample "
            "or shrink the workloads")
    j_best = int(np.argmin(best_scores))
    if is_mo:
        pareto_block, genomes, scores = _searched_front_block(
            space, res, objective)
        # representative design: the searched-front point minimizing
        # the first objective
        if genomes.shape[0] == 0:
            raise RuntimeError(
                f"scenario {scenario.name!r}: the searched front holds "
                "no feasible design")
        best_genome = genomes[int(np.argmin(scores[:, 0]))]
        history = res.histories[j_best, :, 0]
        histories = res.histories[:, :, 0]
    else:
        best = res.seed_result(j_best)
        best_genome = best.best_genome
        history = np.asarray(best.history)
        histories = np.asarray(res.histories)
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
        "generalized": _design_metrics(space, traced, best_genome,
                                       wl_names),
        "history": np.asarray(history).tolist(),
        "histories": np.asarray(histories).tolist(),
        "search_wall_time_s": res.wall_time_s,
        "sampling_time_s": getattr(res, "sampling_time_s", 0.0),
        "cached": False,
    }
    if st.is_joint:
        # the architecture the joint search chose: the best genome's
        # arch slice decoded, and the model each family builds there
        g = np.asarray(best_genome)
        decoded = space.decode(g)
        chosen = {}
        for f in st.families:
            idx = [int(g[space.index(f"{f.name}.{p.name}")])
                   for p in f.params]
            chosen[f.name] = f.build_at(idx).name
        result["joint"] = {
            "families": [f.name for f in st.families],
            "arch_params": {n: decoded[n] for n in space.arch_names},
            "chosen_models": chosen,
            "n_arch_dims": space.n_arch,
        }
    if is_mo:
        result["pareto"] = pareto_block
        result["history_mo"] = res.histories[j_best].tolist()
    elif objective.kind == "edap_cost":
        # §IV-I: the EDAP × cost trade-off the search explored
        result["pareto"] = _pareto_block(space, traced, res, objective)

    gap_means = None
    if scenario.specific_baselines and len(workloads) > 1 and not is_mo:
        if spec is None and specific_fanout and \
                scenario.algorithm != "random":
            spec = run_specific_fanout(scenario, space, traced, seeds,
                                       len(workloads))
        elif spec is None:
            spec = run_specific_sequential(scenario, space, objective,
                                           workloads, seeds, dev)

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
