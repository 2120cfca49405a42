"""Campaign execution engine: a set of scenario runs as one schedulable
workload; counterpart of ``repro/experiments/campaign.py``.

``run --all`` turns the scenario list into buckets of shape-identical
searches and runs each bucket as one lane batch per lane flavor:

* **shape bucketing** — every run gets a bucket signature (scorer
  content key, engine, populations, generation tier, Hamming and
  feasibility flags). Generation counts pad up to tiers, the padded
  rows masked by the engines' ``active`` argument
  (``core.genetic.ga_scan``, ``core.nsga.nsga_scan``,
  ``core.baselines.baseline_scan``), which is bit-identical to the
  unpadded run (tests/test_torch_campaign.py). Populations stay exact:
  a padded population changes the shapes of the PRNG draws.
* **mega-batching** — a bucket's lanes run as one
  ``compile_batched_search`` call per lane flavor: scenario × seeds for
  the generalized search ("main" lanes, ``traced.score``), scenario ×
  seeds × workloads for the specific baselines ("spec" lanes,
  ``traced.score_w`` on the lane's workload column, keys seed + 1000 +
  workload). Both are ``runner.lane_search``'s functions, the ones the
  sequential runner calls. Per-lane keys, schedules and masks are
  lane data; the lane axis pads to tiers (lane 0 repeated, sliced off
  on drain), as the reference pads so that nearby batch sizes share
  one compiled shape. In eager torch the padding buys no compile; it
  keeps the stats schema and the bucket signature.
* **kernel-build cache** — ``enable_persistent_cache`` points the
  CUDA kernels' build directory (``kernels/build.py``) at a directory
  that outlives the process, so a second process with the same
  ``--compile-cache`` runs no ``nvcc``, and keeps a JSON index of
  bucket signatures whose hits and misses the stats report.
* **pipelining** — buckets are dispatched ``window`` deep before the
  oldest drains. The engines synchronize inside their loops, so on
  the card ``dispatch`` runs most of the search and ``drain`` mostly
  copies results and writes artifacts.

Results are the sequential runner's: the same lane functions, keys and
scorers, and the shared ``runner.finalize_result``, so result JSONs are
byte-identical to ``run_scenario``'s modulo timing fields. ``random``
and ``alg_compare`` scenarios, and multi-objective ones that are not
4-phase, fall back to the sequential runner inside the campaign.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as jr
from ..core import nonideal
from ..core.distributed import (cached_compile, compile_batched_search,
                                kernel_cache_stats, search_devices)
from ..core.genetic import MultiSearchResult
from ..core.nsga import MultiMOSearchResult
from ..core.scoring import Scorer
from ..device import resolve_device
from ..kernels import build
from . import runner
from .scenarios import Scenario

# Generation/lane tier ladders: powers of two densified with 3*2^k so
# padding waste stays under ~33%. Distinct (T, B) pairs that round to
# the same tiers share one bucket callable.
GEN_TIERS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128)
LANE_TIERS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192,
              256)


def _tier(n: int, tiers: Sequence[int], step: int) -> int:
    for t in tiers:
        if n <= t:
            return t
    return ((n + step - 1) // step) * step


def gen_tier(t: int) -> int:
    """Smallest schedule-row tier >= t (multiples of 64 past the
    ladder)."""
    return _tier(t, GEN_TIERS, 64)


def lane_tier(b: int) -> int:
    """Smallest batch-lane tier >= b (multiples of 128 past the
    ladder)."""
    return _tier(b, LANE_TIERS, 128)


def scorer_key(scenario: Scenario, device="cuda") -> Tuple:
    """Content key of a scenario's Scorer on ``device``: two scenarios
    with equal keys build arithmetically identical scorers (same space,
    workload set, objective, calibration and resolved backend), so the
    campaign builds one Scorer for, e.g., a scenario and its ``_plain``
    / ``_random`` registry variants."""
    return (scenario.mem, scenario.reduced_space, scenario.tech_variable,
            scenario.workload_source, tuple(scenario.workloads),
            scenario.seq, scenario.objective, scenario.min_accuracy,
            scenario.n_calib, scenario.calib_k,
            nonideal.resolve_backend(scenario.backend,
                                     resolve_device(device)))


@dataclasses.dataclass
class CampaignJob:
    """One scenario run inside a campaign."""
    scenario: Scenario
    seeds: List[int]
    kind: str                    # "bucket" | "fallback" | "cached"
    t0: float = 0.0
    setup: Optional[runner.ScenarioSetup] = None
    traced: Optional[Scorer] = None
    # bucket-kind shape info (GA engines; NSGA-II reuses p_*/sched)
    engine: str = "ga"           # "ga" | "nsga"
    sched: Optional[np.ndarray] = None
    p_h: int = 0
    p_e: int = 0
    hamming: bool = True
    wants_spec: bool = False
    result: Optional[Dict] = None
    error: Optional[str] = None  # set when a degraded retry also fails

    @property
    def n_workloads(self) -> int:
        return len(self.setup.workloads)

    @property
    def n_spec(self) -> int:
        return (len(self.seeds) * self.n_workloads if self.wants_spec
                else 0)

    @property
    def n_lanes(self) -> int:
        return len(self.seeds) + self.n_spec

    def bucket_key(self) -> Tuple:
        sc = self.scenario
        return (self.engine, scorer_key(sc, self.traced.device), self.p_h,
                self.p_e, sc.budget.p_ga, self.hamming, sc.mem == "rram",
                gen_tier(self.sched.shape[0]))


def _job_shape(job: CampaignJob) -> None:
    """Fill the job's shape fields: the populations and schedule the
    sequential path (``runner.search_budget``) uses."""
    job.sched, job.p_h, job.p_e, job.hamming = runner.search_budget(
        job.scenario)


def plan_campaign(scenarios: Sequence[Scenario],
                  out_dir: str = runner.DEFAULT_OUT_DIR,
                  force: bool = False, seed: Optional[int] = None,
                  n_seeds: Optional[int] = None,
                  write: bool = True, device="cuda") -> List[CampaignJob]:
    """Scenario list -> jobs on ``device``, with shared Scorers resolved.

    Scenarios whose result cache already matches become ``cached``
    jobs; ``random``/``alg_compare`` algorithms and multi-objective
    non-fourphase combinations become ``fallback`` jobs (run by the
    sequential runner); everything else gets a bucket signature.
    """
    dev = resolve_device(device)
    scorers: Dict[Tuple, Tuple[runner.ScenarioSetup, Scorer]] = {}
    jobs: List[CampaignJob] = []
    for sc in scenarios:
        s0 = sc.seed if seed is None else seed
        ns = sc.budget.n_seeds if n_seeds is None else n_seeds
        seeds = [s0 + j for j in range(ns)]
        job = CampaignJob(scenario=sc, seeds=seeds, kind="bucket",
                          t0=time.perf_counter())
        if write and not force:
            cached = runner.load_cached_result(sc, out_dir, s0, ns, dev)
            if cached is not None:
                job.kind, job.result = "cached", cached
                jobs.append(job)
                continue
        if sc.algorithm in ("random", "alg_compare"):
            job.kind = "fallback"
            jobs.append(job)
            continue
        key = scorer_key(sc, dev)
        if key not in scorers:
            st = runner.setup_scenario(sc)
            scorers[key] = (st, runner.build_scenario_scorer(sc, st, dev))
        job.setup, job.traced = scorers[key]
        if job.setup.is_mo:
            if sc.algorithm != "fourphase":
                job.kind = "fallback"
                jobs.append(job)
                continue
            job.engine = "nsga"
        job.wants_spec = (sc.specific_baselines
                          and job.n_workloads > 1
                          and not job.setup.is_mo)
        _job_shape(job)
        jobs.append(job)
    return jobs


# ---------------------------------------------------------------------------
# bucket callables
# ---------------------------------------------------------------------------


def _build_bucket_kernel(key: Tuple, traced: Scorer, space, devices,
                         part: str = "main") -> object:
    """The bucket's callable: its lane function over ``devices``. Every
    lane carries (key, padded schedule, active mask — plus a workload
    index on the specific part) as lane data; the scorer, populations
    and tier are fixed.

    The generalized (``part="main"``) and specific-baseline
    (``part="spec"``) lanes are separate calls of the sequential path's
    own lane functions (``runner.lane_search``), ``traced.score`` vs
    ``traced.score_w``, so a lane computes what it computes alone."""
    engine, _, p_h, p_e, p_ga, hamming, rram, _ = key
    one = runner.lane_search(space, traced, engine=engine, part=part,
                             p_h=p_h, p_e=p_e, p_ga=p_ga, hamming=hamming,
                             rram=rram)
    return compile_batched_search(one, devices)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Bucket:
    """Same-signature jobs packed onto one lane axis per lane flavor
    (generalized "main" lanes; specific-baseline "spec" lanes)."""

    def __init__(self, key: Tuple):
        self.key = key
        self.jobs: List[CampaignJob] = []
        self.offsets: List[Tuple[int, int]] = []   # (main, spec)
        self.n_main = 0
        self.n_spec = 0
        self.outs = None
        self.spec_outs = None
        self.dispatch_s = 0.0
        self.drain_s = 0.0

    def add(self, job: CampaignJob) -> None:
        self.offsets.append((self.n_main, self.n_spec))
        self.jobs.append(job)
        self.n_main += len(job.seeds)
        self.n_spec += job.n_spec

    @property
    def device(self) -> torch.device:
        return self.jobs[0].traced.device

    @property
    def n_lanes(self) -> int:
        return self.n_main + self.n_spec

    @property
    def lanes_padded_to(self) -> int:
        return (lane_tier(self.n_main)
                + (lane_tier(self.n_spec) if self.n_spec else 0))

    @property
    def tier(self) -> int:
        return self.key[7]

    def signature(self) -> str:
        """Stable hash of the bucket signature + padded lane counts
        (the persistent-index key)."""
        raw = repr((self.key, lane_tier(self.n_main),
                    lane_tier(self.n_spec) if self.n_spec else 0))
        return hashlib.sha256(raw.encode()).hexdigest()[:16]

    def _padded_sched(self, job: CampaignJob):
        """The job's schedule padded to the tier by repeating its last
        row, and the mask of its real rows."""
        T = job.sched.shape[0]
        pad = np.concatenate(
            [job.sched, np.tile(job.sched[-1:], (self.tier - T, 1))])
        act = np.zeros((self.tier,), bool)
        act[:T] = True
        return pad, act

    @staticmethod
    def _pad_lanes(cols: List[list], n: int, tier: int) -> Tuple:
        """Repeat lane 0 up to the tier; sliced off on drain."""
        return tuple(c + c[:1] * (tier - n) for c in cols)

    def _lane_tensors(self, keys, scheds, actives, ws=None) -> Tuple:
        """Lane lists -> lane-major tensors on the bucket's device; a
        mask with every row active is passed as None (the unmasked
        loop, which gives the same bits)."""
        dev = self.device
        act = np.stack(actives)
        out = [torch.stack(keys).to(dev)]
        if ws is not None:
            out.append(torch.as_tensor(np.asarray(ws, np.int64), device=dev))
        out.append(torch.as_tensor(np.stack(scheds), device=dev))
        out.append(None if act.all() else torch.as_tensor(act, device=dev))
        return tuple(out)

    def _main_arrays(self) -> Tuple:
        keys, scheds, actives = [], [], []
        for job in self.jobs:
            pad, act = self._padded_sched(job)
            keys += [jr.PRNGKey(s) for s in job.seeds]
            scheds += [pad] * len(job.seeds)
            actives += [act] * len(job.seeds)
        keys, scheds, actives = self._pad_lanes(
            [keys, scheds, actives], self.n_main, lane_tier(self.n_main))
        return self._lane_tensors(keys, scheds, actives)

    def _spec_arrays(self) -> Tuple:
        keys, ws, scheds, actives = [], [], [], []
        for job in self.jobs:
            if not job.wants_spec:
                continue
            pad, act = self._padded_sched(job)
            W = job.n_workloads
            lane_keys = [jr.PRNGKey(s + 1000 + i)
                         for s in job.seeds for i in range(W)]
            keys += lane_keys
            ws += [i for _ in job.seeds for i in range(W)]
            scheds += [pad] * len(lane_keys)
            actives += [act] * len(lane_keys)
        keys, ws, scheds, actives = self._pad_lanes(
            [keys, ws, scheds, actives], self.n_spec,
            lane_tier(self.n_spec))
        return self._lane_tensors(keys, scheds, actives, ws)

    def _kernel(self, part: str, n_lanes: int) -> object:
        job = self.jobs[0]
        b = lane_tier(n_lanes)
        devs = search_devices(b, self.device)
        return cached_compile(
            ("campaign", self.key, part, b, tuple(str(d) for d in devs)),
            lambda: _build_bucket_kernel(self.key, job.traced,
                                         job.setup.space, devs, part),
            job.traced)

    def dispatch(self) -> None:
        """Run the bucket's lane calls (the engines synchronize inside
        their loops, so most of the search runs here)."""
        t0 = time.perf_counter()
        kern = self._kernel("main", self.n_main)
        self.outs = kern(*self._main_arrays())
        if self.n_spec:
            kern = self._kernel("spec", self.n_spec)
            self.spec_outs = kern(*self._spec_arrays())
        _sync(self.device)
        self.dispatch_s = time.perf_counter() - t0

    def drain(self, out_dir: str, write: bool,
              specific_fanout: bool) -> None:
        """Copy the bucket's outputs to the host and finalize every
        job's result dict + artifacts."""
        t0 = time.perf_counter()
        outs = [o.cpu().numpy() for o in self.outs]
        spec_outs = ([o.cpu().numpy() for o in self.spec_outs]
                     if self.spec_outs is not None else None)
        self.outs = self.spec_outs = None
        wall = time.perf_counter() - t0
        for job, (mo, so) in zip(self.jobs, self.offsets):
            share = wall * job.n_lanes / max(self.n_lanes, 1)
            S, T = len(job.seeds), job.sched.shape[0]
            sl = slice(mo, mo + S)
            spec = None
            if job.engine == "nsga":
                pop, scores, ranks, hist = outs
                res = MultiMOSearchResult(
                    populations=pop[sl], scores=scores[sl],
                    ranks=ranks[sl], histories=hist[sl][:, :T + 1],
                    wall_time_s=share)
            else:
                best_g, best_s, hist, pops, pscores = outs
                res = MultiSearchResult(
                    best_genomes=best_g[sl], best_scores=best_s[sl],
                    histories=np.concatenate(
                        [hist[sl][:, :T], hist[sl][:, -1:]], axis=1),
                    populations=pops[sl], scores=pscores[sl],
                    wall_time_s=share, sampling_time_s=0.0)
                if job.wants_spec:
                    W = job.n_workloads
                    sp = slice(so, so + S * W)
                    genomes = spec_outs[0][sp].reshape(S, W, -1)
                    spec = {
                        "genomes": genomes,
                        "best_scores": spec_outs[1][sp].reshape(S, W),
                        "edap": runner.specific_edap(job.traced, genomes),
                    }
            job.result = runner.finalize_result(
                job.scenario, job.setup, job.traced, res, job.seeds,
                spec=spec, specific_fanout=specific_fanout,
                out_dir=out_dir, write=write, t0=job.t0)
        self.drain_s = time.perf_counter() - t0


def bucket_jobs(jobs: Sequence[CampaignJob]
                ) -> "OrderedDict[Tuple, _Bucket]":
    """Group the plan's bucket-kind jobs by bucket signature, in first-
    appearance order (cached/fallback jobs are skipped)."""
    buckets: "OrderedDict[Tuple, _Bucket]" = OrderedDict()
    for job in jobs:
        if job.kind != "bucket":
            continue
        bk = job.bucket_key()
        if bk not in buckets:
            buckets[bk] = _Bucket(bk)
        buckets[bk].add(job)
    return buckets


def _run_bucket_sequential(bucket: _Bucket, out_dir: str, write: bool,
                           specific_fanout: bool, cause: str) -> None:
    """Degraded path: every job of a failed bucket through the
    sequential runner. One job failing does not sink its bucket-mates;
    it records ``job.error`` and leaves ``job.result`` None."""
    import traceback
    for job in bucket.jobs:
        if job.result is not None:
            continue
        try:
            job.result = runner.run_scenario(
                job.scenario, out_dir=out_dir, force=True,
                seed=job.seeds[0], write=write, n_seeds=len(job.seeds),
                specific_fanout=specific_fanout, device=job.traced.device)
        except Exception:
            job.error = (f"bucket degraded ({cause}); sequential retry "
                         f"failed:\n{traceback.format_exc(limit=8)}")


def execute_buckets(buckets: Sequence[_Bucket],
                    out_dir: str = runner.DEFAULT_OUT_DIR, *,
                    write: bool = True, specific_fanout: bool = True,
                    window: int = 2, on_drained=None,
                    degrade_sequential: bool = False) -> int:
    """Dispatch + drain a planned bucket sequence, ``window`` buckets in
    flight before the oldest drains. Shared by run_campaign and
    serve.codesign.CodesignService.

    ``on_drained(bucket)`` fires after each bucket's jobs carry their
    results. With ``degrade_sequential`` a bucket whose call (or drain)
    raises falls back to per-scenario sequential runs instead of
    sinking the run; returns the number of buckets degraded.
    """
    degraded = 0
    inflight: List[_Bucket] = []

    def _drain(bucket: _Bucket) -> None:
        nonlocal degraded
        try:
            bucket.drain(out_dir, write, specific_fanout)
        except Exception as e:
            if not degrade_sequential:
                raise
            _run_bucket_sequential(bucket, out_dir, write,
                                   specific_fanout, repr(e))
            degraded += 1
        if on_drained is not None:
            on_drained(bucket)

    for bucket in buckets:
        try:
            bucket.dispatch()
        except Exception as e:
            if not degrade_sequential:
                raise
            _run_bucket_sequential(bucket, out_dir, write,
                                   specific_fanout, repr(e))
            degraded += 1
            if on_drained is not None:
                on_drained(bucket)
            continue
        inflight.append(bucket)
        while len(inflight) > max(window, 1):
            _drain(inflight.pop(0))
    while inflight:
        _drain(inflight.pop(0))
    return degraded


# ---------------------------------------------------------------------------
# the kernel-build cache
# ---------------------------------------------------------------------------

_INDEX_NAME = "campaign_index.json"


def enable_persistent_cache(cache_dir: str) -> str:
    """Point the CUDA kernels' build directory (``kernels/build.py``)
    at ``cache_dir`` (created if missing): a library built there is
    loaded from there by every later process given the same directory,
    with no ``nvcc``. Returns the path of the campaign's
    bucket-signature index inside it."""
    os.makedirs(cache_dir, exist_ok=True)
    build.set_build_dir(cache_dir)
    return os.path.join(cache_dir, _INDEX_NAME)


def _cache_entries(cache_dir: Optional[str]) -> int:
    """Kernel libraries in the cache directory."""
    if not cache_dir or not os.path.isdir(cache_dir):
        return 0
    return sum(1 for n in os.listdir(cache_dir) if n.endswith(".so"))


def _load_index(path: str) -> Dict:
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)
        except (OSError, ValueError):
            pass
    return {}


# ---------------------------------------------------------------------------
# the campaign loop
# ---------------------------------------------------------------------------


def run_campaign(scenarios: Sequence[Scenario],
                 out_dir: str = runner.DEFAULT_OUT_DIR,
                 force: bool = False, seed: Optional[int] = None,
                 n_seeds: Optional[int] = None, write: bool = True,
                 compile_cache: Optional[str] = None,
                 window: int = 2,
                 specific_fanout: bool = True,
                 device="cuda") -> Tuple[List[Dict], Dict]:
    """Execute a scenario set through the campaign engine on
    ``device``.

    Returns (results in input order, campaign stats). ``window`` is
    the pipelining depth. ``compile_cache`` keeps the kernel libraries
    in that directory (``enable_persistent_cache``). Stats are written
    to ``<out_dir>/campaign_stats.json`` when ``write``.
    """
    dev = resolve_device(device)
    t_start = time.perf_counter()
    index_path = None
    if compile_cache:
        index_path = enable_persistent_cache(compile_cache)
    entries_before = _cache_entries(compile_cache)
    kstats0 = kernel_cache_stats()

    jobs = plan_campaign(scenarios, out_dir=out_dir, force=force,
                         seed=seed, n_seeds=n_seeds, write=write,
                         device=dev)
    buckets = bucket_jobs(jobs)

    index = _load_index(index_path) if index_path else {}
    sig_hits = sig_misses = 0
    for bucket in buckets.values():
        sig = bucket.signature()
        if sig in index:
            sig_hits += 1
        else:
            sig_misses += 1
        index[sig] = {"lanes": bucket.lanes_padded_to,
                      "scenarios": [j.scenario.name
                                    for j in bucket.jobs]}
    execute_buckets(buckets.values(), out_dir, write=write,
                    specific_fanout=specific_fanout, window=window)

    # host-driven schemas (random search, Table 3) run sequentially
    # after the bucketed fleet
    for job in jobs:
        if job.kind == "fallback":
            job.result = runner.run_scenario(
                job.scenario, out_dir=out_dir, force=force, seed=seed,
                write=write, n_seeds=n_seeds,
                specific_fanout=specific_fanout, device=dev)

    if index_path:
        with open(index_path, "w") as f:
            json.dump(index, f, indent=1, sort_keys=True)

    kstats1 = kernel_cache_stats()
    wall = time.perf_counter() - t_start
    n_executed = sum(1 for j in jobs if j.kind != "cached")
    stats = {
        "n_scenarios": len(jobs),
        "n_cached": sum(1 for j in jobs if j.kind == "cached"),
        "n_fallback": sum(1 for j in jobs if j.kind == "fallback"),
        "n_bucketed": sum(1 for j in jobs if j.kind == "bucket"),
        "n_buckets": len(buckets),
        "lanes_total": sum(b.n_lanes for b in buckets.values()),
        "lanes_padded": sum(b.lanes_padded_to - b.n_lanes
                            for b in buckets.values()),
        "wall_time_s": wall,
        "scenarios_per_sec": (n_executed / wall if wall > 0
                              else float("inf")),
        "kernel_cache": {
            k: kstats1[k] - kstats0.get(k, 0)
            for k in ("hits", "misses", "evictions")},
        "persistent_cache": {
            "enabled": bool(compile_cache),
            "dir": compile_cache,
            "entries_before": entries_before,
            "entries_after": _cache_entries(compile_cache),
            "signature_hits": sig_hits,
            "signature_misses": sig_misses,
        },
        "buckets": [
            {"signature": b.signature(),
             "engine": b.key[0],
             "gen_tier": b.tier,
             "lanes": b.n_lanes,
             "lanes_padded_to": b.lanes_padded_to,
             "scenarios": [j.scenario.name for j in b.jobs],
             "dispatch_s": b.dispatch_s,
             "drain_s": b.drain_s}
            for b in buckets.values()],
    }
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "campaign_stats.json"),
                  "w") as f:
            json.dump(stats, f, indent=1, sort_keys=True, default=float)
    return [j.result for j in jobs], stats
