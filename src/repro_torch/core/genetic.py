"""Four-phase genetic algorithm with optimized sampling (paper §III-C2);
counterpart of ``repro/core/genetic.py``.

Operators: simulated binary crossover (SBX) + polynomial mutation on a
real-coded relaxation of the discrete genome (index -> (idx + 0.5) /
cardinality, decoded by floor). Phase schedule = Table 4.

The reference folds a search into one ``lax.scan`` and batches
independent searches with ``vmap``. Here a search is a Python loop over
the schedule's rows (``ga_scan``) and the batch is a leading "lane"
dimension written out: keys are (L, 2), populations (L, P, n), and a
lane scorer maps (L, P, n) genomes to (L, P) scores, so one scoring
call serves every lane (one kernel launch per generation for the whole
batch). Every sort is stable, as ``jnp.argsort`` is, and every draw is
the reference's (``repro_torch/random.py``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as jr
from . import sampling
from .search_space import SearchSpace
from .tracing import traced_closure


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    pc: float      # crossover probability
    eta_c: float   # crossover distribution index
    pm: float      # mutation probability (per gene)
    eta_m: float   # mutation distribution index


# Paper Table 4.
FOUR_PHASES: Tuple[Phase, ...] = (
    Phase("exploration", 1.0, 3.0, 1.0, 3.0),
    Phase("transition", 0.9, 7.0, 0.5, 7.0),
    Phase("convergence", 1.0, 15.0, 0.2, 15.0),
    Phase("fine-tuning", 1.0, 25.0, 0.05, 25.0),
)
# Traditional non-modified GA [44]: one phase, stock parameters.
PLAIN_PHASE = Phase("plain", 0.9, 15.0, 0.1, 20.0)

N_ELITE = 2

LaneScore = Callable[[torch.Tensor], torch.Tensor]


def phase_schedule(phases: Sequence[Phase],
                   generations_per_phase: int) -> np.ndarray:
    """One (pc, eta_c, pm, eta_m) float32 row per generation."""
    rows = [[p.pc, p.eta_c, p.pm, p.eta_m]
            for p in phases for _ in range(generations_per_phase)]
    return np.asarray(rows, np.float32)


@traced_closure
def _to_real(pop: torch.Tensor, cards: torch.Tensor) -> torch.Tensor:
    return (pop.float() + 0.5) / cards


@traced_closure
def _to_index(x: torch.Tensor, cards: torch.Tensor) -> torch.Tensor:
    return torch.floor(torch.clamp(x, 0.0, 1.0 - 1e-6) * cards).long()


@traced_closure
def _sbx(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
         pc: torch.Tensor, eta: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Simulated binary crossover per lane: keys (L, 2), parents
    (L, n_pairs, n)."""
    ks = jr.split(key, 3)
    shape = x1.shape[1:]
    u = jr.uniform(ks[:, 0], shape)
    e = torch.reciprocal(eta + 1.0)
    beta = torch.where(
        u <= 0.5,
        torch.pow(2.0 * u, e),
        torch.pow(torch.reciprocal(2.0 * (1.0 - u)), e),
    )
    c1 = 0.5 * ((1 + beta) * x1 + (1 - beta) * x2)
    c2 = 0.5 * ((1 - beta) * x1 + (1 + beta) * x2)
    do_pair = jr.bernoulli(ks[:, 1], pc, (shape[0], 1))
    do_gene = jr.bernoulli(ks[:, 2], 0.5, shape)
    m = do_pair & do_gene
    return torch.where(m, c1, x1), torch.where(m, c2, x2)


@traced_closure
def _poly_mutate(key: torch.Tensor, x: torch.Tensor, pm: torch.Tensor,
                 eta: torch.Tensor,
                 cards: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Polynomial mutation; with ``cards``, a selected gene moves at
    least one discrete index step."""
    ks = jr.split(key)
    u = jr.uniform(ks[:, 0], x.shape[1:])
    e = torch.reciprocal(eta + 1.0)
    delta = torch.where(
        u < 0.5,
        torch.pow(2.0 * u, e) - 1.0,
        1.0 - torch.pow(2.0 * (1.0 - u), e),
    )
    if cards is not None:
        step = torch.reciprocal(cards)[None, :]
        delta = torch.where(delta < 0.0, torch.minimum(delta, -step),
                            torch.maximum(delta, step))
    mask = jr.bernoulli(ks[:, 1], pm, x.shape[1:])
    return torch.clamp(x + torch.where(mask, delta, torch.zeros_like(delta)),
                       0.0, 1.0 - 1e-6)


@traced_closure
def _generation_step(key: torch.Tensor, pop: torch.Tensor,
                     scores: torch.Tensor, cards: torch.Tensor,
                     pc: torch.Tensor, eta_c: torch.Tensor,
                     pm: torch.Tensor, eta_m: torch.Tensor) -> torch.Tensor:
    """One GA generation per lane: sort, tournament-select, SBX,
    mutate, elitism. keys (L, 2), pop (L, P, n), scores (L, P)."""
    P = pop.shape[1]
    order = torch.argsort(scores, dim=1, stable=True)
    pop_sorted = sampling.take_rows(pop, order)

    ks = jr.split(key, 3)
    n_child = P - N_ELITE
    n_pairs = (n_child + 1) // 2
    # binary tournament on ranks (pop_sorted is rank-ordered)
    idx = jr.randint(ks[:, 0], (2, 2 * n_pairs), 0, P).long()
    winners = torch.minimum(idx[:, 0], idx[:, 1])
    parents = _to_real(sampling.take_rows(pop_sorted, winners), cards)
    x1, x2 = parents[:, :n_pairs], parents[:, n_pairs:]
    c1, c2 = _sbx(ks[:, 1], x1, x2, pc, eta_c)
    children = torch.cat([c1, c2], dim=1)[:, :n_child]
    children = _poly_mutate(ks[:, 2], children, pm, eta_m, cards)
    return torch.cat([pop_sorted[:, :N_ELITE], _to_index(children, cards)],
                     dim=1)


def _lane_pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x (L, P, ...) at index i[l] of each lane -> (L, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), i]


def lane_schedule(schedule: torch.Tensor) -> torch.Tensor:
    """A (T, 4) schedule shared by every lane, or an (L, T, 4) one per
    lane; per-lane rows that all agree collapse to one (T, 4), so a batch
    of equal schedules runs exactly as the shared schedule does (one
    device-to-host read)."""
    if schedule.dim() == 3 and torch.equal(
            schedule, schedule[:1].expand_as(schedule)):
        return schedule[0]
    return schedule


def row_params(schedule: torch.Tensor, t: int) -> Tuple[torch.Tensor, ...]:
    """Row ``t`` of a ``lane_schedule``: (pc, eta_c, pm, eta_m) as 0-dim
    tensors, or as (L, 1, 1) tensors of per-lane values."""
    if schedule.dim() == 2:
        p = schedule[t]
    else:
        p = schedule[:, t, :, None, None].transpose(0, 1)
    return p[0], p[1], p[2], p[3]


@traced_closure
def ga_scan(key: torch.Tensor, init_pop: torch.Tensor, cards: torch.Tensor,
            schedule: torch.Tensor, score_fn: LaneScore,
            active: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, ...]:
    """The multi-phase GA over every lane, one loop step per schedule
    row. Returns (best_genome (L, n), best_score (L,), history (L, T+1),
    pop_sorted (L, P, n), scores_sorted (L, P)). ``schedule`` is (T, 4)
    or (L, T, 4), one schedule a lane.

    ``active`` is an optional (T,) or (L, T) bool mask: a row with
    ``active == False`` leaves the lane's population, best and key
    untouched, so a schedule padded past its length reproduces the
    unpadded run."""
    L = init_pop.shape[0]
    dev = init_pop.device
    pop = init_pop
    best_g = init_pop[:, 0]
    best_s = torch.full((L,), float("inf"), dtype=torch.float32, device=dev)
    hist: List[torch.Tensor] = []
    schedule = lane_schedule(schedule)
    for t in range(schedule.shape[-2]):
        params = row_params(schedule, t)
        scores = score_fn(pop)
        i = torch.argmin(scores, dim=1)
        s = _lane_pick(scores, i)
        better = s < best_s
        best_s2 = torch.where(better, s, best_s)
        best_g2 = torch.where(better[:, None], _lane_pick(pop, i), best_g)
        ks = jr.split(key)
        pop2 = _generation_step(ks[:, 1], pop, scores, cards, params[0],
                                params[1], params[2], params[3])
        key2 = ks[:, 0]
        if active is None:
            key, pop, best_g, best_s = key2, pop2, best_g2, best_s2
        else:
            act = active[..., t].expand(L).to(dev)
            key = torch.where(act[:, None], key2, key)
            pop = torch.where(act[:, None, None], pop2, pop)
            best_g = torch.where(act[:, None], best_g2, best_g)
            best_s = torch.where(act, best_s2, best_s)
        hist.append(best_s)
    scores = score_fn(pop)
    order = torch.argsort(scores, dim=1, stable=True)
    pop = sampling.take_rows(pop, order)
    scores = torch.gather(scores, 1, order)
    better = scores[:, 0] < best_s
    best_s = torch.where(better, scores[:, 0], best_s)
    best_g = torch.where(better[:, None], pop[:, 0], best_g)
    hist.append(best_s)
    return best_g, best_s, torch.stack(hist, dim=1), pop, scores


@traced_closure
def search_kernel(key: torch.Tensor, cards: torch.Tensor,
                  schedule: torch.Tensor, score_fn: LaneScore,
                  feasible_fn: Optional[Callable] = None, *,
                  p_h: int, p_e: int, p_ga: int,
                  hamming_sampling: bool = True, oversample: int = 4,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, ...]:
    """Algorithm 1 for every lane: capacity-masked Hamming sampling,
    then the scheduled GA. keys (L, 2), ``schedule`` (T, 4) or
    (L, T, 4); ``score_fn``/``feasible_fn`` map (L, P, n) genomes to
    (L, P)."""
    ks = jr.split(key)
    key, k_s = ks[:, 0], ks[:, 1]
    if hamming_sampling:
        c2 = sampling.sample_initial_device(k_s, cards, p_h, p_e,
                                            feasible_fn=feasible_fn,
                                            oversample=oversample)
        scores = score_fn(c2)
        order = torch.argsort(scores, dim=1, stable=True)[:, :p_ga]
        init = sampling.take_rows(c2, order)
    elif feasible_fn is None:
        init = sampling.uniform_genomes(k_s, cards, p_ga)
    else:
        pool = sampling.sample_initial_device(k_s, cards, p_h, p_ga,
                                              feasible_fn=feasible_fn,
                                              oversample=oversample)
        init = pool[:, :p_ga]
    return ga_scan(key, init, cards, schedule, score_fn, active=active)


class SearchResult(NamedTuple):
    best_genome: np.ndarray
    best_score: float
    history: np.ndarray          # (total_generations,) best-so-far score
    population: np.ndarray       # final population (sorted by score)
    scores: np.ndarray           # final population scores (sorted)
    wall_time_s: float
    sampling_time_s: float


class MultiSearchResult(NamedTuple):
    """S independent searches run as one lane batch; every array has a
    leading seed axis."""
    best_genomes: np.ndarray     # (S, n_params)
    best_scores: np.ndarray      # (S,)
    histories: np.ndarray        # (S, T+1)
    populations: np.ndarray      # (S, P, n_params), sorted per seed
    scores: np.ndarray           # (S, P), sorted per seed
    wall_time_s: float
    sampling_time_s: float

    def seed_result(self, i: int) -> SearchResult:
        return SearchResult(
            best_genome=self.best_genomes[i],
            best_score=float(self.best_scores[i]),
            history=self.histories[i],
            population=self.populations[i], scores=self.scores[i],
            wall_time_s=self.wall_time_s,
            sampling_time_s=self.sampling_time_s)


def lanes_of(fn: Callable[[torch.Tensor], torch.Tensor]) -> LaneScore:
    """A (N, n) -> (N,) function applied to every lane at once."""
    def lane_fn(genomes: torch.Tensor) -> torch.Tensor:
        L, P, n = genomes.shape
        return fn(genomes.reshape(L * P, n)).reshape(L, P)
    return lane_fn


def cards_of(space: SearchSpace, device) -> torch.Tensor:
    return torch.as_tensor(space.cardinalities.astype(np.float32),
                           device=device)


def run_ga_loop(key: torch.Tensor, space: SearchSpace,
                score_fn: Callable[[torch.Tensor], torch.Tensor],
                init_pop: torch.Tensor, phases: Sequence[Phase],
                generations_per_phase: int) -> SearchResult:
    """The reference's host-driven GA loop for one search (key (2,),
    init_pop (P, n)): a best-score read on the host and a key split
    every generation. The equivalence oracle of ``ga_scan``."""
    t0 = time.perf_counter()
    dev = init_pop.device
    cards = cards_of(space, dev)
    pop = init_pop
    best_g, best_s = None, np.inf
    hist: List[float] = []
    for phase in phases:
        params = [torch.tensor(v, dtype=torch.float32, device=dev)
                  for v in (phase.pc, phase.eta_c, phase.pm, phase.eta_m)]
        for _ in range(generations_per_phase):
            scores = score_fn(pop)
            i = int(torch.argmin(scores))
            s = float(scores[i])
            if s < best_s:
                best_s, best_g = s, pop[i].cpu().numpy()
            hist.append(best_s)
            ks = jr.split(key)
            key = ks[0]
            pop = _generation_step(ks[1][None], pop[None], scores[None],
                                   cards, *params)[0]
    scores = score_fn(pop).cpu().numpy()
    order = np.argsort(scores, kind="stable")
    i = order[0]
    if scores[i] < best_s:
        best_s, best_g = float(scores[i]), pop[i].cpu().numpy()
    hist.append(best_s)
    return SearchResult(best_genome=best_g, best_score=best_s,
                        history=np.asarray(hist),
                        population=pop.cpu().numpy()[order],
                        scores=scores[order],
                        wall_time_s=time.perf_counter() - t0,
                        sampling_time_s=0.0)


def run_ga(key: torch.Tensor, space: SearchSpace,
           score_fn: Callable[[torch.Tensor], torch.Tensor],
           init_pop: torch.Tensor, phases: Sequence[Phase],
           generations_per_phase: int,
           use_scan: bool = True) -> SearchResult:
    """The (multi-phase) GA for one search from an initial population
    (P, n): ``ga_scan`` as a one-lane batch, or with ``use_scan=False``
    the host-driven ``run_ga_loop``."""
    if not use_scan:
        return run_ga_loop(key, space, score_fn, init_pop, phases,
                           generations_per_phase)
    t0 = time.perf_counter()
    dev = init_pop.device
    schedule = torch.as_tensor(phase_schedule(phases, generations_per_phase),
                               device=dev)
    best_g, best_s, hist, pop, scores = ga_scan(
        key[None], init_pop[None], cards_of(space, dev), schedule,
        lanes_of(score_fn))
    return SearchResult(
        best_genome=best_g[0].cpu().numpy(),
        best_score=float(best_s[0]), history=hist[0].cpu().numpy(),
        population=pop[0].cpu().numpy(), scores=scores[0].cpu().numpy(),
        wall_time_s=time.perf_counter() - t0, sampling_time_s=0.0)


def batched_joint_search(keys: torch.Tensor, space: SearchSpace,
                         score_fn: Callable[[torch.Tensor], torch.Tensor],
                         p_h: int = 1000, p_e: int = 500, p_ga: int = 40,
                         generations_per_phase: int = 10,
                         phases: Sequence[Phase] = FOUR_PHASES,
                         feasible_fn: Optional[Callable] = None,
                         hamming_sampling: bool = True,
                         oversample: int = 4) -> MultiSearchResult:
    """Algorithm 1, one search per key (S, 2), all as one lane batch.
    ``score_fn`` maps (N, n) genomes to (N,) scores and ``feasible_fn``
    to (N,) bools, on the keys' device."""
    t0 = time.perf_counter()
    dev = keys.device
    cards = cards_of(space, dev)
    schedule = torch.as_tensor(phase_schedule(phases, generations_per_phase),
                               device=dev)
    feas = lanes_of(feasible_fn) if feasible_fn is not None else None
    best_g, best_s, hist, pops, scores = search_kernel(
        keys, cards, schedule, lanes_of(score_fn), feas, p_h=p_h, p_e=p_e,
        p_ga=p_ga, hamming_sampling=hamming_sampling, oversample=oversample)
    return MultiSearchResult(
        best_genomes=best_g.cpu().numpy(), best_scores=best_s.cpu().numpy(),
        histories=hist.cpu().numpy(), populations=pops.cpu().numpy(),
        scores=scores.cpu().numpy(),
        wall_time_s=time.perf_counter() - t0, sampling_time_s=0.0)


def joint_search(key: torch.Tensor, space: SearchSpace,
                 score_fn: Callable[[torch.Tensor], torch.Tensor],
                 p_h: int = 1000, p_e: int = 500, p_ga: int = 40,
                 generations_per_phase: int = 10,
                 phases: Sequence[Phase] = FOUR_PHASES,
                 capacity_filter: Optional[Callable] = None,
                 hamming_sampling: bool = True,
                 feasible_fn: Optional[Callable] = None) -> SearchResult:
    """Algorithm 1 for one seed (key (2,)): optimized sampling + the
    four-phase GA. Without ``capacity_filter`` it is a one-lane batch
    (the capacity constraint, if any, as the device-side
    ``feasible_fn``); with a host-side ``capacity_filter`` ((N, n)
    genomes -> (N,) bools) sampling keeps the reference's host rejection
    loop (``sampling.sample_initial``) and the GA runs from its
    population. ``hamming_sampling=False`` is the 'non-modified GA with
    enhanced sampling' ablation (random init of size p_ga)."""
    if capacity_filter is None:
        return batched_joint_search(
            key[None], space, score_fn, p_h=p_h, p_e=p_e, p_ga=p_ga,
            generations_per_phase=generations_per_phase, phases=phases,
            feasible_fn=feasible_fn,
            hamming_sampling=hamming_sampling).seed_result(0)
    t0 = time.perf_counter()
    dev = key.device
    cards = cards_of(space, dev)
    ks = jr.split(key)
    key, k_s = ks[0], ks[1]
    if hamming_sampling:
        c2 = sampling.sample_initial(k_s, cards, p_h, p_e, capacity_filter)
        order = torch.argsort(score_fn(c2), stable=True)
        init = c2[order[:p_ga]]
    else:
        init = sampling.sample_initial(k_s, cards, p_h, p_ga,
                                       capacity_filter)
    t_sample = time.perf_counter() - t0
    res = run_ga(key, space, score_fn, init, phases, generations_per_phase)
    return res._replace(sampling_time_s=t_sample,
                        wall_time_s=res.wall_time_s + t_sample)


def plain_ga_search(key: torch.Tensor, space: SearchSpace,
                    score_fn: Callable[[torch.Tensor], torch.Tensor],
                    p_ga: int = 40, total_generations: int = 40,
                    capacity_filter: Optional[Callable] = None,
                    feasible_fn: Optional[Callable] = None) -> SearchResult:
    """Traditional non-modified GA [44]: random init, single phase, for
    total_generations (= 4 phases * G for an equal budget). With a
    host-side ``capacity_filter`` the initial pool comes from the
    reference's host rejection loop (``joint_search``)."""
    return joint_search(key, space, score_fn, p_h=max(4 * p_ga, 200),
                        p_e=p_ga, p_ga=p_ga,
                        generations_per_phase=total_generations,
                        phases=(PLAIN_PHASE,),
                        capacity_filter=capacity_filter,
                        feasible_fn=feasible_fn, hamming_sampling=False)


def random_search(key: torch.Tensor, space: SearchSpace,
                  score_fn: Callable[[torch.Tensor], torch.Tensor],
                  n_evals: int = 684, batch: int = 200,
                  capacity_filter=None) -> SearchResult:
    """Random-search baseline: evaluate ``n_evals`` uniform genomes in
    batches; infeasible designs score +inf. History is best-so-far per
    batch."""
    t0 = time.perf_counter()
    cards = cards_of(space, key.device)
    best_g, best_s = None, np.inf
    hist: List[float] = []
    pop = scores = None
    remaining = n_evals
    while remaining > 0:
        n = min(batch, remaining)
        remaining -= n
        ks = jr.split(key)
        key, k = ks[0], ks[1]
        g = sampling.uniform_genomes(k[None], cards, n)[0]
        s = score_fn(g).cpu().numpy()
        if capacity_filter is not None:
            s = np.where(capacity_filter(g).cpu().numpy(), s, np.inf)
        i = int(np.argmin(s))
        if s[i] < best_s:
            best_s, best_g = float(s[i]), g[i].cpu().numpy()
        hist.append(best_s)
        pop, scores = g.cpu().numpy(), s
    if best_g is None:  # every sample infeasible: still return a genome
        i = int(np.argmin(scores))
        best_g, best_s = pop[i], float(scores[i])
    order = np.argsort(scores)
    return SearchResult(best_genome=best_g, best_score=best_s,
                        history=np.asarray(hist),
                        population=pop[order], scores=scores[order],
                        wall_time_s=time.perf_counter() - t0,
                        sampling_time_s=0.0)
