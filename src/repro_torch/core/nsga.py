"""NSGA-II multi-objective search (§IV-I's EDAP × cost front searched
directly); counterpart of ``repro/core/nsga.py``.

  * **fast non-dominated sorting** — Deb's dominance counts, then rank
    peeling: each step assigns the current zero-dominator front and
    subtracts its dominance contributions. Above
    ``DOMINANCE_TILE_THRESHOLD`` the dominance matrix is built in
    row blocks (``dominance_matrix_tiled``); ranks are bit-identical
    either way;
  * **crowding distance** — per objective, a (rank, value) sort puts
    every front contiguous; the front's boundary designs get +inf,
    interior ones the normalized gap to their sorted neighbours;
  * **binary tournament by (rank, crowding)** and **environmental
    selection** of the best P of parents + children by (rank asc,
    crowding desc).

As in ``core/genetic.py``, the reference's ``lax.scan`` over the phase
schedule is a Python loop over its rows (``nsga_scan``) and its ``vmap``
over independent searches is a leading lane dimension: keys (L, 2),
populations (L, P, n), score matrices (L, P, D). A lane score function
maps (L, P, n) genomes to (L, P, D). The reference's ``lax.while_loop``
rank peeling is a Python loop that reads the lanes' unranked count.
``jnp.lexsort((a, b))`` is a stable sort by ``a`` followed by a stable
sort by ``b``. The crossover, mutation and sampling are the GA's
(``genetic._sbx``, ``_poly_mutate``, ``sampling.sample_initial_device``).

``run_nsga_loop`` keeps the reference's host-driven loop over one
search, the equivalence oracle of the lane route.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import random as jr
from . import sampling
from .genetic import (FOUR_PHASES, Phase, _poly_mutate, _sbx, _to_index,
                      _to_real, cards_of, lane_schedule, lanes_of,
                      phase_schedule, row_params)
from .pareto import pareto_front
from .search_space import SearchSpace

LaneScoreVec = Callable[[torch.Tensor], torch.Tensor]


# ---------------------------------------------------------------------------
# fast non-dominated sorting + crowding
# ---------------------------------------------------------------------------

def dominance_matrix(scores: torch.Tensor) -> torch.Tensor:
    """(..., N, D) minimize-all scores -> (..., N, N) bool: [i, j] is
    True iff design i dominates design j (i <= j everywhere, i < j
    somewhere). Duplicates do not dominate each other, as in
    ``pareto.pareto_front``."""
    a, b = scores[..., :, None, :], scores[..., None, :, :]
    return torch.all(a <= b, dim=-1) & torch.any(a < b, dim=-1)


# Row-block size of the tiled dominance build, and the population size
# from which nondominated_rank switches to it (the reference's values).
DOMINANCE_TILE = 256
DOMINANCE_TILE_THRESHOLD = 512


def dominance_matrix_tiled(scores: torch.Tensor,
                           tile: int = DOMINANCE_TILE) -> torch.Tensor:
    """``dominance_matrix`` built in blocks of ``tile`` rows, each block
    compared against all N columns: the float working set is
    O(tile·N·D) instead of O(N²·D). The comparisons are exact, so the
    result is bit-identical."""
    n = scores.shape[-2]
    if n <= tile:
        return dominance_matrix(scores)
    rows = []
    for lo in range(0, n, tile):
        a = scores[..., lo:lo + tile, None, :]
        b = scores[..., None, :, :]
        rows.append(torch.all(a <= b, dim=-1) & torch.any(a < b, dim=-1))
    return torch.cat(rows, dim=-2)


def nondominated_rank(scores: torch.Tensor,
                      tile: Optional[int] = None) -> torch.Tensor:
    """(..., N, D) scores -> (..., N) int32 non-domination ranks
    (0 = front), by Deb's counting sort with rank peeling.

    ``tile=None`` builds the dominance matrix tiled from
    DOMINANCE_TILE_THRESHOLD designs, broadcast below it; ``tile=0``
    forces the broadcast, a block size forces tiling."""
    n = scores.shape[-2]
    if tile is None:
        tile = DOMINANCE_TILE if n >= DOMINANCE_TILE_THRESHOLD else 0
    dom = (dominance_matrix_tiled(scores, tile) if tile
           else dominance_matrix(scores))
    counts = dom.sum(dim=-2)
    ranks = torch.full(counts.shape, -1, dtype=torch.int32,
                       device=scores.device)
    r = 0
    # terminates in at most N steps: a finite strict partial order
    # always has a non-dominated element
    while bool(torch.any(ranks < 0)):
        front = (ranks < 0) & (counts == 0)
        ranks = torch.where(front, torch.full_like(ranks, r), ranks)
        dec = (front[..., :, None] & dom).sum(dim=-2)
        # assigned members drop to -1 so they never re-enter the front
        counts = torch.where(front, torch.full_like(counts, -1),
                             counts - dec)
        r += 1
    return ranks


def _lexsort2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((a, b))`` along the last axis: by ``b``, ties by
    ``a``, ties in index order."""
    o1 = torch.argsort(a, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(b, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def crowding_distance(scores: torch.Tensor,
                      ranks: torch.Tensor) -> torch.Tensor:
    """(..., N, D) scores + (..., N) ranks -> (..., N) crowding
    distances: per front and objective, sorted by value, the boundary
    designs get +inf and the interior ones
    ``(next - prev) / where(span > 0, span, 1)``, summed over the
    objectives in index order."""
    n, d = scores.shape[-2:]
    total = torch.zeros(scores.shape[:-1], dtype=scores.dtype,
                        device=scores.device)
    ones = torch.ones(scores.shape[:-2] + (1,), dtype=torch.bool,
                      device=scores.device)
    for j in range(d):
        f = scores[..., j]
        order = _lexsort2(f, ranks)               # rank, then value
        f_s = torch.gather(f, -1, order)
        r_s = torch.gather(ranks, -1, order)
        change = r_s[..., 1:] != r_s[..., :-1]
        first = torch.cat([ones, change], dim=-1)
        last = torch.cat([change, ones], dim=-1)
        # front id of each sorted position; values ascend inside a
        # front, so its min and max are its first and last entries
        seg = torch.cumsum(first.long(), dim=-1) - 1
        fmin = torch.zeros_like(f_s).scatter_reduce(
            -1, seg, f_s, "amin", include_self=False)
        fmax = torch.zeros_like(f_s).scatter_reduce(
            -1, seg, f_s, "amax", include_self=False)
        span = torch.gather(fmax - fmin, -1, seg)
        prev = torch.cat([f_s[..., :1], f_s[..., :-1]], dim=-1)
        nxt = torch.cat([f_s[..., 1:], f_s[..., -1:]], dim=-1)
        gap = (nxt - prev) / torch.where(span > 0, span,
                                         torch.ones_like(span))
        contrib = torch.where(first | last,
                              torch.full_like(gap, float("inf")), gap)
        # every design gets exactly one contribution per objective
        total = total + torch.zeros_like(total).scatter(-1, order, contrib)
    return total


def crowded_order(ranks: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (rank asc, crowding desc), NSGA-II's total
    preference order."""
    return _lexsort2(-crowd, ranks)


def tournament_select(key: torch.Tensor, ranks: torch.Tensor,
                      crowd: torch.Tensor, n_winners: int) -> torch.Tensor:
    """Binary tournament by (rank, crowding): keys (L, 2), ranks and
    crowd (L, N) -> (L, n_winners) indices."""
    n = ranks.shape[-1]
    idx = jr.randint(key, (2, n_winners), 0, n).long()
    a, b = idx[:, 0], idx[:, 1]
    ra, rb = torch.gather(ranks, 1, a), torch.gather(ranks, 1, b)
    ca, cb = torch.gather(crowd, 1, a), torch.gather(crowd, 1, b)
    a_wins = (ra < rb) | ((ra == rb) & (ca > cb))
    return torch.where(a_wins, a, b)


# ---------------------------------------------------------------------------
# the NSGA-II generation and the scheduled search
# ---------------------------------------------------------------------------

def _nsga_generation(key: torch.Tensor, pop: torch.Tensor,
                     scores: torch.Tensor, cards: torch.Tensor,
                     pc: torch.Tensor, eta_c: torch.Tensor,
                     pm: torch.Tensor, eta_m: torch.Tensor,
                     score_vec: LaneScoreVec
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One NSGA-II generation per lane: tournament by (rank, crowding),
    SBX + polynomial mutation, then (mu + lambda) environmental
    selection over parents + children. keys (L, 2), pop (L, P, n),
    scores (L, P, D); only the P children are scored."""
    P = pop.shape[1]
    ranks = nondominated_rank(scores)
    crowd = crowding_distance(scores, ranks)
    ks = jr.split(key, 3)
    n_pairs = (P + 1) // 2
    winners = tournament_select(ks[:, 0], ranks, crowd, 2 * n_pairs)
    parents = _to_real(sampling.take_rows(pop, winners), cards)
    x1, x2 = parents[:, :n_pairs], parents[:, n_pairs:]
    c1, c2 = _sbx(ks[:, 1], x1, x2, pc, eta_c)
    children = torch.cat([c1, c2], dim=1)[:, :P]
    children = _to_index(
        _poly_mutate(ks[:, 2], children, pm, eta_m, cards), cards)
    comb = torch.cat([pop, children], dim=1)
    comb_scores = torch.cat([scores, score_vec(children)], dim=1)
    r2 = nondominated_rank(comb_scores)
    c2d = crowding_distance(comb_scores, r2)
    sel = crowded_order(r2, c2d)[:, :P]
    return sampling.take_rows(comb, sel), sampling.take_rows(comb_scores, sel)


def _final_order(pop, scores):
    ranks = nondominated_rank(scores)
    order = crowded_order(ranks, crowding_distance(scores, ranks))
    return (sampling.take_rows(pop, order), sampling.take_rows(scores, order),
            torch.gather(ranks, 1, order))


def nsga_scan(key: torch.Tensor, init_pop: torch.Tensor, cards: torch.Tensor,
              schedule: torch.Tensor, score_vec: LaneScoreVec,
              active: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, ...]:
    """The multi-phase NSGA-II over every lane, one loop step per
    schedule row. Returns (pop (L, P, n), scores (L, P, D), ranks
    (L, P)), sorted by (rank, crowding desc), and the (L, T+1, D)
    best-so-far ideal point (per-objective minimum over everything
    evaluated). ``schedule`` is (T, 4) or (L, T, 4), one a lane.

    ``active`` is an optional (T,) or (L, T) bool mask: a row with
    ``active == False`` leaves the lane's carry untouched."""
    L = init_pop.shape[0]
    scores = score_vec(init_pop)
    ideal0 = scores.amin(dim=1)
    pop, ideal = init_pop, ideal0
    hist = []
    schedule = lane_schedule(schedule)
    for t in range(schedule.shape[-2]):
        params = row_params(schedule, t)
        ks = jr.split(key)
        pop2, scores2 = _nsga_generation(ks[:, 1], pop, scores, cards,
                                         params[0], params[1], params[2],
                                         params[3], score_vec)
        key2 = ks[:, 0]
        ideal2 = torch.minimum(ideal, scores2.amin(dim=1))
        if active is None:
            key, pop, scores, ideal = key2, pop2, scores2, ideal2
        else:
            act = active[..., t].expand(L).to(pop.device)
            key = torch.where(act[:, None], key2, key)
            pop = torch.where(act[:, None, None], pop2, pop)
            scores = torch.where(act[:, None, None], scores2, scores)
            ideal = torch.where(act[:, None], ideal2, ideal)
        hist.append(ideal)
    pop, scores, ranks = _final_order(pop, scores)
    return pop, scores, ranks, torch.stack([ideal0] + hist, dim=1)


def nsga_search_kernel(key: torch.Tensor, cards: torch.Tensor,
                       schedule: torch.Tensor, score_vec: LaneScoreVec,
                       feasible_fn: Optional[Callable] = None, *,
                       p_h: int, p_e: int, p_ga: int,
                       hamming_sampling: bool = True, oversample: int = 4,
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Algorithm 1 with a multi-objective tail for every lane: the GA's
    capacity-masked Hamming sampling, whose P_E pool seeds the NSGA-II
    population by (rank, crowding). keys (L, 2); ``score_vec`` maps
    (L, P, n) genomes to (L, P, D), ``feasible_fn`` to (L, P)."""
    ks = jr.split(key)
    key, k_s = ks[:, 0], ks[:, 1]
    if hamming_sampling:
        pool = sampling.sample_initial_device(k_s, cards, p_h, p_e,
                                              feasible_fn=feasible_fn,
                                              oversample=oversample)
        s = score_vec(pool)
        r = nondominated_rank(s)
        c = crowding_distance(s, r)
        init = sampling.take_rows(pool, crowded_order(r, c)[:, :p_ga])
    elif feasible_fn is None:
        init = sampling.uniform_genomes(k_s, cards, p_ga)
    else:
        pool = sampling.sample_initial_device(k_s, cards, p_h, p_ga,
                                              feasible_fn=feasible_fn,
                                              oversample=oversample)
        init = pool[:, :p_ga]
    return nsga_scan(key, init, cards, schedule, score_vec, active=active)


# ---------------------------------------------------------------------------
# host-facing results + entry points
# ---------------------------------------------------------------------------

class MOSearchResult(NamedTuple):
    """One NSGA-II search on the host, sorted by (rank, crowding desc):
    the searched front is the ``ranks == 0`` prefix. ``history`` is the
    (T+1, D) ideal-point trajectory."""
    population: np.ndarray       # (P, n_params)
    scores: np.ndarray           # (P, D)
    ranks: np.ndarray            # (P,)
    history: np.ndarray          # (T+1, D)
    wall_time_s: float

    def front(self) -> Tuple[np.ndarray, np.ndarray]:
        """(genomes, scores) of the rank-0 (non-dominated) designs."""
        m = self.ranks == 0
        return self.population[m], self.scores[m]


class MultiMOSearchResult(NamedTuple):
    """S independent NSGA-II searches run as one lane batch."""
    populations: np.ndarray      # (S, P, n_params)
    scores: np.ndarray           # (S, P, D)
    ranks: np.ndarray            # (S, P)
    histories: np.ndarray        # (S, T+1, D)
    wall_time_s: float

    @property
    def n_seeds(self) -> int:
        return int(self.populations.shape[0])

    def seed_result(self, i: int) -> MOSearchResult:
        return MOSearchResult(population=self.populations[i],
                              scores=self.scores[i], ranks=self.ranks[i],
                              history=self.histories[i],
                              wall_time_s=self.wall_time_s)

    def union_front(self) -> Tuple[np.ndarray, np.ndarray]:
        """Global searched front: every seed's rank-0 designs pooled,
        deduplicated and re-filtered to the non-dominated subset, which
        equals, as a set of points, the front of all final-population
        candidates."""
        genomes = self.populations.reshape(-1, self.populations.shape[-1])
        scores = self.scores.reshape(-1, self.scores.shape[-1])
        mask = self.ranks.reshape(-1) == 0
        genomes, scores = genomes[mask], scores[mask]
        uniq, j = np.unique(genomes, axis=0, return_index=True)
        scores = scores[j]
        idx = pareto_front(scores)
        return uniq[idx], scores[idx]


def lanes_of_vec(fn: Callable[[torch.Tensor], torch.Tensor]) -> LaneScoreVec:
    """A (N, n) -> (N, D) function applied to every lane at once."""
    def lane_fn(genomes: torch.Tensor) -> torch.Tensor:
        L, P, n = genomes.shape
        out = fn(genomes.reshape(L * P, n))
        return out.reshape(L, P, out.shape[-1])
    return lane_fn


def run_nsga_loop(key: torch.Tensor, space: SearchSpace,
                  score_vec: Callable[[torch.Tensor], torch.Tensor],
                  init_pop: torch.Tensor, phases: Sequence[Phase],
                  generations_per_phase: int) -> MOSearchResult:
    """The reference's host-driven loop over one search: a (2,) key,
    (P, n) initial population, ``score_vec`` (N, n) -> (N, D), the ideal
    point kept on the host. The oracle of ``nsga_scan``."""
    t0 = time.perf_counter()
    dev = key.device
    cards = cards_of(space, dev)
    schedule = torch.as_tensor(phase_schedule(phases, generations_per_phase),
                               device=dev)
    vec = lanes_of_vec(score_vec)
    key, pop = key[None], init_pop[None]
    scores = vec(pop)
    ideal = scores[0].amin(dim=0).cpu().numpy()
    hist = [ideal]
    for row in schedule:
        ks = jr.split(key)
        key, k = ks[:, 0], ks[:, 1]
        pop, scores = _nsga_generation(k, pop, scores, cards, row[0], row[1],
                                       row[2], row[3], vec)
        ideal = np.minimum(ideal, scores[0].amin(dim=0).cpu().numpy())
        hist.append(ideal)
    pop, scores, ranks = _final_order(pop, scores)
    return MOSearchResult(population=pop[0].cpu().numpy(),
                          scores=scores[0].cpu().numpy(),
                          ranks=ranks[0].cpu().numpy(),
                          history=np.stack(hist),
                          wall_time_s=time.perf_counter() - t0)


def batched_nsga_search(keys: torch.Tensor, space: SearchSpace,
                        score_vec: Callable[[torch.Tensor], torch.Tensor],
                        p_h: int = 1000, p_e: int = 500, p_ga: int = 40,
                        generations_per_phase: int = 10,
                        phases: Sequence[Phase] = FOUR_PHASES,
                        feasible_fn: Optional[Callable] = None,
                        hamming_sampling: bool = True,
                        oversample: int = 4) -> MultiMOSearchResult:
    """S independent NSGA-II searches, one per key (S, 2), as one lane
    batch. ``score_vec`` maps (N, n) genomes to (N, D) scores and
    ``feasible_fn`` to (N,) bools, on the keys' device."""
    t0 = time.perf_counter()
    dev = keys.device
    cards = cards_of(space, dev)
    schedule = torch.as_tensor(phase_schedule(phases, generations_per_phase),
                               device=dev)
    feas = lanes_of(feasible_fn) if feasible_fn is not None else None
    pops, scores, ranks, hists = nsga_search_kernel(
        keys, cards, schedule, lanes_of_vec(score_vec), feas, p_h=p_h,
        p_e=p_e, p_ga=p_ga, hamming_sampling=hamming_sampling,
        oversample=oversample)
    return MultiMOSearchResult(
        populations=pops.cpu().numpy(), scores=scores.cpu().numpy(),
        ranks=ranks.cpu().numpy(), histories=hists.cpu().numpy(),
        wall_time_s=time.perf_counter() - t0)


def nsga_search(key: torch.Tensor, space: SearchSpace,
                score_vec: Callable[[torch.Tensor], torch.Tensor],
                p_h: int = 1000, p_e: int = 500, p_ga: int = 40,
                generations_per_phase: int = 10,
                phases: Sequence[Phase] = FOUR_PHASES,
                feasible_fn: Optional[Callable] = None,
                hamming_sampling: bool = True) -> MOSearchResult:
    """One NSGA-II search (a single-lane batch)."""
    return batched_nsga_search(
        key[None], space, score_vec, p_h=p_h, p_e=p_e, p_ga=p_ga,
        generations_per_phase=generations_per_phase, phases=phases,
        feasible_fn=feasible_fn,
        hamming_sampling=hamming_sampling).seed_result(0)
