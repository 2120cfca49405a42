"""Hamming-distance-based initial sampling (paper §III-C2, Eqs. 1-2);
counterpart of ``repro/core/sampling.py`` (its device path).

  1. sample P_H candidate genomes (RRAM: capacity-masked, feasible
     candidates first);
  2. greedily select the P_E most mutually distant candidates under
     Hamming distance (max-min greedy, seeded with the first);
  3. the caller scores them and keeps the best P_GA.

The device functions work on a leading batch of independent searches
("lanes", the reference's ``vmap`` axis): keys are (L, 2), genomes
(L, P, n). ``sample_initial`` keeps the reference's host rejection loop
for one search with a host-side capacity filter. Draws match the
reference bit for bit (``random.py``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import random as jr
from .tracing import traced_closure

# Tries of sample_initial's rejection loop (the reference's max_tries).
SAMPLE_TRIES = 20


@traced_closure
def uniform_genomes(key: torch.Tensor, cards: torch.Tensor, n: int
                    ) -> torch.Tensor:
    """(L, 2) keys, (n_params,) float32 cardinalities -> (L, n,
    n_params) int64 uniform value indices."""
    u = jr.uniform(key, (n, cards.shape[0]))
    return torch.floor(u * cards.float()).long()


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (L, P, ...) rows picked per lane by idx (L, Q) -> (L, Q, ...)."""
    lanes = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lanes, idx]


@traced_closure
def hamming_select(candidates: torch.Tensor, n_select: int,
                   n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy max-min Hamming-distance subset selection per lane.

    candidates (L, P_H, n) -> (L, n_select, n). ``n_valid`` (L,)
    restricts each lane's selection to its candidate prefix
    ``[0, n_valid)``; entries past it count as taken and reappear only
    as duplicates of the seed once the valid ones are exhausted. Ties
    go to the lowest index, as ``jnp.argmax``'s do."""
    L, P_H, _ = candidates.shape
    n_select = min(n_select, P_H)
    lanes = torch.arange(L, device=candidates.device)

    def dist_to(idx):
        return torch.sum(candidates != candidates[lanes, idx][:, None, :],
                         dim=2)

    selected = torch.zeros((L, n_select), dtype=torch.int64,
                           device=candidates.device)
    d_min = dist_to(torch.zeros_like(lanes))
    taken = torch.zeros((L, P_H), dtype=torch.bool,
                        device=candidates.device)
    taken[:, 0] = True
    if n_valid is not None:
        pos = torch.arange(P_H, device=candidates.device)
        taken = taken | (pos[None, :] >= n_valid[:, None])
    # a device-side True: a Python scalar put through advanced indexing
    # is a host-to-device copy (a host sync) every iteration
    true = torch.ones((), dtype=torch.bool, device=candidates.device)
    for i in range(1, n_select):
        masked = torch.where(taken, torch.full_like(d_min, -1), d_min)
        nxt = torch.argmax(masked, dim=1)
        selected[:, i] = nxt
        d_min = torch.minimum(d_min, dist_to(nxt))
        taken[lanes, nxt] = true
    return take_rows(candidates, selected)


@traced_closure
def sample_initial_device(key: torch.Tensor, cards: torch.Tensor, p_h: int,
                          p_e: int, feasible_fn: Optional[Callable] = None,
                          oversample: int = 4) -> torch.Tensor:
    """P_H uniform genomes -> P_E Hamming-diverse genomes per lane.

    With ``feasible_fn`` ((L, N, n) -> (L, N) bool) an oversampled pool
    is sorted feasible-first (stable: draw order kept) and selection is
    confined to the feasible prefix; short lanes pad with duplicates of
    the seed rather than with infeasible designs."""
    if feasible_fn is None:
        return hamming_select(uniform_genomes(key, cards, p_h), p_e)
    pool = uniform_genomes(key, cards, p_h * oversample)
    ok = feasible_fn(pool)
    order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
    cands = take_rows(pool, order[:, :p_h])
    n_valid = torch.clamp(ok.sum(dim=1), max=p_h)
    return hamming_select(cands, p_e, n_valid=n_valid)


def sample_initial(key: torch.Tensor, cards: torch.Tensor, p_h: int,
                   p_e: int, capacity_filter: Callable) -> torch.Tensor:
    """P_H uniform capacity-filtered genomes -> P_E Hamming-diverse
    genomes for one search: key (2,) -> (P_E, n).

    ``capacity_filter`` maps (N, n) genomes to (N,) numpy bools on the
    host: the reference's rejection loop draws P_H genomes a try, keeps
    the feasible ones and stops once P_H are kept or after
    ``SAMPLE_TRIES`` tries."""
    pool, total = [], 0
    for _ in range(SAMPLE_TRIES):
        ks = jr.split(key)
        key, k = ks[0], ks[1]
        g = uniform_genomes(k[None], cards, p_h)[0]
        keep = torch.as_tensor(np.asarray(capacity_filter(g)),
                               device=g.device)
        pool.append(g[keep])
        total += pool[-1].shape[0]
        if total >= p_h:
            break
    cands = torch.cat(pool)
    if cands.shape[0] < 2:
        raise RuntimeError(
            "capacity filter rejected (almost) all sampled designs — the "
            "largest workload does not fit anywhere in this space")
    return hamming_select(cands[None, :p_h], p_e)[0]
