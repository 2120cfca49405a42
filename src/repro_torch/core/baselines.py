"""Baseline optimizers of the algorithm-selection study (paper §III-C1,
Table 3): PSO, (µ+λ)-ES, SRES, CMA-ES and G3PCX on the real-coded
relaxation of the discrete genome (index -> (i + 0.5) / cardinality,
decoded by floor); counterpart of ``repro/core/baselines.py``.

Every algorithm is a pair of closures (``init``, ``step``) bundled as a
:class:`BaselineOps`. As in ``core/genetic.py``, the reference's
``lax.scan`` over the iterations is a Python loop (``baseline_scan``)
and its ``vmap`` over seeds is a leading lane dimension: keys are
(L, 2), every state tensor carries a leading L, and a lane scorer maps
(L, P, n) genomes to (L, P) scores, so one scoring call serves every
lane. ``run_baseline_loop`` keeps the reference's host-driven loop over
one search (a best-score sync per iteration), the equivalence oracle of
the lane route.

Arithmetic follows what XLA compiles on the CPU, found by experiment
against the JAX functions and their optimized HLO: the multiply-adds it
contracts into fused multiply-adds (``_fma``), the factor sqrt(2) of a
normal draw folded into the constant or operand it multiplies
(``_erfinv_draws``), its Cephes ``exp`` (``_xla_exp``), norms and small
matrix-vector products accumulated in index order by fused
multiply-adds (``_fma_sum``), and correctly rounded square roots.
The Cholesky factor and two matrix products of CMA-ES are library calls
whose summation order is not XLA's, and the normal draw itself is
within a few ULP of JAX's (ROADMAP Queue 3): those states agree to a
stated tolerance (tests/test_torch_baselines.py) and the decoded
genomes stay equal.

SRES's ``stochastic_rank`` is a bubble sort of n (n - 1) data-dependent
comparisons. It runs on the host, over every lane, after one
device-to-host copy of (objective, penalty, coin flips) per call: as
eager device ops it would be thousands of launches an iteration.

Scorer contract: ``score_fn`` maps (L, P, n) int64 genomes to (L, P)
float32 scores (lower is better, ``INFEASIBLE_PENALTY`` for infeasible
designs). SRES also takes a penalty channel ``penalty_fn``, which maps
the same genomes to (scores, penalties >= 0, 0 = feasible) from one
cost-model pass (the reference gets that sharing from XLA merging its
two passes); without one, the penalty is the scorer's infeasibility
marker.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import random as jr
from ..random import _fma
from .genetic import _lane_pick, _to_index, cards_of, lanes_of
from .objectives import INFEASIBLE_PENALTY
from .search_space import SearchSpace
from .tracing import traced_closure

BASELINE_ALGORITHMS = ("pso", "es", "sres", "cmaes", "g3pcx")

State = Dict[str, torch.Tensor]


class BaselineOps(NamedTuple):
    """One baseline algorithm over a lane batch.

    ``init``: keys (L, 2) -> state (a dict of (L, ...) tensors; the
    initial population is scored, so ``best`` is meaningful at once);
    ``step``: (keys, state) -> state, one iteration; ``best``: state ->
    (x_real (L, n), score (L,)), the best design so far in real coding.
    ``evals_init``/``evals_per_iter`` are the analytic evaluation counts
    of one search (Table 3's budget column).
    """
    init: Callable
    step: Callable
    best: Callable
    evals_init: int
    evals_per_iter: int


class BaselineResult(NamedTuple):
    best_genome: np.ndarray
    best_score: float
    evaluations: int
    wall_time_s: float
    history: Optional[np.ndarray] = None   # (iters+1,) best-so-far


class MultiBaselineResult(NamedTuple):
    """S independent baseline searches run as one lane batch; Table 3's
    hit-rate statistics come straight off the leading axis."""
    best_genomes: np.ndarray     # (S, n_params)
    best_scores: np.ndarray      # (S,)
    histories: np.ndarray        # (S, iters+1)
    evaluations: int             # per search
    wall_time_s: float           # whole batch

    @property
    def n_seeds(self) -> int:
        return int(self.best_scores.shape[0])

    def seed_result(self, i: int) -> BaselineResult:
        return BaselineResult(best_genome=self.best_genomes[i],
                              best_score=float(self.best_scores[i]),
                              evaluations=self.evaluations,
                              wall_time_s=self.wall_time_s,
                              history=self.histories[i])

    def best(self) -> BaselineResult:
        return self.seed_result(int(np.argmin(self.best_scores)))


def _lane_penalty(penalty_fn: Optional[Callable]) -> Optional[Callable]:
    """A (N, n) -> ((N,) scores, (N,) penalties) channel applied to every
    lane at once."""
    if penalty_fn is None:
        return None

    def lane_fn(genomes: torch.Tensor):
        L, P, n = genomes.shape
        s, phi = penalty_fn(genomes.reshape(L * P, n))
        return s.reshape(L, P), phi.reshape(L, P)
    return lane_fn


def _real_scorer(score_fn: Callable, cards: torch.Tensor) -> Callable:
    @traced_closure
    def score(x: torch.Tensor) -> torch.Tensor:
        return score_fn(_to_index(x, cards))
    return score


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(L, 1) lane indices of a state tensor, for per-lane row picks."""
    return torch.arange(x.shape[0], device=x.device)[:, None]


def _where(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """``jnp.where`` of a per-lane condition (L,) over (L, ...) tensors."""
    return torch.where(c.reshape(c.shape + (1,) * (a.dim() - 1)), a, b)


def _fma_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum(a * b)`` over the last axis as XLA computes a short
    reduction or matrix-vector product on the CPU: in index order, each
    step a fused multiply-add."""
    a, b = torch.broadcast_tensors(a.double(), b.double())
    acc = torch.zeros(a.shape[:-1], dtype=torch.float32, device=a.device)
    for i in range(a.shape[-1]):
        acc = _fma(a[..., i], b[..., i], acc)
    return acc


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and CUDA's are;
    PyTorch's float32 CPU kernel misses the nearest float on a fraction
    of a percent of inputs."""
    return torch.sqrt(x.double()).float()


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis, as XLA computes it."""
    return _sqrt(_fma_sum(x, x))


def _f32_div(a: float, b: float) -> float:
    """A float32 quotient of two constants, as XLA folds it."""
    return float(np.float32(a) / np.float32(b))


# XLA's float32 exp on the CPU (Cephes' polynomial, its steps fused
# multiply-adds): n = floor(x log2(e) + 1/2), x - n ln 2 in two parts,
# a degree-5 polynomial, times 2^n.
_EXP_HI = float(np.float32(88.3762626647950))
_LOG2E = float(np.float32(1.44269504088896341))
_EXP_C1, _EXP_C2 = float(np.float32(0.693359375)), float(np.float32(
    -2.12194440e-4))
_EXP_P = [float(np.float32(c)) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1)]


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of float32 ``x`` as XLA computes it on the CPU, bit
    for bit where neither over- nor underflows (|x| < 87); ``torch.exp``
    differs from it in the last place on about a tenth of inputs."""
    x = torch.clamp(x, -_EXP_HI, _EXP_HI)
    fx = torch.floor(_fma(x, _LOG2E, 0.5))
    r = _fma(fx, -_EXP_C2, _fma(fx, -_EXP_C1, x))
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = _fma(y, r, c)
    return (_fma(y, r * r, r) + 1.0) * torch.pow(2.0, fx)


_SQRT2 = jr._SQRT2


def _erfinv_draws(key: torch.Tensor, shape) -> torch.Tensor:
    """``jr.normal(key, shape)`` before its factor sqrt(2): XLA folds
    that constant into the product a draw feeds."""
    return jr.erf_inv(jr._uniform_of_bits(jr.random_bits(key, shape),
                                          jr._NORMAL_LO, 1.0))


# ---------------------------------------------------------------------------
# PSO
# ---------------------------------------------------------------------------

def pso_ops(cards: torch.Tensor, score_fn: Callable, n_particles: int,
            w: float = 0.7, c1: float = 1.5, c2: float = 1.5
            ) -> BaselineOps:
    """Global-best PSO with inertia ``w`` and cognitive/social pulls."""
    n = cards.shape[0]
    score = _real_scorer(score_fn, cards)
    w, c1, c2 = (float(np.float32(c)) for c in (w, c1, c2))

    @traced_closure
    def init(key: torch.Tensor) -> State:
        ks = jr.split(key)
        x = jr.uniform(ks[:, 0], (n_particles, n))
        v = (jr.uniform(ks[:, 1], (n_particles, n)) - 0.5) * 0.2
        s = score(x)
        g = torch.argmin(s, dim=1)
        return dict(x=x, v=v, pb_x=x, pb_s=s, gb_x=_lane_pick(x, g),
                    gb_s=_lane_pick(s, g))

    @traced_closure
    def step(key: torch.Tensor, st: State) -> State:
        ks = jr.split(key)
        shape = st["x"].shape[1:]
        r1 = jr.uniform(ks[:, 0], shape)
        r2 = jr.uniform(ks[:, 1], shape)
        # XLA contracts this into fma(c2 r2, gb - x, fma(w, v, c1 r1
        # (pb - x)))
        v = _fma(c2 * r2, st["gb_x"][:, None] - st["x"],
                 _fma(w, st["v"], c1 * r1 * (st["pb_x"] - st["x"])))
        x = torch.clamp(st["x"] + v, 0.0, 1.0 - 1e-6)
        s = score(x)
        imp = s < st["pb_s"]
        pb_x = torch.where(imp[..., None], x, st["pb_x"])
        pb_s = torch.where(imp, s, st["pb_s"])
        g = torch.argmin(pb_s, dim=1)
        g_s = _lane_pick(pb_s, g)
        better = g_s < st["gb_s"]
        return dict(x=x, v=v, pb_x=pb_x, pb_s=pb_s,
                    gb_x=_where(better, _lane_pick(pb_x, g), st["gb_x"]),
                    gb_s=torch.where(better, g_s, st["gb_s"]))

    @traced_closure
    def best(st: State) -> Tuple[torch.Tensor, torch.Tensor]:
        return st["gb_x"], st["gb_s"]

    return BaselineOps(init, step, best, n_particles, n_particles)


# ---------------------------------------------------------------------------
# (µ+λ)-ES and SRES
# ---------------------------------------------------------------------------

def _stochastic_rank_host(f: np.ndarray, phi: np.ndarray, coin: np.ndarray
                          ) -> np.ndarray:
    """The bubble sort of ``stochastic_rank`` on the host: f, phi (B, N)
    float32, coin (B, N, N-1) bool (objective comparison drawn) ->
    (B, N) int64 permutations. Python floats compare float32 values
    exactly."""
    B, n = f.shape
    out = np.empty((B, n), np.int64)
    for b in range(B):
        fb, pb = f[b].tolist(), phi[b].tolist()
        feas = [p <= 0.0 for p in pb]
        perm = list(range(n))
        for coins in coin[b].tolist():
            for j in range(n - 1):
                a, c = perm[j], perm[j + 1]
                if (feas[a] and feas[c]) or coins[j]:
                    swap = fb[a] > fb[c]
                else:
                    swap = pb[a] > pb[c]
                if swap:
                    perm[j], perm[j + 1] = c, a
        out[b] = perm
    return out


@traced_closure
def stochastic_rank(key: torch.Tensor, f: torch.Tensor, phi: torch.Tensor,
                    p_f: float = 0.45) -> torch.Tensor:
    """Runarsson & Yao stochastic ranking: keys (..., 2), objective ``f``
    and penalty ``phi`` (..., N) -> (..., N) int64 permutations, best
    first.

    A bubble sort over (f, phi): each adjacent comparison uses the
    objective when both designs are feasible (``phi <= 0``) or, with
    probability ``p_f``, otherwise, and the penalty for the rest; N full
    sweeps, comparison (i, j) drawing ``uniform(key, (N, N-1))[i, j]``.
    The draws are made on the tensors' device and copied to the host
    with f and phi in one transfer; the comparisons run there (exact,
    so the order is the reference's bit for bit) and the permutation is
    copied back."""
    n = f.shape[-1]
    batch = f.shape[:-1]
    if n < 2:
        return torch.zeros(f.shape, dtype=torch.int64, device=f.device)
    u = jr.uniform(key, (n, n - 1)).reshape(batch + (n * (n - 1),))
    host = torch.cat([f.float(), phi.float(), u], dim=-1).cpu().numpy()
    host = host.reshape(-1, n * (n + 1))
    coin = host[:, 2 * n:].reshape(-1, n, n - 1) < np.float32(p_f)
    perm = _stochastic_rank_host(host[:, :n], host[:, n:2 * n], coin)
    return torch.as_tensor(perm.reshape(batch + (n,)), device=f.device)


def es_ops(cards: torch.Tensor, score_fn: Callable, mu: int, lam: int,
           sigma0: float = 0.3, stochastic_ranking: bool = False,
           p_f: float = 0.45,
           penalty_fn: Optional[Callable] = None) -> BaselineOps:
    """(µ+λ)-ES with a self-adaptive step size per individual;
    ``stochastic_ranking=True`` gives SRES: survival by
    ``stochastic_rank`` over (objective, penalty) instead of a plain
    objective sort. Penalties are evaluated once per individual, on the
    fresh children, and carried through survival with the scores."""
    n = cards.shape[0]
    # tau * normal, with XLA's folding of the constants (tau sqrt 2)
    tau_s2 = float(np.float32(1.0 / np.sqrt(2.0 * n)) * np.float32(_SQRT2))

    @traced_closure
    def evaluate(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(score, penalty) of a real-coded batch, one decode."""
        genomes = _to_index(x, cards)
        if penalty_fn is not None:
            return penalty_fn(genomes)
        s = score_fn(genomes)
        return s, (s >= INFEASIBLE_PENALTY).float()

    @traced_closure
    def init(key: torch.Tensor) -> State:
        pop = jr.uniform(key, (mu, n))
        s, phi = evaluate(pop)
        b = torch.argmin(s, dim=1)
        return dict(pop=pop, sig=torch.full(s.shape, sigma0,
                                            dtype=torch.float32,
                                            device=s.device),
                    s=s, phi=phi, best_x=_lane_pick(pop, b),
                    best_s=_lane_pick(s, b))

    @traced_closure
    def step(key: torch.Tensor, st: State) -> State:
        ks = jr.split(key, 4)
        parents = jr.randint(ks[:, 0], (lam,), 0, mu).long()
        lanes = _lanes(parents)
        child_sig = st["sig"][lanes, parents] * _xla_exp(
            tau_s2 * _erfinv_draws(ks[:, 1], (lam,)))
        children = torch.clamp(
            _fma(child_sig[..., None] * _SQRT2,
                 _erfinv_draws(ks[:, 2], (lam, n)),
                 st["pop"][lanes, parents]), 0.0, 1.0 - 1e-6)
        cs, cphi = evaluate(children)
        all_x = torch.cat([st["pop"], children], dim=1)
        all_sig = torch.cat([st["sig"], child_sig], dim=1)
        all_s = torch.cat([st["s"], cs], dim=1)
        all_phi = torch.cat([st["phi"], cphi], dim=1)
        if stochastic_ranking:
            order = stochastic_rank(ks[:, 3], all_s, all_phi, p_f)
        else:
            order = torch.argsort(all_s, dim=1, stable=True)
        keep = order[:, :mu]
        b = torch.argmin(cs, dim=1)
        b_s = _lane_pick(cs, b)
        better = b_s < st["best_s"]
        return dict(pop=all_x[lanes, keep], sig=all_sig[lanes, keep],
                    s=all_s[lanes, keep], phi=all_phi[lanes, keep],
                    best_x=_where(better, _lane_pick(children, b),
                                  st["best_x"]),
                    best_s=torch.where(better, b_s, st["best_s"]))

    @traced_closure
    def best(st: State) -> Tuple[torch.Tensor, torch.Tensor]:
        return st["best_x"], st["best_s"]

    return BaselineOps(init, step, best, mu, lam)


# ---------------------------------------------------------------------------
# CMA-ES (minimal rank-µ update)
# ---------------------------------------------------------------------------

def cmaes_ops(cards: torch.Tensor, score_fn: Callable, lam: int,
              sigma0: float = 0.3) -> BaselineOps:
    """Minimal CMA-ES: rank-µ covariance update (no evolution paths),
    log-linear recombination weights, norm-based step-size control. The
    deviations ``y`` are centred on the mean before the recombination
    update, as CMA-ES defines them."""
    n = cards.shape[0]
    mu = max(1, lam // 2)
    wl = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    wts_np = (wl / wl.sum()).astype(np.float32)
    score = _real_scorer(score_fn, cards)
    inv_sqrt_n = float(np.float32(1.0) / np.float32(n ** 0.5))
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def eye_wts(dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The identity and the recombination weights on ``dev``, made
        once (no host-to-device copy a step)."""
        if dev not in consts:
            consts[dev] = (torch.eye(n, dtype=torch.float32, device=dev),
                           torch.as_tensor(wts_np, device=dev))
        return consts[dev]

    @traced_closure
    def init(key: torch.Tensor) -> State:
        L, dev = key.shape[0], key.device
        mean = torch.full((L, n), 0.5, dtype=torch.float32, device=dev)
        s0 = score(mean[:, None])[:, 0]
        eye = eye_wts(dev)[0]
        return dict(mean=mean,
                    sigma=torch.full((L,), sigma0, dtype=torch.float32,
                                     device=dev),
                    C=eye.expand(L, n, n).clone(), best_x=mean, best_s=s0)

    @traced_closure
    def step(key: torch.Tensor, st: State) -> State:
        eye, wts = eye_wts(key.device)
        # C stays a convex combination of PSD terms plus jitter, so the
        # factor exists; cholesky_ex does not sync to check it. The
        # input is symmetrized first, as jnp.linalg.cholesky does
        M = st["C"] + 1e-6 * eye
        A, _ = torch.linalg.cholesky_ex((M + M.transpose(-1, -2)) * 0.5)
        z = jr.normal(key, (lam, n))
        x = torch.clamp(_fma(st["sigma"][:, None, None],
                             z @ A.transpose(-1, -2), st["mean"][:, None]),
                        0.0, 1.0 - 1e-6)
        s = score(x)
        order = torch.argsort(s, dim=1, stable=True)
        b = order[:, 0]
        b_s = _lane_pick(s, b)
        better = b_s < st["best_s"]
        lanes = _lanes(order)
        sel = x[lanes, order[:, :mu]]
        old_mean = st["mean"]
        mean = _fma_sum(sel.transpose(-1, -2), wts)
        y = ((sel - old_mean[:, None])
             / torch.clamp(st["sigma"], min=1e-12)[:, None, None])
        C = _fma(st["C"], 0.7,
                 (y.transpose(-1, -2) * wts * 0.3) @ y)
        zn = _norm(_lane_pick(z, b))
        sigma = st["sigma"] * _xla_exp(0.1 * _fma(zn, inv_sqrt_n, -1.0))
        sigma = torch.clamp(sigma, 1e-4, 1.0)
        return dict(mean=mean, sigma=sigma, C=C,
                    best_x=_where(better, _lane_pick(x, b), st["best_x"]),
                    best_s=torch.where(better, b_s, st["best_s"]))

    @traced_closure
    def best(st: State) -> Tuple[torch.Tensor, torch.Tensor]:
        return st["best_x"], st["best_s"]

    return BaselineOps(init, step, best, 1, lam)


# ---------------------------------------------------------------------------
# G3PCX
# ---------------------------------------------------------------------------

@traced_closure
def companion_indices(key: torch.Tensor, pop_size: int, n_companions: int,
                      best: torch.Tensor) -> torch.Tensor:
    """``n_companions`` distinct population indices per key, drawn
    without replacement and never equal to ``best``: a draw over
    [0, pop_size - 1) shifted past the best index. keys (..., 2), best
    (...) -> (..., n_companions) int64."""
    idx = jr.choice(key, pop_size - 1, n_companions).long()
    return idx + (idx >= best[..., None]).long()


@traced_closure
def pcx_offspring(key: torch.Tensor, p: torch.Tensor,
                  companions: torch.Tensor, n_offspring: int,
                  sigma_zeta: float = 0.1, sigma_eta: float = 0.1
                  ) -> torch.Tensor:
    """Parent-centric crossover around the best parent ``p`` (..., n)
    with ``companions`` (..., k, n), keys (..., 2) -> (..., n_offspring,
    n): offspring = p + zeta d + D̄ z_perp, with d = p - centroid,
    zeta ~ N(0, sigma_zeta²), z_perp the part of z ~ N(0, sigma_eta² I)
    orthogonal to d, and D̄ (floored at 1e-3) the mean distance of the
    companions to the d axis.

    The operations are XLA's after its rewrites on the CPU: the centroid
    is ``(p + sum(companions)) * (1 / (k + 1))`` and ``d`` one fused
    multiply-add from it; the norms and the two projections accumulate
    in index order with fused multiply-adds; each normal draw's factor
    sqrt(2) is folded into its sigma."""
    ks = jr.split(key)
    k, n = companions.shape[-2:]
    csum = companions[..., 0, :]
    for i in range(1, k):
        csum = csum + companions[..., i, :]
    d = _fma(p + csum, -_f32_div(1.0, k + 1), p)
    d_hat = d / torch.clamp(_norm(d), min=1e-12)[..., None]
    diff = companions - p[..., None, :]
    proj = _fma_sum(diff, d_hat[..., None, :])
    perp = _fma(-proj[..., None], d_hat[..., None, :], diff)
    pn = _norm(perp)
    psum = pn[..., 0]
    for i in range(1, k):
        psum = psum + pn[..., i]
    dbar = torch.clamp(psum * _f32_div(1.0, k), min=1e-3)
    c_zeta = float(np.float32(sigma_zeta) * np.float32(np.sqrt(2.0)))
    c_eta = float(np.float32(sigma_eta) * np.float32(np.sqrt(2.0)))
    zeta = _erfinv_draws(ks[..., 0, :], (n_offspring, 1)) * c_zeta
    e = _erfinv_draws(ks[..., 1, :], (n_offspring, n))
    zp = _fma_sum(e * c_eta, d_hat[..., None, :])
    z_perp = _fma(e, c_eta, -(zp[..., None] * d_hat[..., None, :]))
    return _fma(dbar[..., None, None], z_perp,
                _fma(zeta, d[..., None, :], p[..., None, :]))


def g3pcx_ops(cards: torch.Tensor, score_fn: Callable, pop_size: int,
              n_parents: int = 3, n_offspring: int = 2,
              sigma_zeta: float = 0.1, sigma_eta: float = 0.1
              ) -> BaselineOps:
    """G3 (generalized generation gap) with parent-centric crossover:
    each iteration recombines the best parent with ``n_parents - 1``
    distinct companions (never the best itself), then 2 random
    population members compete with the offspring for their slots."""
    n = cards.shape[0]
    score = _real_scorer(score_fn, cards)

    @traced_closure
    def init(key: torch.Tensor) -> State:
        pop = jr.uniform(key, (pop_size, n))
        s = score(pop)
        b = torch.argmin(s, dim=1)
        return dict(pop=pop, s=s, best_x=_lane_pick(pop, b),
                    best_s=_lane_pick(s, b))

    @traced_closure
    def step(key: torch.Tensor, st: State) -> State:
        ks = jr.split(key, 3)
        bi = torch.argmin(st["s"], dim=1)
        comp = companion_indices(ks[:, 0], pop_size, n_parents - 1, bi)
        lanes = _lanes(comp)
        kids = torch.clamp(
            pcx_offspring(ks[:, 1], _lane_pick(st["pop"], bi),
                          st["pop"][lanes, comp], n_offspring, sigma_zeta,
                          sigma_eta), 0.0, 1.0 - 1e-6)
        k_s = score(kids)
        slots = jr.choice(ks[:, 2], pop_size, 2).long()
        pool_x = torch.cat([st["pop"][lanes, slots], kids], dim=1)
        pool_s = torch.cat([st["s"][lanes, slots], k_s], dim=1)
        order = torch.argsort(pool_s, dim=1, stable=True)[:, :2]
        pop, s = st["pop"].clone(), st["s"].clone()
        pop[lanes, slots] = pool_x[lanes, order]
        s[lanes, slots] = pool_s[lanes, order]
        b = torch.argmin(k_s, dim=1)
        b_s = _lane_pick(k_s, b)
        better = b_s < st["best_s"]
        return dict(pop=pop, s=s,
                    best_x=_where(better, _lane_pick(kids, b),
                                  st["best_x"]),
                    best_s=torch.where(better, b_s, st["best_s"]))

    @traced_closure
    def best(st: State) -> Tuple[torch.Tensor, torch.Tensor]:
        return st["best_x"], st["best_s"]

    return BaselineOps(init, step, best, pop_size, n_offspring)


# ---------------------------------------------------------------------------
# the lane engine + host-loop oracle
# ---------------------------------------------------------------------------

def make_baseline_ops(algorithm: str, cards: torch.Tensor,
                      score_fn: Callable, pop: int,
                      penalty_fn: Optional[Callable] = None,
                      **hyper) -> BaselineOps:
    """Map a (algorithm, population-scale) budget onto the algorithm's
    own sizing: PSO swarm / ES offspring / CMA-ES sample / G3PCX
    population of ``pop``. ``score_fn`` and ``penalty_fn`` are lane
    functions."""
    if algorithm == "pso":
        return pso_ops(cards, score_fn, n_particles=pop, **hyper)
    if algorithm == "es":
        mu = hyper.pop("mu", max(2, pop // 3))
        return es_ops(cards, score_fn, mu=mu, lam=pop, **hyper)
    if algorithm == "sres":
        mu = hyper.pop("mu", max(2, pop // 3))
        return es_ops(cards, score_fn, mu=mu, lam=pop,
                      stochastic_ranking=True, penalty_fn=penalty_fn,
                      **hyper)
    if algorithm == "cmaes":
        return cmaes_ops(cards, score_fn, lam=pop, **hyper)
    if algorithm == "g3pcx":
        return g3pcx_ops(cards, score_fn, pop_size=pop, **hyper)
    raise ValueError(f"unknown baseline algorithm {algorithm!r}; "
                     f"known: {BASELINE_ALGORITHMS}")


@traced_closure
def baseline_scan(key: torch.Tensor, ops: BaselineOps, iters: int,
                  active: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Init + ``iters`` steps over every lane, one loop step per
    iteration. keys (L, 2) -> (best_x_real (L, n), best_score (L,),
    history (L, iters+1) best so far).

    ``active`` is an optional (iters,) or (L, iters) bool mask: an
    inactive iteration leaves the lane's state and key untouched, so an
    iteration axis padded with trailing False entries reproduces the
    unpadded run once the history is cut back."""
    ks = jr.split(key)
    key, state = ks[:, 0], ops.init(ks[:, 1])
    L = key.shape[0]
    hist = [ops.best(state)[1]]
    for t in range(iters):
        ks = jr.split(key)
        st2 = ops.step(ks[:, 1], state)
        if active is None:
            key, state = ks[:, 0], st2
        else:
            act = active[..., t].expand(L).to(key.device)
            key = _where(act, ks[:, 0], key)
            state = {k: _where(act, st2[k], state[k]) for k in state}
        hist.append(ops.best(state)[1])
    bx, bs = ops.best(state)
    return bx, bs, torch.stack(hist, dim=1)


@traced_closure
def baseline_kernel(key: torch.Tensor, cards: torch.Tensor,
                    score_fn: Callable, *, algorithm: str, pop: int,
                    iters: int, penalty_fn: Optional[Callable] = None,
                    active: Optional[torch.Tensor] = None,
                    **hyper) -> Tuple[torch.Tensor, ...]:
    """``search_kernel``'s baseline sibling: keys (L, 2) to (best_genome
    (L, n) int64, best_score (L,), history (L, iters+1)); lane scorer
    and penalty."""
    ops = make_baseline_ops(algorithm, cards, score_fn, pop,
                            penalty_fn=penalty_fn, **hyper)
    bx, bs, hist = baseline_scan(key, ops, iters, active=active)
    return _to_index(bx, cards), bs, hist


def n_evaluations(algorithm: str, pop: int, iters: int, **hyper) -> int:
    """Analytic evaluation budget of one search (Table 3 bookkeeping)."""
    cards = torch.ones((1,), dtype=torch.float32)  # sizing only
    ops = make_baseline_ops(algorithm, cards, lambda g: None, pop, **hyper)
    return ops.evals_init + iters * ops.evals_per_iter


def run_baseline_loop(key: torch.Tensor, space: SearchSpace,
                      score_fn: Callable, algorithm: str, pop: int = 24,
                      iters: int = 40,
                      penalty_fn: Optional[Callable] = None,
                      **hyper) -> BaselineResult:
    """Reference host-driven loop over ONE search (key (2,)): the same
    init/step closures as the lane route, a best-score sync per
    iteration. ``score_fn`` maps (N, n) genomes to (N,), ``penalty_fn``
    to ((N,) scores, (N,) penalties)."""
    t0 = time.perf_counter()
    cards = cards_of(space, key.device)
    ops = make_baseline_ops(algorithm, cards, lanes_of(score_fn), pop,
                            penalty_fn=_lane_penalty(penalty_fn), **hyper)
    ks = jr.split(key[None])
    key, state = ks[:, 0], ops.init(ks[:, 1])
    hist = [float(ops.best(state)[1][0])]
    for _ in range(iters):
        ks = jr.split(key)
        key, state = ks[:, 0], ops.step(ks[:, 1], state)
        hist.append(float(ops.best(state)[1][0]))
    bx, bs = ops.best(state)
    return BaselineResult(
        best_genome=_to_index(bx, cards)[0].cpu().numpy(),
        best_score=float(bs[0]),
        evaluations=ops.evals_init + iters * ops.evals_per_iter,
        wall_time_s=time.perf_counter() - t0, history=np.asarray(hist))


def batched_baseline_search(keys: torch.Tensor, space: SearchSpace,
                            score_fn: Callable, algorithm: str,
                            pop: int = 24, iters: int = 40,
                            penalty_fn: Optional[Callable] = None,
                            **hyper) -> MultiBaselineResult:
    """S independent baseline searches, one per key (S, 2), as one lane
    batch. ``score_fn`` maps (N, n) genomes to (N,) on the keys'
    device, ``penalty_fn`` to ((N,) scores, (N,) penalties)."""
    t0 = time.perf_counter()
    best_g, best_s, hists = baseline_kernel(
        keys, cards_of(space, keys.device), lanes_of(score_fn),
        algorithm=algorithm, pop=pop, iters=iters,
        penalty_fn=_lane_penalty(penalty_fn), **hyper)
    return MultiBaselineResult(
        best_genomes=best_g.cpu().numpy(), best_scores=best_s.cpu().numpy(),
        histories=hists.cpu().numpy(),
        evaluations=n_evaluations(algorithm, pop, iters, **hyper),
        wall_time_s=time.perf_counter() - t0)


def baseline_search(key: torch.Tensor, space: SearchSpace,
                    score_fn: Callable, algorithm: str, pop: int = 24,
                    iters: int = 40, use_scan: bool = True,
                    penalty_fn: Optional[Callable] = None,
                    **hyper) -> BaselineResult:
    """One baseline search (key (2,)): a one-lane batch by default,
    the host-driven reference loop with ``use_scan=False``."""
    if not use_scan:
        return run_baseline_loop(key, space, score_fn, algorithm, pop=pop,
                                 iters=iters, penalty_fn=penalty_fn,
                                 **hyper)
    return batched_baseline_search(
        key[None], space, score_fn, algorithm, pop=pop, iters=iters,
        penalty_fn=penalty_fn, **hyper).seed_result(0)


# ---------------------------------------------------------------------------
# per-algorithm entry points (Table 3 call sites)
# ---------------------------------------------------------------------------

def pso_search(key, space: SearchSpace, score_fn: Callable,
               n_particles: int = 24, iters: int = 40, w: float = 0.7,
               c1: float = 1.5, c2: float = 1.5,
               use_scan: bool = True) -> BaselineResult:
    return baseline_search(key, space, score_fn, "pso", pop=n_particles,
                           iters=iters, use_scan=use_scan, w=w, c1=c1,
                           c2=c2)


def es_search(key, space: SearchSpace, score_fn: Callable, mu: int = 8,
              lam: int = 24, iters: int = 40, sigma0: float = 0.3,
              stochastic_ranking: bool = False, p_f: float = 0.45,
              penalty_fn: Optional[Callable] = None,
              use_scan: bool = True) -> BaselineResult:
    """(µ+λ)-ES; ``stochastic_ranking=True`` gives SRES."""
    if stochastic_ranking:
        return baseline_search(key, space, score_fn, "sres", pop=lam,
                               iters=iters, use_scan=use_scan, mu=mu,
                               sigma0=sigma0, p_f=p_f,
                               penalty_fn=penalty_fn)
    return baseline_search(key, space, score_fn, "es", pop=lam,
                           iters=iters, use_scan=use_scan, mu=mu,
                           sigma0=sigma0)


def cmaes_search(key, space: SearchSpace, score_fn: Callable,
                 lam: int = 24, iters: int = 40, sigma0: float = 0.3,
                 use_scan: bool = True) -> BaselineResult:
    return baseline_search(key, space, score_fn, "cmaes", pop=lam,
                           iters=iters, use_scan=use_scan, sigma0=sigma0)


def g3pcx_search(key, space: SearchSpace, score_fn: Callable,
                 pop_size: int = 24, iters: int = 40, n_parents: int = 3,
                 n_offspring: int = 2,
                 use_scan: bool = True) -> BaselineResult:
    return baseline_search(key, space, score_fn, "g3pcx", pop=pop_size,
                           iters=iters, use_scan=use_scan,
                           n_parents=n_parents, n_offspring=n_offspring)
