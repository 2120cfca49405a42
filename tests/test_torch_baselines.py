"""Parity of the port's Table 3 baseline optimizers
(repro_torch/core/baselines.py) and of the draws they need
(repro_torch/random.py ``permutation`` / ``choice``) with the JAX
reference, on shared inputs.

Bitwise: ``permutation`` and ``choice(replace=False)``, the stochastic
ranking (at p_f 0, 0.45 and 1, with ties and mixed feasibility),
``companion_indices``, XLA's CPU ``exp`` and ``norm`` as the port
computes them, the penalty channel of the full-space study, and every
state of PSO.
To a stated tolerance, because a few operations are not XLA's bit for
bit: ``normal`` is within 3 ULP of JAX's on about 1% of draws (its
``log1p``, ROADMAP Queue 3), which reaches ES, SRES, PCX and CMA-ES;
CMA-ES's Cholesky factor and matrix products are library calls with
their own summation order; and PCX's projection of its noise draw at 9
parameters sums in an order the port does not reproduce. Every decoded
genome is held equal.

The step tests score with a function whose float32 values are exact
integers on both sides, so every comparison of scores sees the same
bits and only the algorithms' arithmetic is under test. The port's own
routes (lane batch, host loop, single seeds, padded schedules) are held
to each other bit for bit.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import get_space as jget_space
from repro.core import get_workload_set as jget_workload_set
from repro.core import pack as jpack
from repro.core import reduced_rram_space as jreduced_rram_space
from repro.core.objectives import Objective as JObjective
from repro.core.scoring import ScorerSpec as JScorerSpec
from repro.core.scoring import build_scorer as jbuild_scorer
from repro.experiments import runner as jrunner
from repro.experiments.scenarios import Budget as JBudget
from repro_torch import random as jr
from repro_torch.core import baselines as tb
from repro_torch.core.genetic import _to_index, cards_of, lanes_of
from repro_torch.core.objectives import Objective
from repro_torch.core.scoring import ScorerSpec, build_scorer
from repro_torch.core.search_space import get_space, reduced_rram_space
from repro_torch.core.workloads import get_workload_set, pack
from repro_torch.experiments import runner

torch.set_num_threads(1)

ALGS = ("pso", "es", "sres", "cmaes", "g3pcx")
PAPER_4 = ("resnet18", "alexnet", "vgg16", "mobilenetv3")
# XLA compiles the many small shuffles of the permutation sweep fastest
# without its backend optimizations; integer sorts give the same bits
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _tk(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# permutation / choice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo", range(1, 301, 50))
def test_permutation_matches_reference(lo):
    """``permutation(key, n)`` bitwise for n in [lo, lo + 50) and 20
    keys, the keys batched on the port's side (vmap on JAX's)."""
    ns = range(lo, lo + 50)
    keys = jax.random.split(jax.random.PRNGKey(lo), 20)
    want = jax.jit(lambda ks: [jax.vmap(
        lambda k: jax.random.permutation(k, n))(ks) for n in ns],
        compiler_options=FAST_COMPILE)(keys)
    for n, w in zip(ns, want):
        got = jr.permutation(_tk(keys), n)
        assert got.dtype == torch.int32 and got.shape == (20, n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(w),
                                      err_msg=f"n={n}")


def test_permutation_two_rounds_and_choice():
    """n = 1700 and 5000 need two shuffle rounds; ``choice(replace=
    False)`` is the permutation's head, at the baselines' sizes
    (companions of 24 and 8, G3 slots) and beyond, batched keys too."""
    key = jax.random.PRNGKey(3)
    for n in (1700, 5000):
        np.testing.assert_array_equal(
            jr.permutation(_tk(key), n).numpy(),
            np.asarray(jax.random.permutation(key, n)))
    keys = jax.random.split(jax.random.PRNGKey(7), 12)
    for n, k in ((23, 2), (24, 2), (7, 2), (8, 2), (1, 1), (300, 17),
                 (5, 5)):
        want = jax.vmap(lambda kk: jax.random.choice(
            kk, n, (k,), replace=False))(keys)
        got = jr.choice(_tk(keys), n, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            jr.choice(_tk(keys[0]), n, k).numpy(), np.asarray(want[0]))
    with pytest.raises(ValueError):
        jr.choice(_tk(key), 3, 4)


# ---------------------------------------------------------------------------
# stochastic ranking, companions, PCX
# ---------------------------------------------------------------------------

def _rank_inputs(seed, n, L):
    """Objectives and penalties on small integer grids (many ties),
    each lane mixing feasible (phi = 0) and infeasible designs; one lane
    all feasible, one all infeasible."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 6, (L, n)).astype(np.float32)
    phi = rng.integers(0, 4, (L, n)).astype(np.float32) * 0.25
    phi[rng.random((L, n)) < 0.4] = 0.0
    phi[0] = 0.0
    if L > 1:
        phi[1] = np.maximum(phi[1], 0.5)
    return f, phi


@pytest.mark.parametrize("p_f", [0.0, 0.45, 1.0])
def test_stochastic_rank_matches_reference(p_f):
    for n in (2, 5, 32):
        f, phi = _rank_inputs(n, n, 6)
        keys = jax.random.split(jax.random.PRNGKey(n), 6)
        want = jax.jit(jax.vmap(functools.partial(
            jb.stochastic_rank, p_f=p_f)))(keys, jnp.asarray(f),
                                           jnp.asarray(phi))
        got = tb.stochastic_rank(_tk(keys), _t(f), _t(phi), p_f)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"n={n}")
        # one key, unbatched
        np.testing.assert_array_equal(
            tb.stochastic_rank(_tk(keys[2]), _t(f[2]), _t(phi[2]),
                               p_f).numpy(), np.asarray(want[2]))
    # all-feasible: a stable objective sort for any p_f
    np.testing.assert_array_equal(
        tb.stochastic_rank(_tk(keys[0]), _t(f[0]), _t(np.zeros_like(f[0])),
                           p_f).numpy(), np.argsort(f[0], kind="stable"))


def test_companion_indices_bitwise():
    keys = jax.random.split(jax.random.PRNGKey(11), 16)
    for pop, k in ((24, 2), (8, 2), (24, 5), (3, 2)):
        best = np.arange(16) % pop
        want = jax.vmap(lambda kk, b: jb.companion_indices(kk, pop, k, b))(
            keys, jnp.asarray(best))
        got = tb.companion_indices(_tk(keys), pop, k, _t(best))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not np.any(got.numpy() == best[:, None])


@pytest.mark.parametrize("n", [4, 9])
def test_pcx_offspring_matches_reference(n):
    """Offspring within atol 1e-6 (8 float32 steps at 1; the normal's
    ULPs and, at 9 parameters, the projection's order) and, at the
    reduced space's 4 parameters, bitwise on at least 97% of them."""
    rng = np.random.default_rng(n)
    L = 64
    p = rng.uniform(0, 1, (L, n)).astype(np.float32)
    comp = rng.uniform(0, 1, (L, 2, n)).astype(np.float32)
    comp[::4, 0] = p[::4] + rng.normal(0, 1e-4, (L // 4, n)).astype(
        np.float32)  # a companion near the parent: small perpendicular part
    comp[1::8] = p[1::8, None]  # collapsed onto the parent: D̄ floored
    keys = jax.random.split(jax.random.PRNGKey(n), L)
    want = np.asarray(jax.jit(jax.vmap(
        lambda k, a, c: jb.pcx_offspring(k, a, c, 2)))(
        keys, jnp.asarray(p), jnp.asarray(comp)))
    got = tb.pcx_offspring(_tk(keys), _t(p), _t(comp), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if n == 4:
        assert np.mean(got == want) >= 0.97, np.mean(got == want)


def test_xla_exp_and_norm_bitwise():
    """The port's copies of XLA's CPU ``exp`` (over [-87, 87], where no
    result underflows or overflows) and ``norm`` (index-order fused
    multiply-adds, correctly rounded square root), bit for bit."""
    x = np.concatenate([np.linspace(-87, 87, 400_001),
                        np.linspace(-3, 3, 400_001)]).astype(np.float32)
    np.testing.assert_array_equal(tb._xla_exp(_t(x)).numpy(),
                                  np.asarray(jax.jit(jnp.exp)(x)))
    for n in (1, 4, 9):
        v = np.random.default_rng(n).standard_normal((5000, n)).astype(
            np.float32)
        np.testing.assert_array_equal(
            tb._norm(_t(v)).numpy(),
            np.asarray(jax.jit(lambda a: jnp.linalg.norm(a, axis=1))(v)))


# ---------------------------------------------------------------------------
# init + steps of the five algorithms
# ---------------------------------------------------------------------------

CARDS = {4: jreduced_rram_space().cardinalities.astype(np.float32),
         9: jget_space("rram").cardinalities.astype(np.float32)}


def _exact_scorers(n):
    """Integer-valued float32 scores (exact on both sides; many ties),
    with about a fifth of the designs marked infeasible so SRES ranks
    with a live penalty channel."""
    w = np.arange(1, n + 1, dtype=np.float32) * 7

    def jscore(g):
        s = jnp.sum((g.astype(jnp.float32) - 1.0) ** 2 * w, axis=1)
        return jnp.where(jnp.sum(g, axis=1) % 5 == 0, jb.INFEASIBLE_PENALTY,
                         s)

    def tscore(g):
        s = ((g.float() - 1.0) ** 2 * torch.from_numpy(w)).sum(dim=-1)
        return torch.where(g.sum(dim=-1) % 5 == 0,
                           torch.full_like(s, jb.INFEASIBLE_PENALTY), s)
    return jscore, tscore


# Fields held bitwise per algorithm; the rest within RTOL (and, for
# CMA-ES's covariance, within CMA_ATOL of its largest entry).
BITWISE = {"pso": {"x", "v", "pb_x", "pb_s", "gb_x", "gb_s"},
           "es": {"s", "phi", "best_s"}, "sres": {"s", "phi", "best_s"},
           "cmaes": {"best_s"}, "g3pcx": {"s", "best_s"}}
RTOL = 2e-5
CMA_ATOL = 2e-5


@pytest.mark.parametrize("n", [4, 9])
@pytest.mark.parametrize("alg", ALGS)
def test_init_and_steps_match_reference(alg, n):
    """``init`` and 6 ``step``s of each algorithm on 8 seeds, each step
    fed the reference's state (so differences do not compound): the
    fields of BITWISE bit for bit, the others within RTOL, and the
    decoded best design and population equal."""
    jscore, tscore = _exact_scorers(n)
    cards = CARDS[n]
    jops = jb.make_baseline_ops(alg, jnp.asarray(cards), jscore, 24)
    tops = tb.make_baseline_ops(alg, _t(cards), lanes_of(tscore), 24)
    jinit, jstep = jax.jit(jops.init), jax.jit(jops.step)
    bitwise_steps = total = 0

    def check(jst, tst, what):
        nonlocal bitwise_steps
        same = True
        for k in jst:
            a, b = np.asarray(jst[k]), tst[k][0].numpy()
            if k in BITWISE[alg]:
                np.testing.assert_array_equal(b, a, err_msg=f"{what} {k}")
                continue
            same &= bool(np.array_equal(a, b))
            if k == "C":
                np.testing.assert_allclose(
                    b, a, rtol=0, atol=CMA_ATOL * np.abs(a).max(),
                    err_msg=f"{what} C")
            else:
                np.testing.assert_allclose(b, a, rtol=RTOL,
                                           err_msg=f"{what} {k}")
        for k in ("pop", "x"):
            if k in jst:
                np.testing.assert_array_equal(
                    _to_index(tst[k][0], _t(cards)).numpy(),
                    np.asarray(jb._to_index(jst[k], jnp.asarray(cards))),
                    err_msg=f"{what} decoded {k}")
        np.testing.assert_array_equal(
            _to_index(tops.best(tst)[0], _t(cards))[0].numpy(),
            np.asarray(jb._to_index(jops.best(jst)[0][None],
                                    jnp.asarray(cards)))[0],
            err_msg=f"{what} decoded best")
        bitwise_steps += same

    for seed in range(8):
        key = jax.random.PRNGKey(seed)
        k0, key = jax.random.split(key)
        jst = jinit(k0)
        check(jst, tops.init(_tk(k0)[None]), f"seed {seed} init")
        for t in range(6):
            key, k = jax.random.split(key)
            want = jstep(k, jst)
            got = tops.step(_tk(k)[None],
                            {kk: _t(np.asarray(v))[None]
                             for kk, v in jst.items()})
            check(want, got, f"seed {seed} step {t}")
            total += 1
            jst = want
    if alg == "pso":
        assert bitwise_steps == total + 8
    elif alg != "cmaes" and n == 4:
        # the normal's ULPs touch a few steps only
        assert bitwise_steps >= 0.75 * (total + 8), (bitwise_steps, total)


# ---------------------------------------------------------------------------
# the port's own routes, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def landscape():
    """The reduced space's unpenalized EDAP landscape on the CPU."""
    space = reduced_rram_space()
    wa = pack(get_workload_set(PAPER_4))
    return space, runner.make_landscape_scorer(space, wa, Objective("edap",
                                                                     "mean"),
                                               device="cpu")


@pytest.mark.parametrize("alg", ALGS)
def test_lanes_scan_and_loop_agree(landscape, alg):
    """Three seeds as one lane batch equal each seed alone (one-lane
    batch and the host-driven loop): best genome, score and history,
    bit for bit; evaluations are the analytic count."""
    space, score = landscape
    keys = torch.stack([jr.PRNGKey(s) for s in (0, 1, 2)])
    batch = tb.batched_baseline_search(keys, space, score, alg, pop=8,
                                       iters=6)
    assert batch.evaluations == tb.n_evaluations(alg, 8, 6)
    assert batch.evaluations == jb.n_evaluations(alg, 8, 6)
    for i in range(3):
        for use_scan in (True, False):
            one = tb.baseline_search(keys[i], space, score, alg, pop=8,
                                     iters=6, use_scan=use_scan)
            np.testing.assert_array_equal(one.best_genome,
                                          batch.best_genomes[i])
            assert one.best_score == batch.best_scores[i]
            np.testing.assert_array_equal(one.history, batch.histories[i])
    assert np.all(np.diff(batch.histories, axis=1) <= 0)


@pytest.mark.parametrize("alg", ALGS)
def test_padded_schedule_is_bitwise(landscape, alg):
    """``active`` padded with trailing False iterations (and one lane
    stopped early in an (L, iters) mask) reproduces the unpadded runs."""
    space, score = landscape
    cards = cards_of(space, "cpu")
    keys = torch.stack([jr.PRNGKey(s) for s in (3, 4)])
    kw = dict(algorithm=alg, pop=8)
    g, s, h = tb.baseline_kernel(keys, cards, lanes_of(score), iters=5, **kw)
    act = torch.tensor([True] * 5 + [False] * 3)
    gp, sp, hp = tb.baseline_kernel(keys, cards, lanes_of(score), iters=8,
                                    active=act, **kw)
    assert torch.equal(gp, g) and torch.equal(sp, s)
    assert torch.equal(hp[:, :6], h)
    assert torch.equal(hp[:, 6:], h[:, -1:].expand(2, 3))
    g3, s3, h3 = tb.baseline_kernel(keys[:1], cards, lanes_of(score),
                                    iters=3, **kw)
    per_lane = torch.tensor([[True] * 3 + [False] * 5, [True] * 5
                             + [False] * 3])
    gl, sl, hl = tb.baseline_kernel(keys, cards, lanes_of(score), iters=8,
                                    active=per_lane, **kw)
    assert torch.equal(gl[0], g3[0]) and torch.equal(sl[0], s3[0])
    assert torch.equal(gl[1], g[1]) and torch.equal(hl[1, :6], h[1])


def test_entry_points_and_names():
    """The per-algorithm entry points map onto ``baseline_search`` as
    the reference's do; an unknown algorithm is refused."""
    space = reduced_rram_space()
    score = lambda g: g.float().sum(dim=1)  # noqa: E731
    key = jr.PRNGKey(0)
    for res, alg, kw in (
            (tb.pso_search(key, space, score, n_particles=6, iters=3),
             "pso", {}),
            (tb.es_search(key, space, score, mu=3, lam=6, iters=3), "es",
             {"mu": 3}),
            (tb.es_search(key, space, score, mu=3, lam=6, iters=3,
                          stochastic_ranking=True), "sres", {"mu": 3}),
            (tb.cmaes_search(key, space, score, lam=6, iters=3), "cmaes",
             {}),
            (tb.g3pcx_search(key, space, score, pop_size=6, iters=3),
             "g3pcx", {})):
        want = tb.baseline_search(key, space, score, alg, pop=6, iters=3,
                                  **kw)
        np.testing.assert_array_equal(res.best_genome, want.best_genome)
        assert res.evaluations == jb.n_evaluations(alg, 6, 3, **kw)
    assert tb.BASELINE_ALGORITHMS == jb.BASELINE_ALGORITHMS
    with pytest.raises(ValueError, match="unknown baseline"):
        tb.make_baseline_ops("nelder_mead", _t(CARDS[4]), score, 6)


# ---------------------------------------------------------------------------
# the study's scorers
# ---------------------------------------------------------------------------

def test_landscape_scorer_and_ground_truth_match_reference(landscape):
    """The reduced space's landscape over all 240 designs within rtol
    1e-6 (the cost model's bound, ROADMAP Queue 3), and the same
    exhaustive ground truth: global design and minimum."""
    space, score = landscape
    jspace = jreduced_rram_space()
    assert space.names == jspace.names and space.size == jspace.size == 240
    assert np.array_equal(space.value_table(), jspace.value_table())
    jwa = jpack(jget_workload_set(PAPER_4))
    jscore = jrunner.make_landscape_scorer(jspace, jwa,
                                           JObjective("edap", "mean"))
    want = jrunner.enumerate_ground_truth(jspace, jscore)
    got = runner.enumerate_ground_truth(space, score, "cpu")
    assert got[2] == want[2] == 240
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    combos = np.asarray(np.meshgrid(*[np.arange(len(v)) for v in
                                      space.values], indexing="ij"))
    combos = combos.reshape(4, -1).T
    np.testing.assert_allclose(score(_t(combos)).numpy(),
                               np.asarray(jscore(jnp.asarray(combos))),
                               rtol=1e-6)


def test_penalty_channel_matches_reference():
    """The full-space study's penalty channel: one cost-model pass gives
    scores equal to ``Scorer.score`` bit for bit and penalties equal to
    the reference's, on 512 random RRAM designs."""
    obj = Objective("edap", "mean")
    wa = pack(get_workload_set(PAPER_4))
    space = get_space("rram")
    scorer = build_scorer(space, ScorerSpec(obj, workloads=wa),
                          device="cpu")
    channel = runner.make_infeasibility_penalty(scorer, obj)
    jspace = jget_space("rram")
    jtraced = jbuild_scorer(jspace, JScorerSpec(JObjective("edap", "mean"),
                                                workloads=jpack(
                                                    jget_workload_set(
                                                        PAPER_4))),
                            budget=JBudget())
    jphi = jrunner.make_infeasibility_penalty(jtraced,
                                              JObjective("edap", "mean"))
    g = np.random.default_rng(0).integers(0, jspace.cardinalities,
                                          (512, space.n_params))
    s, phi = channel(_t(g))
    assert torch.equal(s, scorer.score(_t(g)))
    np.testing.assert_array_equal(phi.numpy(),
                                  np.asarray(jphi(jnp.asarray(g))))
    assert np.any(phi.numpy() == 0) and np.any(phi.numpy() > 0)
