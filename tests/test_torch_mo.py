"""Parity of the port's NSGA-II engine (repro_torch/core/nsga.py) and
Pareto tools (core/pareto.py) with the JAX reference on shared inputs:
non-dominated ranks bitwise on the broadcast and tiled routes, crowding
within rtol 1e-5 with the same crowded order, the same tournament
winners, the same NSGA-II generation, the batched multi-seed search
(equal populations and ranks, scores within rtol 1e-4), the host loop
against the lane route, the union front, and the Pareto tools bitwise.

The generation-level tests score with an objective whose float32
values are exact integers on both sides (many ties), so every rank and
crowding comparison sees the same bits; the batched search scores with
the real cost model (EDAP within rtol 1e-6, ROADMAP Queue 3)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nsga as jnsga
from repro.core import pareto as jpareto
from repro.core import genetic as jgen
from repro.core import make_evaluator as jmake_evaluator
from repro.core import make_objective as jmake_objective
from repro.core import get_space as jget_space
from repro.core import get_workload_set as jget_workload_set
from repro.core import pack as jpack
from repro_torch import convert
from repro_torch.core import nsga, pareto
from repro_torch.core.cost_model import make_evaluator
from repro_torch.core.genetic import FOUR_PHASES, cards_of, phase_schedule
from repro_torch.core.objectives import make_objective
from repro_torch.core.search_space import get_space
from repro_torch.core.workloads import get_workload_set, pack

torch.set_num_threads(1)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _tkey(key) -> torch.Tensor:
    return convert.from_reference_key(np.asarray(key), device="cpu")


def _sweep(seed, n_cases=40, levels=5):
    """Random score matrices with heavy ties (integer grids), 1-3
    objectives, plus the reference's duplicate and single cases. A few
    sizes only, so the reference compiles each shape once."""
    rng = np.random.default_rng(seed)
    out = [np.array([[1.0, 1.0], [1.0, 1.0], [2.0, 2.0]], np.float32),
           np.ones((1, 3), np.float32),
           np.array([[1.0, 5.0], [2.0, 2.0], [5.0, 1.0], [3.0, 3.0],
                     [6.0, 6.0]], np.float32),
           np.array([[1e30, 2.0], [1e30, 1e30], [3.0, 1e30]], np.float32)]
    for _ in range(n_cases):
        n = int(rng.choice([1, 2, 9, 23, 39]))
        d = int(rng.integers(1, 4))
        out.append(rng.integers(0, levels, (n, d)).astype(np.float32))
    return out


# ---------------------------------------------------------------------------
# sorting and crowding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [None, 0, 4])
def test_nondominated_rank_matches_reference(tile):
    """Bitwise ranks over the sweep: automatic, forced broadcast and
    forced tiling (blocks of 4 rows)."""
    jrank = jax.jit(functools.partial(jnsga.nondominated_rank, tile=tile))
    for F in _sweep(0):
        want = np.asarray(jrank(jnp.asarray(F)))
        got = nsga.nondominated_rank(_t(F), tile=tile)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            np.nonzero(got.numpy() == 0)[0], pareto.pareto_front(F))


@pytest.mark.parametrize("n", [512, 700])
def test_tiled_route_at_scale_matches_reference(n):
    """From DOMINANCE_TILE_THRESHOLD the automatic route is the tiled
    one; its dominance matrix equals the broadcast one and the ranks
    equal the reference's, also as a lane batch."""
    rng = np.random.default_rng(n)
    F = rng.integers(0, 12, (2, n, 2)).astype(np.float32)
    t = _t(F)
    assert torch.equal(nsga.dominance_matrix_tiled(t, 256),
                       nsga.dominance_matrix(t))
    got = nsga.nondominated_rank(t)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jnsga.nondominated_rank(
                jnp.asarray(F[i]))))


def test_crowding_and_crowded_order_match_reference():
    """Crowding within rtol 1e-5 (the reference's own bound against its
    float32 oracle) and the same (rank, -crowding) order."""
    jrank = jax.jit(jnsga.nondominated_rank)
    jcrowd = jax.jit(jnsga.crowding_distance)
    jorder = jax.jit(jnsga.crowded_order)
    for F in _sweep(1):
        ranks = np.asarray(jrank(jnp.asarray(F)))
        want = np.asarray(jcrowd(jnp.asarray(F), jnp.asarray(ranks)))
        got = nsga.crowding_distance(_t(F), _t(ranks))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
        np.testing.assert_array_equal(
            nsga.crowded_order(_t(ranks), got).numpy(),
            np.asarray(jorder(jnp.asarray(ranks), jnp.asarray(want))))
    # a lane batch equals its lanes one by one
    F = np.random.default_rng(2).integers(0, 6, (3, 30, 2)).astype(
        np.float32)
    r = nsga.nondominated_rank(_t(F))
    batch = nsga.crowding_distance(_t(F), r)
    for i in range(3):
        assert torch.equal(batch[i], nsga.crowding_distance(_t(F[i]), r[i]))


def test_tournament_select_same_winners():
    rng = np.random.default_rng(5)
    for seed in range(4):
        F = rng.integers(0, 4, (24, 2)).astype(np.float32)
        ranks = np.asarray(jnsga.nondominated_rank(jnp.asarray(F)))
        crowd = np.asarray(jnsga.crowding_distance(jnp.asarray(F),
                                                   jnp.asarray(ranks)))
        key = jax.random.PRNGKey(seed)
        want = jnsga.tournament_select(key, jnp.asarray(ranks),
                                       jnp.asarray(crowd), 24)
        got = nsga.tournament_select(_tkey(key)[None], _t(ranks)[None],
                                     _t(crowd)[None], 24)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def _exact_objective(space):
    """Two integer-valued float32 objectives of a genome, exact on both
    sides: a weighted index sum and its mirror."""
    cards = space.cardinalities.astype(np.float32)
    w1 = np.arange(1, space.n_params + 1, dtype=np.float32)
    w2 = w1[::-1].copy()

    def jvec(g):
        g = g.astype(jnp.float32)
        return jnp.stack([g @ jnp.asarray(w1),
                          (jnp.asarray(cards) - 1.0 - g) @ jnp.asarray(w2)],
                         axis=-1)

    def tvec(g):
        g = g.float()
        return torch.stack([g @ _t(w1), (_t(cards) - 1.0 - g) @ _t(w2)],
                           dim=-1)
    return jvec, tvec


def test_nsga_generation_same_population():
    space = jget_space("rram", True)
    cards = space.cardinalities.astype(np.float32)
    jvec, tvec = _exact_objective(space)
    rng = np.random.default_rng(0)
    pop = rng.integers(0, space.cardinalities,
                       (24, space.n_params)).astype(np.int32)
    step = jax.jit(functools.partial(jnsga._nsga_generation,
                                     score_vec=jvec))
    jpop, tpop = jnp.asarray(pop), _t(pop).long()[None]
    jsc, tsc = jvec(jpop), nsga.lanes_of_vec(tvec)(tpop)
    key = jax.random.PRNGKey(3)
    for row in jgen.phase_schedule(jgen.FOUR_PHASES, 2):
        key, k = jax.random.split(key)
        jpop, jsc = step(k, jpop, jsc, jnp.asarray(cards),
                         *map(jnp.float32, row))
        tpop, tsc = nsga._nsga_generation(
            _tkey(k)[None], tpop, tsc, _t(cards), *map(torch.tensor, row),
            score_vec=nsga.lanes_of_vec(tvec))
        np.testing.assert_array_equal(tpop[0].numpy(), np.asarray(jpop))
        np.testing.assert_array_equal(tsc[0].numpy(), np.asarray(jsc))


def test_nsga_scan_active_mask_and_loop_oracle():
    """The host loop equals the lane route; trailing inactive schedule
    rows leave the result and the history unchanged."""
    space = get_space("sram", True)
    _, tvec = _exact_objective(space)
    cards = cards_of(space, "cpu")
    key = torch.tensor([0, 7], dtype=torch.int64)
    init = torch.as_tensor(np.random.default_rng(1).integers(
        0, space.cardinalities, (16, space.n_params)))
    sched = torch.as_tensor(phase_schedule(FOUR_PHASES, 1))
    lane = nsga.lanes_of_vec(tvec)
    pop, scores, ranks, hist = nsga.nsga_scan(key[None], init[None], cards,
                                              sched, lane)
    loop = nsga.run_nsga_loop(key, space, tvec, init, FOUR_PHASES, 1)
    np.testing.assert_array_equal(loop.population, pop[0].numpy())
    np.testing.assert_array_equal(loop.scores, scores[0].numpy())
    np.testing.assert_array_equal(loop.ranks, ranks[0].numpy())
    np.testing.assert_array_equal(loop.history, hist[0].numpy())
    assert (np.diff(loop.history, axis=0) <= 0).all()
    padded = torch.cat([sched, sched[:2]])
    active = torch.tensor([True] * 4 + [False] * 2)
    out = nsga.nsga_scan(key[None], init[None], cards, padded, lane,
                         active=active)
    assert torch.equal(out[0], pop) and torch.equal(out[1], scores)
    assert torch.equal(out[3][:, :5], hist)


@pytest.mark.parametrize("mem", ["rram", "sram"])
def test_batched_nsga_search_matches_reference(mem):
    """Sampling (capacity-masked for RRAM) + 4-phase NSGA-II on EDAP x
    cost with the node in the genome, two seeds as lanes: equal final
    populations and ranks, scores and ideal-point histories within rtol
    1e-4, and the same union front as a set."""
    names = ("resnet18", "alexnet")
    jspace = jget_space(mem, True)
    jev = jmake_evaluator(jspace, jpack(jget_workload_set(names)))
    jobj = jmake_objective("edap:mean+cost")
    space = get_space(mem, True)
    ev = make_evaluator(space, pack(get_workload_set(names)), device="cpu")
    obj = make_objective("edap:mean+cost")
    kw = dict(p_h=40, p_e=16, p_ga=8, generations_per_phase=2)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 1)])
    rram = mem == "rram"
    want = jnsga.batched_nsga_search(
        jkeys, jspace, lambda g: jobj(jev(g)),
        feasible_fn=(lambda g: jev(g).feasible) if rram else None, **kw)
    got = nsga.batched_nsga_search(
        _tkey(jkeys), space, lambda g: obj(ev(g)),
        feasible_fn=(lambda g: ev(g).feasible) if rram else None, **kw)
    np.testing.assert_array_equal(got.populations, want.populations)
    np.testing.assert_array_equal(got.ranks, want.ranks)
    np.testing.assert_allclose(got.scores, want.scores, rtol=1e-4)
    np.testing.assert_allclose(got.histories, want.histories, rtol=1e-4)
    assert got.n_seeds == 2 and got.seed_result(1).history.shape == (9, 2)
    g_got, s_got = got.union_front()
    g_want, s_want = want.union_front()
    assert ({tuple(r) for r in g_got} == {tuple(r) for r in g_want})
    np.testing.assert_allclose(s_got, s_want, rtol=1e-4)
    # the union front is the front of every final-population candidate
    allg = got.populations.reshape(-1, space.n_params)
    alls = got.scores.reshape(-1, 2)
    idx = pareto.pareto_front(alls)
    assert ({tuple(r) for r in allg[idx]} == {tuple(r) for r in g_got})


# ---------------------------------------------------------------------------
# Pareto tools
# ---------------------------------------------------------------------------

def test_pareto_tools_match_reference():
    """pareto_front, hypervolume_2d, front_coverage and edap_cost_front
    bitwise on random sweeps with ties and duplicates."""
    rng = np.random.default_rng(7)
    for i in range(30):
        n = int(rng.integers(0, 60))
        d = 2 if i % 3 else int(rng.integers(1, 4))
        pts = rng.integers(0, 8, (n, d)).astype(np.float64)
        pts += rng.random((n, d)) * (i % 2)
        np.testing.assert_array_equal(pareto.pareto_front(pts),
                                      jpareto.pareto_front(pts))
        if d == 2:
            ref = np.array([8.5, 9.0]) if i % 4 else np.array([4.0, 4.0])
            assert pareto.hypervolume_2d(pts, ref) == \
                jpareto.hypervolume_2d(pts, ref)
            other = rng.integers(0, 8, (int(rng.integers(0, 20)), 2))
            assert pareto.front_coverage(pts, other) == \
                jpareto.front_coverage(pts, other)
            assert pareto.front_coverage(other, pts) == \
                jpareto.front_coverage(other, pts)
            if n:
                for a, b in zip(pareto.edap_cost_front(pts[:, 0], pts[:, 1]),
                                jpareto.edap_cost_front(pts[:, 0],
                                                        pts[:, 1])):
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        pareto.hypervolume_2d(np.zeros((3, 3)), np.ones(3))
