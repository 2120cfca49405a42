"""Parity of the port's joint workload-architecture co-search with the
JAX reference on shared inputs: ``joint_space``, every build of both
workload families, the ``WorkloadBuilder``'s six tensors (bitwise), the
joint cost model (rtol 1e-6, area and capacity flags bitwise), the
accuracy-aware objectives (``min_accuracy``, ``acc_loss``, '+'-joined
specs) and the joint Scorer with its accuracy model (rtol 1e-4, the
bound of tests/test_nonideal.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import cost_model as jcost
from repro.core import nonideal as jnonideal
from repro.core import objectives as jobjectives
from repro.core import scoring as jscoring
from repro.core import search_space as jsearch_space
from repro.core import workloads as jworkloads
from repro_torch import convert
from repro_torch.core import cost_model, objectives, scoring
from repro_torch.core.nonideal import flat_index_strides, make_accuracy_model
from repro_torch.core.search_space import get_space, joint_space
from repro_torch.core.workloads import (FAMILY_NAMES, get_family,
                                        get_workload, get_workload_set,
                                        make_workload_builder, pack)

torch.set_num_threads(1)

FAMILY_SETS = [("resnet_family",), ("vit_family",),
               ("resnet_family", "vit_family")]


def _joint(mem, names, tech=False):
    """(reference space, port space, reference families, port families)."""
    jfams = [jworkloads.get_family(n) for n in names]
    fams = [get_family(n) for n in names]
    return (jsearch_space.joint_space(jsearch_space.get_space(mem, tech),
                                      jfams),
            joint_space(get_space(mem, tech), fams), jfams, fams)


def _genomes(space, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, space.cardinalities,
                        size=(n, space.n_params)).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


# ---------------------------------------------------------------------------
# space, families, builder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mem", ["rram", "sram"])
@pytest.mark.parametrize("names", FAMILY_SETS)
def test_joint_space_matches_reference(mem, names):
    ref, port, _, _ = _joint(mem, names)
    assert port.names == ref.names and port.n_arch == ref.n_arch
    assert port.n_hw == ref.n_hw and port.size == ref.size
    assert port.hw_names == ref.hw_names
    assert port.arch_names == ref.arch_names
    for a, b in zip(port.values, ref.values):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert np.array_equal(port.value_table(), ref.value_table())
    g = _genomes(ref, 3, 0)
    assert np.array_equal(port.arch_slice(g), ref.arch_slice(g))
    assert np.array_equal(port.hw_slice(g), ref.hw_slice(g))
    assert port.decode(g[0]) == ref.decode(g[0])
    conv = convert.from_reference_space(ref)
    assert conv.names == port.names and conv.n_arch == port.n_arch
    assert np.array_equal(conv.value_table(), port.value_table())
    base = get_space(mem)
    assert joint_space(base, []) is base


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_every_family_build_matches_reference(name):
    """Every combination of the family: the same Workload (layers,
    weight_bits, stored_weights, name) bitwise, the same clean
    accuracy, in the same mixed-radix order."""
    ref, fam = jworkloads.get_family(name), get_family(name)
    assert fam.cardinalities == ref.cardinalities
    assert fam.combos() == ref.combos()
    assert fam.n_layers == ref.n_layers
    for a, b in zip(fam.built(), ref.built()):
        assert a.name == b.name
        assert np.array_equal(a.layers, b.layers)
        assert a.layers.dtype == b.layers.dtype == np.float64
        assert np.array_equal(a.weight_bits, b.weight_bits)
        assert np.array_equal(a.layer_weight_bits, b.layer_weight_bits)
        assert a.stored_weights == b.stored_weights
    for idx in np.ndindex(*fam.cardinalities):
        assert fam.accuracy_at(idx) == ref.accuracy_at(idx)
        assert fam.build_at(idx).name == ref.build_at(idx).name


@pytest.mark.parametrize("names", FAMILY_SETS + [("resnet_family",
                                                  "alexnet")])
def test_builder_tensors_match_reference(names):
    """The six tensors of 256 random joint genomes, bitwise."""
    jfams = [jworkloads.get_family(n) if n in FAMILY_NAMES
             else jworkloads.get_workload(n) for n in names]
    fams = [get_family(n) if n in FAMILY_NAMES else get_workload(n)
            for n in names]
    jspace = jsearch_space.joint_space(
        jsearch_space.get_space("rram"),
        [f for f in jfams if isinstance(f, jworkloads.WorkloadFamily)])
    space = convert.from_reference_space(jspace)
    jb = jworkloads.make_workload_builder(jspace, jfams)
    b = make_workload_builder(space, fams)
    assert b.names == jb.names and b.lmax == jb.lmax
    g = _genomes(jspace, 256, seed=len(names))
    want = jb(jnp.asarray(g))
    got = b(_t(g))
    for field in want._fields:
        w, t = np.asarray(getattr(want, field)), getattr(got, field).numpy()
        assert t.shape == w.shape and t.dtype == w.dtype, field
        assert np.array_equal(t, w), field
    # device copies of the tables are made once
    assert b.device_tables(torch.device("cpu")) is b.device_tables(
        torch.device("cpu"))


def test_convert_workload_carries_weight_bits():
    """A resnet_family member at wbits_early=4 converted from the
    reference keeps its per-layer weight bits, so a builder slot of it
    costs its early layers at 4-bit weights, as the reference does."""
    fam = jworkloads.resnet_family()
    idx = [1, 1, 0, 1]  # depth 18, width 1.0, wbits_early 4, wbits_late 8
    wl = fam.build_at(idx)
    assert wl.weight_bits.min() == 4.0 and wl.weight_bits.max() == 8.0
    conv = convert.from_reference_workload(wl)
    assert np.array_equal(conv.weight_bits, wl.weight_bits)
    assert np.array_equal(conv.layer_weight_bits, wl.layer_weight_bits)
    plain = convert.from_reference_workload(jworkloads.resnet18())
    assert plain.weight_bits is None
    assert np.array_equal(plain.layer_weight_bits, np.full(21, 8.0))
    jspace = jsearch_space.get_space("rram")
    g = _genomes(jspace, 64, seed=5)
    want = jcost.make_joint_evaluator(
        jspace, jworkloads.make_workload_builder(jspace, [wl]))(
        jnp.asarray(g))
    space = convert.from_reference_space(jspace)
    got = cost_model.evaluate_population_joint(
        space, make_workload_builder(space, [conv]), _t(g))
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-6)
    assert np.array_equal(got.feasible_w.numpy(),
                          np.asarray(want.feasible_w))
    # 4-bit early layers need fewer crossbars than the 8-bit costing
    flat = cost_model.evaluate_population(space, pack([conv]), _t(g))
    assert (got.energy <= flat.energy).all()
    assert (got.energy < flat.energy).any()


# ---------------------------------------------------------------------------
# joint cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [("resnet_family",), ("vit_family",),
                                   ("resnet_family", "vgg16")])
def test_joint_cost_matches_reference(names):
    """evaluate_population_joint on 512 random RRAM joint genomes:
    energy and latency within rtol 1e-6, area, cost and capacity flags
    bitwise (the 32 nm node is fixed)."""
    jfams = [jworkloads.get_family(n) if n in FAMILY_NAMES
             else jworkloads.get_workload(n) for n in names]
    jspace = jsearch_space.joint_space(
        jsearch_space.get_space("rram"),
        [f for f in jfams if isinstance(f, jworkloads.WorkloadFamily)])
    jb = jworkloads.make_workload_builder(jspace, jfams)
    g = _genomes(jspace, 512, seed=11)
    want = jcost.make_joint_evaluator(jspace, jb)(jnp.asarray(g))
    space = convert.from_reference_space(jspace)
    fams = [get_family(n) if n in FAMILY_NAMES else get_workload(n)
            for n in names]
    ev = cost_model.make_joint_evaluator(
        space, make_workload_builder(space, fams), device="cpu")
    got = ev(_t(g))
    for field in ("area", "cost", "feasible", "feasible_w"):
        assert np.array_equal(getattr(got, field).numpy(),
                              np.asarray(getattr(want, field))), field
    for field in ("energy", "latency"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=1e-6, err_msg=field)
    assert 0 < got.feasible.float().mean() < 1


@pytest.mark.parametrize("mem", ["rram", "sram"])
def test_joint_evaluator_degenerate_matches_flat(mem):
    """Zero families: the joint path equals the flat one within rtol
    1e-5 (pads are masked, not absent), as the reference's own test
    holds it; and equals the reference's joint path within 1e-6."""
    names = ("resnet18", "alexnet", "vgg16")
    space = get_space(mem)
    wls = get_workload_set(names)
    g = _genomes(space, 256, seed=2)
    joint = cost_model.evaluate_population_joint(
        space, make_workload_builder(space, wls), _t(g))
    flat = cost_model.evaluate_population(space, pack(wls), _t(g))
    for field in ("energy", "latency", "area"):
        np.testing.assert_allclose(getattr(joint, field).numpy(),
                                   getattr(flat, field).numpy(), rtol=1e-5)
    assert torch.equal(joint.feasible, flat.feasible)
    jspace = jsearch_space.get_space(mem)
    want = jcost.make_joint_evaluator(
        jspace, jworkloads.make_workload_builder(
            jspace, jworkloads.get_workload_set(names)))(jnp.asarray(g))
    np.testing.assert_allclose(joint.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# objectives and the joint scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,min_acc", [
    ("edap:mean", 0.6), ("acc_loss:mean", 0.0), ("acc_loss:max", 0.0),
    ("edap:mean+cost", 0.0), ("edap:mean+acc_loss:mean", 0.0),
    ("edap_acc:mean+acc_loss:mean", 0.65)])
def test_accuracy_objectives_match_reference(spec, min_acc):
    """The same CostMetrics inputs and (P, W) accuracies on both sides:
    scores within test_objectives_match's rtol 1e-5, the infeasible set
    equal, per_workload_scores('acc_loss') too."""
    space, names = jsearch_space.get_space("rram", True), ("resnet18",
                                                           "alexnet")
    jwa = jworkloads.pack(jworkloads.get_workload_set(names))
    g = _genomes(space, 256, seed=3)
    jm = jcost.make_evaluator(space, jwa)(jnp.asarray(g))
    acc = np.random.default_rng(4).uniform(0.4, 0.95, (256, 2)).astype(
        np.float32)
    want = np.asarray(jobjectives.make_objective(spec, min_accuracy=min_acc)(
        jm, accuracy=jnp.asarray(acc)))
    m = cost_model.evaluate_population(
        get_space("rram", True), pack(get_workload_set(names)),
        _t(g).long())
    obj = objectives.make_objective(spec, min_accuracy=min_acc)
    got = obj(m, accuracy=_t(acc)).numpy()
    assert got.shape == want.shape
    assert isinstance(obj, objectives.MultiObjective) == ("+" in spec)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.array_equal(got >= 1e30, want >= 1e30)
    assert (got >= 1e30).any() and (got < 1e30).any()
    np.testing.assert_allclose(
        objectives.per_workload_scores(m, "acc_loss",
                                       accuracy=_t(acc)).numpy(),
        np.asarray(jobjectives.per_workload_scores(
            jm, "acc_loss", accuracy=jnp.asarray(acc))), rtol=1e-6)


def test_objective_parsing_and_accuracy_rules():
    mo = objectives.make_objective("edap:mean+acc_loss:mean",
                                   min_accuracy=0.5)
    assert mo.kinds == ("edap", "acc_loss") and mo.n_objectives == 2
    assert all(o.min_accuracy == 0.5 for o in mo.components)
    assert objectives.is_multi_spec("edap+cost")
    for bad in ("edap:mean+", "+cost"):
        with pytest.raises(ValueError):
            objectives.make_objective(bad)
    with pytest.raises(ValueError):
        objectives.MultiObjective((objectives.Objective(),))
    m = cost_model.evaluate_population(
        get_space("rram"), pack(get_workload_set(("alexnet",))),
        torch.zeros((2, 9), dtype=torch.int64))
    for o in (objectives.Objective("acc_loss"),
              objectives.Objective("edap", min_accuracy=0.5)):
        with pytest.raises(ValueError, match="accuracy model"):
            o(m)
    assert scoring.needs_accuracy(mo)
    assert scoring.needs_accuracy(objectives.Objective("edap",
                                                       min_accuracy=0.1))
    assert not scoring.needs_accuracy(objectives.make_objective(
        "edap:mean+cost"))


@pytest.mark.parametrize("name,spec,min_acc", [
    ("resnet_family", "edap:mean", 0.60),
    ("vit_family", "edap:mean", 0.58),
    ("resnet_family", "edap:mean+acc_loss:mean", 0.0)])
def test_joint_scorer_matches_reference(name, spec, min_acc):
    """The joint Scorer through 'ref' and 'jnp' against the JAX scorer
    through 'ref' on 12 joint genomes: accuracy, score, score_w and (MO)
    score_vec within rtol 1e-4; the infeasible sets equal."""
    jspace, space, jfams, fams = _joint("rram", (name,))
    kw = dict(calib=jscoring.Calib(16, 128))
    jsc = jscoring.build_scorer(
        jspace, jscoring.ScorerSpec(jobjectives.make_objective(
            spec, min_accuracy=min_acc),
            builder=jworkloads.make_workload_builder(jspace, jfams)),
        backend="ref", **kw)
    g = _genomes(jspace, 12, seed=13)
    g[:4, jspace.index("xbar_rows")] = 3        # deep rows: noisy
    g[4:8, jspace.index("bits_cell")] = 2       # 4-bit cells
    jg = jnp.asarray(g)
    want_acc = np.asarray(jsc.accuracy(jg))
    want = np.asarray(jsc.score(jg))
    want_w = np.asarray(jsc.score_w(jg, 0))
    builder = make_workload_builder(space, fams)
    for backend in ("ref", "jnp"):
        sc = scoring.build_scorer(
            space, scoring.ScorerSpec(objectives.make_objective(
                spec, min_accuracy=min_acc), builder=builder),
            calib=scoring.Calib(16, 128), backend=backend, device="cpu")
        tg = _t(g).long()
        np.testing.assert_allclose(sc.accuracy(tg).numpy(), want_acc,
                                   rtol=1e-4, err_msg=backend)
        got = sc.score(tg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=backend)
        assert np.array_equal(got >= 1e30, want >= 1e30)
        np.testing.assert_allclose(sc.score_w(tg, 0).numpy(), want_w,
                                   rtol=1e-4, err_msg=backend)
        if "+" in spec:
            np.testing.assert_allclose(sc.score_vec(tg).numpy(),
                                       np.asarray(jsc.score_vec(jg)),
                                       rtol=1e-4, err_msg=backend)
            assert np.array_equal(sc.score_vec(tg)[:, 0], sc.score(tg))
        else:
            assert sc.score_vec is None
    if min_acc:
        assert (want >= 1e30).any() or (want_acc < min_acc).sum() == 0


def test_joint_accuracy_model_flat_index_past_2_24():
    """The joint RRAM x resnet_family space folds flat indices up to
    ~1.03e8 into the noise key: int64 on the port's side, the same
    values as the reference's int32 strides, and the accuracy at such
    genomes within rtol 1e-4 of the reference's."""
    jspace, space, jfams, fams = _joint("rram", ("resnet_family",))
    assert space.size == 2150400 * 48
    strides = flat_index_strides(space)
    assert strides.dtype == np.int64
    assert np.array_equal(strides, jnonideal.flat_index_strides(jspace))
    g = _genomes(jspace, 8, seed=21)
    g[:, 0] = 2  # bits_cell's stride alone is 48 x 716800
    flat = g.astype(np.int64) @ strides
    assert (flat > 2 ** 24).all() and (flat < 2 ** 31).all()
    assert np.array_equal(flat, np.asarray(jnonideal.genome_flat_index(
        jspace, jnp.asarray(g))))
    kw = dict(n_calib=8, calib_k=128)
    want = np.asarray(jnonideal.make_accuracy_model(
        jspace, builder=jworkloads.make_workload_builder(jspace, jfams),
        backend="ref", **kw)(jnp.asarray(g)))
    got = make_accuracy_model(space, builder=make_workload_builder(
        space, fams), backend="ref", device="cpu", **kw)(_t(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    with pytest.raises(ValueError, match="exactly one"):
        make_accuracy_model(space, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        make_accuracy_model(space, pack(get_workload_set(("alexnet",))),
                            builder=make_workload_builder(space, fams),
                            device="cpu")
