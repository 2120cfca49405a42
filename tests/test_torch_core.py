"""Module parity of the port's core (repro_torch/core), configs and
models with the JAX reference on shared inputs: search spaces, packed
workloads, the ten LM ArchConfigs and their exported workloads exactly,
CostMetrics on every deduped registry configuration, objectives, the
accuracy model on every accuracy-scored configuration, the noisy
crossbar GEMM and the host accuracy oracle, and the GA operators,
sampler and scheduled search given the same keys.

Where the port is not bitwise, the divergence is an ULP-level one that
ROADMAP Queue 3 records: XLA contracts multiply-adds into FMAs and sums
its float32 dot in an order the port cannot reproduce (the port sums
the workload segments in float64 and rounds once)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import genetic as jgen
from repro.core import sampling as jsamp
from repro.core import HWConstants as JHWConstants
from repro.core import (Objective as JObjective, get_space as jget_space,
                        get_workload_set as jget_workload_set,
                        make_evaluator as jmake_evaluator, pack as jpack)
from repro.core.nonideal import accuracy_proxy_host as jaccuracy_proxy_host
from repro.core.nonideal import calibration_data as jcalibration_data
from repro.core.nonideal import make_accuracy_model as jmake_accuracy_model
from repro.core.nonideal import noisy_crossbar_gemm as jnoisy_crossbar_gemm
from repro.core.objectives import per_workload_scores as jper_workload
from repro.core.workloads import from_arch_config as jfrom_arch_config
from repro.experiments import REGISTRY
from repro_torch import configs, convert
from repro_torch import random as jr
from repro_torch.core import cost_model, from_arch_config, genetic, sampling
from repro_torch.core.nonideal import (CALIB_SEED, accuracy_proxy_host,
                                       calibration_data,
                                       make_accuracy_model,
                                       noisy_crossbar_gemm,
                                       quantize_activations)
from repro_torch.core.objectives import (Objective, make_objective,
                                         per_workload_scores)
from repro_torch.core.search_space import get_space
from repro_torch.core.workloads import get_workload_set, pack

torch.set_num_threads(1)


def _ported(sc) -> bool:
    return sc.workload_source in ("paper", "archs")


def _cost_configs():
    seen, out = set(), []
    for name, sc in REGISTRY.items():
        key = (sc.mem, sc.tech_variable, sc.reduced_space, sc.workloads)
        if _ported(sc) and key not in seen:
            seen.add(key)
            out.append(name)
    return out


def _acc_configs():
    seen, out = set(), []
    for name, sc in REGISTRY.items():
        key = (sc.mem, sc.tech_variable, sc.workloads, sc.n_calib,
               sc.calib_k)
        if (_ported(sc) and sc.objective.startswith("edap_acc")
                and key not in seen):
            seen.add(key)
            out.append(name)
    assert out, "the registry lost its accuracy-scored scenarios?"
    return out


def _genomes(space, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, space.cardinalities,
                        size=(n, space.n_params)).astype(np.int32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).copy())


def _tkey(seed_or_key) -> torch.Tensor:
    key = (jax.random.PRNGKey(seed_or_key) if isinstance(seed_or_key, int)
           else seed_or_key)
    return convert.from_reference_key(np.asarray(key), device="cpu")


# ---------------------------------------------------------------------------
# search space, workloads, cost model, objectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mem", ["rram", "sram"])
@pytest.mark.parametrize("tech", [False, True])
def test_search_space_tables_equal(mem, tech):
    ref, port = jget_space(mem, tech), get_space(mem, tech)
    assert port.names == ref.names and port.size == ref.size
    assert np.array_equal(port.value_table(), ref.value_table())
    assert np.array_equal(port.cardinalities, ref.cardinalities)
    assert port.index("xbar_rows") == ref.index("xbar_rows")
    g = _genomes(ref, 1, 0)[0]
    assert port.decode(g) == ref.decode(g)
    conv = convert.from_reference_space(ref)
    assert np.array_equal(conv.value_table(), port.value_table())


def test_pack_equal_on_every_registry_workload_set():
    sets = {sc.workloads for sc in REGISTRY.values()
            if sc.workload_source == "paper"}
    for names in sorted(sets):
        ref, port = jpack(jget_workload_set(names)), pack(
            get_workload_set(names))
        conv = convert.from_reference_workload_arrays(ref)
        for wa in (port, conv):
            assert wa.names == ref.names
            for field in ("layers", "mask", "stored_weights", "flat_layers",
                          "seg_ids"):
                assert np.array_equal(getattr(wa, field),
                                      getattr(ref, field)), (names, field)


@pytest.mark.parametrize("name", _cost_configs())
def test_cost_metrics_match_on_registry_config(name):
    """CostMetrics of 512 random designs. Capacity flags bitwise
    everywhere, area/cost bitwise at the fixed 32 nm node; energy and
    latency (and area/cost with the node in the genome) within rtol
    1e-6 — see ROADMAP Queue 3."""
    sc = REGISTRY[name]
    jspace, jwa = sc.space(), jpack(sc.resolve_workloads())
    g = _genomes(jspace, 512, seed=len(name))
    ref = jmake_evaluator(jspace, jwa)(jnp.asarray(g))
    port = cost_model.evaluate_population(
        convert.from_reference_space(jspace),
        convert.from_reference_workload_arrays(jwa),
        convert.from_reference_genomes(g, device="cpu"),
        convert.from_reference_constants(JHWConstants()))
    for field in ("feasible", "feasible_w"):
        assert np.array_equal(getattr(port, field).numpy(),
                              np.asarray(getattr(ref, field))), field
    exact = ("area", "cost") if not sc.tech_variable else ()
    for field in ("energy", "latency", "area", "cost"):
        got, want = getattr(port, field).numpy(), np.asarray(getattr(ref,
                                                                    field))
        if field in exact:
            assert np.array_equal(got, want), field
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=field)


@pytest.mark.parametrize("spec", ["edap:max", "edap:mean", "edap:all",
                                  "edp:mean", "energy:max", "delay:mean",
                                  "area", "cost", "edap_cost:mean"])
def test_objectives_match(spec):
    space, names = jget_space("rram", True), ("resnet18", "alexnet", "vgg16")
    jwa = jpack(jget_workload_set(names))
    g = _genomes(space, 256, seed=3)
    jm = jmake_evaluator(space, jwa)(jnp.asarray(g))
    kind, _, agg = spec.partition(":")
    want = np.asarray(JObjective(kind, agg or "max")(jm))
    m = cost_model.evaluate_population(
        get_space("rram", True), pack(get_workload_set(names)), _t(g).long())
    got = make_objective(spec)(m).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.array_equal(got >= 1e30, want >= 1e30)
    np.testing.assert_allclose(per_workload_scores(m, kind).numpy(),
                               np.asarray(jper_workload(jm, kind)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# accuracy model
# ---------------------------------------------------------------------------

def test_calibration_data_matches():
    k = jax.random.split(jax.random.PRNGKey(CALIB_SEED))[0]
    jx, jw = jcalibration_data(k, 32, 256, 32)
    x, w = calibration_data(_tkey(k), 32, 256, 32)
    assert np.array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=4 * 2 ** -23,
                               atol=1e-30)
    cx, cw = convert.from_reference_calibration(jx, jw, device="cpu")
    assert torch.equal(cx, x)
    np.testing.assert_allclose(cw.numpy(), w.numpy(), rtol=4 * 2 ** -23,
                               atol=1e-30)
    xq = quantize_activations(x)
    assert xq.dtype == torch.int32
    assert int(xq.min()) >= 0 and int(xq.max()) <= 255


@pytest.mark.parametrize("name", _acc_configs())
@pytest.mark.parametrize("calib", [(32, 256), (8, 128)])
def test_accuracy_model_matches_reference(name, calib):
    """Port 'jnp'/'ref' vs JAX 'jnp'/'ref' at rtol 1e-4 (the bound of
    tests/test_nonideal.py), on the registry's calibration and on a
    reduced one."""
    sc = REGISTRY[name]
    n_calib, calib_k = calib
    jspace, jwa = (jget_space(sc.mem, sc.tech_variable),
                   jpack(jget_workload_set(sc.workloads)))
    g = _genomes(jspace, 6, seed=1)
    space = convert.from_reference_space(jspace)
    wa = convert.from_reference_workload_arrays(jwa)
    kw = dict(n_calib=n_calib, calib_k=calib_k)
    want = np.asarray(jmake_accuracy_model(jspace, jwa, backend="jnp",
                                           **kw)(jnp.asarray(g)))
    tg = convert.from_reference_genomes(g, device="cpu")
    for backend in ("jnp", "ref"):
        got = make_accuracy_model(space, wa, backend=backend, device="cpu",
                                  **kw)(tg)
        assert got.shape == (6, len(sc.workloads))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   err_msg=backend)
    jref = np.asarray(jmake_accuracy_model(jspace, jwa, backend="ref",
                                           **kw)(jnp.asarray(g)))
    np.testing.assert_allclose(jref, want, rtol=1e-4)


def test_accuracy_model_device_and_backend_rules():
    space, wa = get_space("rram"), pack(get_workload_set(("resnet18",)))
    with pytest.raises(ValueError):
        make_accuracy_model(space, wa, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        make_accuracy_model(space, wa, backend="pallas", device="cpu")
    acc = make_accuracy_model(space, wa, backend="auto", device="cpu")
    assert acc.backend == "jnp"


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("rows", [64, 128, 512])
def test_noisy_crossbar_gemm_matches_reference(use_kernel, rows):
    """The static-tiling noisy GEMM from the same key on both sides (the
    same threefry noise draws), through imc_matmul (ops.imc_gemm) or its
    plain version; JAX runs the Pallas kernel in interpret mode."""
    key = jax.random.PRNGKey(rows + use_kernel)
    rng = np.random.default_rng(rows)
    x = rng.random((8, 200)).astype(np.float32)  # ragged K: padded
    w = (rng.standard_normal((200, 16)) * 0.3).astype(np.float32)
    want = np.asarray(jnoisy_crossbar_gemm(key, jnp.asarray(x),
                                           jnp.asarray(w), xbar_rows=rows,
                                           use_kernel=use_kernel))
    got = noisy_crossbar_gemm(_tkey(key), _t(x), _t(w), xbar_rows=rows,
                              use_kernel=use_kernel)
    assert got.shape == (8, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_accuracy_proxy_host_matches_reference(use_kernel):
    """The host oracle on a few RRAM genomes against the reference's,
    rtol 1e-4, and against the port's batched model at the atol 5e-3 of
    tests/test_nonideal.py (a Workload list and its pack agree)."""
    names = ("resnet18", "vgg16", "alexnet", "mobilenetv3")
    jspace = jget_space("rram")
    g = _genomes(jspace, 4, seed=7)
    kw = dict(n_calib=8, calib_k=128)
    want = jaccuracy_proxy_host(jspace, g, jget_workload_set(names),
                                use_kernel=use_kernel, **kw)
    space = get_space("rram")
    got = accuracy_proxy_host(space, g, get_workload_set(names),
                              use_kernel=use_kernel, device="cpu", **kw)
    assert got.shape == (4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4)
    wa = pack(get_workload_set(names))
    packed = accuracy_proxy_host(space, g, wa, use_kernel=use_kernel,
                                 device="cpu", **kw)
    np.testing.assert_array_equal(packed, got)
    model = make_accuracy_model(space, wa, device="cpu", **kw)(
        convert.from_reference_genomes(g, device="cpu"))
    np.testing.assert_allclose(model.numpy(), got, atol=5e-3)


def test_convert_defaults_to_the_gpu():
    """Like every entry point, the converters put tensors on 'cuda' by
    default and raise without a CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    key = np.asarray(jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference_key(key)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference_genomes(np.zeros((2, 3), np.int32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.from_reference_calibration(np.zeros((2, 3)),
                                           np.zeros((3, 2)))


# ---------------------------------------------------------------------------
# LM architecture configs and their IMC workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("reduced", [False, True])
def test_arch_config_matches_reference(arch, reduced):
    """Every field and derived quantity of the ten assigned ArchConfigs,
    full and reduced."""
    ref = jconfigs.get_config(arch, reduced)
    cfg = configs.get_config(arch, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert convert.from_reference_arch_config(ref) == cfg
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.layout() == ref.layout()
    assert cfg.schedule() == ref.schedule()
    assert (cfg.rnn_w, cfg.is_decoder, cfg.sub_quadratic) == (
        ref.rnn_w, ref.is_decoder, ref.sub_quadratic)
    assert cfg.torch_dtype == (torch.bfloat16 if ref.dtype == "bfloat16"
                               else torch.float32)


def test_arch_registry_and_shapes_match_reference():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    for cfg, ref in zip(configs.all_configs(), jconfigs.all_configs()):
        for shape in configs.SHAPES.values():
            jshape = jconfigs.SHAPES[shape.name]
            assert (configs.cell_runnable(cfg, shape)
                    == jconfigs.cell_runnable(ref, jshape))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
@pytest.mark.parametrize("seq", [128, 256])
def test_from_arch_config_matches_reference(arch, seq):
    """The exported per-layer GEMMs (float64) and stored weights, bit
    for bit, from the port's own config and from a converted one."""
    ref = jfrom_arch_config(jconfigs.get_config(arch), seq=seq)
    for wl in (from_arch_config(configs.get_config(arch), seq=seq),
               from_arch_config(convert.from_reference_arch_config(
                   jconfigs.get_config(arch)), seq=seq),
               convert.from_reference_workload(ref)):
        assert wl.name == ref.name
        assert wl.layers.dtype == np.float64
        assert np.array_equal(wl.layers, ref.layers)
        assert wl.stored_weights == ref.stored_weights


# ---------------------------------------------------------------------------
# GA operators, sampling, scheduled search
# ---------------------------------------------------------------------------

def _edap_scorers(mem="rram", names=("resnet18", "alexnet")):
    jspace, jwa = jget_space(mem), jpack(jget_workload_set(names))
    jev = jmake_evaluator(jspace, jwa)
    jobj = JObjective("edap", "mean")
    space, wa = get_space(mem), pack(get_workload_set(names))
    ev = cost_model.make_evaluator(space, wa, device="cpu")
    obj = Objective("edap", "mean")
    return (jspace, lambda g: jobj(jev(g)), lambda g: jev(g).feasible,
            space, lambda g: obj(ev(g)), lambda g: ev(g).feasible)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("row", range(4))
def test_sbx_and_mutation_same_children(seed, row):
    """The real-coded operators give the same decoded genomes from the
    same keys (their pow and FMA roundings differ by ULPs)."""
    space = jget_space("rram")
    cards = space.cardinalities.astype(np.float32)
    pc, eta_c, pm, eta_m = jgen.phase_schedule(jgen.FOUR_PHASES, 1)[row]
    rng = np.random.default_rng(seed)
    x1 = rng.random((11, space.n_params)).astype(np.float32)
    x2 = rng.random((11, space.n_params)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    j1, j2 = jgen._sbx(key, jnp.asarray(x1), jnp.asarray(x2),
                       jnp.float32(pc), jnp.float32(eta_c))
    t1, t2 = genetic._sbx(_tkey(key)[None], _t(x1)[None], _t(x2)[None],
                          torch.tensor(pc), torch.tensor(eta_c))
    np.testing.assert_allclose(t1[0].numpy(), np.asarray(j1), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(t2[0].numpy(), np.asarray(j2), rtol=1e-5,
                               atol=1e-6)
    jm = jgen._poly_mutate(key, j1, jnp.float32(pm), jnp.float32(eta_m),
                           jnp.asarray(cards))
    tm = genetic._poly_mutate(_tkey(key)[None], t1, torch.tensor(pm),
                              torch.tensor(eta_m), _t(cards))
    np.testing.assert_array_equal(
        genetic._to_index(tm, _t(cards))[0].numpy(),
        np.asarray(jgen._to_index(jm, jnp.asarray(cards))))


@pytest.mark.parametrize("seed", range(4))
def test_generation_step_same_population(seed):
    space = jget_space("rram")
    cards = space.cardinalities.astype(np.float32)
    pop = _genomes(space, 24, seed)
    scores = np.random.default_rng(seed).random(24).astype(np.float32)
    scores[::5] = 1e30  # ties, as infeasible designs produce
    key = jax.random.PRNGKey(seed)
    for row in jgen.phase_schedule(jgen.FOUR_PHASES, 1):
        want = jgen._generation_step(key, jnp.asarray(pop),
                                     jnp.asarray(scores), jnp.asarray(cards),
                                     *map(jnp.float32, row))
        got = genetic._generation_step(
            _tkey(key)[None], _t(pop).long()[None], _t(scores)[None],
            _t(cards), *map(torch.tensor, row))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_uniform_genomes_and_hamming_select_equal():
    space = jget_space("rram")
    cards = space.cardinalities.astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        jg = jsamp.uniform_genomes(key, jnp.asarray(cards), 60)
        tg = sampling.uniform_genomes(_tkey(key)[None], _t(cards), 60)
        assert np.array_equal(tg[0].numpy(), np.asarray(jg))
        for n_valid in (None, 17):
            want = jsamp.hamming_select(
                jg, 20, None if n_valid is None else jnp.int32(n_valid))
            got = sampling.hamming_select(
                tg, 20, None if n_valid is None else torch.tensor([n_valid]))
            assert np.array_equal(got[0].numpy(), np.asarray(want))


def test_sample_initial_device_equal_with_capacity_mask():
    jspace, jscore, jfeas, space, score, feas = _edap_scorers()
    cards = jspace.cardinalities.astype(np.float32)
    keys = [jax.random.PRNGKey(s) for s in (0, 3)]
    lanes = genetic.lanes_of(feas)
    got = sampling.sample_initial_device(
        torch.stack([_tkey(k) for k in keys]), _t(cards), 40, 16,
        feasible_fn=lanes)
    for i, k in enumerate(keys):
        want = jsamp.sample_initial_device(k, jnp.asarray(cards), 40, 16,
                                           feasible_fn=jfeas)
        assert np.array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("mem", ["rram", "sram"])
def test_batched_search_same_genomes(mem):
    """The whole scheduled search (sampling + 4-phase GA), two seeds as
    one lane batch: identical best genomes and final populations, scores
    and histories to float tolerance."""
    jspace, jscore, jfeas, space, score, feas = _edap_scorers(mem)
    kw = dict(p_h=40, p_e=16, p_ga=8, generations_per_phase=2)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in (0, 1)])
    want = jgen.batched_joint_search(
        jkeys, jspace, jscore, feasible_fn=jfeas if mem == "rram" else None,
        **kw)
    got = genetic.batched_joint_search(
        _tkey(jkeys), space, score, feasible_fn=feas if mem == "rram"
        else None, **kw)
    np.testing.assert_array_equal(got.best_genomes, want.best_genomes)
    np.testing.assert_array_equal(got.populations, want.populations)
    np.testing.assert_allclose(got.best_scores, want.best_scores, rtol=1e-5)
    np.testing.assert_allclose(got.histories, want.histories, rtol=1e-5)


def test_ga_scan_active_mask_freezes_padded_rows():
    _, _, _, space, score, _ = _edap_scorers("sram")
    cards = genetic.cards_of(space, "cpu")
    sched = torch.as_tensor(genetic.phase_schedule(genetic.FOUR_PHASES, 1))
    keys = torch.stack([jr.PRNGKey(s) for s in (4, 5)])
    init = sampling.uniform_genomes(keys, cards, 8)
    lane = genetic.lanes_of(score)
    base = genetic.ga_scan(keys, init, cards, sched, lane)
    padded = torch.cat([sched, sched[:2]])
    active = torch.tensor([True] * 4 + [False] * 2)
    out = genetic.ga_scan(keys, init, cards, padded, lane, active=active)
    assert torch.equal(out[0], base[0]) and torch.equal(out[3], base[3])
    assert torch.equal(out[2][:, -1], base[2][:, -1])


def test_plain_ga_search_same_best_genome():
    """The non-modified GA baseline (random init, one phase)."""
    jspace, jscore, _, space, score, _ = _edap_scorers("sram")
    key = jax.random.PRNGKey(9)
    want = jgen.plain_ga_search(key, jspace, jscore, p_ga=8,
                                total_generations=3)
    got = genetic.plain_ga_search(_tkey(key), space, score, p_ga=8,
                                  total_generations=3)
    np.testing.assert_array_equal(got.best_genome, want.best_genome)
    np.testing.assert_allclose(got.history, want.history, rtol=1e-5)


@pytest.mark.parametrize("seed", range(3))
def test_run_ga_loop_matches_reference(seed):
    """The host-driven GA loop: the reference's ``run_ga_loop`` and the
    port's on the same key, initial population and an integer-valued
    scorer (exact on both sides, with ties) give the same best genome,
    history and final population bit for bit; the port's one-lane
    ``run_ga`` (its device route, ``ga_scan``) gives the loop's."""
    space = jget_space("rram")
    w = np.arange(1, space.n_params + 1, dtype=np.float32)

    def jscore(g):
        return jnp.sum((g.astype(jnp.float32) % 3.0) * w, axis=1)

    def tscore(g):
        return ((g.float() % 3.0) * torch.from_numpy(w)).sum(dim=-1)

    pop = _genomes(space, 12, seed)
    key = jax.random.PRNGKey(seed)
    want = jgen.run_ga_loop(key, space, jscore, jnp.asarray(pop),
                            jgen.FOUR_PHASES, 2)
    got = genetic.run_ga_loop(_tkey(key), space, tscore, _t(pop).long(),
                              genetic.FOUR_PHASES, 2)
    np.testing.assert_array_equal(got.best_genome, want.best_genome)
    assert got.best_score == want.best_score
    np.testing.assert_array_equal(got.history, want.history)
    np.testing.assert_array_equal(got.population, want.population)
    np.testing.assert_array_equal(got.scores, want.scores)
    scan = genetic.run_ga(_tkey(key), space, tscore, _t(pop).long(),
                          genetic.FOUR_PHASES, 2)
    np.testing.assert_array_equal(scan.best_genome, got.best_genome)
    np.testing.assert_array_equal(scan.population, got.population)
    np.testing.assert_array_equal(scan.history, got.history)


def test_random_genomes_equal():
    space = jget_space("sram")
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(
        sampling.random_genomes(_tkey(key), space, 50).numpy(),
        np.asarray(jsamp.random_genomes(key, space, 50)))


# names of the reference the port still owes, by ROADMAP Queue 1 item:
# "package" -> its missing submodules, "package.module" -> the functions
# and classes that module defines and the port's lacks
OWED = {
    "launch": {"dryrun": "13i"},
}


@pytest.mark.parametrize("pkg", ["core", "experiments", "kernels", "models",
                                 "serve", "train", "data", "checkpoint",
                                 "launch", "parallel"])
def test_port_has_every_public_name_of_the_reference(pkg):
    """Every public name of ``repro.<pkg>`` (its re-exports and
    submodules) exists in the port's package, and module by module every
    function and class a reference module defines exists in the port's
    module of that name, except the names ``OWED`` lists by ROADMAP
    item."""
    import importlib
    import inspect
    import pkgutil
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    owed = OWED.get(pkg, {})
    names = {n for n in dir(ref) if not n.startswith("_")}
    assert sorted(n for n in names if not hasattr(port, n)
                  and n not in owed) == []
    for info in pkgutil.iter_modules(ref.__path__):
        if info.name in owed:
            continue
        rmod = importlib.import_module(f"repro.{pkg}.{info.name}")
        pmod = importlib.import_module(f"repro_torch.{pkg}.{info.name}")
        mine = OWED.get(f"{pkg}.{info.name}", {})
        defined = [n for n, obj in vars(rmod).items()
                   if not n.startswith("_") and (inspect.isfunction(obj)
                                                 or inspect.isclass(obj))
                   and obj.__module__ == rmod.__name__]
        assert sorted(n for n in defined if not hasattr(pmod, n)
                      and n not in mine) == [], info.name
    # an owed name the port has by now comes off the list
    for name in owed:
        assert not hasattr(port, name) and importlib.util.find_spec(
            f"repro_torch.{pkg}.{name}") is None, name


def test_kernel_oracles_match_the_reference():
    """``kernels.ref``: the plain versions under the reference's oracle
    names and signatures, against its jnp oracles on the same inputs
    (float32 sums in other orders: rtol 1e-5; the ADC codes equal)."""
    from repro.kernels import ref as jref
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    x_q = rng.integers(0, 256, (4, 512)).astype(np.int32)
    w = rng.uniform(-1, 1, (512, 8)).astype(np.float32)
    np.testing.assert_allclose(
        ref.imc_matmul_ref(_t(x_q), _t(w), xbar_rows=256).numpy(),
        np.asarray(jref.imc_matmul_ref(jnp.asarray(x_q), jnp.asarray(w),
                                       xbar_rows=256)), rtol=1e-5)
    eps = [rng.standard_normal((512, 8)).astype(np.float32)
           for _ in range(2)]
    np.testing.assert_allclose(
        ref.imc_fused_ref(_t(x_q), _t(w), _t(eps[0]), _t(eps[1]), 128.0,
                          sub=64).numpy(),
        np.asarray(jref.imc_fused_ref(jnp.asarray(x_q), jnp.asarray(w),
                                      *map(jnp.asarray, eps), 128.0,
                                      sub=64)), rtol=1e-5, atol=1e-3)
    q, k, v = (rng.standard_normal((3, 20, 16)).astype(np.float32)
               for _ in range(3))
    for causal, window in ((True, 0), (False, 0), (True, 5)):
        np.testing.assert_allclose(
            ref.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                              window=window).numpy(),
            np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                          causal=causal, window=window)),
            atol=2e-6)


def test_conductance_noise_and_flat_index_match_the_reference():
    """``apply_conductance_noise`` draws the reference's normals from the
    same key (rtol 1e-6: the sigma polynomial's float32 rounding);
    ``genome_flat_index`` is the reference's index; the removed
    ``make_sharded_scorer`` raises ImportError in both packages."""
    from repro.core import distributed as jdist
    from repro.core import nonideal as jni
    from repro_torch.core import distributed, nonideal
    key = jax.random.PRNGKey(3)
    g = np.random.default_rng(1).uniform(0, 1, (64, 9)).astype(np.float32)
    np.testing.assert_allclose(
        nonideal.apply_conductance_noise(_tkey(key), _t(g)).numpy(),
        np.asarray(jni.apply_conductance_noise(key, jnp.asarray(g))),
        rtol=1e-6, atol=1e-7)
    space = jget_space("rram")
    pop = _genomes(space, 12, 0)
    np.testing.assert_array_equal(
        nonideal.genome_flat_index(get_space("rram"), _t(pop)).numpy(),
        np.asarray(jni.genome_flat_index(space, jnp.asarray(pop))))
    for mod in (jdist, distributed):
        with pytest.raises(ImportError, match="make_sharded_scorer"):
            mod.make_sharded_scorer()


def test_layer_norm_and_init_mlp_match_the_reference():
    from repro.models import layers as jlayers
    from repro_torch.models import layers
    rng = np.random.default_rng(2)
    x, s, b = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((3, 5, 16), (16,), (16,)))
    np.testing.assert_allclose(
        layers.layer_norm(_t(x), _t(s), _t(b)).numpy(),
        np.asarray(jlayers.layer_norm(*map(jnp.asarray, (x, s, b)))),
        atol=2e-6)
    for gated in (True, False):
        m = layers.init_mlp(torch.Generator().manual_seed(0), 16, 24, gated,
                            torch.float32)
        jm, _ = jlayers.init_mlp(jax.random.PRNGKey(0), 16, 24, gated,
                                 jnp.float32, 0)
        assert {n: tuple(p.shape) for n, p in m.named_parameters()} == \
            {n: tuple(a.shape) for n, a in jm.items()}
