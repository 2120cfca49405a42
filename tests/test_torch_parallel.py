"""The port's mesh and sharding layer (``repro_torch.parallel``,
``repro_torch.launch.mesh``, ``models.layers.spec_for``,
``models.param_specs``) against the JAX package's on the CPU; the
counterpart of tests/test_compression.py and tests/test_sharding.py.

Compression is held bit for bit to ``jax.jit`` of each reference
function (the form XLA compiles: the division by 127 a product, the
residual one fused multiply-add) and to the eager reference within one
ULP of the scale and one quantisation step. ``compressed_grad_mean``
runs over gloo in 2 and 4 spawned CPU processes (a file store under
``tmp_path``, a join timeout, so a hang fails one test): bit for bit
what the reference's psums give across devices, and within rtol 1e-6 of
the reference under ``jax.vmap`` with an axis name on one device. The
specs are data: equal to the reference's ``PartitionSpec``s, unstacked,
for every full arch; the 2 x 2 gloo mesh places a cache by them."""
import multiprocessing as mp
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from conftest import tiny_config
from repro.configs import ARCH_IDS, get_config as jget_config
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models.transformer import init_cache as jinit_cache
from repro.parallel import compression as jcomp
from repro.parallel import sharding as jsharding
from repro_torch.configs import get_config
from repro_torch.convert import from_reference_arch_config
from repro_torch.launch.mesh import (Mesh, current_mesh, make_host_mesh,
                                     make_production_mesh, mesh_context)
from repro_torch.models import init_cache, init_params, param_specs
from repro_torch.models.layers import spec_for
from repro_torch.parallel import compression as comp
from repro_torch.parallel.sharding import (NamedSharding, P,
                                           batch_partition_spec,
                                           cache_specs, input_specs_tree,
                                           place, shardings_from_specs,
                                           zero1_specs)

JOIN_TIMEOUT_S = 60


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(jspec):
    """A reference spec as the port's (one-name tuples normalised)."""
    return P(*tuple(jspec))


# vector lengths of the compression tests: a few, so that the reference
# compiles each function once a length
_LENGTHS = (1, 7, 1000, 4097)


def _grad(rng, n=None):
    """A gradient-like float32 vector of one of ``_LENGTHS`` (or n):
    normals at a magnitude drawn in 1e-8..1e3."""
    n = int(rng.choice(_LENGTHS)) if n is None else n
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 3)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

_jcompress = jax.jit(jcomp.compress_int8)
_jdecompress = jax.jit(jcomp.decompress_int8)
_jfeedback = jax.jit(jcomp.error_feedback_compress)


@pytest.mark.parametrize("seed", range(4))
def test_compress_int8_bitwise_jitted_reference(seed):
    """q and scale bit for bit ``jax.jit(compress_int8)`` over 50 vectors
    at magnitudes 1e-8..1e3 (ties and the 1e-12 floor among them: an
    all-zero vector, halves of the scale)."""
    rng = np.random.default_rng(seed)
    cases = [np.zeros(7, np.float32),
             np.array([127.0, 0.5, -1.5, 2.5, 63.5, 0.0, -127.0],
                      np.float32)]
    cases += [_grad(rng) for _ in range(48)]
    for x in cases:
        q, s = comp.compress_int8(_t(x))
        jq, js = _jcompress(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert s.numpy().tobytes() == np.asarray(js).tobytes()
        np.testing.assert_array_equal(
            comp.decompress_int8(q, s).numpy(),
            np.asarray(_jdecompress(jq, js)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_error_feedback_compress_bitwise_jitted_reference(dt):
    """q, scale and the new residual bit for bit ``jax.jit(
    error_feedback_compress)`` (its residual one rounding: XLA fuses the
    product and the difference) over 50 gradients and residuals, the
    gradient in ``dt``."""
    rng = np.random.default_rng(3)
    tdt, jdt = getattr(torch, dt), getattr(jnp, dt)
    for _ in range(50):
        g = _grad(rng)
        r = (rng.standard_normal(g.size) * np.abs(g).max() * 1e-3
             ).astype(np.float32)
        got = comp.error_feedback_compress(_t(g).to(tdt), _t(r))
        want = _jfeedback(jnp.asarray(g).astype(jdt), jnp.asarray(r))
        for a, b in zip(got, want):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_compression_within_one_step_of_eager_reference():
    """Against the reference run eagerly (a true division by 127, the
    residual's product rounded first) over 200 vectors: the scale within
    one ULP, q within one step, the residual within one scale."""
    rng = np.random.default_rng(4)
    for _ in range(200):
        g = _grad(rng)
        r = (rng.standard_normal(g.size) * np.abs(g).max() * 1e-3
             ).astype(np.float32)
        q, s, nr = comp.error_feedback_compress(_t(g), _t(r))
        jq, js, jnr = jcomp.error_feedback_compress(jnp.asarray(g),
                                                    jnp.asarray(r))
        js = np.float32(js)
        ulp = np.spacing(js)
        assert abs(np.float32(s) - js) <= ulp
        assert np.abs(q.numpy().astype(np.int32)
                      - np.asarray(jq).astype(np.int32)).max() <= 1
        assert np.abs(nr.numpy() - np.asarray(jnr)).max() <= js + ulp


def test_roundtrip_relative_error_small():
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    q, s = comp.compress_int8(_t(x))
    err = float((comp.decompress_int8(q, s) - _t(x)).abs().max())
    assert err <= float(s) * 0.5 + 1e-7
    assert q.dtype == torch.int8


def test_training_with_compressed_grads_converges():
    """SGD on a quadratic with int8 + error-feedback gradients reaches
    the optimum, as the reference's does."""
    w_true = torch.tensor([2.0, -1.0, 0.5, 3.0])
    w, r = torch.zeros(4), torch.zeros(4)
    for _ in range(300):
        q, s, r = comp.error_feedback_compress(w - w_true, r)
        w = w - 0.1 * comp.decompress_int8(q, s)
    np.testing.assert_allclose(w.numpy(), w_true.numpy(), atol=1e-2)


def test_init_residuals_zero_and_matching_structure():
    g = {"a": torch.ones((3, 2), dtype=torch.bfloat16),
         "b": {"c": torch.ones(5)}, "d": [torch.ones(2, 2), torch.ones(())]}
    r = comp.init_residuals(g)
    assert list(r) == ["a", "b", "d"] and list(r["b"]) == ["c"]
    assert isinstance(r["d"], list) and len(r["d"]) == 2
    leaves = [r["a"], r["b"]["c"], *r["d"]]
    assert [x.shape for x in leaves] == [(3, 2), (5,), (2, 2), ()]
    assert all(x.dtype == torch.float32 and x.device.type == "cpu"
               and not x.any() for x in leaves)
    jr = jcomp.init_residuals({"a": jnp.ones((3, 2)),
                               "b": {"c": jnp.ones(5)}})
    assert jr["a"].dtype == jnp.float32


# the gradient tree each rank holds in the all-reduce tests: nested dicts
# and lists, float32 and bfloat16 leaves, one leaf all zeros (the scale's
# floor)
_TREE_SHAPES = {"a": ((5, 7), "float32"),
                "b": [((13,), "bfloat16"), ((3, 2, 2), "float32")],
                "z": ((4,), "float32")}


def _rank_inputs(world, seed=0):
    """(grads, residuals) of every rank, numpy float32, in
    ``_TREE_SHAPES``' nesting (bf16 leaves rounded to bf16 values)."""
    rng = np.random.default_rng(seed)

    def draw(shape, dt, zero=False):
        g = np.zeros(shape, np.float32) if zero else \
            (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 1)
             ).astype(np.float32)
        if dt == "bfloat16":
            g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16)
                           .astype(jnp.float32))
        return g
    out = []
    for _ in range(world):
        grads = {"a": draw(*_TREE_SHAPES["a"]),
                 "b": [draw(*s) for s in _TREE_SHAPES["b"]],
                 "z": draw(*_TREE_SHAPES["z"], zero=True)}
        res = jax.tree.map(
            lambda x: (rng.standard_normal(x.shape) * 1e-4
                       ).astype(np.float32), grads)
        out.append((grads, res))
    return out


def _dtypes():
    return {"a": "float32", "b": ["bfloat16", "float32"], "z": "float32"}


def _spawn(job, world, tmp_path, payload):
    """Runs ``job`` in ``world`` spawned processes (gloo over a file store
    in ``tmp_path``), each reading ``payload`` and writing its result;
    fails if any is not done within JOIN_TIMEOUT_S. Returns the results
    by rank."""
    with open(tmp_path / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(job, r, world, str(tmp_path)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_TIMEOUT_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks hung"
    assert [p.exitcode for p in procs] == [0] * world, \
        [p.exitcode for p in procs]
    out = []
    for r in range(world):
        with open(tmp_path / f"out{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _worker(job, rank, world, tmp):
    """One rank: joins the gloo group, runs ``job`` on the payload, writes
    its result."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world)
    try:
        out = _JOBS[job](rank, world, payload)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _job_grad_mean(rank, world, payload):
    grads, res = payload["inputs"][rank]
    dts = payload["dtypes"]
    tg = jax.tree.map(lambda x, dt: torch.from_numpy(x).to(
        getattr(torch, dt)), grads, dts)
    tr = jax.tree.map(torch.from_numpy, res)
    mean, new_r = comp.compressed_grad_mean(tg, tr)
    return (jax.tree.map(lambda t: (str(t.dtype), t.float().numpy()), mean,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)),
            jax.tree.map(lambda t: t.numpy(), new_r,
                         is_leaf=lambda x: isinstance(x, torch.Tensor)))


def _job_cache_place(rank, world, payload):
    """make_host_mesh(model=2) over the 4 ranks; the cache placed by its
    cache_specs (batch over data, slots over model): each leaf's local
    shard and the mesh's coordinates of this rank."""
    mesh = make_host_mesh(model=2)
    cfg = payload["cfg"]
    cache = init_cache(cfg, payload["B"], payload["L"], device="cpu")
    g = torch.Generator().manual_seed(0)
    for blk in cache:       # distinct values, the same on every rank
        for t in blk.values():
            t.copy_(torch.randint(-100, 100, t.shape, generator=g))
    shards = cache_specs(mesh, cache, payload["B"], kv_seq_axis="model")
    placed = place(cache, shards)
    coords = mesh.device_mesh.get_coordinate()
    return {"shape": dict(mesh.shape), "coords": list(coords),
            "specs": [{k: tuple(s.spec) for k, s in blk.items()}
                      for blk in shards],
            "local": [{k: t.to_local().numpy() for k, t in blk.items()}
                      for blk in placed],
            "full": [{k: t.numpy() for k, t in blk.items()}
                     for blk in cache]}


_JOBS = {"grad_mean": _job_grad_mean, "cache_place": _job_cache_place}


def _per_device_mean(inputs, dts):
    """What the reference's psums compute on real devices: each rank's
    ``jax.jit(error_feedback_compress)``, the int32 sum of q, the float32
    sum of the rounded scales rank by rank, ``qsum * (ssum / n) / n``,
    cast to the leaf's type. Returns (means, residuals by rank)."""
    world = len(inputs)
    n = np.float32(world)
    per = [jax.tree.map(lambda g, r, dt: _jfeedback(
        jnp.asarray(g).astype(getattr(jnp, dt)), jnp.asarray(r)),
        grads, res, dts) for grads, res in inputs]
    is_out = lambda x: isinstance(x, tuple) and len(x) == 3  # noqa: E731

    def mean(dt, *outs):
        qsum = sum(np.asarray(q).astype(np.int32) for q, _, _ in outs)
        ssum = np.float32(0)
        for _, sc, _ in outs:
            ssum = np.float32(ssum + np.float32(sc))
        m = qsum.astype(np.float32) * (ssum / n) / n
        return np.asarray(jnp.asarray(m).astype(getattr(jnp, dt))
                          .astype(jnp.float32))
    means = jax.tree.map(mean, dts, *per)
    res = [jax.tree.map(lambda o: np.asarray(o[2]), p, is_leaf=is_out)
           for p in per]
    return means, res


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_grad_mean_matches_reference_over_gloo(world, tmp_path):
    """``compressed_grad_mean`` across ``world`` gloo ranks: every rank's
    mean (in its leaf's type) the same, and bit for bit what the
    reference's psums give on devices (``_per_device_mean``: at 2 ranks
    the scales' sum has one order; at 4, gloo adds them rank by rank);
    each rank's new residual bit for bit the jitted reference's. Against
    ``jax.jit(jax.vmap(compressed_grad_mean(..., "i"), axis_name="i"))``
    on one device, within rtol 1e-6: XLA fuses that program's scales into
    its sum (one scale unrounded in a fused multiply-add), which a sum
    across devices cannot do."""
    inputs = _rank_inputs(world, seed=world)
    dts = _dtypes()
    out = _spawn("grad_mean", world, tmp_path,
                 {"inputs": inputs, "dtypes": dts})
    stack = lambda i: jax.tree.map(  # noqa: E731
        lambda *xs: jnp.stack(xs), *[inp[i] for inp in inputs])
    jg = jax.tree.map(lambda x, dt: x.astype(getattr(jnp, dt)), stack(0),
                      dts)
    vmapped, _ = jax.jit(jax.vmap(
        lambda g, r: jcomp.compressed_grad_mean(g, r, "i"),
        axis_name="i"))(jg, stack(1))
    want_mean, want_res = _per_device_mean(inputs, dts)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    flat_w = jax.tree.leaves(want_mean)
    flat_v = jax.tree.leaves(vmapped)
    for rank, (mean, res) in enumerate(out):
        flat_m = jax.tree.leaves(mean, is_leaf=is_pair)
        assert [dt for dt, _ in flat_m] == [
            f"torch.{v.dtype}" for v in flat_v]
        for (_, got), want, vm in zip(flat_m, flat_w, flat_v):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(
                got, np.asarray(vm[rank]).astype(np.float32), rtol=1e-6)
        for got, want in zip(jax.tree.leaves(res),
                             jax.tree.leaves(want_res[rank])):
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

class _FakeMesh:
    """Production-shaped mesh stand-in (rule helpers only read .shape)."""
    shape = {"pod": 2, "data": 16, "model": 16}


def test_partition_spec_has_the_reference_equality():
    assert P(("pod", "data"), None) == P(("pod", "data"), None)
    assert P(None, None) != P(None)
    assert P(("data",), None) == P("data", None)
    assert hash(P(("data",), None)) == hash(P("data", None))
    for parts in ((("pod", "data"), None), (None, "model"), (("data",),),
                  ()):
        assert _spec(JP(*parts)) == P(*parts)
    assert repr(P(("pod", "data"), None)) == \
        "PartitionSpec(('pod', 'data'), None)"


@pytest.mark.parametrize("shape,dim,n", [
    ((64, 128), 1, 16), ((64, 128), 0, 16), ((64, 100), 1, 16),
    ((64, 128), None, 16), ((64, 128), 1, 0), ((7,), 0, 1), ((), None, 16),
    ((8, 64, 48), 2, 16)])
def test_spec_for_matches_reference(shape, dim, n):
    assert spec_for(shape, dim, n) == _spec(jlayers.spec_for(shape, dim, n))


def _reference_specs(jcfg, n_shards):
    """The reference's init_params specs, traced by ``jax.eval_shape``
    (no weights made), keyed by the port's parameter names: period
    leaves unstacked (their leading depth None dropped), ``rem`` blocks
    after them."""
    box = {}

    def build(k):
        p, s = jinit_params(k, jcfg, n_shards=n_shards)
        box["s"] = s
        return p
    jax.eval_shape(build, jax.random.PRNGKey(0))
    specs = box["s"]
    is_spec = lambda x: isinstance(x, JP)  # noqa: E731

    def flat(tree, prefix, out, drop):
        for k, v in tree.items():
            if is_spec(v):
                out[prefix + k] = P(*tuple(v)[drop:])
            else:
                flat(v, f"{prefix}{k}.", out, drop)
    out = {}
    flat({k: v for k, v in specs.items() if k not in ("period", "rem")},
         "", out, 0)
    pattern, n_full, rem = jcfg.schedule()
    for layer in range(n_full * len(pattern) + len(rem)):
        n, i = divmod(layer, len(pattern))
        if n < n_full:
            flat(specs["period"][f"pos{i}"], f"blocks.{layer}.", out, 1)
        else:
            flat(specs["rem"][layer - n_full * len(pattern)],
                 f"blocks.{layer}.", out, 0)
    return out


@pytest.mark.parametrize("n_shards", [0, 1, 16])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, n_shards):
    """``param_specs`` of every full arch equal to the reference's
    ``init_params`` specs, unstacked, leaf for leaf, and keyed by exactly
    the port's parameter names."""
    got = param_specs(get_config(arch), n_shards)
    want = _reference_specs(jget_config(arch), n_shards)
    assert sorted(got) == sorted(want)
    assert {k: v for k, v in got.items() if v != want[k]} == {}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_divisible_for_all_full_archs(arch):
    """Every dim the port's specs put on "model" divides by 16 (the
    production model axis), and each spec has its leaf's rank."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_config(arch)
    specs = param_specs(cfg, 16)
    with FakeTensorMode():
        shapes = {n: tuple(p.shape) for n, p in init_params(
            torch.Generator().manual_seed(0), cfg).named_parameters()}
    assert any("model" in s for s in specs.values())
    for name, spec in specs.items():
        assert len(spec) == len(shapes[name]), name
        for dim, part in zip(shapes[name], spec):
            if part == "model":
                assert dim % 16 == 0, (arch, name, shapes[name], spec)


def test_batch_partition_spec_divisibility():
    mesh = _FakeMesh()
    assert batch_partition_spec(mesh, 256, 1) == P(("pod", "data"), None)
    assert batch_partition_spec(mesh, 7, 1) == P(None, None)
    for b, extra in ((256, 1), (7, 1), (64, 3), (32, 0)):
        assert batch_partition_spec(mesh, b, extra) == _spec(
            jsharding.batch_partition_spec(mesh, b, extra))
    two = Mesh((16, 16), ("data", "model"))
    assert batch_partition_spec(two, 32, 2) == _spec(
        jsharding.batch_partition_spec(two, 32, 2)) == P("data", None, None)


def test_zero1_adds_data_axis():
    mesh = _FakeMesh()
    specs = {"w": P(None, "model"), "b": P(None), "e": P(None, None),
             "s": P()}
    shapes = {"w": torch.empty(64, 128), "b": torch.empty(3),
              "e": torch.empty(3, 32), "s": torch.empty(())}
    z = zero1_specs(specs, shapes, mesh, axis="data")
    assert z["w"] == P("data", "model")
    assert z["b"] == P(None)
    jz = jsharding.zero1_specs(
        {k: JP(*v) for k, v in specs.items()},
        {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
         for k, v in shapes.items()}, mesh, axis="data")
    assert z == {k: _spec(v) for k, v in jz.items()}
    assert zero1_specs(specs, shapes, Mesh((1, 1), ("data", "model"))) \
        == specs


def test_input_specs_tree_puts_the_batch_on_dim_0():
    mesh = _FakeMesh()
    batch = {"tokens": torch.zeros((64, 16), dtype=torch.long),
             "frames": torch.zeros((64, 16, 8)),
             "odd": [torch.zeros((5, 2))]}
    got = input_specs_tree(mesh, batch)
    assert got["tokens"].spec == P(("pod", "data"), None)
    assert got["frames"].spec == P(("pod", "data"), None, None)
    assert got["odd"][0].spec == P(None, None)
    assert got["tokens"].mesh is mesh


# caches of every block kind: dense GQA on the int8 cache, the RG-LRU
# hybrid with its local ring, xLSTM's states, the vision layers' cross
# cache
_CACHE_CASES = {
    "dense int8": dict(n_layers=2, kv_quant=True),
    "rglru hybrid": dict(pattern=("rglru", "rglru", "local_attn"),
                         n_layers=7, rnn_width=32, local_window=16,
                         family="hybrid"),
    "xlstm": dict(pattern=("slstm", "mlstm"), n_layers=4, family="ssm"),
    "vision": dict(pattern=("attn", "cross_attn"), n_layers=4,
                   frontend="vision", d_vision=24, n_img_tokens=6,
                   family="vlm"),
}


@pytest.mark.parametrize("kv_seq_axis", [None, "model"])
@pytest.mark.parametrize("case", sorted(_CACHE_CASES))
def test_cache_specs_match_reference_on_the_production_mesh(
        case, kv_seq_axis, monkeypatch):
    """The port's ``cache_specs`` on its per-layer cache against the
    reference's on its stacked one (``jax.eval_shape`` of its
    ``init_cache``; ``NamedSharding`` swapped for its spec so a
    production-shaped stand-in mesh serves): layer by layer, leaf by
    leaf, the reference's depth None dropped."""
    jcfg = tiny_config(**_CACHE_CASES[case])
    cfg = from_reference_arch_config(jcfg)
    B, L = 32, 32
    monkeypatch.setattr(jsharding, "NamedSharding", lambda mesh, spec: spec)
    mesh = _FakeMesh()
    want = jsharding.cache_specs(
        mesh, jax.eval_shape(lambda: jinit_cache(jcfg, B, L)), B,
        kv_seq_axis=kv_seq_axis)
    got = cache_specs(mesh, init_cache(cfg, B, L, device="cpu"), B,
                      kv_seq_axis=kv_seq_axis)
    pattern, n_full, rem = jcfg.schedule()
    assert len(got) == n_full * len(pattern) + len(rem)
    for layer, blk in enumerate(got):
        n, i = divmod(layer, len(pattern))
        ref = (want["period"][f"pos{i}"] if n < n_full
               else want["rem"][layer - n_full * len(pattern)])
        drop = 1 if n < n_full else 0
        assert sorted(blk) == sorted(ref)
        for k, s in blk.items():
            assert s.spec == P(*tuple(ref[k])[drop:]), (layer, k)
            assert s.mesh is mesh
    for blk in got:         # B divides by pod x data: every leaf's dim 0
        assert all(sh.spec[0] == ("pod", "data") for sh in blk.values())
        if "pos" in blk:    # a self-attention cache: its slots
            assert blk["k"].spec[1] == kv_seq_axis


def test_named_sharding_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_production_mesh(multi_pod=True)
    s = NamedSharding(mesh, P(("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert NamedSharding(mesh, P(None)).placements == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        NamedSharding(mesh, P(("data", "pod"))).placements
    with pytest.raises(ValueError, match="no mesh axis"):
        NamedSharding(make_production_mesh(), P("pod")).placements
    with pytest.raises(RuntimeError, match="no devices"):
        s.place(torch.zeros(4, 2, 16))


def test_meshes_as_the_reference_shapes_them():
    """The production meshes' axes and sizes; the host mesh 1 x 1 in a
    process without a process group; ``mesh_context`` scopes
    ``current_mesh``."""
    from repro.launch import mesh as jmesh
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        assert m.axis_names == (("pod", "data", "model") if multi
                                else ("data", "model"))
        assert m.shape == ({"pod": 2, "data": 16, "model": 16} if multi
                           else {"data": 16, "model": 16})
        assert m.size == (512 if multi else 256)
    host = make_host_mesh()
    want = jmesh.make_host_mesh()
    assert host.shape == dict(want.shape) == {"data": 1, "model": 1}
    assert host.device_mesh is None and host.size == 1
    assert current_mesh() is None
    with mesh_context(host) as m:
        assert m is host and current_mesh() is host
        with mesh_context(make_production_mesh()):
            assert current_mesh().size == 256
        assert current_mesh() is host
    assert current_mesh() is None


def test_cache_specs_place_a_cache_on_the_host_mesh():
    """On the 1 x 1 host mesh every leaf of a real cache gets a sharding
    and placing leaves each tensor as it is."""
    cfg = from_reference_arch_config(tiny_config(
        pattern=("rglru", "rglru", "local_attn"), n_layers=6, rnn_width=32,
        local_window=8))
    mesh = make_host_mesh()
    cache = init_cache(cfg, 2, 16, device="cpu")
    shards = cache_specs(mesh, cache, 2)
    placed = place(cache, shards)
    assert len(placed) == len(cache)
    for blk, pblk, sblk in zip(cache, placed, shards):
        assert sorted(pblk) == sorted(blk) == sorted(sblk)
        assert all(pblk[k] is blk[k] for k in blk)
        assert all(isinstance(s, NamedSharding) for s in sblk.values())


def test_cache_specs_place_a_cache_over_a_2x2_gloo_mesh(tmp_path):
    """4 gloo ranks, ``make_host_mesh(model=2)`` (2 x 2): the cache of a
    hybrid config placed by ``cache_specs`` (batch over data, the slots
    over model): each rank's local shard of each leaf is the slice of the
    whole that its spec and its mesh coordinates name."""
    cfg = from_reference_arch_config(tiny_config(
        pattern=("rglru", "local_attn"), n_layers=2, rnn_width=32,
        local_window=8, kv_quant=True, family="hybrid"))
    out = _spawn("cache_place", 4, tmp_path, {"cfg": cfg, "B": 4, "L": 16})
    seen = set()
    for res in out:
        assert res["shape"] == {"data": 2, "model": 2}
        coords = dict(zip(("data", "model"), res["coords"]))
        seen.add(tuple(res["coords"]))
        for specs, local, full in zip(res["specs"], res["local"],
                                      res["full"]):
            for k, spec in specs.items():
                want = full[k]
                for d, part in enumerate(spec):
                    if part is None:
                        continue
                    size = want.shape[d] // 2
                    i = coords[part]
                    want = np.take(want, range(i * size, (i + 1) * size),
                                   axis=d)
                np.testing.assert_array_equal(local[k], want)
        assert out[0]["specs"][1]["k"] == ("data", "model", None, None)
        assert out[0]["specs"][0]["h"] == ("data", None)
    assert seen == {(0, 0), (0, 1), (1, 0), (1, 1)}


def test_sharded_train_step_on_host_mesh_is_the_unplaced_step():
    """On the 1 x 1 host mesh, under ``mesh_context``: parameters placed by
    ``shardings_from_specs(param_specs)`` and a batch by
    ``input_specs_tree`` train one step bit for bit as the same model and
    batch unplaced."""
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.train.loop import init_train_state, make_train_step
    cfg = from_reference_arch_config(tiny_config(n_layers=2))
    mesh = make_host_mesh()
    finals = []
    for placed in (False, True):
        model = init_params(torch.Generator().manual_seed(0), cfg)
        batch = {k: torch.as_tensor(v).long() for k, v in
                 SyntheticTokenPipeline(cfg, 4, 16).next_batch().items()}
        if placed:
            with mesh_context(mesh):
                specs = param_specs(cfg, mesh.shape["model"])
                named = dict(model.named_parameters())
                params = place(named, shardings_from_specs(mesh, specs))
                assert all(params[k] is named[k] for k in named)
                batch = place(batch, input_specs_tree(mesh, batch))
        state = init_train_state(model)
        state, m = make_train_step(cfg, total_steps=10)(state, batch)
        assert np.isfinite(float(m["loss"]))
        finals.append({k: p.detach().clone()
                       for k, p in state.params.named_parameters()})
    assert all(torch.equal(finals[0][k], finals[1][k]) for k in finals[0])
