"""The port's mixture-of-experts FFN (``repro_torch.models.moe``) and the
MoE archs phi3.5-moe and mixtral-8x22b end to end, against the JAX
package on the CPU, at their reduced configs (d 32, ff 64, 4 experts,
top-2), on the same numpy inputs and the reference's weights carried
across by ``convert``.

Bounds, each with its reason:
- the routing: the chosen experts, their order, the ranks within each
  expert and the dropped tokens equal the reference's bit for bit
  (including a zero router, where every probability ties and
  ``lax.top_k`` takes the lower indices), and so does the capacity;
- ``moe_ffn``'s y: within 1e-5 of max|y| (float32; the expert products
  sum in other orders), aux rtol 1e-6; their gradients (``jax.grad`` of a
  fixed linear read-out of y plus aux) within 1e-5 of each gradient's
  largest entry;
- the models' logits (forward, prefill, three decode steps): atol 1e-4,
  as tests/test_torch_lm.py holds the dense archs; the loss rtol 1e-5
  and every gradient leaf within 1e-4 of its largest |g|, as
  tests/test_torch_train.py holds them; the engine's greedy tokens
  equal;
- the train-mode trunk with and without remat: the loss, aux and every
  gradient bit for bit (the block's aux is carried through
  ``torch.utils.checkpoint``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LMRequest as JLMRequest
from repro.api import ServeEngine as JServeEngine
from repro.configs import get_config as jget_config
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
from repro.models import prefill as jprefill
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models import (decode_step, forward, loss_fn, moe,
                                prefill)
from repro_torch.models.transformer import MOE_AUX_WEIGHT
from repro_torch.serve import LMRequest, ServeEngine

torch.set_num_threads(1)

MOE_ARCHS = ("phi3_5_moe", "mixtral_8x22b")
_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jloss = jax.jit(jloss_fn, static_argnums=(1,), static_argnames=("remat",))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_close(got, want, tol, what=""):
    """|got - want| within tol times want's largest entry."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

# (name, B, S, router scale, drop_free): "skewed" biases the router so
# that most tokens pick experts 0 and 1 and overflow them; "zero" ties
# every probability; "half" has T = 4 tokens at k = 2 and E = 4, so
# 1.25 k T / E = 2.5 and Python's round gives C = 2 (half to even)
FFN_CASES = [("skewed", 2, 9, 1.0, False), ("drop_free", 2, 9, 1.0, True),
             ("zero", 2, 5, 0.0, False), ("half", 1, 4, 1.0, False),
             ("decode", 4, 1, 1.0, True)]


def _ffn_weights(cfg, name, scale, seed):
    rng = np.random.default_rng(seed)
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    router = rng.standard_normal((d, E)).astype(np.float32) * scale
    if name == "skewed":
        router[:, :2] += 1.5
    return {"router": router,
            "gate": (rng.standard_normal((E, d, ff)) / d ** 0.5
                     ).astype(np.float32),
            "up": (rng.standard_normal((E, d, ff)) / d ** 0.5
                   ).astype(np.float32),
            "down": (rng.standard_normal((E, ff, d)) / ff ** 0.5
                     ).astype(np.float32)}


def _jax_route(w, x, k, C):
    """The reference's routing (``repro/models/moe.py:55-77``) in jnp:
    the expert indices (T, k) and each slot's row and keep mask."""
    E = w["router"].shape[1]
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ w["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    base = jnp.zeros((E,), jnp.int32)
    rows, keeps = [], []
    for slot in range(k):
        e_id = gate_idx[:, slot]
        onehot = jax.nn.one_hot(e_id, E, dtype=jnp.int32)
        rank = jnp.cumsum(onehot, axis=0) - onehot
        pos = jnp.sum(rank * onehot, axis=1) + base[e_id]
        base = base + jnp.sum(onehot, axis=0)
        keeps.append(np.asarray(pos < C))
        rows.append(np.asarray(jnp.where(pos < C, pos, C)))
    return np.asarray(gate_idx), rows, keeps


def _moe_module(cfg, w):
    m = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                     cfg.d_ff, cfg.n_experts, torch.float32)
    m.load_state_dict({n: _t(a) for n, a in w.items()})
    return m


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("name,B,S,scale,drop_free", FFN_CASES)
def test_moe_ffn_matches_reference(arch, name, B, S, scale, drop_free):
    """The routing bit for bit (experts, ranks, dropped tokens, the
    capacity), y and aux, and their gradients against ``jax.grad``."""
    cfg = get_config(arch, reduced=True)
    k, E = cfg.top_k, cfg.n_experts
    w = _ffn_weights(cfg, name, scale, seed=len(name) + B * S)
    rng = np.random.default_rng(B * S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    T = B * S
    C = moe.capacity(T, k, E, cfg.capacity_factor, drop_free)
    assert C == (T * k if drop_free else
                 int(max(1, round(cfg.capacity_factor * k * T / E))))
    if name == "half":
        assert cfg.capacity_factor * k * T / E == 2.5 and C == 2
    m = _moe_module(cfg, w)
    _, _, idx, slots = moe.route(m, _t(x).reshape(T, -1), k, C)
    j_idx, j_rows, j_keeps = _jax_route(w, x, k, C)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    for (_, rows, keep), jr, jk in zip(slots, j_rows, j_keeps):
        np.testing.assert_array_equal(rows.numpy(), jr)
        np.testing.assert_array_equal(keep.numpy(), jk)
    dropped = sum(int((~keep).sum()) for _, _, keep in slots)
    if name == "zero":
        assert (idx == torch.arange(k)).all()   # ties: the lower indices
    if name == "skewed":
        assert dropped > 0
    if drop_free:
        assert dropped == 0

    cot = rng.standard_normal(x.shape).astype(np.float32)

    def jread(p, xx):
        y, aux = jmoe.moe_ffn(p, xx, k, cfg.capacity_factor,
                              drop_free=drop_free)
        return jnp.sum(y * cot) + 0.3 * aux, (y, aux)
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    (_, (jy, jaux)), (jgw, jgx) = jax.value_and_grad(
        jread, argnums=(0, 1), has_aux=True)(jw, jnp.asarray(x))
    m.requires_grad_(True)
    tx = _t(x).requires_grad_(True)
    y, aux = moe.moe_ffn(m, tx, k, cfg.capacity_factor, drop_free=drop_free)
    _rel_close(y, jy, 1e-5, "y")
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert y.dtype == tx.dtype and aux.dtype == torch.float32
    read = torch.sum(y * _t(cot)) + 0.3 * aux
    names = ("router", "gate", "up", "down")
    grads = torch.autograd.grad(read, [tx] + [getattr(m, n) for n in names])
    _rel_close(grads[0], jgx, 1e-5, "x")
    for n, g in zip(names, grads[1:]):
        _rel_close(g, jgw[n], 1e-5, n)


def test_top_k_ties_go_to_the_lower_index():
    """``top_k_lower_index`` against ``lax.top_k`` on rows full of ties
    (values from a handful of levels): the same values and indices."""
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (200, 8)).astype(np.float32) / 4
    for k in (1, 2, 3):
        vals, idx = moe.top_k_lower_index(_t(probs), k)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_router_stays_float32_in_a_bf16_model():
    """A bf16 config's MoE FFN: the router float32, the experts bf16; y
    comes back in x's type."""
    cfg = get_config("phi3_5_moe", reduced=True)
    m = moe.init_moe(torch.Generator().manual_seed(0), cfg.d_model,
                     cfg.d_ff, cfg.n_experts, torch.bfloat16)
    assert m.router.dtype == torch.float32
    assert {m.gate.dtype, m.up.dtype, m.down.dtype} == {torch.bfloat16}
    assert m.gate.shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)
    assert m.down.shape == (cfg.n_experts, cfg.d_ff, cfg.d_model)
    x = torch.randn((2, 3, cfg.d_model)).bfloat16()
    y, aux = moe.moe_ffn(m, x, cfg.top_k)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


# ---------------------------------------------------------------------------
# the MoE archs end to end
# ---------------------------------------------------------------------------

def _reference_weights(jcfg, seed=0):
    """The reference's init with its zero leaves (norm gains) replaced
    by small draws, so every parameter matters; numpy."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def _pair(arch):
    jcfg = jget_config(arch, reduced=True)
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    return jcfg, np_params, model, cfg


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_matches_reference(arch):
    """forward (train), the loss with its aux term, prefill and three
    decode steps (drop-free routing) on the same weights and tokens;
    mixtral's 20 tokens wrap its 16-slot window."""
    jcfg, np_params, model, cfg = _pair(arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _, jaux = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              remat=False)
    got, _, aux = forward(model, cfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0
    jl, jparts = _jloss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(toks)},
                        remat=False)
    tl, parts = loss_fn(model, cfg, {"tokens": _t(toks).long(),
                                     "labels": _t(toks).long()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]),
                               rtol=1e-5)
    cache_len = 24
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              cache_len)
    last, cache = prefill(model, cfg, {"tokens": _t(toks).long()},
                          cache_len)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    pos = np.array([20, 20], np.int32)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        log, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                 _t(pos).long())
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        pos = pos + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_engine_matches_reference(arch):
    """The port's ServeEngine and the JAX one on the same weights and
    requests (more requests than slots, ragged prompts, each prefilled
    alone at batch 1): the same greedy tokens."""
    jcfg, np_params, model, cfg = _pair(arch)
    jp = jax.tree.map(jnp.asarray, np_params)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 22)]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=32)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=5))
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in want:
        assert got[i].output == want[i].output, i


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_and_gradients_match_reference(arch):
    """The loss (CE plus 0.01 aux) and every parameter's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, leaf by leaf
    through ``convert.to_reference_lm_tree``."""
    jcfg, np_params, model, cfg = _pair(arch)
    model.train()
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jbatch)
    tl, _ = loss_fn(model, cfg, {"tokens": _t(toks).long(),
                                 "labels": _t(toks).long()})
    named = list(model.named_parameters())
    grads = torch.autograd.grad(tl, [p for _, p in named])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = convert.to_reference_lm_tree(
        {n: g for (n, _), g in zip(named, grads)}, cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_j) == len(flat_t)
    for path, want in flat_j:
        _rel_close(flat_t[path], np.asarray(want, np.float32), 1e-4,
                   jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_carries_the_aux_loss(arch):
    """``loss_fn(remat=True)`` (each block under ``torch.utils.
    checkpoint``) and ``remat=False``: the same loss, the same nonzero
    aux and the same gradients, bit for bit; the aux term is in the
    loss."""
    cfg = get_config(arch, reduced=True)
    model = convert.from_reference_lm_params(
        _reference_weights(jget_config(arch, reduced=True)), cfg,
        device="cpu").train()
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 10)))
    batch = {"tokens": toks, "labels": toks}
    named = list(model.named_parameters())
    out = []
    for remat in (True, False):
        loss, parts = loss_fn(model, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, [p for _, p in named])
        out.append((loss, parts, grads))
    (l1, p1, g1), (l2, p2, g2) = out
    assert float(p1["aux"]) > 0
    assert torch.equal(l1, l2) and torch.equal(p1["aux"], p2["aux"])
    assert torch.equal(l1, p1["ce"] + MOE_AUX_WEIGHT * p1["aux"])
    for (n, _), a, b in zip(named, g1, g2):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_keeps_moe_leaves(dtype):
    """The reference's MoE leaves (``ffn.router``/``gate``/``up``/
    ``down``, stacked over depth) carried into the port and back equal
    the reference's; the router stays float32 in a bf16 model; the
    train state's Adam moments of the same leaves carry across."""
    import dataclasses
    jcfg = dataclasses.replace(jget_config("phi3_5_moe", reduced=True),
                               dtype=dtype)
    params, _ = jinit_params(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             params)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    ffn = model.blocks[0].ffn
    assert isinstance(ffn, moe.MoE) and ffn.router.dtype == torch.float32
    assert ffn.gate.dtype == cfg.torch_dtype
    back = convert.to_reference_lm_tree(dict(model.named_parameters()), cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(np_params)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_j) == len(flat_t)
    for path, want in flat_j:
        np.testing.assert_array_equal(flat_t[path], want,
                                      jax.tree_util.keystr(path))
    from repro.train import loop as jloop
    jstate = jloop.init_train_state(params)
    jstate = jax.tree.map(np.asarray, jstate)
    state = convert.from_reference_train_state(jstate, cfg, device="cpu")
    m_router = state.opt.m["blocks.1.ffn.router"]
    assert m_router.shape == (cfg.d_model, cfg.n_experts)
    assert set(state.opt.m) == {n for n, _ in model.named_parameters()}


def test_launch_train_runs_a_moe_arch(capsys):
    """``launch.train --arch phi3_5_moe --reduced`` takes the same code
    path as the dense archs: finite losses, a nonzero aux metric."""
    args = launch_train.parse_args(["--arch", "phi3_5_moe", "--reduced",
                                    "--steps", "2", "--batch", "2", "--seq",
                                    "16", "--device", "cpu"])
    _, state, step_fn, pipe = launch_train.setup(args,
                                                  torch.device("cpu"))
    for _ in range(2):
        state, m = step_fn(state, pipe.next_batch())
        assert np.isfinite(float(m["loss"])) and float(m["aux"]) > 0
    assert launch_train.main(["--arch", "phi3_5_moe", "--reduced",
                              "--steps", "2", "--batch", "2", "--seq", "16",
                              "--device", "cpu"]) == 0
    assert "done at step 2" in capsys.readouterr().out
