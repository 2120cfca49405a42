"""The port's LM serving stack (``repro_torch.models``, ``serve``) against
the JAX package on the CPU, on the same numpy inputs and weights: the
layers (rtol 1e-6), attention (atol 2e-5, the tests/test_kernels.py
float32 bound), the whole model's forward / prefill / decode logits on
the reduced dense archs with the reference's weights carried across by
``convert.from_reference_lm_params`` (atol 1e-4), and the serving
engine's greedy tokens (equal). Plus the port's counterparts of
tests/test_serve.py. The attention runs through the flash kernel's
plain version here (CPU tensors); tests/test_torch_gpu.py holds the
kernel to it on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import LMRequest as JLMRequest
from repro.api import ServeEngine as JServeEngine
from repro.configs import get_config as jget_config
from repro.models import ArchConfig as JArchConfig
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import (from_reference_arch_config,
                                 from_reference_lm_params)
from repro_torch.models import (attention, decode_step, forward,
                                init_params, layers, loss_fn, prefill)
from repro_torch.models.layers import MLP
from repro_torch.serve import LMRequest, ServeEngine

torch.set_num_threads(1)

DENSE_ARCHS = ("qwen3_4b", "qwen2_5_3b", "glm4_9b", "phi4_mini_3_8b")
# the reference's model functions, compiled whole (one XLA compile per
# config instead of one per eager op)
_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jloss = jax.jit(jloss_fn, static_argnums=(1,), static_argnames=("remat",))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3.0
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    _close(layers.rms_norm(_t(x), _t(scale), 1e-6),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           rtol=1e-6)


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_apply_rope_matches_reference(theta):
    """Split halves (not interleaved pairs), positions with an offset."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [40]])).astype(np.int32)
    _close(layers.apply_rope(_t(x), _t(pos), theta),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_reference(gated):
    """SwiGLU, and GELU with the tanh approximation (jax.nn.gelu's
    default)."""
    rng = np.random.default_rng(2)
    d, ff = 12, 20
    x = rng.standard_normal((3, 4, d)).astype(np.float32)
    w = {n: (rng.standard_normal(s) * 0.3).astype(np.float32) for n, s in
         (("up", (d, ff)), ("gate", (d, ff)), ("down", (ff, d)))}
    if not gated:
        del w["gate"]
    p = MLP(torch.Generator().manual_seed(0), d, ff, gated, torch.float32)
    p.load_state_dict({n: _t(a) for n, a in w.items()})
    want = jlayers.mlp({n: jnp.asarray(a) for n, a in w.items()},
                       jnp.asarray(x))
    _close(layers.mlp(p, _t(x)), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 2
    labels = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(_t(logits), _t(labels),
                               None if mask is None else _t(mask))
    _close(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window,q_offset", [
    (2, 37, 37, 4, 2, 16, True, 0, 0),      # GQA, ragged length
    (1, 48, 48, 6, 2, 8, True, 12, 0),      # sliding window
    (1, 700, 700, 2, 1, 8, True, 200, 0),   # window across plain chunks
    (2, 9, 30, 4, 4, 8, True, 0, 21),       # prefill continuation
    (1, 20, 33, 4, 1, 32, False, 0, 0),     # bidirectional, GQA
])
def test_blockwise_attention_matches_reference(B, S, T, H, KV, hd, causal,
                                               window, q_offset):
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset)
    got = attention.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                        window=window, q_offset=q_offset)
    assert got.shape == (B, S, H, hd)
    _close(got, want, atol=2e-5)


def test_expand_kv_is_repeat_interleave():
    """Query heads 0..G-1 read KV head 0 (jnp.repeat), not head h % KV."""
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = attention._expand_kv(_t(x), 6)
    _close(got, jattn._expand_kv(jnp.asarray(x), 6))
    assert torch.equal(got[:, :, 2], _t(x)[:, :, 0])


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(4 + window)
    B, T, H, KV, hd = 3, 12, 4, 2, 8
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    vc = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    kv_pos = np.tile(np.arange(T), (B, 1)).astype(np.int32)
    kv_pos[1, 7:] = -1                       # empty slots
    q_pos = np.array([11, 6, 9], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(kv_pos),
                                  jnp.asarray(q_pos), window=window)
    got = attention.decode_attention(_t(q), _t(kc), _t(vc), _t(kv_pos),
                                     _t(q_pos), window=window)
    _close(got, want, atol=2e-5)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _reference_weights(jcfg, seed=0):
    """The reference's init, with its zero leaves (norm gains, biases)
    replaced by small draws so that every parameter matters; numpy."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def _pair(jcfg):
    """(reference weights as jnp, the port's LM on the CPU, port cfg)."""
    np_params = _reference_weights(jcfg)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(np_params, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, np_params), model, cfg


def _windowed_config(**kw):
    """A tiny config with a local_attn layer and a windowed attn layer
    (3 layers over a 2-kind pattern, so the reference has a ``rem``)."""
    base = dict(name="tiny_local", family="hybrid", n_layers=3, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                vocab_size=101, dtype="float32",
                pattern=("attn", "local_attn"), local_window=4, window=6)
    base.update(kw)
    return JArchConfig(**base)


MODEL_CASES = [*DENSE_ARCHS, "windowed"]


def _jcfg(name):
    return _windowed_config() if name == "windowed" else jget_config(
        name, reduced=True)


@pytest.mark.parametrize("name", MODEL_CASES)
def test_model_matches_reference(name):
    """forward (train), the loss, prefill and three decode steps: logits
    within atol 1e-4 on the same weights and tokens."""
    jcfg = _jcfg(name)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)

    want, _, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                          remat=False)
    got, _, _ = forward(model, cfg, {"tokens": _t(toks).long()})
    _close(got, want, atol=1e-4)
    jl, _ = _jloss(jp, jcfg, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(toks)}, remat=False)
    tl, _ = loss_fn(model, cfg, {"tokens": _t(toks).long(),
                                 "labels": _t(toks).long()})
    _close(tl, jl, rtol=1e-5)

    cache_len = 16
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                             cache_len)
    last, cache = prefill(model, cfg, {"tokens": _t(toks).long()}, cache_len)
    _close(last, jlast, atol=1e-4)
    pos = np.array([11, 11], np.int32)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                    jnp.asarray(pos))
        log, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                 _t(pos).long())
        _close(log, jlog, atol=1e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        pos = pos + 1
    # the cache itself: first layer's keys and slot positions
    jk = jcache["period"]["pos0"]["k"][0]
    _close(cache[0]["k"], jk, atol=1e-4)
    np.testing.assert_array_equal(cache[0]["pos"].numpy(),
                                  np.asarray(jcache["period"]["pos0"]["pos"][0]))


def test_qkv_bias_matches_reference_in_logits_and_gradients():
    """Reduced qwen2.5-3b with its ``bq``, ``bk``, ``bv`` drawn non-zero by
    numpy from a seed (standard normals, the scale of the projections'
    outputs; the init's zeros would add nothing), the other leaves the
    reference's init, carried into both packages: forward, prefill and
    three decode steps' logits within atol 1e-4; the loss within rtol
    1e-5 and every gradient leaf, the bias leaves among them (three,
    stacked over the two layers), within 2e-5 of its largest |g| of
    ``jax.value_and_grad``'s."""
    from repro_torch.convert import to_reference_lm_tree
    jcfg = jget_config("qwen2_5_3b", reduced=True)
    params, _ = jinit_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.array, params)
    rng = np.random.default_rng(33)
    biases = []
    for blk in np_params["period"].values():
        for name in ("bq", "bk", "bv"):
            blk[name] = rng.standard_normal(blk[name].shape).astype(
                blk[name].dtype)
            biases.append(blk[name])
    assert len(biases) == 3 and all(np.all(b != 0) for b in biases)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(np_params, cfg, device="cpu")
    jp = jax.tree.map(jnp.asarray, np_params)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    batch = {"tokens": _t(toks).long(), "labels": _t(toks).long()}
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}

    want, _, _ = _jforward(jp, jcfg, jbatch, remat=False)
    _close(forward(model, cfg, batch)[0], want, atol=1e-4)
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    last, cache = prefill(model, cfg, {"tokens": batch["tokens"]}, 16)
    _close(last, jlast, atol=1e-4)
    pos = np.array([11, 11], np.int32)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        log, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                 _t(pos).long())
        _close(log, jlog, atol=1e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        pos = pos + 1

    model.train()
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jloss_fn(q, jcfg, b), has_aux=True))(jp, jbatch)
    tl, _ = loss_fn(model, cfg, batch)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(tl, [q for _, q in named])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = to_reference_lm_tree({n: g for (n, _), g in zip(named, grads)},
                               cfg)
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat_j) == len(flat_t)
    seen = set()
    for path, want in flat_j:
        want = np.asarray(want, np.float32)
        name = jax.tree_util.keystr(path)
        err = float(np.abs(flat_t[path] - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()), (name, err)
        if name.split("'")[-2] in ("bq", "bk", "bv"):
            assert np.abs(want).max() > 0, name
            seen.add(name)
    assert len(seen) == 3


@pytest.mark.parametrize("name", MODEL_CASES)
def test_engine_matches_reference(name):
    """The port's ServeEngine and the JAX ServeEngine, on the same
    weights and requests (more requests than slots, ragged prompts, one
    request retired by max_len - 1): the same greedy tokens."""
    jcfg = _jcfg(name)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 26)]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=32)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=5))
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in want:
        assert got[i].output == want[i].output, i
    assert len(got[3].output) == 32 - 1 - 26   # retired at max_len - 1
    st = eng.stats
    assert st["prefill_tokens"] == sum(len(p) for p in prompts)
    assert st["decode_tokens"] == sum(len(r.output) - 1 for r in got.values())


# ---------------------------------------------------------------------------
# tests/test_serve.py's checks, on the port alone
# ---------------------------------------------------------------------------

def _tiny(**kw):
    base = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                vocab_size=101, dtype="float32")
    base.update(kw)
    return from_reference_arch_config(JArchConfig(**base))


def _tiny_model(**kw):
    cfg = _tiny(**kw)
    return init_params(torch.Generator().manual_seed(0), cfg), cfg


def _greedy_reference(model, cfg, prompt, n_new):
    last, cache = prefill(model, cfg, {"tokens": _t(prompt)[None].long()},
                          cache_len=128)
    out = [int(torch.argmax(last[0]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, cache = decode_step(model, cfg, torch.tensor([[out[-1]]]),
                                    cache, torch.tensor([pos]))
        out.append(int(torch.argmax(logits[0])))
        pos += 1
    return out


def test_engine_matches_single_request_reference():
    model, cfg = _tiny_model()
    prompt = np.arange(7, dtype=np.int32) % cfg.vocab_size
    ref = _greedy_reference(model, cfg, prompt, 6)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=128, device="cpu")
    eng.submit(LMRequest(rid=0, prompt=prompt, max_new_tokens=6))
    assert eng.run()[0].output == ref


def test_engine_continuous_batching_all_complete():
    model, cfg = _tiny_model()
    eng = ServeEngine(model, cfg, n_slots=2, max_len=64, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(LMRequest(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, 4 + i).astype(np.int32),
            max_new_tokens=5))
    done = eng.run()
    assert sorted(done) == list(range(6))
    assert all(len(r.output) == 5 for r in done.values())


def test_engine_isolation_between_slots():
    """Results with co-batched requests match single-request runs."""
    model, cfg = _tiny_model()
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 5 + i).astype(np.int32)
               for i in range(3)]
    refs = [_greedy_reference(model, cfg, p, 4) for p in prompts]
    eng = ServeEngine(model, cfg, n_slots=3, max_len=64, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=4))
    done = eng.run()
    for i in range(3):
        assert done[i].output == refs[i], i


def test_engine_stops_at_eos():
    model, cfg = _tiny_model()
    prompt = np.arange(5, dtype=np.int32)
    ref = _greedy_reference(model, cfg, prompt, 6)
    eng = ServeEngine(model, cfg, n_slots=1, max_len=64, device="cpu")
    eng.submit(LMRequest(rid=0, prompt=prompt, max_new_tokens=6,
                         eos_id=ref[2]))
    out = eng.run()[0].output
    # the prefill's token is never checked against EOS, as in the reference
    stop = 1 + ref[1:].index(ref[2])
    assert out == ref[:stop + 1]


def test_encoder_arch_rejected():
    model, cfg = _tiny_model(causal=False)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(model, cfg, device="cpu")


@pytest.mark.parametrize("arch,item", [
    ("mixtral_8x22b", "13f"), ("phi3_5_moe", "13f")])
def test_unported_archs_name_roadmap_item(arch, item):
    """The MoE archs (the name and the item are the ones this test had
    while the port refused them, naming ROADMAP item 13f) build: every
    block's FFN is a ``MoE`` with the reference's leaves and shapes
    (router (d, E) float32 also in a bf16 model, gate and up (E, d, ff),
    down (E, ff, d) in the model's type), and a prefill runs
    (tests/test_torch_moe.py holds them to the reference)."""
    import dataclasses
    from repro_torch.models.moe import MoE
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="bfloat16")
    model = init_params(torch.Generator().manual_seed(0), cfg)
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    for blk in model.blocks:
        assert isinstance(blk.ffn, MoE)
        shapes = {n: (tuple(p.shape), p.dtype)
                  for n, p in blk.ffn.named_parameters()}
        assert shapes == {"router": ((d, E), torch.float32),
                          "gate": ((E, d, ff), torch.bfloat16),
                          "up": ((E, d, ff), torch.bfloat16),
                          "down": ((E, ff, d), torch.bfloat16)}
    toks = torch.arange(6)[None] % cfg.vocab_size
    last, _ = prefill(model, cfg, {"tokens": toks}, cache_len=8)
    assert last.shape == (1, cfg.vocab_size)
    assert bool(torch.isfinite(last.float()).all())


def test_init_cache_defaults_to_the_card():
    """``init_cache`` and ``init_cache_block`` build the KV cache on the
    card unless told otherwise: without a CUDA device a bare call raises,
    and ``device="cpu"`` gives the empty cache on the CPU."""
    from repro_torch.models.transformer import init_cache, init_cache_block
    cfg = get_config("qwen3_4b", reduced=True)
    if torch.cuda.is_available():
        assert init_cache(cfg, 1, 8)[0]["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_cache_block(cfg, "attn", 1, 8)
    cache = init_cache(cfg, 1, 8, device="cpu")
    assert len(cache) == cfg.n_layers
    shape = (1, 8, cfg.n_kv_heads, cfg.head_dim)
    for blk in cache:
        assert blk["k"].shape == blk["v"].shape == shape
        assert blk["k"].device.type == "cpu"
        assert blk["k"].dtype == cfg.torch_dtype
        assert not blk["k"].any() and (blk["pos"] == -1).all()
