"""llama-3.2-vision in the port (``cross_attn`` blocks, the vision
frontend, the decode kernel's cross route) against the JAX package on
the CPU, at reduced size, on the same numpy inputs and the reference's
weights carried across by ``convert``. The gates start at 0 in both
packages (tanh(0) = 0 leaves the image layers out), so every test that
means the cross path draws them non-zero from its seed.

Bounds, each with its reason:
- ``cross_attention`` against the reference's jitted one: float32 within
  2e-6 (the port's plain flash scales q before the product, the
  reference the scores after it, and the two sum in other orders);
  bfloat16 every element within two bf16 steps of the reference's (plus
  1e-4): both round a float32 result once;
- the cross route's plain version against the reference's jitted
  ``cross_attention`` at one query: within 1e-6 of max|out| (float32;
  the sums run in another order, the scale is the same product);
- the kernel's split arithmetic, emulated, against the plain version:
  the limit chip_smoke.py phase 30 holds the kernel to (1e-5 of max|out|,
  bf16 each element the rounding of a value within it);
- blocks: atol 2e-5; the model's logits atol 5e-4, as the other archs';
  loss rtol 1e-5 and every gradient leaf within 1e-4 of its largest |g|
  (float32), as ``tests/test_torch_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.kernels import decode_attention as dk
from repro_torch.launch import train as launch_train
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                prefill)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import init_cache_block
from repro_torch.train import loop

torch.set_num_threads(1)

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))
_jcross = jax.jit(jattn.cross_attention)
# the cross route's limit on the card (chip_smoke.py CROSS_REL)
CROSS_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _bf16_over(got, want) -> int:
    """Elements of ``got`` more than two bf16 steps (plus 1e-4) from
    ``want``."""
    want = np.asarray(want, np.float32)
    return int((np.abs(np.asarray(got, np.float32) - want)
                > 1e-4 + 2.0 ** -6 * np.abs(want)).sum())


def _rel_close(got, want, tol, what=""):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _reference_weights(jcfg, seed=0):
    """The reference's init with its zero leaves (norm gains, and the
    gates) drawn instead, so that every parameter matters and the image
    layers add something; numpy."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.5).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def _pair(jcfg, seed=0):
    np_params = _reference_weights(jcfg, seed)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, np_params), model, cfg


def _jcfg(**kw):
    """Reduced llama-3.2-vision (5 layers, one pattern period: layer 3 is
    ``cross_attn``; d 32, 4 heads of 8 over 2 KV heads, 8 image tokens
    of 16), or with ``kw`` replaced."""
    return dataclasses.replace(jget_config("llama32_vision_11b",
                                           reduced=True), **kw)


def _batch(cfg, B=2, S=10, seed=3):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    img = rng.standard_normal((B, cfg.n_img_tokens, cfg.d_vision)).astype(
        np.float32)
    return toks, img


# ---------------------------------------------------------------------------
# cross attention and the decode kernel's cross route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,T,H,KV,hd,dt", [
    (2, 10, 8, 4, 2, 8, "float32"),       # the reduced config's shape
    (1, 37, 600, 4, 1, 16, "float32"),    # T past the plain chunk of 512
    (2, 5, 1, 2, 2, 8, "float32"),        # one image token
    (1, 70, 300, 8, 2, 32, "bfloat16"),
])
def test_cross_attention_matches_reference(B, S, T, H, KV, hd, dt):
    rng = np.random.default_rng(S + T)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, hd)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    want = np.asarray(_jcross(*(jnp.asarray(x).astype(jdt)
                                for x in (q, k, v))), np.float32)
    tdt = getattr(torch, dt)
    got = attn.cross_attention(*(_t(x).to(tdt) for x in (q, k, v)))
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    if dt == "float32":
        np.testing.assert_allclose(_np(got), want, atol=2e-6, rtol=0)
    else:
        assert _bf16_over(_np(got), want) == 0


def test_cross_scale_is_the_jitted_reference_product():
    """The reference divides the scores by sqrt(float32(hd)). Under jit,
    and inside ``lax.scan``, whose body is compiled (the reference's
    prefill and decode run its layers there), XLA multiplies by the
    float32 reciprocal instead, and eager JAX divides. The cross route
    multiplies by ``inv_sqrt_hd``: bit for bit the jitted and scanned
    forms at hd 8 and 128 (reciprocals that round) and 16."""
    x = (np.random.default_rng(0).standard_normal(4096) * 3).astype(
        np.float32)
    for hd in (8, 16, 128):
        def f(a):
            return a / jnp.sqrt(jnp.float32(hd))
        jitted = np.asarray(jax.jit(f)(jnp.asarray(x)))
        scanned = np.asarray(jax.lax.scan(
            lambda c, a: (c, f(a)), 0, jnp.asarray(x.reshape(16, -1)))[1]
        ).reshape(-1)
        got = (_t(x) * dk.inv_sqrt_hd(hd)).numpy()
        np.testing.assert_array_equal(got, jitted)
        np.testing.assert_array_equal(got, scanned)
    eager = np.asarray(jnp.asarray(x) / jnp.sqrt(jnp.float32(128)))
    assert not np.array_equal(eager, x * np.float32(dk.inv_sqrt_hd(128)))


@pytest.mark.parametrize("B,T,KV,G,hd,dt", [
    (2, 8, 2, 2, 8, "float32"), (3, 37, 2, 3, 16, "float32"),
    (4, 100, 8, 4, 128, "bfloat16")])
def test_cross_decode_plain_matches_reference(B, T, KV, G, hd, dt):
    """``cross_decode_attention_plain`` (and the wrapper on CPU tensors)
    against the reference's jitted ``cross_attention`` at one query; the
    wrapper's output in q's type."""
    rng = np.random.default_rng(T)
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, hd)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    want = np.asarray(_jcross(*(jnp.asarray(x).astype(jdt)
                                for x in (q, k, v))), np.float32)
    tdt = getattr(torch, dt)
    tq, tk, tv = (_t(x).to(tdt) for x in (q, k, v))
    got = dk.cross_decode_attention_kernel(tq, tk, tv)
    assert torch.equal(got, dk.cross_decode_attention_plain(tq, tk, tv))
    assert got.dtype == tdt
    assert torch.equal(got, attn.cross_attention(tq, tk, tv, decode=True))
    if dt == "float32":
        _rel_close(got, want, 1e-6)
    else:
        assert _bf16_over(_np(got), want) == 0


def _emulate_cross_kernel(q, k, v):
    """The decode kernel's arithmetic on its cross route (one launch) in
    plain torch: T cut into 32-slot chunks dealt round robin to the
    route's splits (``launch_plan``); a split's scores (times float32(1 /
    sqrt(hd))), its max m_s, p = exp(s - m_s), l_s = sum p and the
    unnormalised o_s = sum p v; then, in split order, m = max m_s, w_s =
    exp(m_s - m), l = sum l_s w_s and o = sum w_s o_s, divided by l once
    after the fold. Every slot is visible; p is never rounded; the
    output is float32 (the kernel rounds it to q's type last)."""
    B, _, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    route, _, L, splits = dk.launch_plan(B, T, KV, G, hd, q.dtype, k.dtype,
                                         cross=True)
    assert route == "cross"
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, KV, G, hd).float(),
                     k.float()) * dk.inv_sqrt_hd(hd)
    i = np.arange(L)
    ms, ls, os_ = [], [], []
    for split in range(splits):
        t = (split + (i // dk.CHUNK) * splits) * dk.CHUNK + i % dk.CHUNK
        part = torch.from_numpy(t[t < T])
        m_s = s[..., part].amax(-1)
        p = torch.exp(s[..., part] - m_s[..., None])
        ms.append(m_s)
        ls.append(p.sum(-1))
        os_.append(torch.einsum("bkgt,btkd->bkgd", p, v[:, part].float()))
    m = ms[0]
    for m_s in ms[1:]:
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(m)
    out = torch.zeros((B, KV, G, hd))
    for m_s, l_s, o_s in zip(ms, ls, os_):
        w = torch.exp(m_s - m)
        l = l + l_s * w
        out = out + w[..., None] * o_s
    return (out / l[..., None]).reshape(B, 1, H, hd)


@pytest.mark.parametrize("B,T,KV,G,hd,dt", [
    (4, 1600, 8, 4, 128, "bfloat16"),     # llama-3.2-vision's cross cache
    (1, 1600, 8, 4, 128, "bfloat16"),     # phase 31's batch of 1: 25 splits
    (2, 700, 2, 6, 256, "float32"),       # hd 256: the V rows' cap of 96
    (3, 37, 2, 3, 16, "float32")])
def test_cross_kernel_emulation_within_the_card_limit(B, T, KV, G, hd, dt):
    """The cross route's split arithmetic, emulated, is within the limit
    phase 30 holds the kernel to against the plain version: float32
    within CROSS_REL x max|out|; bfloat16 every element between the bf16
    roundings of the plain float32 value minus and plus that."""
    tdt = getattr(torch, dt)
    g = torch.Generator().manual_seed(T)
    q = torch.randn((B, 1, KV * G, hd), generator=g).to(tdt)
    k, v = (torch.randn((B, T, KV, hd), generator=g).to(tdt)
            for _ in range(2))
    want = dk.cross_decode_attention_plain(q.float(), k.float(), v.float())
    emul = _emulate_cross_kernel(q, k, v)
    tol = CROSS_REL * float(want.abs().max())
    assert float((emul - want).abs().max()) <= tol
    got = emul.to(tdt)
    lo, hi = (want - tol).to(tdt), (want + tol).to(tdt)
    assert int(((got < lo) | (got > hi)).sum()) == 0
    if dt == "bfloat16":
        assert dk.launch_plan(B, T, KV, G, hd, tdt, tdt, True)[3] > 1
        # the limit's power: p rounded to bf16 (the bfloat16 route's
        # rounding) moves the float32 result past it
        s = torch.einsum("bkgd,btkd->bkgt",
                         q.reshape(B, KV, G, hd).float(), k.float()) * \
            dk.inv_sqrt_hd(hd)
        p = torch.softmax(s, -1).to(tdt).float()
        rounded = torch.einsum("bkgt,btkd->bkgd", p, v.float()).reshape(
            want.shape)
        assert float((rounded - want).abs().max()) > tol


def test_cross_decode_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 1, 4, 8))
    k = torch.zeros((2, 5, 2, 8))
    with pytest.raises(ValueError, match="expected"):
        dk.cross_decode_attention_kernel(q[:, :1].expand(2, 2, 4, 8), k, k)
    with pytest.raises(ValueError, match="query heads"):
        dk.cross_decode_attention_kernel(torch.zeros((2, 1, 3, 8)), k, k)
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        dk.cross_decode_attention_kernel(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(TypeError, match="all float32 or all bfloat16"):
        dk.cross_decode_attention_kernel(q, k.to(torch.int8),
                                         k.to(torch.int8))


# ---------------------------------------------------------------------------
# the cross_attn block and the model
# ---------------------------------------------------------------------------

def test_cross_block_matches_reference_in_every_mode():
    """The ``cross_attn`` block (layer 3, gates drawn non-zero) on the
    same input and image tokens: train, then prefill into the cross
    cache, then two decode steps from it (q without bias or q norm, as
    the reference); outputs atol 2e-5, the cache's k and v within 1e-5 of
    their largest entry, against the reference's jitted ``apply_block``.
    A config with QKV bias and q/k norm shows decode's q skips them."""
    for extra in ({}, {"qkv_bias": True, "qk_norm": True}):
        jcfg = _jcfg(**extra)
        jp, model, cfg = _pair(jcfg)
        jblk = jax.tree.map(lambda a: a[0], jp["period"]["pos3"])
        blk = model.blocks[3]
        assert float(blk.gate_attn) != 0 and float(blk.gate_mlp) != 0
        assert blk.gate_attn.dtype == torch.float32
        assert blk.gate_attn.shape == ()
        rng = np.random.default_rng(7)
        B, S, d = 2, 6, cfg.d_model
        x = rng.standard_normal((B, S + 2, d)).astype(np.float32)
        vis = rng.standard_normal((B, cfg.n_img_tokens,
                                   cfg.d_vision)).astype(np.float32)
        japply = jax.jit(jtf.apply_block, static_argnums=(0, 1),
                         static_argnames=("mode",))
        want, _, _ = japply(jcfg, "cross_attn", jblk, jnp.asarray(x[:, :S]),
                            mode="train", vis_embeds=jnp.asarray(vis))
        got, _, aux = tf.apply_block(cfg, "cross_attn", blk, _t(x[:, :S]),
                                     mode="train", vis_embeds=_t(vis))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
        assert aux == 0.0
        jcache = jtf.init_cache_block(jcfg, "cross_attn", B, 32)
        cache = init_cache_block(cfg, "cross_attn", B, 32, device="cpu")
        assert cache["k"].shape == tuple(jcache["k"].shape)
        want, jcache, _ = japply(jcfg, "cross_attn", jblk,
                                 jnp.asarray(x[:, :S]), mode="prefill",
                                 cache=jcache, vis_embeds=jnp.asarray(vis))
        got, cache, _ = tf.apply_block(cfg, "cross_attn", blk,
                                       _t(x[:, :S]), mode="prefill",
                                       cache=cache, vis_embeds=_t(vis))
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
        for t in (S, S + 1):
            want, jcache, _ = japply(jcfg, "cross_attn", jblk,
                                     jnp.asarray(x[:, t:t + 1]),
                                     mode="decode", cache=jcache)
            got, cache, _ = tf.apply_block(cfg, "cross_attn", blk,
                                           _t(x[:, t:t + 1]), mode="decode",
                                           cache=cache)
            np.testing.assert_allclose(_np(got), np.asarray(want),
                                       atol=2e-5)
        assert set(cache) == set(jcache) == {"k", "v"}
        for name in cache:
            _rel_close(cache[name], jcache[name], 1e-5, name)


def test_vision_matches_reference():
    """Reduced llama-3.2-vision, gates drawn non-zero: forward (train)
    logits; ``prefill`` with ``image_embeds``, then 4 ``decode_step``s
    (the reference's jitted ones), logits atol 5e-4."""
    jcfg = _jcfg()
    jp, model, cfg = _pair(jcfg)
    toks, img = _batch(cfg)
    jb = {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}
    tb = {"tokens": _t(toks).long(), "image_embeds": _t(img)}
    want, _, _ = _jforward(jp, jcfg, jb, remat=False)
    got, _, _ = forward(model, cfg, tb)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4)
    B, S = toks.shape
    jlast, jcache = _jprefill(jp, jcfg, jb, S + 4)
    last, cache = prefill(model, cfg, tb, S + 4)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), atol=5e-4)
    for i in range(4):
        tok = np.asarray(jnp.argmax(jlast, -1), np.int32)[:, None]
        jlast, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                 jnp.full((B,), S + i, jnp.int32))
        last, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                  torch.full((B,), S + i))
        np.testing.assert_allclose(_np(last), np.asarray(jlast), atol=5e-4)


def test_vision_loss_and_gradients_match_reference():
    """Loss and every leaf's gradient (the 0-dim gates and ``vis_proj``
    included) against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same tokens and image embeddings, as
    ``tests/test_torch_train.py`` holds the dense archs in float32."""
    loss_rtol, grad_tol = 1e-5, 1e-4
    jcfg = _jcfg()
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg,
                                             device="cpu").train()
    toks, img = _batch(cfg, S=12, seed=5)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
              "image_embeds": jnp.asarray(img)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jbatch)
    tbatch = {"tokens": _t(toks).long(), "labels": _t(toks).long(),
              "image_embeds": _t(img)}
    tl, _ = loss_fn(model, cfg, tbatch)
    named = list(model.named_parameters())
    grads = torch.autograd.grad(tl, [p for _, p in named])
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=loss_rtol)
    got = convert.to_reference_lm_tree(
        {n: g for (n, _), g in zip(named, grads)}, cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_j) == len(flat_t)
    for path, want in flat_j:
        _rel_close(flat_t[path], np.asarray(want, np.float32), grad_tol,
                   jax.tree_util.keystr(path))
    # remat off gives the same gradients bit for bit
    tl2, _ = loss_fn(model, cfg, tbatch, remat=False)
    grads2 = torch.autograd.grad(tl2, [p for _, p in named])
    for g, g2 in zip(grads, grads2):
        assert torch.equal(g, g2)


def test_convert_round_trip_keeps_vision_leaves():
    """``vis_proj`` and the stacked gates carry across: the gates as 0-dim
    float32 parameters in a bfloat16 model, and back to the reference's
    layout unchanged."""
    jcfg = _jcfg(dtype="bfloat16", n_layers=10)
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    assert model.vis_proj.dtype == torch.bfloat16
    assert model.vis_proj.shape == (cfg.d_vision, cfg.d_vision)
    for i, kind in enumerate(cfg.layout()):
        blk = model.blocks[i]
        assert hasattr(blk, "gate_attn") == (kind == "cross_attn")
        if kind == "cross_attn":
            assert blk.gate_mlp.dtype == torch.float32
            assert blk.gate_mlp.shape == ()
            assert blk.wk.shape == (cfg.d_vision,
                                    cfg.n_kv_heads * cfg.head_dim)
    back = convert.to_reference_lm_tree(
        {n: p for n, p in model.named_parameters()}, cfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat) == len(want)
    for path, a in want:
        np.testing.assert_array_equal(
            flat[path], np.asarray(a, np.float32),
            err_msg=jax.tree_util.keystr(path))


def test_init_params_builds_vision():
    """The port's own seeded init of reduced llama-3.2-vision: the
    reference's leaves and shapes (``param_count`` plus the norm gains
    and the gates, which it leaves out), the gates 0-dim float32 zeros
    in a bfloat16 model, serving mode."""
    jcfg = _jcfg(dtype="bfloat16")
    cfg = convert.from_reference_arch_config(jcfg)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    jparams, _ = jinit_params(jax.random.PRNGKey(0), jcfg)
    got = convert.to_reference_lm_tree(dict(model.named_parameters()), cfg)
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), got)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), jparams)
    n = sum(p.numel() for p in model.parameters())
    d, kinds = cfg.d_model, cfg.layout()
    # ``param_count`` counts vis_proj as (d_vision, d), the same at full
    # width; the reference's leaf is (d_vision, d_vision)
    assert n == cfg.param_count() + d + 2 * d * len(kinds) + \
        2 * kinds.count("cross_attn") + cfg.d_vision * (cfg.d_vision - d)
    for blk, kind in zip(model.blocks, kinds):
        if kind == "cross_attn":
            for g in (blk.gate_attn, blk.gate_mlp):
                assert g.dtype == torch.float32 and g.shape == ()
                assert float(g) == 0.0
    assert not any(p.requires_grad for p in model.parameters())


def test_vision_without_image_embeds_raises_as_the_reference_fails():
    """Prefill or train of a vision config without ``image_embeds``
    raises a ValueError naming it; the reference fails on the same call
    (its ``None @ wk``). Decode needs none: it reads the cross cache."""
    jcfg = _jcfg()
    jp, model, cfg = _pair(jcfg)
    toks, _ = _batch(cfg)
    with pytest.raises(ValueError, match="image_embeds"):
        prefill(model, cfg, {"tokens": _t(toks).long()}, 16)
    with pytest.raises(ValueError, match="image_embeds"):
        loss_fn(model, cfg, {"tokens": _t(toks).long(),
                             "labels": _t(toks).long()})
    with pytest.raises(Exception):
        jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    with pytest.raises(Exception):
        jloss_fn(jp, jcfg, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(toks)})


def test_vision_train_steps_match_reference():
    """Two ``make_train_step`` steps on the token pipeline's batches
    (float32 ``image_embeds``; clip 1.0, so the clip is live) against the
    reference's jitted step: losses and grad norms rtol 1e-5, the 0-dim
    gates' AdamW moments within 1e-4 of the reference's."""
    jcfg = _jcfg()
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    jstate = jloop.init_train_state(jax.tree.map(jnp.asarray, np_params))
    state = convert.from_reference_train_state(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    jstep = jax.jit(jloop.make_train_step(jcfg, **kw))
    tstep = loop.make_train_step(cfg, **kw)
    pipe = SyntheticTokenPipeline(cfg, 2, 12, seed=3)
    for _ in range(2):
        batch = pipe.next_batch()
        assert batch["image_embeds"].dtype == np.float32
        jstate, jm = jstep(jstate, {k: jnp.asarray(x)
                                    for k, x in batch.items()})
        state, tm = tstep(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    for moment in ("m", "v"):
        want = getattr(jstate.opt, moment)["period"]["pos3"]["gate_attn"]
        got = getattr(state.opt, moment)["blocks.3.gate_attn"]
        assert got.shape == ()
        _rel_close(got, np.asarray(want)[0], 1e-4, moment)


def test_launch_train_runs_vision_on_cpu(capsys):
    """``launch.train`` trains reduced llama-3.2-vision on the CPU from
    its pipeline's batches (tokens and float32 image embeddings), with no
    flag of its own."""
    assert launch_train.main(["--arch", "llama32_vision_11b", "--reduced",
                              "--steps", "2", "--batch", "2", "--seq", "8",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done at step 2" in out and "nan" not in out
