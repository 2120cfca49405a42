"""The port's decode path against the JAX package on the CPU: the int8 KV
cache's quantiser (``_kv_quantize``, bit for bit the reference's jitted
function), ``decode_attention`` on float32, bfloat16 and int8 caches
(G in {1, 4, 16}, hd in {8, 128, 256}, windows, empty and future slots,
a wrapped ring; float32 within atol 2e-5, bfloat16 within two bf16
steps), reduced qwen3-4b with ``kv_quant=True`` (forward, prefill and
decode logits within atol 5e-4, the serving engine's greedy tokens
equal, decode within the reference's 0.15 of teacher forcing), and a
plain-torch emulation of the decode kernel's split-T passes
(``csrc/decode_attention.cu``) held to ``decode_attention_plain`` within
the limit the card is held to. Here the wrappers take their plain
versions (CPU tensors); tests/test_torch_gpu.py holds the kernel to them
on a card."""
import dataclasses

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
from repro.models import prefill as jprefill
from repro.models.transformer import _kv_quantize as jkv_quantize
from repro_torch.convert import (from_reference_arch_config,
                                 from_reference_lm_params)
from repro_torch.kernels import decode_attention as dk
from repro_torch.models import (attention, decode_step, forward,
                                init_params, prefill)
from repro_torch.models.transformer import _kv_quantize, init_cache
from repro_torch.serve import LMRequest, ServeEngine

torch.set_num_threads(1)

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))
_jquant = jax.jit(jkv_quantize)

# the card's limit for the decode kernel against its plain version
# (chip_smoke.py phase 25): bfloat16 outputs within two bf16 steps of
# |want| plus a floor near zero; float32 within 1e-5 of max|want|
BF16_RTOL, BF16_ATOL = 2.0 ** -6, 1e-4
F32_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _bf16_over(got, want) -> int:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return int((np.abs(got - want) > BF16_ATOL + BF16_RTOL * np.abs(want)
                ).sum())


# ---------------------------------------------------------------------------
# the quantiser
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,shape,scale", [
    (0, (2, 40, 2, 16), 1.0),
    (1, (3, 7, 1, 256), 37.0),
    (2, (1, 300, 8, 128), 1e-3),
])
def test_kv_quantize_is_bitwise(seed, shape, scale):
    """Values and scales bit for bit the reference's jitted quantiser
    (XLA multiplies by float32(1/127) there), with zero rows (scale
    1e-10), exact halves (rounded to even) and +-127 extremes."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, 0] = 0.0                                   # scale floor
    x[-1, -1, 0, :4] = np.array([2.5, -2.5, 0.5, 127.0]) * (
        np.abs(x[-1, -1, 0]).max() / 127.0)         # halves, the extreme
    want_q, want_s = _jquant(jnp.asarray(x))
    got_q, got_s = _kv_quantize(_t(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_kv_quantize_eager_reference_differs_by_an_ulp_at_most():
    """The reference run op by op divides by 127; its jitted form (which
    the port follows) multiplies by the reciprocal: scales within one
    float32 ULP of each other."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 500, 2, 32)).astype(np.float32)
    _, eager = jkv_quantize(jnp.asarray(x))
    _, got = _kv_quantize(_t(x))
    eager = np.asarray(eager)
    assert np.all(np.abs(got.numpy() - eager) <= np.spacing(eager))


def test_bf16_values_quantize_through_float32():
    """A bfloat16 k quantises as its float32 value, as the reference."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 2, 16)).astype(np.float32)
    xb = torch.from_numpy(x).bfloat16()
    want_q, want_s = _jquant(jnp.asarray(xb.float().numpy()).astype(
        jnp.bfloat16))
    got_q, got_s = _kv_quantize(xb)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

def _positions(B, T, window):
    """Slot positions and query positions: row 0 a full cache whose last
    three slots lie past the query; row 1 empty slots from 17 on; row 2
    (and up) a ring buffer that has wrapped (position p in slot p % T)."""
    pos = np.tile(np.arange(T), (B, 1)).astype(np.int64)
    q_pos = np.full(B, T - 1, np.int64)
    q_pos[0] = T - 4
    pos[1, 17:] = -1
    q_pos[1] = 16
    for b in range(2, B):
        q_pos[b] = T + 13 + b
        for p in range(q_pos[b] - T + 1, q_pos[b] + 1):
            pos[b, p % T] = p
    return pos, q_pos


def _decode_inputs(seed, B, T, KV, G, hd, kind, q_dtype):
    """q (B, 1, KV G, hd) and the caches as numpy float32 arrays, the
    int8 cache through the reference's quantiser; the torch tensors in
    their working types."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, KV * G, hd)).astype(np.float32)
    k = (rng.standard_normal((B, T, KV, hd)) * 2).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    qt = torch.from_numpy(q).to(q_dtype)
    if kind == "int8":
        kq, ks = (np.asarray(a) for a in _jquant(jnp.asarray(k)))
        vq, vs = (np.asarray(a) for a in _jquant(jnp.asarray(v)))
        return qt, (_t(kq), _t(vq), _t(ks), _t(vs))
    ct = torch.from_numpy(k).to(q_dtype), torch.from_numpy(v).to(q_dtype)
    return qt, (*ct, None, None)


def _jnp(t):
    """A torch tensor as jnp in its own type (bfloat16 via float32)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


DECODE_CASES = [
    # (cache, q type, KV, G, hd, window)
    ("float32", "float32", 2, 1, 8, 0),
    ("float32", "float32", 2, 4, 128, 0),
    ("float32", "float32", 1, 16, 256, 5),
    ("bfloat16", "bfloat16", 2, 1, 8, 5),
    ("bfloat16", "bfloat16", 2, 4, 128, 0),
    ("bfloat16", "bfloat16", 1, 16, 256, 0),
    ("int8", "float32", 2, 1, 128, 0),
    ("int8", "float32", 2, 4, 8, 7),
    ("int8", "bfloat16", 2, 4, 128, 7),
    ("int8", "bfloat16", 1, 16, 256, 0),
    # GQA groups of 6 and 8 (the kernel's grouped route on the card)
    ("bfloat16", "bfloat16", 2, 6, 128, 0),
    ("bfloat16", "bfloat16", 1, 8, 64, 5),
    ("int8", "bfloat16", 2, 6, 128, 7),
    ("int8", "bfloat16", 1, 8, 256, 0),
]


@pytest.mark.parametrize("cache,qdt,KV,G,hd,window", DECODE_CASES)
def test_decode_attention_matches_reference(cache, qdt, KV, G, hd, window):
    """``models.attention.decode_attention`` (the plain version on CPU
    tensors) against the reference's on the same caches: float32 within
    atol 2e-5, a bfloat16 output within two bf16 steps."""
    B, T = 3, 40
    q, (kc, vc, ks, vs) = _decode_inputs(G + hd + KV, B, T, KV, G, hd, cache,
                                         getattr(torch, qdt))
    pos, q_pos = _positions(B, T, window)
    want = jattn.decode_attention(
        _jnp(q), _jnp(kc), _jnp(vc), jnp.asarray(pos.astype(np.int32)),
        jnp.asarray(q_pos.astype(np.int32)), window=window,
        k_scale=None if ks is None else _jnp(ks),
        v_scale=None if vs is None else _jnp(vs))
    got = attention.decode_attention(q, kc, vc, _t(pos), _t(q_pos),
                                     window=window, k_scale=ks, v_scale=vs)
    assert got.shape == q.shape and got.dtype == q.dtype
    want = np.asarray(want.astype(jnp.float32))
    if qdt == "float32":
        np.testing.assert_allclose(_np(got), want, atol=2e-5, rtol=0)
    else:
        assert _bf16_over(_np(got), want) == 0


def _split_slots(T, L, split):
    """The slots split ``split`` takes, in the kernel's order: chunks
    split, split + splits, ... of ``CHUNK`` slots, cut at T
    (csrc/decode_attention.cu ``slot_of``)."""
    i = np.arange(L)
    t = (split + (i // dk.CHUNK) * dk.n_splits(T, L)) * dk.CHUNK + \
        i % dk.CHUNK
    return t[t < T]


def _emulate_split_kernel(q, kc, vc, pos, q_pos, window, ks=None, vs=None):
    """The decode kernel's arithmetic in plain torch (the split and the
    grouped routes alike: the grouped route's products run on the tensor
    cores, exact for bf16 operands, with sums in another order): T cut
    into 32-slot chunks dealt round robin to ``n_splits`` splits of the
    route's length (``launch_plan``, ``_split_slots``);
    pass 1 a split's scores, max m_s and sum l_s (over its visible
    slots; a split that sees none has m_s = NEG_INF and l_s its slot
    count, every exp(NEG_INF - NEG_INF) being 1); pass 2 the row's m =
    max m_s and l = sum l_s exp(m_s - m) in split order, p = exp(s - m)
    / l (times v_scale), rounded to the value type, each split's partial
    p . v, and the partials added in split order. A split's invisible
    slots carry NEG_INF scores, so they add exact zeros here where the
    kernel skips them (or, in a row that sees no slot, p = 1 / T on
    every slot, as the kernel lists them all)."""
    B, _, H, hd = q.shape
    T, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    L = dk.launch_plan(B, T, KV, G, hd, q.dtype, kc.dtype)[2]
    quant = ks is not None
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(B, KV, G, hd).float(),
                     kc.float())
    if quant:
        s = s * ks.permute(0, 2, 1)[:, :, None, :]
    s = s / dk.sqrt_hd(hd)
    vis = dk.visible_slots(pos, q_pos, window)
    s = torch.where(vis[:, None, None, :], s, dk.NEG_INF)
    parts = [torch.from_numpy(_split_slots(T, L, i))
             for i in range(dk.n_splits(T, L))]
    ms = [s[..., i].amax(-1) for i in parts]
    ls = [torch.exp(s[..., i] - m[..., None]).sum(-1)
          for i, m in zip(parts, ms)]
    m = ms[0]
    for m_s in ms[1:]:
        m = torch.maximum(m, m_s)
    l = torch.zeros_like(m)
    for m_s, l_s in zip(ms, ls):
        l = l + l_s * torch.exp(m_s - m)
    p = torch.exp(s - m[..., None]) / l[..., None]
    if quant:
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    p = p.to(q.dtype if quant else vc.dtype).float()
    out = torch.zeros((B, KV, G, hd))
    for i in parts:
        out = out + torch.einsum("bkgt,btkd->bkgd", p[..., i],
                                 vc[:, i].float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


@pytest.mark.parametrize("name,B,T,KV,G,hd,cache,window,filled", [
    ("qwen3-4b serving, bf16", 4, 4352, 8, 4, 128, "bfloat16", 0, 0.5),
    ("qwen3-4b serving, int8", 4, 4352, 8, 4, 128, "int8", 0, 0.5),
    ("recurrentgemma-9b ring, bf16", 4, 2048, 1, 16, 256, "bfloat16",
     2048, 1.0),
    ("reduced float32", 2, 40, 2, 2, 16, "float32", 0, 0.7),
    ("int8, rows that see no slot", 3, 70, 2, 4, 64, "int8", 0, 0.0),
    ("qwen2.5-3b serving (G 8), bf16", 4, 4352, 2, 8, 128, "bfloat16", 0,
     0.5),
    ("qwen2.5-3b serving (G 8), int8", 4, 4352, 2, 8, 128, "int8", 0, 0.5),
    ("glm4-9b serving (G 16), bf16", 4, 4352, 2, 16, 128, "bfloat16", 0,
     0.5),
    ("glm4-9b serving (G 16), int8", 4, 4352, 2, 16, 128, "int8", 0, 0.5),
    ("mixtral-8x22b ring (G 6), bf16", 4, 4096, 8, 6, 128, "bfloat16",
     4096, 1.0),
    ("G 20 (two grouped blocks), rows that see no slot", 3, 70, 1, 20, 64,
     "int8", 0, 0.0),
])
def test_split_kernel_emulation_within_the_card_limit(name, B, T, KV, G, hd,
                                                      cache, window, filled):
    """The split passes round p after normalising it as the plain version
    does; their sums differ only in order. At the shapes the card runs
    (a half-filled qwen3-4b cache; recurrentgemma's wrapped 2048-slot
    ring and mixtral's 4096-slot one; qwen2.5-3b's and glm4-9b's GQA
    groups of 8 and 16, on the grouped route's splits; ``filled`` 0:
    every slot past its row's query, the softmax over all NEG_INF), the
    emulation is within the limit phases 25, 36 and 41 hold the kernel
    to: every bf16 element within two bf16 steps of the plain version
    (plus 1e-4), float32 within 1e-5 x max|out|."""
    q_dtype = torch.float32 if cache == "float32" else torch.bfloat16
    q, (kc, vc, ks, vs) = _decode_inputs(T + G, B, T, KV, G, hd, cache,
                                         q_dtype)
    rng = np.random.default_rng(T)
    pos = np.tile(np.arange(T), (B, 1)).astype(np.int64)
    q_pos = np.zeros(B, np.int64)
    for b in range(B):
        n = max(1, int(T * filled * rng.uniform(0.5, 1.0)))
        if not filled:      # every slot past the query
            q_pos[b] = 0
            pos[b] += 1
        elif window:        # a ring that has wrapped past its length
            q_pos[b] = T + int(rng.integers(0, T))
            for p in range(q_pos[b] - T + 1, q_pos[b] + 1):
                pos[b, p % T] = p
        else:
            pos[b, n:] = -1
            q_pos[b] = n - 1
    pos, q_pos = _t(pos), _t(q_pos)
    want = dk.decode_attention_plain(q, kc, vc, pos, q_pos, window, ks, vs)
    got = _emulate_split_kernel(q, kc, vc, pos, q_pos, window, ks, vs)
    assert dk.launch_plan(B, T, KV, G, hd, q.dtype, kc.dtype)[3] > 1
    if q_dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= F32_REL * float(want.abs().max()), (name, err)
    else:
        assert _bf16_over(_np(got), _np(want)) == 0, name


def test_split_len_fills_the_card():
    """Splits of whole 32-slot chunks, as many as bring the B x KV x
    ceil(G / heads) x splits blocks near one wave of two blocks an SM
    (264) without passing it, at most 2048 slots (4 heads a block, the
    split route), 1024 (16, the grouped route); the chunks dealt round
    robin cover every slot once; the grouped route also takes at most 16
    splits while 16 of 1024 slots hold T."""
    bf, f32 = torch.bfloat16, torch.float32

    def split_l(B, T, KV, G, hd, dt):
        return dk.launch_plan(B, T, KV, G, hd, dt, dt)[2]
    assert split_l(4, 4352, 8, 4, 128, bf) == 544    # 8 splits: 256 blocks
    assert dk.n_splits(4352, 544) == 8
    # 16 splits x 4 groups x 4 (float32: the split route at G 16)
    assert split_l(4, 2048, 1, 16, 256, f32) == 128
    assert dk.n_splits(2048, 128) == 16
    assert split_l(1, 100000, 1, 64, 64, f32) == 2048    # the cap
    assert dk.n_splits(100000, 2048) == 49
    assert split_l(2, 12, 2, 1, 64, bf) == 32
    assert dk.n_splits(12, 32) == 1
    # the grouped route: a block a KV head (B x KV x ceil(G / 16) units)
    g_rule = (dk.GROUPED_HEADS, dk.GROUPED_MAX_SPLIT_LEN)
    assert dk.split_len(4, 1, 16, 2048, *g_rule,
                        dk.SPLIT_BLOCKS) == 32   # uncapped: 64 x 4 blocks
    assert split_l(4, 2048, 1, 16, 256, bf) == 128   # 16 x 4
    assert split_l(1, 100000, 1, 64, 128, bf) == 1024   # its cap
    assert dk.n_splits(100000, 1024) == 98   # past 16: T needs them
    for T, L in ((4352, 544), (2048, 128), (1000, 96), (12, 32)):
        slots = np.concatenate([_split_slots(T, L, i)
                                for i in range(dk.n_splits(T, L))])
        assert np.array_equal(np.sort(slots), np.arange(T))
    assert _split_slots(4352, 544, 1)[:33].tolist() == \
        list(range(32, 64)) + [8 * 32 + 32]


@pytest.mark.parametrize("B,T,KV,G,hd,q_dtype,cache,want", [
    # phase 25: qwen3-4b's groups of 4 stay on the split route
    (4, 4352, 8, 4, 128, "bfloat16", "bfloat16", ("split", 4, 544, 8)),
    (4, 4352, 8, 4, 128, "bfloat16", "int8", ("split", 4, 544, 8)),
    # phase 41: qwen2.5-3b (G 8) and glm4-9b (G 16), 8 units x 16 splits
    # (the grouped route's cap; 33 would fill the wave)
    (4, 4352, 2, 8, 128, "bfloat16", "bfloat16", ("grouped", 16, 288, 16)),
    (4, 4352, 2, 8, 128, "bfloat16", "int8", ("grouped", 16, 288, 16)),
    (4, 4352, 2, 16, 128, "bfloat16", "bfloat16", ("grouped", 16, 288, 16)),
    (4, 4352, 2, 16, 128, "bfloat16", "int8", ("grouped", 16, 288, 16)),
    # phi4-mini's G 3 stays; recurrentgemma's ring (phase 25) and
    # mixtral's (phase 36, G 6) go grouped
    (4, 4352, 8, 3, 128, "bfloat16", "bfloat16", ("split", 4, 544, 8)),
    (4, 2048, 1, 16, 256, "bfloat16", "bfloat16", ("grouped", 16, 128, 16)),
    (4, 4096, 8, 6, 128, "bfloat16", "bfloat16", ("grouped", 16, 512, 8)),
    # G 20: two blocks a KV head
    (3, 70, 1, 20, 64, "bfloat16", "int8", ("grouped", 16, 32, 3)),
    # a cache longer than 16 splits of 1024 slots: splits of 1024
    (1, 100000, 1, 64, 128, "bfloat16", "bfloat16",
     ("grouped", 16, 1024, 98)),
    # float32 caches and an int8 cache under a float32 q: the split route
    (2, 300, 1, 16, 256, "float32", "float32", ("split", 4, 32, 10)),
    (4, 4352, 2, 8, 128, "float32", "int8", ("split", 4, 288, 16)),
])
def test_launch_plan_routes(B, T, KV, G, hd, q_dtype, cache, want):
    """The route each call takes, its heads a block, split length and
    splits: the grouped route exactly where G > 4 and a bf16 q meets the
    bf16 or int8 cache, its splits counted over B x KV x ceil(G / 16)
    units and at most ``GROUPED_MAX_SPLITS`` unless T needs more of
    ``GROUPED_MAX_SPLIT_LEN`` slots."""
    got = dk.launch_plan(B, T, KV, G, hd, getattr(torch, q_dtype),
                         getattr(torch, cache))
    assert got == want
    route, heads, L, splits = got
    assert L % dk.CHUNK == 0 and splits * L >= T
    assert B * KV * -(-G // heads) * splits <= dk.SPLIT_BLOCKS or \
        L == (dk.GROUPED_MAX_SPLIT_LEN if route == "grouped"
              else dk.MAX_SPLIT_LEN)
    if route == "grouped":
        assert splits <= dk.GROUPED_MAX_SPLITS or \
            L == dk.GROUPED_MAX_SPLIT_LEN


def test_decode_wrapper_rejects_bad_inputs():
    q, (kc, vc, ks, vs) = _decode_inputs(0, 2, 8, 2, 2, 16, "int8",
                                         torch.float32)
    pos, q_pos = _positions(2, 8, 0)
    pos, q_pos = _t(pos), _t(q_pos)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        dk.decode_attention_kernel(q, kc, vc, pos, q_pos, k_scale=ks)
    with pytest.raises(TypeError, match="needs scales"):
        dk.decode_attention_kernel(q, kc, vc, pos, q_pos)
    with pytest.raises(ValueError, match="expected float32"):
        dk.decode_attention_kernel(q, kc, vc, pos, q_pos, k_scale=ks[:, :4],
                                   v_scale=vs)
    with pytest.raises(ValueError, match="query heads"):
        dk.decode_attention_kernel(q[:, :, :3], kc[..., :16], vc,
                                   pos, q_pos, k_scale=ks, v_scale=vs)


# ---------------------------------------------------------------------------
# reduced qwen3-4b with the int8 cache
# ---------------------------------------------------------------------------

def _quant_config(**kw):
    return dataclasses.replace(jget_config("qwen3_4b", reduced=True),
                               kv_quant=True, **kw)


def _pair(jcfg, seed=0):
    """(reference weights as jnp, the port's LM on the CPU, port cfg); the
    reference's zero leaves replaced by small draws."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    np_params = jax.tree.map(fill, params)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(np_params, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, np_params), model, cfg


@pytest.mark.parametrize("extra", [{}, {"window": 8}])
def test_kv_quant_model_matches_reference(extra):
    """forward, prefill and three decode steps on the int8 cache: logits
    within atol 5e-4; the cache's values and scales as the reference's."""
    jcfg = _quant_config(**extra)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 11)).astype(np.int32)
    want, _, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           remat=False)
    got, _, _ = forward(model, cfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4)
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    last, cache = prefill(model, cfg, {"tokens": _t(toks).long()}, 16)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), atol=5e-4)
    pos = np.array([11, 11], np.int32)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        log, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                 _t(pos).long())
        np.testing.assert_allclose(_np(log), np.asarray(jlog), atol=5e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        pos = pos + 1
    jc = jcache["period"]["pos0"]
    assert cache[0]["k"].dtype == torch.int8
    assert int((cache[0]["k"].numpy().astype(np.int32)
                - np.asarray(jc["k"][0]).astype(np.int32)).__abs__().max()
               ) <= 1
    np.testing.assert_allclose(cache[0]["k_scale"].numpy(),
                               np.asarray(jc["k_scale"][0]), rtol=1e-5)
    np.testing.assert_array_equal(cache[0]["pos"].numpy(),
                                  np.asarray(jc["pos"][0]))


def _tiny(**kw):
    """tests/conftest.py's ``tiny_config`` as the port's config."""
    return from_reference_arch_config(JArchConfig(
        name="tiny", family="dense", n_layers=4, d_model=32, n_heads=4,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=101, dtype="float32",
        **kw))


@pytest.mark.parametrize("extra", [{}, {"window": 8}, {"qk_norm": True}])
def test_kv_quant_decode_close_to_teacher_forcing(extra):
    """tests/test_models.py's int8 check on the port: prefill 15 tokens,
    decode the 16th; within the reference's 0.15 of the full forward."""
    cfg = _tiny(kv_quant=True, **extra)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    full, _, _ = forward(model, cfg, {"tokens": toks})
    _, cache = prefill(model, cfg, {"tokens": toks[:, :15]}, cache_len=16)
    dec, _ = decode_step(model, cfg, toks[:, 15:], cache,
                         torch.full((2,), 15))
    assert float((dec - full[:, -1]).abs().max()) < 0.15
    assert cache[0]["k"].dtype == torch.int8


def test_kv_quant_engine_matches_reference():
    """The port's ServeEngine and the JAX one on the int8 cache, the same
    weights and requests (more requests than slots, a prompt longer than
    the cache's window retired at max_len - 1): the same greedy
    tokens. ``_write_slot`` copies the int8 values and both scales."""
    jcfg = _quant_config()
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 26)]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=32)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    assert set(eng.cache[0]) == {"k", "v", "k_scale", "v_scale", "pos"}
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=5))
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in want:
        assert got[i].output == want[i].output, i


def test_kv_quant_cache_layout():
    """``init_cache`` under kv_quant: int8 values, float32 scales per
    slot and KV head, empty positions; windowed layers keep the window."""
    cfg = _tiny(kv_quant=True, window=6)
    cache = init_cache(cfg, 3, 10, device="cpu")
    blk = cache[0]
    assert blk["k"].dtype == blk["v"].dtype == torch.int8
    assert blk["k"].shape == (3, 6, cfg.n_kv_heads, cfg.head_dim)
    assert blk["k_scale"].shape == blk["v_scale"].shape == (3, 6, 2)
    assert blk["k_scale"].dtype == torch.float32
    assert (blk["pos"] == -1).all()
