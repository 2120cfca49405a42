"""The port's RG-LRU stack (``repro_torch.models.recurrent``, the
``rglru`` block, recurrentgemma end to end) against the JAX package on
the CPU, on the same numpy inputs and weights: the causal conv1d and
its step, the RG-LRU sequence and step (float32 within 1e-5 of max|h|:
the reference's associative scan adds in another order than the port's
loop), reduced recurrentgemma-9b's forward, prefill and decode logits
(atol 5e-4) and the serving engine's greedy tokens (equal), the two
prefill-state rules, the weights' round trip through ``convert``, and
the names of the parts still to port, and a plain-torch emulation of
the scan kernel's chunked arithmetic (``csrc/rglru_scan.cu``) held to
the plain loop and to the reference's associative scan within the limit
the card holds the kernel to. Here the scan takes its plain version (CPU
tensors); tests/test_torch_gpu.py holds the kernel to it on a card."""
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
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import recurrent as jrec
from repro_torch.configs import get_config
from repro_torch.convert import (from_reference_arch_config,
                                 from_reference_lm_params,
                                 to_reference_lm_tree)
from repro_torch.examples import serve_lm
from repro_torch.kernels import rglru_scan as rs
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                prefill)
from repro_torch.models import recurrent as rec
from repro_torch.models.transformer import init_cache
from repro_torch.serve import LMRequest, ServeEngine

torch.set_num_threads(1)

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jloss = jax.jit(jloss_fn, static_argnums=(1,), static_argnames=("remat",))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))
LRU_NAMES = ("a_param", "alpha_i", "beta_i", "alpha_r", "beta_r")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _within_max(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _lru(seed, w):
    """The five lru leaves, drawn around the reference's init values."""
    rng = np.random.default_rng(seed)
    p = {"a_param": rng.uniform(-3.0, 25.0, w),
         "alpha_i": rng.uniform(0.5, 1.5, w),
         "beta_i": rng.uniform(-0.5, 0.5, w),
         "alpha_r": rng.uniform(0.5, 1.5, w),
         "beta_r": rng.uniform(-0.5, 0.5, w)}
    return {k: v.astype(np.float32) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the functions of recurrent.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,C,W", [(2, 9, 16, 4), (1, 2, 8, 4),
                                     (3, 20, 5, 1)])
def test_causal_conv1d_matches_reference(B, S, C, W):
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32)
    want = jrec.causal_conv1d(jnp.asarray(x), jnp.asarray(w))
    _within_max(rec.causal_conv1d(_t(x), _t(w)), want, 1e-6)


def test_causal_conv1d_step_matches_reference():
    """Three steps from a state; each output and the next state."""
    rng = np.random.default_rng(7)
    B, C, W = 3, 12, 4
    w = rng.standard_normal((W, C)).astype(np.float32)
    state = rng.standard_normal((B, W - 1, C)).astype(np.float32)
    jstate, tstate = jnp.asarray(state), _t(state)
    for _ in range(3):
        x = rng.standard_normal((B, C)).astype(np.float32)
        jy, jstate = jrec.causal_conv1d_step(jnp.asarray(x), jstate,
                                             jnp.asarray(w))
        y, tstate = rec.causal_conv1d_step(_t(x), tstate, _t(w))
        _within_max(y, jy)
        np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate))


def test_conv_step_continues_the_sequence_conv():
    """The step form fed the sequence's inputs gives the sequence form's
    outputs (the port against itself, as the reference defines both)."""
    rng = np.random.default_rng(8)
    x = _t(rng.standard_normal((2, 7, 6)).astype(np.float32))
    w = _t(rng.standard_normal((4, 6)).astype(np.float32))
    seq = rec.causal_conv1d(x, w)
    state = torch.zeros((2, 3, 6))
    for t in range(7):
        y, state = rec.causal_conv1d_step(x[:, t], state, w)
        torch.testing.assert_close(y, seq[:, t], rtol=1e-6, atol=1e-6)


def test_softplus_has_no_threshold():
    """``jax.nn.softplus`` is logaddexp(x, 0) everywhere; F.softplus
    switches to x above 20."""
    x = np.linspace(-40.0, 40.0, 1601).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = rs.softplus(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)


@pytest.mark.parametrize("B,S,w", [(2, 37, 16), (1, 300, 8), (3, 1, 5)])
def test_rglru_sequence_matches_reference(B, S, w):
    rng = np.random.default_rng(B * S)
    x = (rng.standard_normal((B, S, w)) * 2).astype(np.float32)
    p = _lru(S, w)
    want = jrec.rglru_sequence(jnp.asarray(x),
                               {k: jnp.asarray(v) for k, v in p.items()})
    got = rec.rglru_sequence(_t(x), {k: _t(v) for k, v in p.items()})
    assert got.shape == x.shape and got.dtype == torch.float32
    _within_max(got, want)


def test_rglru_step_matches_reference():
    """Four steps from a float32 state: the rounded and the float32 h."""
    rng = np.random.default_rng(9)
    B, w = 2, 24
    p = _lru(9, w)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    h = rng.standard_normal((B, w)).astype(np.float32)
    jh, th = jnp.asarray(h), _t(h)
    for _ in range(4):
        x = rng.standard_normal((B, w)).astype(np.float32)
        jo, jh = jrec.rglru_step(jnp.asarray(x), jh, jp)
        o, th = rec.rglru_step(_t(x), th, tp)
        _within_max(o, jo)
        _within_max(th, jh)


def test_scan_plain_equals_steps_and_rounds_to_x():
    """The plain scan is the step function repeated from h = 0, and h
    comes back in x's type (bfloat16 here) from a float32 carry."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(
        np.float32)).bfloat16()
    p = {k: _t(v) for k, v in _lru(10, 8).items()}
    seq = rs.rglru_scan_plain(x, *(p[k] for k in LRU_NAMES))
    assert seq.dtype == torch.bfloat16
    h = torch.zeros((2, 8))
    for t in range(6):
        o, h = rec.rglru_step(x[:, t], h, p)
        assert torch.equal(o, seq[:, t])


def _emulate_chunked_scan(x, a_param, alpha_i, beta_i, alpha_r, beta_r,
                          sub=rs.SCAN_SUB):
    """The scan kernel's arithmetic (csrc/rglru_scan.cu) in plain torch,
    rounded as the kernel rounds (separate products and sums): the
    coefficients; each sub-chunk of ``sub`` steps scanned from 0 into its
    aggregate (A = its a_t multiplied in step order, L = its h from 0);
    the carries h_in' = A h_in + L in sub-chunk order from 0 (the
    kernel's tiles of SCAN_STEPS steps hand the last one to the next tile,
    so the chain runs over sub-chunks whatever the tile); then each
    sub-chunk's recurrence re-run from its carry. A ragged last sub-chunk
    is padded with identity steps (a = 1, b = 0), exact as the kernel's
    shorter loop."""
    a_t, b_t = rs.rglru_coeffs(x, a_param, alpha_i, beta_i, alpha_r,
                               beta_r)
    B, S, W = a_t.shape
    n = -(-S // sub)
    if n * sub > S:
        pad = n * sub - S
        a_t = torch.cat([a_t, a_t.new_ones((B, pad, W))], dim=1)
        b_t = torch.cat([b_t, b_t.new_zeros((B, pad, W))], dim=1)
    a_t, b_t = a_t.reshape(B, n, sub, W), b_t.reshape(B, n, sub, W)
    A = torch.ones_like(a_t[:, :, 0])
    L = torch.zeros_like(a_t[:, :, 0])
    for j in range(sub):
        L = a_t[:, :, j] * L + b_t[:, :, j]
        A = a_t[:, :, j] * A
    h_in = torch.empty_like(A)
    hc = torch.zeros_like(A[:, 0])
    for k in range(n):
        h_in[:, k] = hc
        hc = A[:, k] * hc + L[:, k]
    h, out = h_in, []
    for j in range(sub):
        h = a_t[:, :, j] * h + b_t[:, :, j]
        out.append(h)
    return torch.stack(out, dim=2).reshape(B, n * sub, W)[:, :S].to(x.dtype)


def _bf16_within(got, want):
    """Every element within two bf16 steps of |want| plus 1e-4 (the limit
    chip_smoke.py phase 26 holds the kernel to)."""
    got, want = _np(got), np.asarray(want, np.float32)
    over = np.abs(got - want) > 1e-4 + 2.0 ** -6 * np.abs(want)
    assert not over.any(), (int(over.sum()), float(np.abs(got - want).max()))


@pytest.mark.parametrize("B,S,W,dt", [(1, 4096, 4096, "float32"),
                                      (1, 4096, 4096, "bfloat16"),
                                      (3, 300, 1000, "float32"),
                                      (2, 37, 40, "bfloat16")])
def test_chunked_scan_emulation_within_the_card_limit(B, S, W, dt):
    """The chunked scan's carries go through the product of each
    sub-chunk's a_t where the plain loop applies them one at a time: at
    recurrentgemma-9b's 4096-token prefill (rnn width 4096) and at ragged
    shapes (S off the sub-chunk and the tile, B > 1, W off the channel
    tile) the emulation is within the limit the card holds the kernel to
    against ``rglru_scan_plain`` (float32 1e-5 x max|h|, bf16 two bf16
    steps + 1e-4), and within the same limit of the reference's
    ``rglru_sequence`` (JAX's associative scan)."""
    rng = np.random.default_rng(S + W)
    xf = (rng.standard_normal((B, S, W)) * 2).astype(np.float32)
    p = _lru(W, W)
    x = _t(xf).to(getattr(torch, dt))
    tp = [_t(p[k]) for k in LRU_NAMES]
    got = _emulate_chunked_scan(x, *tp)
    plain = rs.rglru_scan_plain(x, *tp)
    jx = jnp.asarray(x.float().numpy()).astype(getattr(jnp, dt))
    ref = jrec.rglru_sequence(jx, {k: jnp.asarray(v) for k, v in p.items()})
    ref = np.asarray(ref.astype(jnp.float32))
    assert got.shape == x.shape and got.dtype == x.dtype
    if dt == "float32":
        _within_max(got, _np(plain))
        _within_max(got, ref)
        # the carries really took another way than the plain loop
        assert not torch.equal(got, plain)
    else:
        _bf16_within(got, _np(plain))
        _bf16_within(got, ref)


def test_rglru_scan_rejects_bad_parameters():
    x = torch.zeros((1, 3, 4))
    p = [torch.zeros(4) for _ in LRU_NAMES]
    with pytest.raises(ValueError, match="expected float32"):
        rs.rglru_scan(x, *p[:4], torch.zeros(5))
    with pytest.raises(ValueError, match="expected float32"):
        rs.rglru_scan(x, *p[:4], torch.zeros(4, dtype=torch.float64))


# ---------------------------------------------------------------------------
# recurrentgemma end to end
# ---------------------------------------------------------------------------

def _reference_weights(jcfg, seed=0):
    """The reference's init, its zero leaves (norm gains, beta_i, beta_r)
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
    np_params = _reference_weights(jcfg)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(np_params, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, np_params), model, cfg


def _hybrid(**kw):
    """A tiny [R, R, A] hybrid with a window shorter than the prompts."""
    base = dict(name="tiny_hybrid", family="hybrid", n_layers=4,
                d_model=32, n_heads=4, n_kv_heads=1, head_dim=8, d_ff=64,
                vocab_size=101, rnn_width=24, local_window=8,
                dtype="float32", pattern=("rglru", "rglru", "local_attn"))
    base.update(kw)
    return JArchConfig(**base)


RG_CASES = ["recurrentgemma_9b", "hybrid"]


def _jcfg(name):
    return _hybrid() if name == "hybrid" else jget_config(name, reduced=True)


@pytest.mark.parametrize("name", RG_CASES)
def test_recurrentgemma_matches_reference(name):
    """forward (train), the loss, prefill and three decode steps: logits
    within atol 5e-4 on the same weights and tokens (the reduced config's
    8 layers are 2 x [R, R, A] + [R, R]; 20 prompt tokens wrap a 16- or
    8-slot local ring); every cache leaf of the first R and A layers."""
    jcfg = _jcfg(name)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    want, _, _ = _jforward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           remat=False)
    got, _, _ = forward(model, cfg, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4)
    jl, _ = _jloss(jp, jcfg, {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(toks)}, remat=False)
    tl, _ = loss_fn(model, cfg, {"tokens": _t(toks).long(),
                                 "labels": _t(toks).long()})
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    cache_len = 24
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                              cache_len)
    last, cache = prefill(model, cfg, {"tokens": _t(toks).long()},
                          cache_len)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), atol=5e-4)
    pos = np.array([20, 20], np.int32)
    tok = np.argmax(np.asarray(jlast), -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = _jdecode(jp, jcfg, jnp.asarray(tok), jcache,
                                jnp.asarray(pos))
        log, cache = decode_step(model, cfg, _t(tok).long(), cache,
                                 _t(pos).long())
        np.testing.assert_allclose(_np(log), np.asarray(jlog), atol=5e-4)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int32)[:, None]
        pos = pos + 1
    r0, a0 = jcache["period"]["pos0"], jcache["period"]["pos2"]
    _within_max(cache[0]["h"], r0["h"][0], 1e-4)
    np.testing.assert_allclose(_np(cache[0]["conv"]), np.asarray(
        r0["conv"][0]), atol=1e-5)
    np.testing.assert_allclose(_np(cache[2]["k"]), np.asarray(a0["k"][0]),
                               atol=1e-4)
    np.testing.assert_array_equal(cache[2]["pos"].numpy(),
                                  np.asarray(a0["pos"][0]))


@pytest.mark.parametrize("name", RG_CASES)
def test_recurrentgemma_engine_matches_reference(name):
    """The port's ServeEngine and the JAX one on the hybrid cache (RG-LRU
    state and conv window beside the local KV ring), the same weights
    and requests: more requests than slots, ragged prompts, one longer
    than the window, one retired at max_len - 1; the same greedy
    tokens."""
    jcfg = _jcfg(name)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 2, 26)]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=32)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    assert set(eng.cache[0]) == {"h", "conv"}
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=5))
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in want:
        assert got[i].output == want[i].output, i
    assert len(got[3].output) == 32 - 1 - 26


def test_prefill_h_is_rounded_to_the_model_type_decode_h_is_not():
    """Prefill's state is the last h after its rounding to the model's
    type (bfloat16 here), then float32; decode's is the float32 carry,
    which bfloat16 cannot hold. Prefill's state equals the last row of
    the block's own sequence output."""
    cfg = from_reference_arch_config(_hybrid(dtype="bfloat16", n_layers=3))
    model = init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)))
    _, cache = prefill(model, cfg, {"tokens": toks}, cache_len=16)
    h = cache[0]["h"]
    assert h.dtype == torch.float32
    assert torch.equal(h, h.bfloat16().float())
    blk = model.blocks[0]
    from repro_torch.models.layers import rms_norm
    x = torch.nn.functional.embedding(toks, model.embed)
    xr = (rms_norm(x, blk.ln, cfg.norm_eps) @ blk.w_in)[..., :cfg.rnn_w]
    hseq = rec.rglru_sequence(rec.causal_conv1d(xr, blk.conv), blk.lru)
    assert torch.equal(h, hseq[:, -1].float())
    _, cache = decode_step(model, cfg, toks[:, :1], cache,
                           torch.full((2,), 9))
    h = cache[0]["h"]
    assert not torch.equal(h, h.bfloat16().float())


@pytest.mark.parametrize("S", [2, 3, 7])
def test_prefill_conv_state(S):
    """With S < W - 1 prompt tokens prefill keeps the zero conv state,
    as the reference; from W - 1 on it holds the last W - 1 inputs.
    Both against the reference's cache."""
    jcfg = _hybrid(n_layers=3)
    jp, model, cfg = _pair(jcfg)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size, (2, S)
                                             ).astype(np.int32)
    _, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 16)
    _, cache = prefill(model, cfg, {"tokens": _t(toks).long()}, 16)
    conv = cache[0]["conv"]
    assert conv.shape == (2, cfg.conv1d_size - 1, cfg.rnn_w)
    if S < cfg.conv1d_size - 1:
        assert not conv.any()
    np.testing.assert_allclose(_np(conv), np.asarray(
        jcache["period"]["pos0"]["conv"][0]), atol=1e-5)


def test_rglru_cache_layout():
    cfg = get_config("recurrentgemma_9b", reduced=True)
    cache = init_cache(cfg, 3, 40, device="cpu")
    kinds = cfg.layout()
    for blk, kind in zip(cache, kinds):
        if kind == "rglru":
            assert blk["h"].shape == (3, cfg.rnn_w)
            assert blk["h"].dtype == torch.float32
            assert blk["conv"].shape == (3, cfg.conv1d_size - 1, cfg.rnn_w)
            assert not blk["h"].any() and not blk["conv"].any()
        else:
            assert blk["k"].shape[1] == min(40, cfg.local_window)


def test_convert_round_trip_keeps_rglru_leaves():
    """The reference's tree (12 x [R, R, A] + [R, R] in the full config's
    schedule; 2 x [R, R, A] + [R, R] reduced) into the port and back,
    bit for bit, in a bfloat16 model: the nested ``lru`` dict and the
    conv taps stay float32, the projections are bfloat16."""
    jcfg = dataclasses.replace(jget_config("recurrentgemma_9b",
                                           reduced=True), dtype="bfloat16")
    params = _reference_weights(jcfg)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(params, cfg, device="cpu")
    blk = model.blocks[0]
    assert blk.conv.dtype == torch.float32
    assert all(blk.lru[k].dtype == torch.float32 for k in LRU_NAMES)
    assert blk.w_in.dtype == torch.bfloat16
    tree = to_reference_lm_tree(dict(model.named_parameters()), cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path],
                                      np.asarray(want, np.float32))
    assert set(tree["period"]["pos0"]["lru"]) == set(LRU_NAMES)
    assert tree["period"]["pos0"]["lru"]["a_param"].shape == (
        2, cfg.rnn_w)
    assert len(tree["rem"]) == 2


def test_recurrentgemma_full_schedule():
    """The published config: 38 layers, 26 RG-LRU and 12 local attention,
    12 periods of [R, R, A] and a remainder [R, R]."""
    cfg = get_config("recurrentgemma_9b")
    pattern, n_full, rem = cfg.schedule()
    assert (n_full, rem) == (12, ("rglru", "rglru"))
    assert cfg.layout().count("rglru") == 26
    assert cfg.layout().count("local_attn") == 12


def test_serve_lm_example_on_cpu(capsys):
    """The port of examples/serve_lm.py: 10 requests of 12 tokens each
    through the reduced hybrid model; exit 2 without a GPU by default."""
    assert serve_lm.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("10 requests, 120 tokens")
    if not torch.cuda.is_available():
        assert serve_lm.main([]) == 2


# ---------------------------------------------------------------------------
# the scan's gradient
# ---------------------------------------------------------------------------

def test_scan_gradient_off_the_cpu_names_roadmap_item():
    """A call off the CPU that needs a gradient (the name is the one this
    test had while such a call raised naming ROADMAP item 13j) takes the
    kernel route (``RGLRUScan``) and so reaches the device check before
    any launch (meta tensors stand in for CUDA ones here), as a call
    without one does; so does the backward wrapper."""
    x = torch.empty((1, 4, 8), device="meta", requires_grad=True)
    p = [torch.empty(8, device="meta") for _ in LRU_NAMES]
    before = (rs.rglru_scan.launches, rs.rglru_scan_backward.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.rglru_scan(x, *p)
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported device"):
            rs.rglru_scan(x, *p)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.rglru_scan_backward(x.detach(), *p, torch.empty_like(x))
    assert (rs.rglru_scan.launches, rs.rglru_scan_backward.launches) == \
        before


def _scan_inputs(B, S, W, dt, seed):
    rng = np.random.default_rng(seed)
    x = _t((rng.standard_normal((B, S, W)) * 2).astype(np.float32)).to(
        getattr(torch, dt))
    dh = _t(rng.standard_normal((B, S, W)).astype(np.float32)).to(x.dtype)
    p = _lru(seed, W)
    return x, [_t(p[k]) for k in LRU_NAMES], dh


@pytest.mark.parametrize("B,S,W,dt", [(2, 37, 20, "float32"),
                                      (1, 300, 8, "float32"),
                                      (3, 1, 5, "float32"),
                                      (2, 37, 20, "bfloat16")])
def test_scan_backward_plain_matches_autograd(B, S, W, dt):
    """``rglru_scan_backward_plain`` against autograd of
    ``rglru_scan_plain`` on the same inputs: dx and the five parameter
    gradients within 1e-6 of each one's largest entry (the same
    operations; autograd adds the two paths into log a and the parameter
    sums in its own order). dx comes back in x's type, the parameter
    gradients in float32. The clamp of 1 - a^2 never ties at float32
    1e-8: 1 - a^2 is 0 or at least 2^-24."""
    x, p, dh = _scan_inputs(B, S, W, dt, seed=B * S + W)
    leaves = [x.clone().requires_grad_(True)] + [
        t.clone().requires_grad_(True) for t in p]
    want = torch.autograd.grad(rs.rglru_scan_plain(*leaves), leaves, dh)
    got = rs.rglru_scan_backward_plain(x, *p, dh)
    assert got[0].dtype == x.dtype
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _within_max(g, _np(w), 1e-6)
    a_t, _ = rs.rglru_coeffs(x, *p)
    u = 1.0 - a_t * a_t
    assert not (u == np.float32(1e-8)).any()
    u = 1.0 - torch.exp(2.0 * torch.log(a_t))
    assert bool(((u == 0) | (u >= 2.0 ** -24)).all())


def _kogge_stone(A, L, reverse=False):
    """The inclusive scan of affine maps (A, L): h -> A h + L along dim 2
    of (B, tiles, 32, W) as a warp's Kogge-Stone shuffles take it, rounded
    as the kernel rounds: at distance d = 1, 2, 4, 8, 16 each lane applies
    its map after the one d lanes before it (after it, ``reverse``), a
    lane with none there keeping its own."""
    K = A.shape[2]
    d = 1
    while d < K:
        if reverse:
            L = torch.cat([A[:, :, :-d] * L[:, :, d:] + L[:, :, :-d],
                           L[:, :, -d:]], dim=2)
            A = torch.cat([A[:, :, :-d] * A[:, :, d:], A[:, :, -d:]], dim=2)
        else:
            L = torch.cat([L[:, :, :d],
                           A[:, :, d:] * L[:, :, :-d] + L[:, :, d:]], dim=2)
            A = torch.cat([A[:, :, :d], A[:, :, d:] * A[:, :, :-d]], dim=2)
        d *= 2
    return A, L


def _emulate_chunked_scan_bwd(x, a_param, alpha_i, beta_i, alpha_r, beta_r,
                              dh, sub=rs.SCAN_BWD_SUB, tile=rs.SCAN_STEPS,
                              fsub=rs.SCAN_SUB):
    """The backward kernel's arithmetic (csrc/rglru_scan_bwd.cu) in plain
    torch, rounded as the kernel rounds: h entering each time tile of
    ``tile`` steps as the forward kernel carries it (its ``fsub``-step
    sub-chunk aggregates in order, ``_emulate_chunked_scan``'s chain);
    each ``sub``-step sub-chunk's forward aggregate (A = its a_t
    multiplied in step order, L = its h from 0) and backward aggregate
    (A' = its a_t multiplied from the last step down, L' = a_first
    g_first from a zero carry); inside a tile, h into each sub-chunk from
    the tile's h and the g carry into each from the carry entering the
    tile through a Kogge-Stone scan of those aggregates (``_kogge_stone``,
    exclusive), the carry out of a tile the whole backward scan's; h and
    g re-run in each sub-chunk from them; the chain rule element by
    element as ``rglru_scan_backward_plain`` rounds it; the parameter
    sums over a thread's ``sub`` contiguous steps in order, then a tile's
    sub-chunks pairwise a group of four, (s0 + s1) + (s2 + s3), and the
    groups in order, then the tiles in (time tile, batch row) order. A ragged edge
    is padded with identity steps (a = 1, b = 0, dh = 0, no terms)."""
    xf = x.float()
    i_t = torch.sigmoid(xf * alpha_i + beta_i)
    r_t = torch.sigmoid(xf * alpha_r + beta_r)
    nc = -rs.RGLRU_C * rs.softplus(a_param)
    log_a = nc * r_t
    a_t = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    u = 1.0 - e2
    s = torch.sqrt(torch.clamp(u, min=1e-8))
    ix = i_t * xf
    b_t = s * ix
    B, S, W = x.shape
    n_tt = -(-S // tile)
    subs = tile // sub
    n = n_tt * subs
    pad = n * sub - S

    def padded(t, value):
        return torch.cat([t, t.new_full((B, pad, W), value)], dim=1) \
            if pad else t

    def aggregates(a, b):
        # each sub-chunk's (A, L) from zero, a and b (B, chunks, len, W)
        A = torch.ones_like(a[:, :, 0])
        L = torch.zeros_like(A)
        for j in range(a.shape[2]):
            L = a[:, :, j] * L + b[:, :, j]
            A = a[:, :, j] * A
        return A, L
    ap, bp = padded(a_t, 1.0), padded(b_t, 0.0)
    # the forward kernel's carry into each time tile
    fA, fL = aggregates(ap.reshape(B, n * sub // fsub, fsub, W),
                        bp.reshape(B, n * sub // fsub, fsub, W))
    h_tile = torch.zeros_like(fA[:, :n_tt])
    hc = torch.zeros_like(fA[:, 0])
    per = tile // fsub
    for k in range(n * sub // fsub):
        if k % per == 0:
            h_tile[:, k // per] = hc
        hc = fA[:, k] * hc + fL[:, k]
    a4 = ap.reshape(B, n, sub, W)
    b4 = bp.reshape(B, n, sub, W)
    d4 = padded(dh.float(), 0.0).reshape(B, n, sub, W)
    A, L = aggregates(a4, b4)
    Ab = torch.ones_like(A)
    Lb = torch.zeros_like(A)
    for j in range(sub - 1, -1, -1):
        Lb = a4[:, :, j] * (d4[:, :, j] + Lb)
        Ab = a4[:, :, j] * Ab
    shape = (B, n_tt, subs, W)
    fA, fL = _kogge_stone(A.reshape(shape), L.reshape(shape))
    bA, bL = _kogge_stone(Ab.reshape(shape), Lb.reshape(shape),
                          reverse=True)
    one, zero = A.new_ones((B, n_tt, 1, W)), A.new_zeros((B, n_tt, 1, W))
    eA = torch.cat([one, fA[:, :, :-1]], dim=2)
    eL = torch.cat([zero, fL[:, :, :-1]], dim=2)
    h_in = eA * h_tile[:, :, None] + eL
    gA = torch.cat([bA[:, :, 1:], one], dim=2)
    gL = torch.cat([bL[:, :, 1:], zero], dim=2)
    c_tile = torch.zeros_like(h_tile)
    cc = torch.zeros_like(h_tile[:, 0])
    for tt in range(n_tt - 1, -1, -1):
        c_tile[:, tt] = cc
        cc = bA[:, tt, 0] * cc + bL[:, tt, 0]
    c_in = (gA * c_tile[:, :, None] + gL).reshape(B, n, W)
    h, hs = h_in.reshape(B, n, W), []
    for j in range(sub):
        hs.append(h)
        h = a4[:, :, j] * h + b4[:, :, j]
    h_prev = torch.stack(hs, dim=2)
    gs, cc = [None] * sub, c_in
    for j in range(sub - 1, -1, -1):
        gs[j] = d4[:, :, j] + cc
        cc = a4[:, :, j] * gs[j]
    g = torch.stack(gs, dim=2).reshape(B, n * sub, W)[:, :S]
    h_prev = h_prev.reshape(B, n * sub, W)[:, :S]
    da = g * h_prev
    dix = g * s
    du = torch.where(u >= 1e-8, (g * ix) / (2.0 * s), torch.zeros_like(u))
    dlog_a = da * a_t - 2.0 * (du * e2)
    dzi = (dix * xf) * (i_t * (1.0 - i_t))
    dzr = (dlog_a * nc) * (r_t * (1.0 - r_t))
    dx = (dix * i_t + dzi * alpha_i + dzr * alpha_r).to(x.dtype)

    def kernel_sum(term):
        # thread k of a channel takes steps k sub .. (k + 1) sub - 1; a
        # warp holds four of a channel's sub-chunks
        t5 = padded(term, 0.0).reshape(B, n_tt, subs // 4, 4, sub, W)
        acc = torch.zeros_like(t5[..., 0, :])
        for j in range(sub):
            acc = acc + t5[..., j, :]
        while acc.shape[3] > 1:
            acc = acc[:, :, :, 0::2] + acc[:, :, :, 1::2]
        part = acc[:, :, 0, 0]
        for k in range(1, subs // 4):
            part = part + acc[:, :, k, 0]
        total = torch.zeros_like(part[0, 0])
        for tt in range(n_tt):
            for b in range(B):
                total = total + part[b, tt]
        return total
    d_nc = kernel_sum(dlog_a * r_t)
    d_a = (d_nc * -rs.RGLRU_C) * torch.sigmoid(a_param)
    return (dx, d_a, kernel_sum(dzi * xf), kernel_sum(dzi),
            kernel_sum(dzr * xf), kernel_sum(dzr))


@pytest.mark.parametrize("B,S,W,dt", [(1, 4096, 512, "float32"),
                                      (1, 4096, 512, "bfloat16"),
                                      (3, 300, 100, "float32"),
                                      (2, 37, 40, "bfloat16"),
                                      (1, 1, 7, "float32"),
                                      (2, 263, 1036, "float32")])
def test_chunked_scan_backward_emulation_within_the_card_limit(B, S, W, dt):
    """The backward kernel's carries and sums (``_emulate_chunked_scan_
    bwd``) against ``rglru_scan_backward_plain`` within the limits the
    card holds the kernel to (chip_smoke.py phase 33): float32 dx within
    1e-5 of max|dx|, bf16 dx within two bf16 steps of |dx| plus that, and
    each parameter gradient within 1e-4 of its largest entry; at a
    4096-token sequence (16 time tiles) and at ragged shapes (S off the
    sub-chunk and the tile, B > 1, S = 1, a last time tile of 7 steps
    inside one sub-chunk with W off the 8-channel tile)."""
    x, p, dh = _scan_inputs(B, S, W, dt, seed=S + W)
    got = _emulate_chunked_scan_bwd(x, *p, dh)
    want = rs.rglru_scan_backward_plain(x, *p, dh)
    assert got[0].dtype == x.dtype and got[0].shape == x.shape
    g0, w0 = _np(got[0]), _np(want[0])
    scale = float(np.abs(w0).max())
    if dt == "float32":
        assert float(np.abs(g0 - w0).max()) <= 1e-5 * scale
    else:
        over = np.abs(g0 - w0) > 2.0 ** -7 * np.abs(w0) + 1e-5 * scale
        assert not over.any(), int(over.sum())
    for g, w in zip(got[1:], want[1:]):
        _within_max(g, _np(w), 1e-4)
    if S > 2 * rs.SCAN_SUB and dt == "float32":
        # the carries really took another way than the plain loop
        assert not torch.equal(got[0], want[0])


def test_recurrentgemma_gradients_match_jax():
    """The reduced recurrentgemma-9b (8 layers: 2 x [R, R, A] + [R, R])
    trains through the plain scan on the CPU: its loss and all 64 leaves'
    gradients against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same weights and tokens, each leaf within 2e-5 of
    its largest |g| (float32; the associative scan and the loop add in
    other orders), the loss rtol 1e-5."""
    jcfg = jget_config("recurrentgemma_9b", reduced=True)
    jp, model, cfg = _pair(jcfg)
    model.train()
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jloss_fn(q, jcfg, b), has_aux=True))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)})
    tl, _ = loss_fn(model, cfg, {"tokens": _t(toks).long(),
                                 "labels": _t(toks).long()})
    named = list(model.named_parameters())
    grads = torch.autograd.grad(tl, [q for _, q in named])
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    got = to_reference_lm_tree({n: g for (n, _), g in zip(named, grads)},
                               cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_j) == len(flat_t) == 64
    for path, want in flat_j:
        want = np.asarray(want, np.float32)
        err = float(np.abs(flat_t[path] - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()), \
            (jax.tree_util.keystr(path), err)


def test_plain_scan_trains_on_the_cpu():
    """On the CPU the plain scan is differentiable: the reduced hybrid's
    loss gradient reaches the lru leaves and the conv taps."""
    cfg = from_reference_arch_config(_hybrid(n_layers=3))
    model = init_params(torch.Generator().manual_seed(0), cfg).train()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)))
    loss, _ = loss_fn(model, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    blk = model.blocks[0]
    assert blk.conv.grad is not None and blk.conv.grad.abs().sum() > 0
    assert all(blk.lru[k].grad is not None for k in LRU_NAMES)
