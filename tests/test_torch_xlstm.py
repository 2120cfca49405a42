"""The port's xLSTM stack (``kernels/mlstm_scan.py``, ``kernels/slstm_scan.py``,
the ``mlstm`` and ``slstm`` functions of ``repro_torch.models.recurrent``,
their blocks, xlstm-350m end to end) against the JAX package on the CPU,
on the same numpy inputs and weights: the two scans' plain versions
against the reference's cells (h and the final state within 1e-5 of
their largest entry: the port's loop and XLA's scan round the same
operations, the dot products summed in another order), the blocks in the
train, prefill and decode modes, reduced xlstm-350m's forward, prefill
and decode logits (atol 5e-4) and the serving engine's greedy tokens
(equal), the weights' round trip through ``convert``, a prefill followed
by a decode step against a prefill one token longer (bitwise), and a
plain-torch emulation of the mLSTM kernel's summation order
(``csrc/mlstm_scan.cu``) at xlstm-350m's head width held to the plain
loop within the limit the card holds the kernel to. Here the scans take
their plain versions (CPU tensors); tests/test_torch_gpu.py and
chip_smoke.py hold the kernels to them on a card."""
import dataclasses

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
from repro.models import prefill as jprefill
from repro.models import recurrent as jrec
from repro.models import transformer as jtf
from repro_torch.configs import get_config
from repro_torch.convert import (from_reference_arch_config,
                                 from_reference_lm_params,
                                 to_reference_lm_tree)
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.kernels.decode_attention import inv_sqrt_hd
from repro_torch.kernels import slstm_scan as ss
from repro_torch.kernels.rglru_scan import softplus
from repro_torch.launch import serve as launch_serve
from repro_torch.models import (decode_step, forward, init_params, loss_fn,
                                prefill)
from repro_torch.models import recurrent as rec
from repro_torch.models import transformer as tf
from repro_torch.models.transformer import init_cache, init_cache_block
from repro_torch.serve import LMRequest, ServeEngine

torch.set_num_threads(1)

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jloss = jax.jit(jloss_fn, static_argnums=(1,), static_argnames=("remat",))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))
_jdecode = jax.jit(jdecode_step, static_argnums=(1,))
# h and the final state of a scan: within this share of their largest
# entry of the reference's (float32; the dot products C q and n . q are
# summed in another order, the transcendentals' last bits differ)
SCAN_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _within_max(got, want, rel=SCAN_REL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(_np(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), err


def _mlstm_inputs(seed, B, S, H, hd):
    """q, v normal; k normal / sqrt(hd), as the block scales it; the gate
    pre-activations spread over [-4, 4] so that m follows both gates."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, hd)).astype(np.float32)
               for _ in range(3))
    k = (k / np.sqrt(np.float32(hd))).astype(np.float32)
    i_pre, f_pre = ((rng.standard_normal((B, S, H)) * 2).astype(np.float32)
                    for _ in range(2))
    return q, k, v, i_pre, f_pre


def _reference_mlstm_state(q, k, v, i_pre, f_pre):
    """The reference's prefill replay: ``mlstm_step`` scanned from
    ``mlstm_init_state`` (src/repro/models/transformer.py:331-343)."""
    B, S, H, hd = q.shape
    st = jrec.mlstm_init_state(B, H, hd)

    def body(s, t):
        s, _ = jrec.mlstm_step(s, q[:, t], k[:, t], v[:, t], i_pre[:, t],
                               f_pre[:, t])
        return s, ()
    st, _ = jax.lax.scan(body, st, jnp.arange(S))
    return st


@pytest.mark.parametrize("B,S,H,hd", [(2, 37, 4, 16), (1, 60, 2, 32),
                                      (3, 1, 4, 8)])
def test_mlstm_scan_plain_matches_reference(B, S, H, hd):
    """h and the final state (C, n, m) of ``mlstm_scan_plain`` from the
    zero state against the reference's ``mlstm_sequence`` and its
    replayed state, each within 1e-5 of its largest entry."""
    args = _mlstm_inputs(S * hd, B, S, H, hd)
    jargs = [jnp.asarray(a) for a in args]
    want = jrec.mlstm_sequence(*jargs)
    jst = _reference_mlstm_state(*jargs)
    C, n, m = ms.init_state(B, H, hd, "cpu")
    got = ms.mlstm_scan(*(_t(a) for a in args), C, n, m)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    _within_max(got, want)
    _within_max(C, jst.C)
    _within_max(n, jst.n)
    _within_max(m, jst.m)


@pytest.mark.parametrize("B,S,w,dt", [(2, 37, 16, "float32"),
                                      (1, 200, 8, "float32"),
                                      (3, 1, 5, "float32"),
                                      (2, 29, 12, "bfloat16")])
def test_slstm_scan_plain_matches_reference(B, S, w, dt):
    """h and the final state (c, n, m, h) of ``slstm_scan_plain`` from the
    zero state against the reference's ``slstm_sequence`` and its
    replayed state, each within 1e-5 of its largest entry; bfloat16
    gates (the model's type) are read as the reference reads them."""
    rng = np.random.default_rng(S * w)
    gates = (rng.standard_normal((B, S, w, 4)) * 2).astype(np.float32)
    r = (rng.standard_normal((w, 4)) * 0.5).astype(np.float32)
    tg = _t(gates).to(getattr(torch, dt))
    jg = jnp.asarray(tg.float().numpy()).astype(getattr(jnp, dt))
    want = jrec.slstm_sequence(jg, jnp.asarray(r))

    def body(s, t):
        s, _ = jrec.slstm_step(s, jg[:, t], jnp.asarray(r))
        return s, ()
    jst, _ = jax.lax.scan(body, jrec.slstm_init_state(B, w), jnp.arange(S))
    state = ss.init_state(B, w, "cpu")
    got = ss.slstm_scan(tg, _t(r), *state)
    assert got.shape == (B, S, w) and got.dtype == torch.float32
    _within_max(got, want)
    for mine, ref in zip(state, jst):
        _within_max(mine, ref)


@pytest.mark.parametrize("B,S,w,dt,start", [(2, 37, 16, "float32", "zero"),
                                            (1, 45, 7, "float32", "random"),
                                            (3, 1, 5, "float32", "zero"),
                                            (2, 29, 13, "bfloat16", "random"),
                                            (1, 70, 33, "bfloat16", "zero")])
def test_slstm_saved_states_match_reference_cell(B, S, w, dt, start):
    """The saving launch's plain counterpart, ``slstm_scan_plain(...,
    save=True)``: the state c, n, m before every step against the
    reference's ``_slstm_cell`` stepped under JAX from the same state
    (the zero state, or a random one), each within 1e-5 of its largest
    entry over the steps (m at the zero state's -1e30 exactly); step 0
    holds the starting state bitwise, and hs and the final state are
    bitwise those of the call without saving."""
    rng = np.random.default_rng(S * w + B)
    gates = (rng.standard_normal((B, S, w, 4)) * 2).astype(np.float32)
    r = (rng.standard_normal((w, 4)) * 0.5).astype(np.float32)
    tg = _t(gates).to(getattr(torch, dt))
    jg = jnp.asarray(tg.float().numpy()).astype(getattr(jnp, dt))
    if start == "zero":
        state = [t.numpy() for t in ss.init_state(B, w, "cpu")]
    else:
        c, m, h = (rng.standard_normal((B, w)).astype(np.float32)
                   for _ in range(3))
        n = (np.abs(rng.standard_normal((B, w))) + 0.5).astype(np.float32)
        state = [c, n, m, h]
    jst = jrec.SLSTMState(*(jnp.asarray(a) for a in state))
    want = [[], [], []]
    for t in range(S):
        for dst, src in zip(want, jst[:3]):
            dst.append(np.asarray(src))
        jst, _ = jrec._slstm_cell(jst, jg[:, t], jnp.asarray(r))
    mine = [_t(a) for a in state]
    hs, saved = ss.slstm_scan_plain(tg, _t(r), *mine, save=True)
    plain = [_t(a) for a in state]
    assert torch.equal(hs, ss.slstm_scan_plain(tg, _t(r), *plain))
    assert all(torch.equal(a, b) for a, b in zip(mine, plain))
    for i, (got, ref) in enumerate(zip(saved, want)):
        ref = np.stack(ref, axis=1)
        assert got.shape == (B, S, w) and got.dtype == torch.float32
        assert torch.equal(got[:, 0], _t(state[i]))
        if i == 2 and start == "zero":
            np.testing.assert_array_equal(_np(got[:, 0]), ref[:, 0])
            got, ref = got[:, 1:], ref[:, 1:]
        if got.numel():
            _within_max(got, ref)


def test_recurrent_functions_match_reference():
    """``mlstm_step``/``slstm_step`` from a state the sequence forms left
    (the reference's names and shapes; the port's update the state in
    place): three steps, h and the state within 1e-5 of their largest
    entry of the reference's."""
    B, S, H, hd = 2, 9, 4, 16
    args = _mlstm_inputs(3, B, S + 3, H, hd)
    jargs = [jnp.asarray(a) for a in args]
    jst = _reference_mlstm_state(*(a[:, :S] for a in jargs))
    st = rec.mlstm_init_state(B, H, hd, device="cpu")
    rec.mlstm_sequence(*(_t(a[:, :S]) for a in args), state=st)
    rng = np.random.default_rng(4)
    w = 24
    gates = (rng.standard_normal((B, S + 3, w, 4)) * 2).astype(np.float32)
    r = (rng.standard_normal((w, 4)) * 0.5).astype(np.float32)
    sst = rec.slstm_init_state(B, w, device="cpu")
    rec.slstm_sequence(_t(gates[:, :S]), _t(r), sst)

    def body(s, t):
        s, _ = jrec.slstm_step(s, jnp.asarray(gates)[:, t], jnp.asarray(r))
        return s, ()
    jsst, _ = jax.lax.scan(body, jrec.slstm_init_state(B, w), jnp.arange(S))
    for t in range(S, S + 3):
        jst, jh = jrec.mlstm_step(jst, *(a[:, t] for a in jargs))
        st, h = rec.mlstm_step(st, *(_t(a[:, t]) for a in args))
        assert h.shape == (B, H, hd)
        _within_max(h, jh)
        jsst, jsh = jrec.slstm_step(jsst, jnp.asarray(gates[:, t]),
                                    jnp.asarray(r))
        sst, sh = rec.slstm_step(sst, _t(gates[:, t]), _t(r))
        assert sh.shape == (B, w)
        _within_max(sh, jsh)
    for mine, ref in zip(st + sst, tuple(jst) + tuple(jsst)):
        _within_max(mine, ref)


def test_sequence_then_step_equals_longer_sequence_bitwise():
    """The scans' state after N tokens and one S = 1 call equals their
    state after N + 1 tokens, bit for bit, and so does the step's h: a
    prefill and the decode step after it share one arithmetic (the
    kernels' too: tests/test_torch_gpu.py, chip_smoke.py phase 28)."""
    B, S, H, hd = 2, 13, 4, 16
    args = [_t(a) for a in _mlstm_inputs(5, B, S + 1, H, hd)]
    one, two = ms.init_state(B, H, hd, "cpu"), ms.init_state(B, H, hd, "cpu")
    h_all = ms.mlstm_scan(*args, *one)
    ms.mlstm_scan(*(a[:, :S] for a in args), *two)
    h_last = ms.mlstm_scan(*(a[:, S:] for a in args), *two)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(h_all[:, S:], h_last)
    rng = np.random.default_rng(6)
    gates = _t((rng.standard_normal((B, S + 1, 24, 4)) * 2).astype(
        np.float32)).bfloat16()
    r = _t((rng.standard_normal((24, 4)) * 0.5).astype(np.float32))
    one, two = ss.init_state(B, 24, "cpu"), ss.init_state(B, 24, "cpu")
    hs_all = ss.slstm_scan(gates, r, *one)
    ss.slstm_scan(gates[:, :S], r, *two)
    hs_last = ss.slstm_scan(gates[:, S:], r, *two)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert torch.equal(hs_all[:, S:], hs_last)


# ---------------------------------------------------------------------------
# the mLSTM kernel's summation order
# ---------------------------------------------------------------------------

def _one_exp_gates(i_pre, f_pre, m):
    """The kernels' exact-one form of the gates (csrc/mlstm_scan.cu's
    producer, csrc/slstm_scan.cu's step): d = (log_f + m) - i_pre, one
    exp, i_g = 1 where d <= 0 and f_g = 1 where d > 0, the other gate
    exp(-|d|). Returns (i_g, f_g, m')."""
    lfm = -softplus(-f_pre) + m
    d = lfm - i_pre
    e = torch.exp(-torch.abs(d))
    wins = d > 0
    one = torch.ones_like(e)
    return (torch.where(wins, e, one), torch.where(wins, one, e),
            torch.maximum(lfm, i_pre))


def _emulate_mlstm_kernel(q, k, v, i_pre, f_pre, C, n, m):
    """The mLSTM kernel's arithmetic (csrc/mlstm_scan.cu) in plain torch:
    the gates in the exact-one form (``_one_exp_gates``), the state update
    C' = f_g C + i_g (v k^T), n' = f_g n + i_g k with each product and sum
    rounded on its own, and the two dot products in the kernel's order
    (``kernel_order_dot``: a lane's columns in order, then the lanes
    pairwise). Returns h; the state is updated in place."""
    out = []
    for t in range(q.shape[1]):
        i_g, f_g, m_new = _one_exp_gates(i_pre[:, t], f_pre[:, t], m)
        m.copy_(m_new)
        C.copy_(f_g[..., None, None] * C + i_g[..., None, None] * (
            v[:, t, :, :, None] * k[:, t, :, None, :]))
        n.copy_(f_g[..., None] * n + i_g[..., None] * k[:, t])
        num = ms.kernel_order_dot(C, q[:, t, :, None, :])
        den = torch.clamp(torch.abs(ms.kernel_order_dot(n, q[:, t])),
                          min=1.0)
        out.append(num / den[..., None])
    return torch.stack(out, dim=1)


def _gate_cases():
    """(i_pre, f_pre, m) float32: random, exact ties (i_pre = log_f + m
    bit for bit, so d = 0), the zero state's m = -1e30, and large |pre|
    (both signs, to +-1e4, where exp underflows to 0 or a gate saturates)."""
    rng = np.random.default_rng(11)
    n = 512
    f_pre = _t((rng.standard_normal(n) * 3).astype(np.float32))
    m = _t((rng.standard_normal(n) * 2).astype(np.float32))
    i_pre = _t((rng.standard_normal(n) * 3).astype(np.float32))
    tie = -softplus(-f_pre) + m
    big = _t(rng.choice(np.array([-1e4, -300, -80, 80, 300, 1e4],
                                 np.float32), n))
    return [(i_pre, f_pre, m),
            (tie.clone(), f_pre, m),
            (i_pre, f_pre, torch.full_like(m, ms.M_INIT)),
            (big, f_pre, m), (i_pre, big, m), (big, big.flip(0), m),
            (big, f_pre, torch.full_like(m, ms.M_INIT))]


def test_one_exp_gates_are_the_cells_gates_bitwise():
    """The kernels' exact-one form of the gates (one exp and a select)
    against ``mlstm_scan.gates`` and the sLSTM cell's gates as
    ``slstm_scan_plain`` computes them (two exps), bit for bit, at random
    inputs, exact ties, m = -1e30 and large |pre|; at a tie both gates
    are exactly 1, and in every case one of them is."""
    for i_pre, f_pre, m in _gate_cases():
        got = _one_exp_gates(i_pre, f_pre, m)
        want = ms.gates(i_pre, f_pre, m)
        lfm = -softplus(-f_pre) + m
        m_new = torch.maximum(lfm, i_pre)
        cell = (torch.exp(i_pre - m_new), torch.exp(lfm - m_new), m_new)
        for a, b, c in zip(got, want, cell):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert bool(((got[0] == 1) | (got[1] == 1)).all())
    i_pre, f_pre, m = _gate_cases()[1]
    i_g, f_g, _ = _one_exp_gates(i_pre, f_pre, m)
    assert bool((i_g == 1).all() and (f_g == 1).all())


def _tie_gates(seed, B, S, H, m):
    """i_pre, f_pre (B, S, H) float32 for the stabiliser m (B, H), every
    entry at least 1: i_pre wins the max at t % 3 == 0, log_f + m at
    t % 3 == 1 and ties it exactly at t % 3 == 2 (f_pre = 30 there: log_f
    ~ -9.4e-14 leaves log_f + m = m bit for bit, so m is known at every
    step)."""
    rng = np.random.default_rng(seed)
    u = _t(rng.random((B, S, H)).astype(np.float32))
    f_pre = _t((rng.standard_normal((B, S, H)) * 2).astype(np.float32))
    i_pre = torch.empty((B, S, H))
    for t in range(S):
        if t % 3 == 0:
            i_pre[:, t] = m + 1 + u[:, t]
            m = i_pre[:, t].clone()
        else:
            f_pre[:, t] = 30.0
            i_pre[:, t] = m - 1 - u[:, t] if t % 3 == 1 else m
    return i_pre, f_pre


@pytest.mark.parametrize("B,S,H,hd,ties", [(1, 24, 4, 512, False),
                                           (2, 37, 4, 16, False),
                                           (2, 30, 4, 16, True)])
def test_mlstm_kernel_order_within_the_card_limit(B, S, H, hd, ties):
    """At xlstm-350m's head width (512: 16 columns a lane) and at the
    reduced one (16: half the lanes hold no column) the kernel's
    arithmetic (the exact-one gates, the summation order) gives the plain
    loop's state bit for bit (the state update has no sum across
    columns) and h within the limit the card holds the kernel to
    (1e-5 x max|h|), and not the same bits (the check sees the order);
    also where i_pre wins the stabiliser's max on some steps, log_f + m
    on others and ties it exactly on the rest."""
    args = [_t(a) for a in _mlstm_inputs(hd + S, B, S, H, hd)]
    plain_state = ms.init_state(B, H, hd, "cpu")
    emu_state = ms.init_state(B, H, hd, "cpu")
    if ties:
        m = _t(np.random.default_rng(S).random((B, H)).astype(np.float32))
        for st in (plain_state, emu_state):
            st[2].copy_(m + 1)
        args[3:] = _tie_gates(S, B, S, H, m + 1)
    want = ms.mlstm_scan_plain(*args, *plain_state)
    got = _emulate_mlstm_kernel(*args, *emu_state)
    assert all(torch.equal(a, b) for a, b in zip(plain_state, emu_state))
    _within_max(got, _np(want))
    if hd == 512:
        assert not torch.equal(got, want)


@pytest.mark.parametrize("hd", [8, 16, 48, 512])
def test_kernel_order_dot_is_the_sum(hd):
    """``kernel_order_dot`` sums every product once (float64 check)."""
    rng = np.random.default_rng(hd)
    a, b = (_t(rng.standard_normal((3, hd)).astype(np.float32))
            for _ in range(2))
    want = (a.double() * b.double()).sum(-1)
    got = ms.kernel_order_dot(a, b).double()
    assert float((got - want).abs().max()) <= 1e-5 * float(
        (a.double() * b.double()).abs().sum(-1).max())


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _reference_weights(jcfg, seed=0):
    """The reference's init, its zero leaves (norm gains) replaced by
    small draws so that every parameter matters; numpy."""
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


def _jcfg(**kw):
    """Reduced xlstm-350m (d 32, 4 heads: mLSTM heads of 16), or with
    ``kw`` replaced."""
    return dataclasses.replace(jget_config("xlstm_350m", reduced=True), **kw)


@pytest.mark.parametrize("kind,d", [("slstm", 32), ("mlstm", 32),
                                    ("mlstm", 48)])
def test_blocks_match_reference_in_every_mode(kind, d):
    """One block (the reference's layer 0 or 1) on the same input: train,
    then prefill into the cache, then two decode steps from it; the
    outputs (atol 2e-5) and every cache leaf (1e-5 of its largest entry)
    against the reference's jitted ``apply_block``. d 48 gives mLSTM
    heads of 24, whose sqrt is no power of two: the reference's k scale
    under jit is a product with a rounded reciprocal."""
    jcfg = _jcfg(d_model=d)
    jp, model, cfg = _pair(jcfg)
    layer = 0 if kind == "slstm" else 1
    jblk = jax.tree.map(lambda a: a[0], jp["period"][f"pos{layer}"])
    blk = model.blocks[layer]
    rng = np.random.default_rng(d)
    B, S = 2, 11
    x = rng.standard_normal((B, S + 2, d)).astype(np.float32)
    japply = jax.jit(jtf.apply_block, static_argnums=(0, 1),
                     static_argnames=("mode",))
    want, _, _ = japply(jcfg, kind, jblk, jnp.asarray(x[:, :S]), mode="train")
    got, _, aux = tf.apply_block(cfg, kind, blk, _t(x[:, :S]), mode="train")
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    assert aux == 0.0
    jcache = jtf.init_cache_block(jcfg, kind, B, 32)
    cache = init_cache_block(cfg, kind, B, 32, device="cpu")
    want, jcache, _ = japply(jcfg, kind, jblk, jnp.asarray(x[:, :S]),
                             mode="prefill", cache=jcache)
    got, cache, _ = tf.apply_block(cfg, kind, blk, _t(x[:, :S]),
                                   mode="prefill", cache=cache)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    for t in (S, S + 1):
        want, jcache, _ = japply(jcfg, kind, jblk, jnp.asarray(x[:, t:t + 1]),
                                 mode="decode", cache=jcache)
        got, cache, _ = tf.apply_block(cfg, kind, blk, _t(x[:, t:t + 1]),
                                       mode="decode", cache=cache)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)
    assert set(cache) == set(jcache)
    for name in cache:
        _within_max(cache[name], jcache[name])


def test_k_scale_is_the_jitted_reference_product():
    """The reference divides k by sqrt(float32(hd)); XLA compiles that
    under jit into a product with the constant's float32 reciprocal, as
    the reference's model functions run. The port multiplies by the same
    constant: bit for bit at hd 24, 512 (reciprocals that round) and 16."""
    x = (np.random.default_rng(0).standard_normal(4096) * 3).astype(
        np.float32)
    for hd in (16, 24, 512):
        want = jax.jit(lambda a: a.astype(jnp.float32) / jnp.sqrt(
            jnp.float32(hd)))(jnp.asarray(x))
        got = _t(x) * inv_sqrt_hd(hd)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(x / np.sqrt(np.float32(512)),
                              x * np.float32(inv_sqrt_hd(512)))


# ---------------------------------------------------------------------------
# xlstm-350m end to end
# ---------------------------------------------------------------------------

def test_xlstm_matches_reference():
    """Reduced xlstm-350m (4 layers [slstm, mlstm] x 2, d 32): forward
    (train) and loss, prefill and three decode steps, logits within atol
    5e-4 on the same weights and tokens; every cache leaf of the first
    sLSTM and mLSTM layers within 1e-5 of its largest entry."""
    jcfg = jget_config("xlstm_350m", reduced=True)
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
    jlast, jcache = _jprefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 24)
    last, cache = prefill(model, cfg, {"tokens": _t(toks).long()}, 24)
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
    for i in range(2):
        ref = jcache["period"][f"pos{i}"]
        assert set(cache[i]) == set(ref)
        for name in cache[i]:
            _within_max(cache[i][name], ref[name][0])


def test_xlstm_engine_matches_reference():
    """The port's ServeEngine and the JAX one on the xLSTM cache (the
    mLSTM's C, n, m and the sLSTM's c, n, m, h copied into a slot), the
    same weights and requests: more requests than slots, ragged prompts,
    one retired at max_len - 1; the same greedy tokens."""
    jcfg = jget_config("xlstm_350m", reduced=True)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 2, 26)]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=32)
    eng = ServeEngine(model, cfg, n_slots=2, max_len=32, device="cpu")
    assert set(eng.cache[0]) == {"c", "n", "m", "h"}
    assert set(eng.cache[1]) == {"C", "n", "m"}
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=5))
        eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=5))
    want, got = jeng.run(), eng.run()
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for i in want:
        assert got[i].output == want[i].output, i
    assert len(got[3].output) == 32 - 1 - 26


def test_engine_takes_the_reference_sampling_arguments():
    """``greedy`` and ``seed`` as the reference's ServeEngine takes them,
    by keyword and in its positional order: an engine built with
    ``greedy=True, seed=3`` gives the default engine's tokens and the
    reference engine's built alike, and keeps the two arguments."""
    jcfg = jget_config("xlstm_350m", reduced=True)
    jp, model, cfg = _pair(jcfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (4, 11, 7)]
    engines = [ServeEngine(model, cfg, n_slots=2, max_len=24,
                           device="cpu"),
               ServeEngine(model, cfg, n_slots=2, max_len=24, greedy=True,
                           seed=3, device="cpu"),
               ServeEngine(model, cfg, 2, 24, True, 3, device="cpu")]
    jeng = JServeEngine(jp, jcfg, n_slots=2, max_len=24, greedy=True,
                        seed=3)
    assert (engines[1].greedy, engines[1].seed) == (True, 3)
    assert (engines[2].greedy, engines[2].seed) == (True, 3)
    for i, p in enumerate(prompts):
        jeng.submit(JLMRequest(rid=i, prompt=p, max_new_tokens=4))
        for eng in engines:
            eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=4))
    want = {i: r.output for i, r in jeng.run().items()}
    for eng in engines:
        assert {i: r.output for i, r in eng.run().items()} == want


@pytest.mark.parametrize("N", [1, 12])
def test_prefill_then_decode_equals_longer_prefill(N):
    """prefill(N) and one decode step leave the state of prefill(N + 1)
    bit for bit, in every layer, and the decode step's logits are the
    longer prefill's last ones within atol 1e-5 (the projections of one
    token and of N + 1 tokens may round apart; the scans add nothing of
    their own)."""
    cfg = get_config("xlstm_350m", reduced=True)
    model = init_params(torch.Generator().manual_seed(1), cfg)
    toks = torch.from_numpy(np.random.default_rng(N).integers(
        0, cfg.vocab_size, (2, N + 1)))
    _, short = prefill(model, cfg, {"tokens": toks[:, :N]}, 16)
    logits, short = decode_step(model, cfg, toks[:, N:], short,
                                torch.full((2,), N))
    want, full = prefill(model, cfg, {"tokens": toks}, 16)
    for a, b in zip(short, full):
        assert set(a) == set(b)
        for name in a:
            assert torch.equal(a[name], b[name]), name
    torch.testing.assert_close(logits, want, rtol=0, atol=1e-5)


def test_prefill_starts_from_the_zero_state():
    """Prefill into a cache that holds another state gives the state and
    logits of a prefill into an empty one, as the reference (which never
    reads the cache it is given in prefill)."""
    cfg = get_config("xlstm_350m", reduced=True)
    model = init_params(torch.Generator().manual_seed(2), cfg)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 7)))
    want, fresh = prefill(model, cfg, {"tokens": toks}, 16)
    used = [{k: t.clone() for k, t in c.items()} for c in fresh]
    from repro_torch.models.transformer import _trunk
    x, used, _ = _trunk(model, cfg, {"tokens": toks.flip(1)}, "prefill",
                        used, None)
    x, used, _ = _trunk(model, cfg, {"tokens": toks}, "prefill", used, None)
    torch.testing.assert_close(x[:, -1] @ model.unembed, want, rtol=0,
                               atol=0)
    for a, b in zip(used, fresh):
        for name in a:
            assert torch.equal(a[name], b[name]), name


def test_xlstm_cache_layout():
    """The reduced and the full configs' caches: the mLSTM's heads are
    2 d / H wide (16 reduced, 512 at full width, not ``head_dim``'s 8 and
    256), the state float32, m at -1e30."""
    cfg = get_config("xlstm_350m", reduced=True)
    cache = init_cache(cfg, 3, 40, device="cpu")
    assert cfg.layout() == ("slstm", "mlstm") * 2
    for blk, kind in zip(cache, cfg.layout()):
        assert all(t.dtype == torch.float32 for t in blk.values())
        if kind == "mlstm":
            assert blk["C"].shape == (3, 4, 16, 16)
            assert blk["n"].shape == (3, 4, 16)
            assert blk["m"].shape == (3, 4)
        else:
            assert {k: tuple(t.shape) for k, t in blk.items()} == {
                k: (3, 32) for k in ("c", "n", "m", "h")}
        assert (blk["m"] == -1e30).all()
        assert not any(t.any() for k, t in blk.items() if k != "m")
    full = get_config("xlstm_350m")
    assert (full.n_layers, full.d_model, full.n_heads, full.head_dim) == (
        24, 1024, 4, 256)
    assert full.layout().count("mlstm") == full.layout().count("slstm") == 12
    blk = init_cache_block(full, "mlstm", 1, 8, device="cpu")
    assert blk["C"].shape == (1, 4, 512, 512)


def test_convert_round_trip_keeps_xlstm_leaves():
    """The reference's tree (2 x [slstm, mlstm] reduced) into the port and
    back, bit for bit, in a bfloat16 model: the sLSTM's ``r`` stays
    float32, the projections are bfloat16, and the xLSTM blocks carry no
    ``ln2``/``ffn`` (the strict load would refuse a tree without them)."""
    jcfg = _jcfg(dtype="bfloat16")
    params = _reference_weights(jcfg)
    cfg = from_reference_arch_config(jcfg)
    model = from_reference_lm_params(params, cfg, device="cpu")
    s_blk, m_blk = model.blocks[0], model.blocks[1]
    assert s_blk.r.dtype == torch.float32
    assert s_blk.w_gates.dtype == m_blk.w_up.dtype == torch.bfloat16
    assert {n for n, _ in s_blk.named_parameters()} == {
        "ln", "w_gates", "r", "w_out"}
    assert {n for n, _ in m_blk.named_parameters()} == {
        "ln", "w_up", "wq", "wk", "wv", "w_if", "w_down"}
    assert m_blk.w_if.shape == (2 * cfg.d_model, 2 * cfg.n_heads)
    tree = to_reference_lm_tree(dict(model.named_parameters()), cfg)
    flat_want = jax.tree_util.tree_leaves_with_path(params)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path],
                                      np.asarray(want, np.float32))
    assert tree["period"]["pos0"]["r"].shape == (2, cfg.d_model, 4)


def test_plain_scans_train_on_the_cpu():
    """On the CPU the plain scans are differentiable: reduced xlstm's loss
    gradient (each block recomputed in the backward pass) reaches every
    parameter of both blocks, finite and not all zero."""
    cfg = get_config("xlstm_350m", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg).train()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)))
    loss, _ = loss_fn(model, cfg, {"tokens": toks, "labels": toks})
    loss.backward()
    for blk in model.blocks[:2]:
        for name, p in blk.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
            assert p.grad.abs().sum() > 0, name


# ---------------------------------------------------------------------------
# the scans' gradients: the plain backwards (the kernels' steps) against
# autograd of the plain forwards and jax.vjp of the reference's sequences
# ---------------------------------------------------------------------------

# each gradient within this share of its largest entry of the reference's
# (float32): the input gradients sum in other orders; the gates' gradients
# also carry the Q recurrence's rounding (mlstm_scan_backward_plain)
GRAD_REL = {"x": 1e-5, "gate": 1e-4}


def _mlstm_tie_inputs(seed, B, S, H, hd):
    """``_mlstm_inputs`` with gates planted for the stabiliser from the
    zero state: i_pre wins the max at t % 3 == 0 (m' = i_pre), log_f + m at
    t % 3 == 1 and ties it exactly at t % 3 == 2 (f_pre = 30: log_f ~
    -9.4e-14 leaves log_f + m = m bit for bit); and at step 0 of batch row
    0, head 0, k = q = e_0, so |n . q| == 1 exactly there (n = i_g k with
    i_g = 1): max(|s|, 1)'s tie."""
    q, k, v, i_pre, f_pre = _mlstm_inputs(seed, B, S, H, hd)
    u = np.random.default_rng(seed + 1).uniform(size=(B, S, H)).astype(
        np.float32)
    m = None
    for t in range(S):
        if t % 3 == 0:
            i_pre[:, t] = (1 + u[:, t]) if m is None else m + 1 + u[:, t]
            m = i_pre[:, t].copy()
        else:
            f_pre[:, t] = 30.0
            i_pre[:, t] = m - 1 - u[:, t] if t % 3 == 1 else m
    q[0, 0, 0] = k[0, 0, 0] = np.eye(hd, dtype=np.float32)[0]
    return q, k, v, i_pre, f_pre


def _check_grads(got, want, kinds):
    for g, w, kind in zip(got, want, kinds):
        _within_max(g, w, GRAD_REL[kind])


@pytest.mark.parametrize("B,S,H,hd,ties", [(2, 37, 4, 16, False),
                                           (2, 1, 4, 16, False),
                                           (1, 30, 2, 32, True),
                                           (2, 37, 4, 16, True)])
def test_mlstm_backward_plain_matches_autograd_and_jax(B, S, H, hd, ties,
                                                     monkeypatch):
    """``mlstm_scan_backward_plain`` (the kernel's steps: C^T dnum in a
    forward pass, G and dN in reverse, the telescoped Q) against autograd
    of ``mlstm_scan_plain`` and ``jax.vjp`` of the reference's
    ``mlstm_sequence`` on the same inputs from the zero state: dq, dk, dv
    within 1e-5 of their largest entry, d i_pre and d f_pre within 1e-4;
    B > 1, S = 1 (whose gate gradients are exactly 0), and the planted
    ties of the stabiliser's max and of max(|n . q|, 1), whose gradients
    are halved as ``jnp.maximum`` halves them."""
    arrs = (_mlstm_tie_inputs if ties else _mlstm_inputs)(S + hd, B, S, H, hd)
    dh = np.random.default_rng(S).standard_normal((B, S, H, hd)).astype(
        np.float32)
    got = ms.mlstm_scan_backward_plain(*map(_t, arrs),
                                       *ms.init_state(B, H, hd, "cpu"),
                                       _t(dh))
    _, vjp = jax.vjp(jrec.mlstm_sequence, *map(jnp.asarray, arrs))
    want = vjp(jnp.asarray(dh))
    kinds = ("x", "x", "x", "gate", "gate")
    _check_grads(got, want, kinds)
    leaves = [_t(a).requires_grad_() for a in arrs]
    h = ms.mlstm_scan_plain(*leaves, *ms.init_state(B, H, hd, "cpu"))
    _check_grads(got, torch.autograd.grad(h, leaves, _t(dh)), kinds)
    if S == 1:
        assert not got[3].any() and not got[4].any()
    if ties:
        # the planted ties are exact, and the split matters: the stabiliser's
        # tie given wholly to log_f + m misses the reference's gate gradients
        q, k, _, i_pre, f_pre = map(_t, arrs)
        m = torch.full((B, H), ms.M_INIT)
        for t in range(S):
            lfm = -softplus(-f_pre[:, t]) + m
            assert bool(((lfm - i_pre[:, t]) == 0).all()) == (t % 3 == 2)
            m = torch.maximum(lfm, i_pre[:, t])
        assert float(q[0, 0, 0] @ k[0, 0, 0]) == 1.0
        monkeypatch.setattr(ms, "tie_weight", lambda d: (d >= 0).float())
        off = ms.mlstm_scan_backward_plain(*map(_t, arrs),
                                           *ms.init_state(B, H, hd, "cpu"),
                                           _t(dh))
        err = max(float(np.abs(off[i].numpy() - np.asarray(want[i])).max())
                  / float(np.abs(np.asarray(want[i])).max()) for i in (3, 4))
        assert err > 1e-3


# ---------------------------------------------------------------------------
# the mLSTM gradient kernel's arithmetic (csrc/mlstm_scan_bwd.cu)
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """fmaf(a, b, c) in float32: the product exact in float64, the sum
    rounded to float64 and then to float32."""
    return (a.double() * b.double() + c.double()).float()


def _bwd_columns(hd):
    """The gradient kernel's split of the hd columns of a row: (halves,
    32 lanes, columns a lane) column indices, -1 where a lane holds none.
    A row group's columns are on one warp (hd <= 256) or a pair that
    halves them (hd 512); lane l holds columns half * span + 32 vec g +
    vec l + e, vec = min(columns a lane, 4)."""
    halves = 2 if hd >= 512 else 1
    span = hd // halves
    cpl = max(span // 32, 1)
    vec = min(cpl, 4)
    idx = torch.full((halves, 32, cpl), -1, dtype=torch.long)
    for h in range(halves):
        for lane in range(min(span, 32)):
            for g in range(cpl // vec):
                for e in range(vec):
                    idx[h, lane, g * vec + e] = (h * span + 32 * vec * g
                                                 + vec * lane + e)
    return idx


def _bwd_row_sums(X, y, idx):
    """out_r = sum_c X[..., r, c] y[..., c] in the kernel's order: a lane's
    columns one FMA at a time from 0, the 32 lanes pairwise at distances
    16, 8, 4, 2, 1, then a pair's second half added to its first."""
    zero = X.new_zeros(X.shape[:-1] + (1,))
    Xp = torch.cat([X, zero], -1)           # index -1: the zero column
    yp = torch.cat([y, zero[..., 0, :]], -1)
    acc = X.new_zeros(X.shape[:-1] + idx.shape[:2])
    for c in range(idx.shape[2]):
        acc = _fma(Xp[..., idx[..., c]], yp[..., idx[..., c]][..., None, :, :],
                   acc)
    width = 32
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    out = acc[..., 0]
    total = out[..., 0]
    for h in range(1, out.shape[-1]):
        total = total + out[..., h]
    return total


def _bwd_update(a, X, u, w):
    """The scans' update of X (..., rows, cols) by a (...,) and u (...,
    rows) w (..., cols)^T: fmaf(a, X, u w) with u w rounded."""
    return _fma(a[..., None, None], X, u[..., :, None] * w[..., None, :])


def _group_dot_pairs(a, b):
    """A row group's sum_r a_r b_r (4 rows): the rounded products added
    pairwise, (p0 + p1) + (p2 + p3) (the lanes' two shuffles)."""
    p = (a * b).unflatten(-1, (-1, 4))
    return (p[..., 0] + p[..., 1]) + (p[..., 2] + p[..., 3])


def _in_groups(parts, order):
    """A step's partials (..., groups) added from 0 in ``order``."""
    total = torch.zeros_like(parts[..., 0])
    for g in order:
        total = total + parts[..., g]
    return total


def _emulate_mlstm_backward_kernel(q, k, v, i_pre, f_pre, C, n, m, dh,
                                   order=None):
    """The mLSTM gradient kernel's arithmetic (csrc/mlstm_scan_bwd.cu) in
    plain torch: the gates in the exact-one form with the tie weight
    (``ms.tie_weight``) and sigmoid(-f) as 1 / (1 + exp(f)); the forward
    pass X = C^T with the fused update (``_bwd_update``: u = i_g k, w = v),
    C^T dh in the kernel's order (``_bwd_row_sums``) scaled by 1 / den
    afterwards, n walked as the plain loop rounds it, n . q and q . C^T dh
    as row groups' partials (``_group_dot_pairs``); the reverse passes G
    (u = dh / den, w = q, y = k) and G^T (u = q / den, w = dh, y = v), each
    its own update, dN walked as the plain loop, dN . k and dN . n_{t-1}
    as partials; each step's
    partials added in ``order`` (the row groups 0, 1, ... by default);
    then Q and the gates' chain as the plain backward's. Returns (dq, dk,
    dv, d i_pre, d f_pre)."""
    B, S, H, hd = q.shape
    idx = _bwd_columns(hd)
    order = range(hd // ms.SCAN_ROWS) if order is None else order
    ig, fg, wt, sgf, mt = [], [], [], [], m.clone()
    for t in range(S):
        lfm = -softplus(-f_pre[:, t]) + mt
        d = lfm - i_pre[:, t]
        e = torch.exp(-torch.abs(d))
        ig.append(torch.where(d > 0, e, torch.ones_like(e)))
        fg.append(torch.where(d > 0, torch.ones_like(e), e))
        wt.append(ms.tie_weight(d))
        sgf.append(1.0 / (1.0 + torch.exp(f_pre[:, t])))
        mt = torch.maximum(lfm, i_pre[:, t])
    X, nt = C.transpose(-1, -2).clone(), n.clone()
    dqc, ns, rden, ds, hh = [], [n.clone()], [], [], []
    for t in range(S):
        ur = ig[t][..., None] * k[:, t]
        X = _bwd_update(fg[t], X, ur, v[:, t])
        dqc.append(_bwd_row_sums(X, dh[:, t], idx))
        nt = fg[t][..., None] * nt + ur
        ns.append(nt)
        s = _in_groups(_group_dot_pairs(nt, q[:, t]), order)
        h = _in_groups(_group_dot_pairs(q[:, t], dqc[t]), order)
        rd = 1.0 / torch.clamp(torch.abs(s), min=1.0)
        sel = torch.where(torch.abs(s) > 1, torch.sign(s), torch.where(
            torch.abs(s) == 1, 0.5 * torch.sign(s), torch.zeros_like(s)))
        rden.append(rd)
        hh.append(h * rd)
        ds.append(-(hh[t] * rd) * sel)
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    di, df = torch.zeros_like(i_pre), torch.zeros_like(i_pre)
    G = torch.zeros_like(C)
    GT, dN = torch.zeros_like(C), torch.zeros_like(n)
    Q, carry = torch.zeros_like(m), torch.zeros_like(m)
    for t in range(S - 1, -1, -1):
        a = fg[t + 1] if t + 1 < S else torch.zeros_like(m)
        G = _bwd_update(a, G, dh[:, t] * rden[t][..., None], q[:, t])
        gk = _bwd_row_sums(G, k[:, t], idx)
        dv[:, t] = ig[t][..., None] * gk
        GT = _bwd_update(a, GT, q[:, t] * rden[t][..., None], dh[:, t])
        gtv = _bwd_row_sums(GT, v[:, t], idx)
        dN = ds[t][..., None] * q[:, t] + a[..., None] * dN
        dk[:, t] = ig[t][..., None] * (gtv + dN)
        dq[:, t] = _fma(ds[t][..., None], ns[t + 1],
                        dqc[t] * rden[t][..., None])
        vgk = _in_groups(_group_dot_pairs(v[:, t], gk), order)
        dnk = _in_groups(_group_dot_pairs(dN, k[:, t]), order)
        dnn = _in_groups(_group_dot_pairs(dN, ns[t]), order)
        DI = ig[t] * (vgk + dnk)
        Q = torch.where(fg[t] == 0, 0.0, (hh[t] + Q) - ig[t] * vgk)
        DF = Q + fg[t] * dnn
        di[:, t], df[:, t], carry = ms.gate_chain(DI, DF, wt[t], sgf[t],
                                                  carry)
    return dq, dk, dv, di, df


def _random_state_tie_case(seed, B, S, H, hd):
    """Inputs from a random state (C * 0.3, n, m >= 1) with the
    stabiliser's planted ties (``_tie_gates``), as phase 38's ties case."""
    q, k, v, _, _ = map(_t, _mlstm_inputs(seed, B, S, H, hd))
    rng = np.random.default_rng(seed + 2)
    C = _t((rng.standard_normal((B, H, hd, hd)) * 0.3).astype(np.float32))
    n = _t(rng.standard_normal((B, H, hd)).astype(np.float32))
    m = _t(np.abs(rng.standard_normal((B, H))).astype(np.float32) + 1)
    i_pre, f_pre = _tie_gates(seed, B, S, H, m)
    return (q, k, v, i_pre, f_pre), (C, n, m)


@pytest.mark.parametrize("B,S,H,hd,ties", [(2, 37, 4, 16, False),
                                           (3, 20, 4, 64, False),
                                           (1, 30, 2, 32, True),
                                           (2, 37, 4, 16, True),
                                           (1, 19, 2, 512, True)])
def test_mlstm_backward_kernel_arithmetic_matches_jax(B, S, H, hd, ties,
                                                      monkeypatch):
    """The gradient kernel's arithmetic (``_emulate_mlstm_backward_kernel``:
    its column split and tree, the row groups' partials added in order, its
    fused updates, C^T dh scaled afterwards, the Q recurrence) against
    ``mlstm_scan_backward_plain`` and ``jax.vjp`` of the reference's
    ``mlstm_sequence`` from the zero state, within phase 38's limits (dq,
    dk, dv 1e-5 of their largest entry, the gates' 1e-4); at ragged S, at
    xlstm-350m's head width (a pair of warps a row group) and at the
    planted ties of the stabiliser and of max(|n . q|, 1). The row groups
    added in reverse change the bits and stay within the limits; one row
    group left out, or the stabiliser's tie given wholly to log_f + m,
    misses the reference."""
    arrs = (_mlstm_tie_inputs if ties else _mlstm_inputs)(S + hd, B, S, H, hd)
    dh = np.random.default_rng(S).standard_normal((B, S, H, hd)).astype(
        np.float32)
    args = (*map(_t, arrs), *ms.init_state(B, H, hd, "cpu"), _t(dh))
    got = _emulate_mlstm_backward_kernel(*args)
    kinds = ("x", "x", "x", "gate", "gate")
    _check_grads(got, ms.mlstm_scan_backward_plain(*args), kinds)
    _, vjp = jax.vjp(jrec.mlstm_sequence, *map(jnp.asarray, arrs))
    want = [np.asarray(w, np.float32) for w in vjp(jnp.asarray(dh))]
    _check_grads(got, want, kinds)
    groups = hd // ms.SCAN_ROWS
    back = _emulate_mlstm_backward_kernel(*args, order=range(groups)[::-1])
    _check_grads(back, want, kinds)
    assert any(not torch.equal(a, b) for a, b in zip(back, got))

    def worst(res):
        return max(float(np.abs(_np(r) - w).max()) / float(np.abs(w).max())
                   for r, w in zip(res, want))
    assert worst(_emulate_mlstm_backward_kernel(
        *args, order=range(groups - 1))) > 1e-3
    if ties:
        monkeypatch.setattr(ms, "tie_weight", lambda d: (d >= 0).float())
        assert worst(_emulate_mlstm_backward_kernel(*args)) > 1e-3


@pytest.mark.parametrize("B,S,H,hd", [(2, 21, 2, 64), (1, 13, 2, 512)])
def test_mlstm_backward_kernel_arithmetic_from_a_random_state(B, S, H, hd):
    """The gradient kernel's arithmetic from a random state (C, n, m, the
    stabiliser's ties planted), as phase 38's ties case, against
    ``mlstm_scan_backward_plain`` within phase 38's limits."""
    (q, k, v, i_pre, f_pre), state = _random_state_tie_case(hd + S, B, S, H,
                                                            hd)
    dh = _t(np.random.default_rng(hd).standard_normal(
        (B, S, H, hd)).astype(np.float32))
    args = (q, k, v, i_pre, f_pre, *state, dh)
    _check_grads(_emulate_mlstm_backward_kernel(*args),
                 ms.mlstm_scan_backward_plain(*args),
                 ("x", "x", "x", "gate", "gate"))


@pytest.mark.parametrize("B,S,w,dt", [(2, 37, 16, "float32"),
                                      (3, 1, 16, "float32"),
                                      (2, 29, 16, "bfloat16")])
def test_slstm_backward_plain_matches_autograd_and_jax(B, S, w, dt):
    """``slstm_scan_backward_plain`` against autograd of
    ``slstm_scan_plain`` and ``jax.vjp`` of the reference's
    ``slstm_sequence`` from the zero state: dgates (in the gates' type)
    within 1e-5 of its largest entry (bf16: two bf16 steps of each entry
    plus that, the rounding of the float32 gradient), dr within 1e-4."""
    rng = np.random.default_rng(S + w)
    gates = (rng.standard_normal((B, S, w, 4)) * 2).astype(np.float32)
    r = (rng.standard_normal((w, 4)) * 0.5).astype(np.float32)
    dhs = rng.standard_normal((B, S, w)).astype(np.float32)
    tg = _t(gates).to(getattr(torch, dt))
    got = ss.slstm_scan_backward_plain(tg, _t(r), *ss.init_state(B, w, "cpu"),
                                       _t(dhs))
    assert got[0].dtype == tg.dtype and got[1].dtype == torch.float32
    jg = jnp.asarray(tg.float().numpy()).astype(jnp.bfloat16) \
        if dt == "bfloat16" else jnp.asarray(gates)
    _, vjp = jax.vjp(jrec.slstm_sequence, jg, jnp.asarray(r))
    jwant = vjp(jnp.asarray(dhs))
    leaves = [tg.clone().requires_grad_(), _t(r).requires_grad_()]
    hs = ss.slstm_scan_plain(*leaves, *ss.init_state(B, w, "cpu"))
    for want in (jwant, torch.autograd.grad(hs, leaves, _t(dhs))):
        wg = np.asarray(_np(want[0]) if isinstance(want[0], torch.Tensor)
                        else np.asarray(want[0], np.float32))
        scale = float(np.abs(wg).max())
        diff = np.abs(_np(got[0]) - wg)
        if dt == "float32":
            assert float(diff.max()) <= 1e-5 * scale
        else:
            assert not (diff > 2.0 ** -7 * np.abs(wg) + 1e-5 * scale).any()
        _within_max(got[1], want[1] if not isinstance(want[1], torch.Tensor)
                    else _np(want[1]), GRAD_REL["gate"])


def _emulate_slstm_backward_kernel(gates, r, c, n, m, h, dhs):
    """``csrc/slstm_scan_bwd.cu``'s arithmetic in plain torch (float32):
    the state before every step as the forward's saving launch stores it
    (``slstm_scan_plain(..., save=True)``), every step's coefficients as
    the producers compute them (the exact-one gates), then the chain
    warp's reverse step as ``chain_step`` writes it: each product added
    to a sum fused with it (``_fma``), a / n_t as q = a r, then
    q + (a - n_t q) r, with r the reciprocal of n_t (the kernel refines
    the hardware's approximation of it; IEEE 1 / n_t here), dr's sums
    over t in reverse and over the batch rows in order."""
    B, S, w, _ = gates.shape
    dhs = dhs.float()
    hs, (cs_, ns_, ms_) = ss.slstm_scan_plain(
        gates, r, *(t.clone() for t in (c, n, m, h)), save=True)
    h_prev = torch.cat([h[:, None], hs[:, :-1]], dim=1)
    pre = gates.float() + h_prev[..., None] * r
    z, o = torch.tanh(pre[..., 0]), torch.sigmoid(pre[..., 3])
    i_g, f_g, _ = _one_exp_gates(pre[..., 1], pre[..., 2], ms_)
    d = (-softplus(-pre[..., 2]) + ms_) - pre[..., 1]
    c_t = f_g * cs_ + i_g * z
    inner = f_g * ns_ + i_g
    n_t = torch.clamp(inner, min=ss.N_FLOOR)
    cn, rn = c_t / n_t, 1.0 / n_t
    mask, wt = ms.tie_weight(inner - ss.N_FLOOR), ms.tie_weight(d)
    zz, sgf, oo = 1.0 - z * z, torch.sigmoid(-pre[..., 2]), o * (1.0 - o)

    def div(a, t):
        q = a * rn[:, t]
        return _fma(rn[:, t], _fma(-n_t[:, t], q, a), q)
    fb, dc, dn, carry = (torch.zeros((B, w)) for _ in range(4))
    dpre = torch.empty((B, S, w, 4))
    dr_b = torch.zeros((B, w, 4))
    for t in range(S - 1, -1, -1):
        dH = dhs[:, t] + fb
        d_o, dcn = dH * cn[:, t], dH * o[:, t]
        dc = dc + div(dcn, t)
        dn = (dn - div(dcn * cn[:, t], t)) * mask[:, t]
        DF = f_g[:, t] * _fma(dn, ns_[:, t], dc * cs_[:, t])
        DI = i_g[:, t] * _fma(dc, z[:, t], dn)
        am = carry - (DI + DF)
        dlfm = _fma(wt[:, t], am, DF)
        dp = torch.stack([(dc * i_g[:, t]) * zz[:, t],
                          _fma(1.0 - wt[:, t], am, DI), dlfm * sgf[:, t],
                          d_o * oo[:, t]], dim=-1)
        dc, dn, carry = dc * f_g[:, t], dn * f_g[:, t], dlfm
        fb = _fma(dp[..., 3], r[:, 3], _fma(dp[..., 2], r[:, 2], _fma(
            dp[..., 1], r[:, 1], dp[..., 0] * r[:, 0])))
        dpre[:, t] = dp
        dr_b = dr_b + dp * h_prev[:, t, :, None]
    dr = dr_b[0]
    for b in range(1, B):
        dr = dr + dr_b[b]
    return dpre.to(gates.dtype), dr, (d == 0, inner == ss.N_FLOOR)


def _slstm_tie_case(seed, B, S, w, case):
    """Gates, r and the state for the emulation test: ``plain`` random
    gates from the zero state; ``ties`` every third channel planted so
    that log_f + m == i_pre at every step after the first (r_i = r_f =
    0, i_pre = 2, f_pre = 30: softplus(-30) vanishes beside m = 2), from
    the zero state; ``floor`` a random state whose even channels hold n
    at its 1e-6 floor (i_g exactly 0: i_pre = -300, f_pre = 30, m = 0, so
    f n + i == 1e-6, a tie of the floor's max) or below it."""
    rng = np.random.default_rng(seed)
    gates = (rng.standard_normal((B, S, w, 4)) * 2).astype(np.float32)
    r = (rng.standard_normal((w, 4)) * 0.5).astype(np.float32)
    state = [a.numpy() for a in ss.init_state(B, w, "cpu")]
    if case == "ties":
        r[::3, 1:3] = 0.0
        gates[:, :, ::3, 1], gates[:, :, ::3, 2] = 2.0, 30.0
    elif case == "floor":
        c, m, h = (rng.standard_normal((B, w)).astype(np.float32)
                   for _ in range(3))
        n = (np.abs(rng.standard_normal((B, w))) + 0.5).astype(np.float32)
        n[:, ::2] = np.float32(1e-6)
        n[:, 2::4] = np.float32(1e-7)
        m[:, ::2] = 0.0
        r[::2, 1:3] = 0.0
        gates[:, :, ::2, 1], gates[:, :, ::2, 2] = -300.0, 30.0
        state = [c, n, m, h]
    return gates, r, state


@pytest.mark.parametrize("B,S,w,dt,case", [(2, 37, 16, "float32", "plain"),
                                           (3, 70, 33, "float32", "ties"),
                                           (2, 29, 13, "bfloat16", "ties"),
                                           (1, 45, 7, "float32", "floor"),
                                           (2, 40, 16, "bfloat16",
                                            "floor")])
def test_slstm_backward_kernel_arithmetic_matches_jax(B, S, w, dt, case):
    """The sLSTM gradient kernel's arithmetic emulated in plain torch
    (``_emulate_slstm_backward_kernel``: the FMAs and the division by
    n_t through its reciprocal) against ``slstm_scan_backward_plain`` and
    ``jax.vjp`` of the reference (``slstm_sequence`` from the zero state,
    its ``_slstm_cell`` scanned from a random one) within phase 38's
    limits: float32 dgates within 1e-5 of its largest entry (bf16: two
    bf16 steps of each entry plus that), dr within 1e-4; ragged S and w,
    planted ties of log_f + m with i_pre and n at its 1e-6 floor (the
    planted ties are checked to be there; a max's share at them moves
    the gradients little, since the stabiliser's total derivative
    cancels and n at its floor scales what it feeds, while an error of
    1e-4 in dc's update misses the limits)."""
    gates, r, state = _slstm_tie_case(S * w + B, B, S, w, case)
    dhs = np.random.default_rng(S).standard_normal((B, S, w)).astype(
        np.float32)
    tg = _t(gates).to(getattr(torch, dt))
    tst = [_t(a) for a in state]
    got_g, got_r, (ties, floor) = _emulate_slstm_backward_kernel(
        tg, _t(r), *tst, _t(dhs))
    if case == "ties":
        assert int(ties.sum()) >= (S - 1) * B * len(range(0, w, 3))
    if case == "floor":
        assert int(floor.sum()) >= S * B * len(range(0, w, 4))
    jg = jnp.asarray(tg.float().numpy()).astype(getattr(jnp, dt))
    if case == "floor":
        def seq(g, rr):
            _, out = jax.lax.scan(
                lambda s, x: jrec._slstm_cell(s, x, rr),
                jrec.SLSTMState(*(jnp.asarray(a) for a in state)),
                g.transpose(1, 0, 2, 3))
            return out.transpose(1, 0, 2)
    else:
        seq = jrec.slstm_sequence
    _, vjp = jax.vjp(seq, jg, jnp.asarray(r))
    jwant = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(dhs))]
    plain = ss.slstm_scan_backward_plain(tg, _t(r), *tst, _t(dhs))
    assert got_g.dtype == tg.dtype and got_r.dtype == torch.float32
    for want_g, want_r in ((_np(plain[0]), _np(plain[1])), jwant):
        scale = float(np.abs(want_g).max())
        diff = np.abs(_np(got_g) - want_g)
        lim = 1e-5 * scale + (2.0 ** -7 * np.abs(want_g)
                              if dt == "bfloat16" else 0.0)
        assert not (diff > lim).any(), float(diff.max())
        _within_max(got_r, want_r, GRAD_REL["gate"])


def test_xlstm_gradients_match_jax():
    """Reduced xlstm-350m (4 layers [slstm, mlstm] x 2, d 32) trains
    through the plain scans on the CPU: its loss and all 14 leaves'
    gradients against ``jax.value_and_grad`` of the reference's
    ``loss_fn`` on the same weights and tokens, each leaf within 2e-5 of
    its largest |g|, the loss rtol 1e-5."""
    jcfg = _jcfg()
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
    assert len(flat_j) == len(flat_t) == 14
    for path, want in flat_j:
        want = np.asarray(want, np.float32)
        err = float(np.abs(flat_t[path] - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()), \
            (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# the wrappers' guards, the launcher
# ---------------------------------------------------------------------------

def test_scan_gradient_off_the_cpu_names_roadmap_item():
    """Off the CPU the scans run only on CUDA tensors: a call that needs a
    gradient (which would go through ``MLSTMScan`` / ``SLSTMScan`` and
    their backward kernels) is refused on any other device before any
    launch (meta tensors stand in for them here), as is the same call
    without a gradient and each backward wrapper."""
    meta = dict(device="meta")
    q = torch.empty((1, 3, 2, 16), requires_grad=True, **meta)
    g = torch.empty((1, 3, 2, 16), **meta)
    gp = torch.empty((1, 3, 2), **meta)
    state = (torch.empty((1, 2, 16, 16), **meta),
             torch.empty((1, 2, 16), **meta), torch.empty((1, 2), **meta))
    gates = torch.empty((1, 3, 8, 4), requires_grad=True, **meta)
    r = torch.empty((8, 4), **meta)
    sstate = [torch.empty((1, 8), **meta) for _ in range(4)]
    before = (ms.mlstm_scan.launches, ss.slstm_scan.launches,
              ms.mlstm_scan_backward.launches,
              ss.slstm_scan_backward.launches)
    with pytest.raises(ValueError, match="unsupported device"):
        ms.mlstm_scan(q, g, g, gp, gp, *state)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.slstm_scan(gates, r, *sstate)
    with torch.no_grad():
        with pytest.raises(ValueError, match="unsupported device"):
            ms.mlstm_scan(q, g, g, gp, gp, *state)
        with pytest.raises(ValueError, match="unsupported device"):
            ss.slstm_scan(gates, r, *sstate)
    with pytest.raises(ValueError, match="unsupported device"):
        ms.mlstm_scan_backward(q, g, g, gp, gp, *state, g)
    with pytest.raises(ValueError, match="unsupported device"):
        ss.slstm_scan_backward(gates, r, *sstate,
                               torch.empty((1, 3, 8), **meta))
    assert (ms.mlstm_scan.launches, ss.slstm_scan.launches,
            ms.mlstm_scan_backward.launches,
            ss.slstm_scan_backward.launches) == before


def test_scan_wrappers_reject_bad_inputs():
    q = torch.zeros((1, 3, 2, 16))
    gp = torch.zeros((1, 3, 2))
    C, n, m = ms.init_state(1, 2, 16, "cpu")
    with pytest.raises(ValueError, match="expected float32"):
        ms.mlstm_scan(q, q, q, gp, gp, C[..., :8], n, m)
    with pytest.raises(ValueError, match="expected float32"):
        ms.mlstm_scan(q, q.double(), q, gp, gp, C, n, m)
    with pytest.raises(ValueError, match="must be contiguous"):
        ms.mlstm_scan(q, q, q, gp, gp, C.transpose(2, 3), n, m)
    gates = torch.zeros((1, 3, 8, 4))
    state = list(ss.init_state(1, 8, "cpu"))
    with pytest.raises(ValueError, match="expected float32"):
        ss.slstm_scan(gates, torch.zeros((8, 4)).bfloat16(), *state)
    with pytest.raises(ValueError, match="expected \\(B, S, w, 4\\)"):
        ss.slstm_scan(gates[..., :3], torch.zeros((8, 4)), *state)
    with pytest.raises(TypeError, match="gates are"):
        ss.slstm_scan(gates.half(), torch.zeros((8, 4)), *state)
    with pytest.raises(ValueError, match="must be contiguous"):
        ss.slstm_scan(gates[:, :, :4], torch.zeros((4, 4)),
                      *(torch.zeros((1, 8))[:, ::2] for _ in range(4)))


def test_serve_launcher_runs_xlstm_on_cpu(capsys):
    """``launch.serve --arch xlstm_350m --reduced --device cpu`` serves
    its 8 requests; without ``--device cpu`` it exits 2 where there is no
    GPU."""
    assert launch_serve.main(["--arch", "xlstm_350m", "--reduced",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("served 8 requests, 128 tokens")
    if not torch.cuda.is_available():
        assert launch_serve.main(["--arch", "xlstm_350m", "--reduced"]) == 2
