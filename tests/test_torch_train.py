"""The port's training path (``repro_torch.train``, ``data``,
``checkpoint``, ``launch.train``, the attention gradient) against the
JAX package on the CPU, at reduced size, on the same numpy inputs and
the reference's weights carried across by ``convert``.

Bounds, each with its reason:
- the attention gradient's plain version: within 1e-5 of each
  gradient's largest entry, against autograd through the forward's plain
  version and against ``jax.vjp`` of the reference's
  ``blockwise_attention`` (float32; the sums run in other orders);
- loss and gradients of the model: loss rtol 1e-5, every leaf within
  1e-4 of its largest |g| (float32: XLA and PyTorch sum the products and
  the softmax in other orders); bfloat16: loss rtol 2e-2 and leaves
  within 5e-2 of their largest |g|, since the two frameworks round to
  bfloat16 at other places (each matmul output, the attention output)
  and a bf16 step is 2^-8 relative;
- AdamW and the clip: XLA on the CPU contracts the two moment updates
  into fused multiply-adds, ``m = fma(b1, m, (1 - b1) g)`` and
  ``v = fma(b2, v, ((1 - b2) g) g)``, where the port rounds ``b1 m`` and
  ``b2 v`` before the add (one rounding more); its ``pow`` for the bias
  corrections and its reduction order for the norm are its own: m, v
  and the norm within rtol 1e-6, the parameters within 1e-6 of the
  leaf's largest entry;
- three train steps: losses and grad norms rtol 1e-5; at every step
  each gradient leaf after the clip within 1e-4 of its largest |g| (as
  above: this is the check that pins the step); every parameter within
  2e-3 lr per step taken where AdamW's step has been well-conditioned,
  that is where the reference's |m-hat| was 0 or at least 100 eps at
  every step so far. AdamW's step m-hat / (sqrt(v-hat) + eps) is
  scale-free, so where 0 < |g| ~ eps it is lr g / (|g| + eps), and a
  last-bit difference of g (the frameworks sum in other orders) moves
  it by a share of lr, not of g. There the parameter is held to the
  step's own bound, 2 lr per step taken (at b1 0.9 and b2 0.95,
  |m-hat / (sqrt(v-hat) + eps)| stays at or under about 1 over three
  steps), and such elements are at most 0.1% of the model's at each
  step;
- the token pipeline, checkpoints and resume: bit for bit.
The kernel itself is held to its plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py phase 23).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.models import ArchConfig as JArchConfig
from repro.models import attention as jattn
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch import convert
from repro_torch.checkpoint import latest_step, list_steps, restore, save
from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokenPipeline, make_batch_specs
from repro_torch.examples import train_lm
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)
from repro_torch.kernels.ops import flash_mha
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params, loss_fn
from repro_torch.train import loop, optimizer

torch.set_num_threads(1)


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
# the attention gradient
# ---------------------------------------------------------------------------

FLASH_CASES = [  # B, S, T, H, hd, causal, window, q_offset
    (2, 37, 37, 3, 16, True, 0, 0),       # causal, ragged tiles
    (1, 64, 64, 2, 16, True, 9, 0),       # sliding window
    (1, 20, 60, 2, 16, True, 0, 40),      # prefill continuation
    (1, 33, 50, 2, 8, False, 0, 0),       # non-causal, ragged T
    (1, 600, 900, 1, 8, True, 200, 300),  # window and offset over chunks
    (1, 70, 70, 2, 256, True, 32, 0),     # recurrentgemma's head width
]


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset", FLASH_CASES)
def test_flash_gradient_matches_autograd_and_jax(B, S, T, H, hd, causal,
                                                 window, q_offset):
    rng = np.random.default_rng(S + T)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, hd), (B, T, H, hd), (B, T, H, hd)))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def jf(q_, k_, v_):
        return jattn.blockwise_attention(q_, k_, v_, chunk_q=64, chunk_k=64,
                                         **kw)
    _, vjp = jax.vjp(jf, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want_jax = vjp(jnp.asarray(do))

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_plain(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), **kw)
    want_ag = torch.autograd.grad(out, (tq, tk, tv), _t(do).transpose(1, 2))
    got = flash_attention_bwd_plain(
        tq.detach().transpose(1, 2), tk.detach().transpose(1, 2),
        tv.detach().transpose(1, 2), out.detach(), _t(do).transpose(1, 2),
        **kw)
    for name, g, a, j in zip("qkv", got, want_ag, want_jax):
        _rel_close(g.transpose(1, 2), a, 1e-5, f"d{name} vs autograd")
        _rel_close(g.transpose(1, 2), j, 1e-5, f"d{name} vs jax.vjp")
    # the same gradient through flash_mha's autograd function
    before = flash_attention_bwd.launches
    got_mha = torch.autograd.grad(flash_mha(tq, tk, tv, **kw), (tq, tk, tv),
                                  _t(do))
    assert flash_attention_bwd.launches == before  # plain version on CPU
    for name, g, j in zip("qkv", got_mha, want_jax):
        _rel_close(g, j, 1e-5, f"d{name} flash_mha vs jax.vjp")


def test_flash_gradient_rejects_mismatched_inputs():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="must be q's"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 3, 8))
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention_bwd(q, q, q, q.bfloat16(), q.bfloat16())


# ---------------------------------------------------------------------------
# loss and gradients of the model
# ---------------------------------------------------------------------------

def _reference_weights(jcfg, seed=0):
    """The reference's init with its zero leaves (norm gains, biases)
    replaced by small draws, so every parameter takes a gradient."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def _windowed_config(**kw):
    """A tiny config with a local_attn layer and a windowed attn layer
    (3 layers over a 2-kind pattern, so the reference has a ``rem``)."""
    base = dict(name="tiny_local", family="hybrid", n_layers=3, d_model=32,
                n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64,
                vocab_size=101, dtype="float32",
                pattern=("attn", "local_attn"), local_window=4, window=6)
    base.update(kw)
    return JArchConfig(**base)


GRAD_CASES = {"qwen3": (lambda: jget_config("qwen3_4b", reduced=True),
                        1e-5, 1e-4),
              "windowed": (_windowed_config, 1e-5, 1e-4),
              "qwen3_bf16": (lambda: dataclasses.replace(
                  jget_config("qwen3_4b", reduced=True), dtype="bfloat16"),
                  2e-2, 5e-2)}


def _batch(cfg, B=2, S=12, seed=5):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_gradients_match_reference(case):
    make, loss_rtol, grad_tol = GRAD_CASES[case]
    jcfg = make()
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg,
                                             device="cpu").train()
    toks = _batch(cfg)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jbatch)
    tbatch = {"tokens": _t(toks).long(), "labels": _t(toks).long()}
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


def test_serving_parameters_take_no_gradients():
    cfg = get_config("qwen3_4b", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    assert not any(p.requires_grad for p in model.parameters())
    assert all(p.requires_grad for p in model.train().parameters())
    assert not any(p.requires_grad for p in model.eval().parameters())
    state = loop.init_train_state(model)
    assert all(p.requires_grad for p in state.params.parameters())


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def _trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    p = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         shapes.items()}
    g = {k: (rng.standard_normal(s) * 3).astype(np.float32) for k, s in
         shapes.items()}
    m = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in
         shapes.items()}
    v = {k: np.abs(rng.standard_normal(s) * 0.01).astype(np.float32) for
         k, s in shapes.items()}
    return p, g, m, v


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, g, _, _ = _trees(1)
    jg, jnorm = jopt.clip_by_global_norm(
        {k: jnp.asarray(x) for k, x in g.items()}, max_norm)
    tg, tnorm = optimizer.clip_by_global_norm(
        {k: _t(x) for k, x in g.items()}, max_norm)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("count", [0, 7])
def test_adamw_update_matches_reference(count):
    p, g, m, v = _trees(2)
    lr = optimizer.warmup_cosine(count + 1, 3e-4, 5, 50)
    jlr = jopt.warmup_cosine(jnp.int32(count + 1), 3e-4, 5, 50)
    np.testing.assert_allclose(lr, float(jlr), rtol=1e-6)
    jstate = jopt.AdamWState(m={k: jnp.asarray(x) for k, x in m.items()},
                             v={k: jnp.asarray(x) for k, x in v.items()},
                             count=jnp.int32(count))
    jp, js = jax.jit(jopt.adamw_update)(
        {k: jnp.asarray(x) for k, x in g.items()}, jstate,
        {k: jnp.asarray(x) for k, x in p.items()}, jnp.float32(lr))
    tp = {k: _t(x) for k, x in p.items()}
    ts = optimizer.AdamWState(m={k: _t(x) for k, x in m.items()},
                              v={k: _t(x) for k, x in v.items()},
                              count=count)
    tp2, ts2 = optimizer.adamw_update({k: _t(x) for k, x in g.items()}, ts,
                                      tp, lr)
    assert ts2.count == int(js.count) == count + 1
    for k in p:
        np.testing.assert_allclose(ts2.m[k].numpy(), np.asarray(js.m[k]),
                                   rtol=1e-6)
        np.testing.assert_allclose(ts2.v[k].numpy(), np.asarray(js.v[k]),
                                   rtol=1e-6)
        _rel_close(tp2[k], jp[k], 1e-6, k)
        assert tp2[k] is tp[k]  # in place


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 4, 5, 6, 30, 50, 80):
        np.testing.assert_allclose(
            optimizer.warmup_cosine(step, 1e-3, 5, 50),
            float(jopt.warmup_cosine(jnp.int32(step), 1e-3, 5, 50)),
            rtol=1e-6)


# ---------------------------------------------------------------------------
# train steps, the pipeline, checkpoints
# ---------------------------------------------------------------------------

def _jax_state(jcfg, np_params):
    return jloop.init_train_state(jax.tree.map(jnp.asarray, np_params))


def _reference_clipped_grads(jcfg, **kw):
    """A jitted function of (state, batch) that returns the clipped
    gradients the reference's ``make_train_step`` hands to AdamW: the
    step traced with the update replaced by one that returns them as
    the new parameters (the patch lives only while the step is traced)."""
    step = jloop.make_train_step(jcfg, **kw)
    real = jloop.adamw_update

    def grads_of(state, batch):
        jloop.adamw_update = lambda grads, opt, params, lr: (grads, opt)
        try:
            return step(state, batch)[0].params
        finally:
            jloop.adamw_update = real
    return jax.jit(grads_of)


# AdamW's eps (the reference's default), and the share of the model's
# elements whose step may be ill-conditioned at one train step
ADAM_EPS = 1e-8
ILL_SHARE = 1e-3


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum, monkeypatch):
    """Three steps of ``make_train_step`` from the same weights on the
    same batches (clip 1.0, so the clip is live): losses, grad norms,
    every gradient leaf after the clip, and every parameter after each
    step, the parameters held as the docstring's bounds list says."""
    jcfg = jget_config("qwen3_4b", reduced=True)
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    jstate = _jax_state(jcfg, np_params)
    state = convert.from_reference_train_state(
        jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10, accum=accum)
    jstep = jax.jit(jloop.make_train_step(jcfg, **kw))
    jgrads_of = _reference_clipped_grads(jcfg, **kw)
    tstep = loop.make_train_step(cfg, **kw)
    seen = {}
    real_update = loop.adamw_update

    def spy(grads, *args, **kwargs):
        seen["grads"] = {n: g.clone() for n, g in grads.items()}
        return real_update(grads, *args, **kwargs)

    pipe = SyntheticTokenPipeline(cfg, 4, 16, seed=3)
    ill = None   # elements whose AdamW step has been ill-conditioned
    n_elems = sum(int(np.size(x)) for x in jax.tree.leaves(jstate.params))
    monkeypatch.setattr(loop, "adamw_update", spy)
    for t in range(3):
        batch = pipe.next_batch()
        jbatch = {k: jnp.asarray(x) for k, x in batch.items()}
        jgrads = jgrads_of(jstate, jbatch)
        jstate, jm = jstep(jstate, jbatch)
        state, tm = tstep(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
        tgrads = dict(jax.tree_util.tree_flatten_with_path(
            convert.to_reference_lm_tree(seen.pop("grads"), cfg))[0])
        for path, want in jax.tree_util.tree_flatten_with_path(
                jgrads)[0]:
            want = np.asarray(want)
            np.testing.assert_allclose(
                tgrads[path], want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()),
                err_msg=f"step {t} grad {jax.tree_util.keystr(path)}")
        # the reference's bias-corrected first moment after this step
        bc1 = 1.0 - 0.9 ** (t + 1)
        m_hat = {p: np.abs(np.asarray(m)) / bc1 for p, m in
                 jax.tree_util.tree_flatten_with_path(jstate.opt.m)[0]}
        now_ill = {p: (m > 0) & (m < 100 * ADAM_EPS)
                   for p, m in m_hat.items()}
        ill = now_ill if ill is None else {
            p: ill[p] | now_ill[p] for p in ill}
        got = convert.to_reference_lm_tree(
            dict(state.params.named_parameters()), cfg)
        flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        for path, want in jax.tree_util.tree_flatten_with_path(
                jstate.params)[0]:
            diff = np.abs(np.asarray(flat_t[path], np.float32)
                          - np.asarray(want, np.float32))
            bound = np.where(ill[path], 2 * kw["peak_lr"],
                             2e-3 * kw["peak_lr"]) * (t + 1)
            worst = int(np.argmax(diff - bound))
            assert (diff <= bound).all(), (
                f"step {t} {jax.tree_util.keystr(path)}: element "
                f"{worst} off by {diff.flat[worst]:.3g}, bound "
                f"{bound.flat[worst]:.3g}")
        n_ill = sum(int(m.sum()) for m in now_ill.values())
        assert n_ill <= ILL_SHARE * n_elems, (t, n_ill, n_elems)
    assert state.step == int(jstate.step) == 3
    assert state.opt.count == int(jstate.opt.count) == 3


def test_pipeline_batches_bitwise():
    jcfg = jget_config("qwen3_4b", reduced=True)
    cfg = get_config("qwen3_4b", reduced=True)
    a = JPipeline(jcfg, 8, 32, seed=11, process_index=1, process_count=2)
    b = SyntheticTokenPipeline(cfg, 8, 32, seed=11, process_index=1,
                               process_count=2)
    for _ in range(5):
        x, y = a.next_batch(), b.next_batch()
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    a.seek(2)
    b.seek(2)
    assert b.state() == {"step": 2}
    x, y = a.next_batch(), b.next_batch()
    for k in x:
        np.testing.assert_array_equal(x[k], y[k])
    c = SyntheticTokenPipeline(cfg, 4, 8)
    assert (c.pi, c.pc) == (0, 1)  # no process group: one process
    specs = make_batch_specs(cfg, 4, 8)
    assert specs["tokens"].device.type == "meta"
    assert tuple(specs["labels"].shape) == (4, 8)
    assert specs["tokens"].dtype == torch.int32


def _small_state(dtype="float32", seed=0):
    cfg = dataclasses.replace(get_config("qwen3_4b", reduced=True),
                              dtype=dtype)
    model = init_params(torch.Generator().manual_seed(seed), cfg)
    return cfg, loop.init_train_state(model)


def test_checkpoint_round_trip_bitwise(tmp_path):
    """bf16 parameters, float32 moments and the counters come back bit for
    bit, in the target's structure; ``keep`` drops the oldest steps."""
    cfg, state = _small_state("bfloat16")
    step_fn = loop.make_train_step(cfg, warmup=1, total_steps=5)
    pipe = SyntheticTokenPipeline(cfg, 2, 8)
    state, _ = step_fn(state, pipe.next_batch())
    for s in (1, 2, 3, 4):
        save(str(tmp_path), s, state, keep=3)
    assert list_steps(str(tmp_path)) == [2, 3, 4]
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == [
        f"step_{s:08d}_p0.npz" for s in (2, 3, 4)]
    _, fresh = _small_state("bfloat16", seed=1)
    back = restore(str(tmp_path), 4, fresh)
    assert back.params is fresh.params  # loaded in place
    assert back.step == state.step == 1 and back.opt.count == 1
    for (n, a), (_, b) in zip(state.params.named_parameters(),
                              back.params.named_parameters()):
        assert a.dtype == b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), n
    for tree in ("m", "v"):
        for n, a in getattr(state.opt, tree).items():
            assert torch.equal(a, getattr(back.opt, tree)[n]), (tree, n)
    other_cfg, other = _small_state()
    other_params = init_params(torch.Generator(), dataclasses.replace(
        other_cfg, d_ff=other_cfg.d_ff * 2))
    with pytest.raises(ValueError, match="different config"):
        restore(str(tmp_path), 4, loop.init_train_state(other_params))


def test_train_loop_resume_bitwise(tmp_path):
    """4 steps straight against 2 steps, a checkpoint, a fresh state and
    2 more steps restored from it: the same parameters, m and v."""
    def run(n_steps, ckpt_dir=None):
        cfg, state = _small_state()
        step_fn = loop.make_train_step(cfg, warmup=1, total_steps=4)
        pipe = SyntheticTokenPipeline(cfg, 2, 8, seed=4)
        return loop.train_loop(state, step_fn, pipe, n_steps,
                               ckpt_dir=ckpt_dir, ckpt_every=2, log_every=0)
    straight = run(4)
    ck = str(tmp_path / "ck")
    run(2, ck)
    assert latest_step(ck) == 2
    resumed = run(4, ck)
    assert resumed.step == straight.step == 4
    for (n, a), (_, b) in zip(straight.params.named_parameters(),
                              resumed.params.named_parameters()):
        assert torch.equal(a, b), n
    for tree in ("m", "v"):
        for n, a in getattr(straight.opt, tree).items():
            assert torch.equal(a, getattr(resumed.opt, tree)[n]), (tree, n)


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_launch_train_and_example_run_on_cpu(tmp_path, capsys):
    assert launch_train.main(["--arch", "qwen3_4b", "--reduced", "--device",
                              "cpu", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--ckpt-dir",
                              str(tmp_path / "a"), "--ckpt-every", "2"]) == 0
    assert "done at step 3" in capsys.readouterr().out
    assert latest_step(str(tmp_path / "a")) == 2
    assert train_lm.main(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path / "b")]) == 0
    assert "finished at step 2" in capsys.readouterr().out


def test_launchers_default_to_the_card_and_name_item_13h():
    """The launchers default to the card and exit 2 without one;
    ``--model-shards 2`` without a process group fails as the
    reference's does (one rank is not divisible by 2: ``make_host_mesh``'s
    assertion); ``elastic_remesh`` onto the 1 x 1 host mesh leaves every
    leaf as it is."""
    if not torch.cuda.is_available():
        assert launch_train.main(["--reduced", "--steps", "1"]) == 2
        assert train_lm.main(["--steps", "1"]) == 2
    with pytest.raises(AssertionError):
        launch_train.main(["--reduced", "--device", "cpu",
                           "--model-shards", "2"])
    from repro_torch.launch.mesh import make_host_mesh
    cfg, state = _small_state()
    before = dict(state.params.named_parameters())
    m, v = dict(state.opt.m), dict(state.opt.v)
    back = loop.elastic_remesh(state, loop.train_state_shardings(
        cfg, make_host_mesh(), state.params))
    assert back.params is state.params and back.step == state.step
    assert all(p is before[n] for n, p in back.params.named_parameters())
    assert all(back.opt.m[n] is m[n] and back.opt.v[n] is v[n] for n in m)
