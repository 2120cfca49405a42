"""hubert-xlarge in the port (the audio frontend and the bidirectional
encoder, ``loss="frame_ce"``) and the type promotion of both frontends,
against the JAX package on the CPU, at reduced size, on the same numpy
inputs and the reference's weights carried across by ``convert``.

Bounds, each with its reason:
- logits atol 5e-4, as the other archs'; loss rtol 1e-5 and every
  gradient leaf within 1e-4 of its largest |g| (float32: XLA and
  PyTorch sum in other orders), as ``tests/test_torch_train.py``;
- the promoted trunk (bfloat16 weights, float32 frames): float32 logits
  in both packages, atol 5e-4, since both run the trunk in float32 on
  the same bf16 values;
- ``image_embeds @ vis_proj`` in a bf16 model: a float32 product in
  both, cast to bf16 once, so each element within one bf16 step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import ServeEngine as JServeEngine
from repro.configs import get_config as jget_config
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import prefill as jprefill
from repro.models import transformer as jtf
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.data import SyntheticTokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params, loss_fn, prefill
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine
from repro_torch.train import loop

torch.set_num_threads(1)

_jforward = jax.jit(jforward, static_argnums=(1,),
                    static_argnames=("mode", "remat"))
_jprefill = jax.jit(jprefill, static_argnums=(1, 3))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


def _rel_close(got, want, tol, what=""):
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _reference_weights(jcfg, seed=0):
    """The reference's init with its zero leaves (norm gains) drawn
    instead, so that every parameter matters; numpy."""
    params, _ = jinit_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)

    def fill(a):
        a = np.array(a)
        if not a.any():
            a = (rng.standard_normal(a.shape) * 0.2).astype(a.dtype)
        return a
    return jax.tree.map(fill, params)


def _pair(jcfg, seed=0):
    np_params = _reference_weights(jcfg, seed)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    return jax.tree.map(jnp.asarray, np_params), model, cfg


def _jcfg(**kw):
    """Reduced hubert-xlarge (2 layers, d 32, 4 heads of 8, frames of 16,
    96 classes), or with ``kw`` replaced."""
    return dataclasses.replace(jget_config("hubert_xlarge", reduced=True),
                               **kw)


def _frames(cfg, B=2, S=12, seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return frames.astype(dtype), labels


def test_hubert_matches_reference():
    """Reduced hubert: the train-mode logits over the frames, the frame
    CE loss, and ``prefill`` from frames alone (its batch size from them):
    the last logits and every attention layer's cache."""
    jcfg = _jcfg()
    jp, model, cfg = _pair(jcfg)
    assert not cfg.causal and not cfg.rope and not cfg.gated_mlp
    frames, labels = _frames(cfg, S=37)
    jb = {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)}
    tb = {"frames": _t(frames), "labels": _t(labels).long()}
    want, _, _ = _jforward(jp, jcfg, jb, remat=False)
    got, _, _ = forward(model, cfg, tb)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4)
    jl, _ = jax.jit(jloss_fn, static_argnums=(1,))(jp, jcfg, jb)
    tl, aux = loss_fn(model, cfg, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jlast, jcache = _jprefill(jp, jcfg, {"frames": jb["frames"]}, 40)
    last, cache = prefill(model, cfg, {"frames": tb["frames"]}, 40)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), atol=5e-4)
    for i, blk in enumerate(cache):
        jblk = jax.tree.map(lambda a: a[i], jcache["period"]["pos0"])
        np.testing.assert_array_equal(blk["pos"].numpy(),
                                      np.asarray(jblk["pos"]))
        for name in ("k", "v"):
            _rel_close(blk[name], jblk[name], 1e-5, name)


def test_hubert_loss_and_gradients_match_reference():
    """The frame CE loss and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``; ``embed``,
    which the encoder never reads, has a zero gradient in both."""
    jcfg = _jcfg()
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg,
                                             device="cpu").train()
    frames, labels = _frames(cfg, S=20, seed=6)
    jb = {"frames": jnp.asarray(frames), "labels": jnp.asarray(labels)}
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_fn(p, jcfg, b), has_aux=True))(
        jax.tree.map(jnp.asarray, np_params), jb)
    tl, _ = loss_fn(model, cfg, {"frames": _t(frames),
                                 "labels": _t(labels).long()})
    named = list(model.named_parameters())
    grads = torch.autograd.grad(tl, [p for _, p in named],
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tree = {n: g for (n, _), g in zip(named, grads)}
    assert not tree["embed"].any() and not np.asarray(jg["embed"]).any()
    got = convert.to_reference_lm_tree(tree, cfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_j) == len(flat_t)
    for path, want in flat_j:
        _rel_close(flat_t[path], np.asarray(want, np.float32), 1e-4,
                   jax.tree_util.keystr(path))


@pytest.mark.parametrize("frames_dt,want_dt", [
    ("float32", torch.float32), ("bfloat16", torch.bfloat16)])
def test_frames_promote_as_the_reference(frames_dt, want_dt):
    """A bfloat16 hubert: float32 frames (the data pipeline's) make
    ``frames @ frontend`` float32, so the whole trunk runs in float32 and
    the logits are float32, in both packages; bfloat16 frames (the dry
    run's specs) keep it bf16. float32 logits within atol 5e-4 of the
    reference's."""
    jcfg = _jcfg(dtype="bfloat16")
    jp, model, cfg = _pair(jcfg)
    frames, _ = _frames(cfg, S=16)
    jdt = jnp.float32 if frames_dt == "float32" else jnp.bfloat16
    want, _, _ = _jforward(jp, jcfg, {"frames": jnp.asarray(frames, jdt)},
                           remat=False)
    got, _, _ = forward(model, cfg, {"frames": _t(frames).to(
        getattr(torch, frames_dt))})
    assert got.dtype == want_dt
    assert str(want.dtype) == frames_dt
    if frames_dt == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=5e-4)


def test_image_embeds_promote_as_the_reference():
    """A bfloat16 llama-3.2-vision: float32 ``image_embeds @ vis_proj``
    is a float32 product cast to bf16, in both packages (each element
    within one bf16 step: the float32 sums run in other orders); bf16
    embeddings give a bf16 product."""
    jcfg = dataclasses.replace(jget_config("llama32_vision_11b",
                                           reduced=True), dtype="bfloat16")
    jp, model, cfg = _pair(jcfg)
    img = np.random.default_rng(2).standard_normal(
        (2, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)
    for dt in ("float32", "bfloat16"):
        want = jtf._vis_kv_source(jp, jcfg, {"image_embeds": jnp.asarray(
            img, getattr(jnp, dt))})
        got = tf._vis_kv_source(model, cfg, {"image_embeds": _t(img).to(
            getattr(torch, dt))})
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        want = np.asarray(want, np.float32)
        assert (np.abs(_np(got) - want)
                <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_hubert_train_steps_match_reference():
    """Two ``make_train_step`` steps on the pipeline's float32 frames
    against the reference's jitted step: losses and grad norms rtol
    1e-5."""
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
        assert set(batch) == {"frames", "labels"}
        jstate, jm = jstep(jstate, {k: jnp.asarray(x)
                                    for k, x in batch.items()})
        state, tm = tstep(state, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)


def test_engine_refuses_hubert_as_the_reference():
    """hubert is encoder-only: the port's ``ServeEngine`` raises on it,
    as the reference's asserts."""
    jcfg = _jcfg()
    jp, model, cfg = _pair(jcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(model, cfg, device="cpu")
    with pytest.raises(AssertionError, match="encoder-only"):
        JServeEngine(jp, jcfg)


def test_convert_round_trip_keeps_the_frontend():
    """``frontend`` carries across in a bfloat16 model and back to the
    reference's layout unchanged."""
    jcfg = _jcfg(dtype="bfloat16")
    np_params = _reference_weights(jcfg)
    cfg = convert.from_reference_arch_config(jcfg)
    model = convert.from_reference_lm_params(np_params, cfg, device="cpu")
    assert model.frontend.shape == (cfg.frontend_dim, cfg.d_model)
    assert model.frontend.dtype == torch.bfloat16
    back = convert.to_reference_lm_tree(dict(model.named_parameters()), cfg)
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    want = jax.tree_util.tree_flatten_with_path(np_params)[0]
    assert len(flat) == len(want)
    for path, a in want:
        np.testing.assert_array_equal(flat[path], np.asarray(a, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_init_params_builds_hubert():
    """The port's own seeded init of reduced hubert has the reference's
    leaves and shapes, and ``param_count`` plus the norm gains."""
    jcfg = _jcfg(dtype="bfloat16")
    cfg = convert.from_reference_arch_config(jcfg)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    jparams, _ = jinit_params(jax.random.PRNGKey(0), jcfg)
    got = convert.to_reference_lm_tree(dict(model.named_parameters()), cfg)
    assert jax.tree.map(lambda a: tuple(np.shape(a)), got) == \
        jax.tree.map(lambda a: tuple(a.shape), jparams)
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + cfg.d_model * (1 + 2 * cfg.n_layers)


def test_launch_train_runs_hubert_on_cpu(capsys):
    """``launch.train`` trains reduced hubert on the CPU from its
    pipeline's float32 frames, with no flag of its own."""
    assert launch_train.main(["--arch", "hubert_xlarge", "--reduced",
                              "--steps", "2", "--batch", "2", "--seq", "8",
                              "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "done at step 2" in out and "nan" not in out
