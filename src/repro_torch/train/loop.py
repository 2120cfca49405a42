"""The train step and the fault-tolerant training loop; counterpart of
``repro/train/loop.py``.

- ``make_train_step``: loss and gradients (``torch.autograd.grad`` of
  ``models.loss_fn``, each block recomputed in the backward pass), with
  optional microbatch accumulation (float32 sums in microbatch order,
  divided by ``accum``, as the reference's ``lax.scan``), global-norm
  clipping, the 1-based warmup-cosine rate and AdamW, leaf by leaf;
- checkpoints every ``ckpt_every`` steps (``checkpoint/``), auto-resume
  from the latest one with the data pipeline sought to its step, so a
  resumed run is bit for bit the straight one;
- the straggler flag: per-step wall times, an outlier is reported so an
  external scheduler can evict a slow host;
- ``elastic_remesh`` (re-placing a state on another mesh) is not ported
  yet (ROADMAP Queue 1 item 13h, part 3).

The step is deterministic, on the card and on a CPU with many
threads, with no global switch: the attention gradient kernel sums
without atomics, the GQA expansion's gradient is a reduction
(``models/attention._expand_kv``), and the embedding's gradient is
``F.embedding``'s dense backward (``models/transformer._embed_inputs``),
which adds each row's occurrences in a fixed order (a sort by token on
the card), where ``embed[tokens]``'s index-put adds them by atomics.
The step reads nothing back from the device; the loop reads the loss
and the grad norm once a step, for its log (the reference's
``block_until_ready``).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..models import ArchConfig
from ..models.transformer import LM, loss_fn
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, warmup_cosine)


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState
    step: int


def init_train_state(params: LM) -> TrainState:
    """The model switched to training (gradients on) with zero AdamW
    state beside it, at step 0."""
    params.train()
    return TrainState(params=params, opt=adamw_init(params), step=0)


def _to_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def make_train_step(cfg: ArchConfig, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    clip: float = 1.0, accum: int = 1,
                    remat: bool = True) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. The batch
    may be numpy arrays (the pipeline's) or tensors; it goes to the
    parameters' device. With ``accum > 1`` the batch's leading dim is
    split into ``accum`` microbatches, their gradients summed in float32
    in order and divided by ``accum``, as is the loss. ``metrics`` holds
    0-dim tensors ``loss``, ``aux`` (the blocks' auxiliary loss, inside
    ``loss`` at weight ``MOE_AUX_WEIGHT``) and ``grad_norm`` (not read
    here) and the rate ``lr``. Parameters and AdamW state are updated in
    place."""

    def value_and_grad(params: LM, names, leaves, batch):
        loss, parts = loss_fn(params, cfg, batch, remat=remat)
        # a leaf the loss does not read (the encoder's ``embed``: its
        # frames go through ``frontend``) gets a zero gradient, as
        # ``jax.grad`` gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), parts["aux"].detach(), dict(zip(names, grads))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        named = list(params.named_parameters())
        names = [n for n, _ in named]
        leaves = [p for _, p in named]
        batch = _to_device(batch, leaves[0].device)
        if accum > 1:
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for n, p in named}
            lsum = asum = None
            n_mb = next(iter(batch.values())).shape[0] // accum
            for a in range(accum):
                mb = {k: x[a * n_mb:(a + 1) * n_mb] for k, x in batch.items()}
                loss, aux, g = value_and_grad(params, names, leaves, mb)
                for n in names:
                    gsum[n].add_(g.pop(n))
                lsum = loss.float() if lsum is None else lsum + loss
                asum = aux if asum is None else asum + aux
            grads = {n: g.div_(accum) for n, g in gsum.items()}
            loss, aux = lsum / accum, asum / accum
        else:
            loss, aux, grads = value_and_grad(params, names, leaves, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        # 1-based schedule step: lr > 0 from the very first update
        lr = warmup_cosine(state.step + 1, peak_lr, warmup, total_steps)
        _, opt = adamw_update(grads, state.opt, params, lr)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm, "lr": lr}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def train_loop(state: TrainState, train_step: Callable, data_iter,
               n_steps: int, ckpt_dir: Optional[str] = None,
               ckpt_every: int = 50, log_every: int = 10,
               straggler_factor: float = 3.0,
               on_metrics: Optional[Callable] = None) -> TrainState:
    """Run to step ``n_steps``, checkpointing and auto-resuming.

    If ``ckpt_dir`` holds a checkpoint, training resumes from it
    (bit-exact: the data pipeline is advanced to the checkpointed step).
    """
    from ..checkpoint import latest_step, restore, save

    start = 0
    if ckpt_dir is not None:
        last = latest_step(ckpt_dir)
        if last is not None:
            state = restore(ckpt_dir, last, state)
            start = int(last)
            data_iter.seek(start)

    times = []
    for step in range(start, n_steps):
        batch = data_iter.next_batch()
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        # the step's one host read, for the log and the step time
        loss, gnorm = (float(x) for x in torch.stack(
            [metrics["loss"].float(), metrics["grad_norm"].float()]).cpu())
        dt = time.perf_counter() - t0
        times.append(dt)
        if len(times) > 20:
            times.pop(0)
        med = float(np.median(times))
        if dt > straggler_factor * med and len(times) >= 10:
            print(f"[straggler] step {step} took {dt:.3f}s "
                  f"(median {med:.3f}s) — flagged for eviction")
        if log_every and step % log_every == 0:
            print(f"step {step} loss {loss:.4f} gnorm {gnorm:.3f} "
                  f"{dt*1e3:.0f}ms")
        if on_metrics is not None:
            on_metrics(step, {**metrics, "loss": loss, "grad_norm": gnorm,
                              "step_time_s": dt})
        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            save(ckpt_dir, step + 1, state)
    return state


def elastic_remesh(state: TrainState, new_shardings: Any) -> TrainState:
    """Re-placing a train state on another mesh (``launch/mesh.py``,
    ``parallel/``): not ported yet."""
    raise NotImplementedError(
        "elastic_remesh (a train state re-placed on another mesh) is not "
        "ported yet: ROADMAP Queue 1 item 13h, part 3")
