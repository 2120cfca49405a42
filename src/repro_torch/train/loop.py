"""The train step and the fault-tolerant training loop; counterpart of
``repro/train/loop.py``.

- ``make_train_step``: loss and gradients (``torch.autograd.grad`` of
  ``models.loss_fn``, each block recomputed in the backward pass), with
  optional microbatch accumulation (float32 sums in microbatch order,
  divided by ``accum``, as the reference's ``lax.scan``), global-norm
  clipping, the 1-based warmup-cosine rate and AdamW, leaf by leaf,
  over a state of plain tensors or one placed on a mesh (below);
- checkpoints every ``ckpt_every`` steps (``checkpoint/``), auto-resume
  from the latest one with the data pipeline sought to its step, so a
  resumed run is bit for bit the straight one;
- the straggler flag: per-step wall times, an outlier is reported so an
  external scheduler can evict a slow host;
- ``elastic_remesh``: a state re-placed on another mesh (node loss,
  elastic scaling), each leaf gathered whole and placed by the same
  spec rules on the new mesh. With checkpoint/restart it is the
  reference's large-fleet recovery path.

The placed state (``train_state_shardings``, placed by
``elastic_remesh``) is what the reference's ``in_shardings`` say: each
parameter a DTensor placed by ``models.param_specs(cfg, model size)``,
AdamW's ``m`` and ``v`` DTensors placed by ``zero1_specs`` (ZeRO-1 over
"data"), the counters Python ints, the same on every rank; so a rank
holds only its shard of every sharded leaf between steps. On a 1 x 1
mesh, and without a mesh, every leaf is a plain tensor. There is one
step, and on plain leaves each of its gathers and placements is the
leaf itself (nothing is copied). The step:

1. gathers the parameters whole into the model, the rank's working copy;
2. runs the one-process step's loss and gradients on this data rank's
   batch (``SyntheticTokenPipeline(process_index=data rank,
   process_count=data size)``);
3. over more than one data rank, gathers their float32 gradient sums,
   adds them in rank order and divides by ``accum`` times the data
   size, as ``accum`` does with its microbatches;
4. clips on the global norm of that whole gradient;
5. runs AdamW leaf by leaf on this rank's part of each leaf at ``m`` and
   ``v``'s placement (``optimizer.adamw_update``);
6. gathers the new parameters back to their own placement.

So a (1, M) mesh is bit for bit the one-process step, and a (2, M)
mesh bit for bit the one-process step with ``accum=2`` over the two
data ranks' batches, rank 0's first. The compute runs whole on every
rank: splitting the products over "model", as the reference's GSPMD
does, is ROADMAP Queue 2 work.

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

import contextlib
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from ..models import ArchConfig
from ..models.transformer import LM, loss_fn, param_specs
from ..parallel.sharding import (NamedSharding, P, batch_axes,
                                 from_local_like, is_placed, local_like,
                                 shardings_from_specs, whole, zero1_specs)
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


def train_state_shardings(cfg: ArchConfig, mesh, params: LM) -> TrainState:
    """The ``NamedSharding``s of a train state of ``params`` on ``mesh``,
    in the state's structure: each parameter by ``models.param_specs``
    over the mesh's model axis, ``m`` and ``v`` by ``zero1_specs``, the
    counters replicated."""
    specs = param_specs(cfg, mesh.shape["model"])
    shapes = dict(params.named_parameters())
    mv = shardings_from_specs(mesh, zero1_specs(specs, shapes, mesh))
    rep = NamedSharding(mesh, P())
    return TrainState(params=shardings_from_specs(mesh, specs),
                      opt=AdamWState(m=mv, v=mv, count=rep), step=rep)


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """The parameter ``name`` of ``model`` replaced by ``value`` (its
    ``requires_grad`` kept); nothing when ``value`` is that parameter."""
    path, _, leaf = name.rpartition(".")
    mod = model.get_submodule(path)
    old = mod._parameters[leaf]
    if value is not old:
        mod._parameters[leaf] = nn.Parameter(value,
                                             requires_grad=old.requires_grad)


@contextlib.contextmanager
def whole_params(model: nn.Module) -> Iterator[Dict[str, torch.Tensor]]:
    """Inside the block each placed parameter of ``model`` is its whole
    value (the gathered tensor, a parameter of its own); yields them all
    by name (a plain leaf is itself). The placed leaves come back after
    the block."""
    placed = dict(model.named_parameters())
    values = {n: whole(p) for n, p in placed.items()}
    try:
        for n, p in placed.items():
            _set_param(model, n, values[n])
        yield dict(model.named_parameters())
    finally:
        for n, p in placed.items():
            path, _, leaf = n.rpartition(".")
            model.get_submodule(path)._parameters[leaf] = p


def _over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every data rank (the batch axes, ("pod", "data"), in rank
    order), stacked on a new leading dim."""
    import torch.distributed._functional_collectives as funcol
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    out = x[None]
    for axis in reversed(batch_axes(mesh)):
        if mesh.shape[axis] > 1:
            out = gather(out.contiguous(), 0,
                         mesh.device_mesh.get_group(axis))
    if isinstance(out, funcol.AsyncCollectiveTensor):
        out = out.wait()
    return out


def _to_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


@torch.no_grad()
def _place_back(placed: Dict[str, torch.Tensor],
                values: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor]
                ) -> None:
    """Each placed parameter's new value, this rank's part of its updated
    whole value at ``m``'s placement, redistributed to the parameter's
    own placement; a plain parameter was updated in place."""
    for name, p in placed.items():
        value = values.pop(name)
        if is_placed(p):
            part = local_like(value, m[name]).contiguous()
            new = from_local_like(part, m[name]).redistribute(
                p.device_mesh, p.placements)
            p.to_local().copy_(new.to_local())


def make_train_step(cfg: ArchConfig, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    clip: float = 1.0, accum: int = 1,
                    remat: bool = True, seq_spec=None,
                    mesh=None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. The batch
    may be numpy arrays (the pipeline's) or tensors; it goes to the
    parameters' device. With ``accum > 1`` the batch's leading dim is
    split into ``accum`` microbatches, their gradients summed in float32
    in order and divided by ``accum``, as is the loss. ``metrics`` holds
    0-dim tensors ``loss``, ``aux`` (the blocks' auxiliary loss, inside
    ``loss`` at weight ``MOE_AUX_WEIGHT``) and ``grad_norm`` (not read
    here) and the rate ``lr``. Parameters and AdamW state are updated in
    place. ``seq_spec`` is the reference's (``models.forward``). The
    state is plain tensors (``mesh`` None, or 1 x 1) or placed on
    ``mesh`` (``launch.mesh``; ``elastic_remesh(state,
    train_state_shardings(cfg, mesh, state.params))``), and then
    ``batch`` is this data rank's part, as the module docstring says."""
    data = 1
    if mesh is not None:
        for a in batch_axes(mesh):
            data *= mesh.shape[a]

    def value_and_grad(params: LM, names, leaves, batch):
        loss, parts = loss_fn(params, cfg, batch, remat=remat,
                              seq_spec=seq_spec)
        # a leaf the loss does not read (the encoder's ``embed``: its
        # frames go through ``frontend``) gets a zero gradient, as
        # ``jax.grad`` gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), parts["aux"].detach(), dict(zip(names, grads))

    def loss_and_grads(params: LM, batch):
        named = list(params.named_parameters())
        names = [n for n, _ in named]
        leaves = [p for _, p in named]
        batch = _to_device(batch, leaves[0].device)
        if accum == 1 and data == 1:
            return value_and_grad(params, names, leaves, batch)
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
        if data > 1:
            # the data ranks' sums added in rank order, as the
            # microbatches' are
            with torch.no_grad():
                ranks = _over_data(torch.stack([lsum, asum]), mesh)
                lsum, asum = ranks[0, 0], ranks[0, 1]
                for r in range(1, data):
                    lsum, asum = lsum + ranks[r, 0], asum + ranks[r, 1]
                for n in names:
                    ranks = _over_data(gsum[n], mesh)
                    gsum[n].zero_()
                    for r in range(data):
                        gsum[n].add_(ranks[r])
                    del ranks
        k = accum * data
        return lsum / k, asum / k, {n: g.div_(k) for n, g in gsum.items()}

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state.params
        placed = dict(params.named_parameters())
        with whole_params(params) as values:
            loss, aux, grads = loss_and_grads(params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip)
        # 1-based schedule step: lr > 0 from the very first update
        lr = warmup_cosine(state.step + 1, peak_lr, warmup, total_steps)
        _, opt = adamw_update(grads, state.opt, values, lr)
        _place_back(placed, values, opt.m)
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


def elastic_remesh(state: TrainState, new_shardings: TrainState
                   ) -> TrainState:
    """``state`` re-placed by ``new_shardings`` (the state's structure of
    ``NamedSharding``s, as ``train_state_shardings`` gives them): every
    leaf gathered whole (``parallel.sharding.whole``) and placed by the
    sharding at its spot; a 1 x 1 target gives plain tensors. The
    model's parameters are replaced on its modules, one leaf at a time,
    so one whole leaf is alive beside the state; a plain leaf that
    stays plain is not copied. Placing a fresh state on a mesh is the
    same call."""
    model = state.params
    for name, p in list(model.named_parameters()):
        _set_param(model, name, new_shardings.params[name].place(whole(p)))

    def tree(old: Dict[str, torch.Tensor], shardings) -> Dict:
        return {n: shardings[n].place(whole(x)) for n, x in old.items()}
    opt = AdamWState(m=tree(state.opt.m, new_shardings.opt.m),
                     v=tree(state.opt.v, new_shardings.opt.v),
                     count=state.opt.count)
    return TrainState(model, opt, state.step)
