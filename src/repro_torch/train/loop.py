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

The placed state (``train_state_shardings``; ``init_train_state(params,
shardings)`` makes one without a whole moment, ``elastic_remesh``
re-places one) is what the reference's ``in_shardings`` say: each
parameter a DTensor placed by ``models.param_specs(cfg, model size)``,
AdamW's ``m`` and ``v`` DTensors placed by ``zero1_specs`` (ZeRO-1 over
"data"), the counters Python ints, the same on every rank; so a rank
holds only its shard of every sharded leaf. On a 1 x 1 mesh, and
without a mesh, every leaf is a plain tensor, and the step is the
plain one (nothing is gathered, placed or copied). The step:

1. swaps each placed parameter for its local tensor
   (``parallel.tensor_parallel.local_params``; no parameter is ever
   gathered whole);
2. runs the loss and its gradients on this data rank's batch
   (``SyntheticTokenPipeline(process_index=data rank,
   process_count=data size)``), the compute split over "model" as the
   reference's GSPMD splits it (``models/split.py``): each sharded
   product on its shard, partial sums added by rank-ordered
   collectives, small leaves gathered one at a time; each rank's
   gradient is that of its own shards;
3. over more than one data rank, adds their float32 gradient sums in
   rank order by a rank-ordered reduce-scatter that leaves each rank
   its part at ``m``'s placement, and divides by ``accum`` times the
   data size, as ``accum`` does with its microbatches;
4. clips on the global norm, whose leaves' float64 square sums are
   taken part by part and gathered, each part counted once
   (``optimizer.sq_sum``);
5. runs AdamW leaf by leaf on this rank's parts (``optimizer.
   adamw_update``);
6. gathers the data ranks' new parts back into each local shard.

So a (D, 1) mesh is bit for bit the one-process step with ``accum=D``
over the data ranks' batches, rank 0's first (unless a norm's float64
sum lies at a float32 rounding boundary). Over "model" the partial sums
round differently from the whole products, so a (D, M > 1) step is the
one-process step within the bound tests/test_torch_mesh_train.py states,
and every rank of a model group holds the same bits, run to run.

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
import torch.distributed as dist
from torch import nn

from ..models import ArchConfig
from ..models.transformer import LM, loss_fn, param_specs
from ..parallel.sharding import (NamedSharding, P, batch_axes, is_placed,
                                 shard_dims, shardings_from_specs, whole,
                                 zero1_specs)
from ..parallel.tensor_parallel import (all_gather, all_reduce,
                                        local_params, reduce_scatter,
                                        split_of, use_split)
from .optimizer import (AdamWState, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, sq_sum,
                        warmup_cosine)


class TrainState(NamedTuple):
    params: LM
    opt: AdamWState
    step: int


def init_train_state(params: LM, shardings: Optional[TrainState] = None
                     ) -> TrainState:
    """The model switched to training (gradients on) with zero AdamW
    state beside it, at step 0. With ``shardings`` (``train_state_
    shardings``) each parameter is placed by its sharding, one leaf at a
    time, and ``m`` and ``v`` are made as this rank's zero parts, so no
    whole moment is ever made."""
    params.train()
    if shardings is None:
        return TrainState(params=params, opt=adamw_init(params), step=0)
    for name, p in list(params.named_parameters()):
        _set_param(params, name, shardings.params[name].place(whole(p)))

    def zeros(tree):
        return {n: tree[n].zeros(p.shape, torch.float32, _local(p).device)
                for n, p in params.named_parameters()}
    opt = AdamWState(m=zeros(shardings.opt.m), v=zeros(shardings.opt.v),
                     count=0)
    return TrainState(params=params, opt=opt, step=0)


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


def _to_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, x in batch.items():
        t = torch.as_tensor(x)
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def _batch_groups(mesh):
    """(group, size) of each batch axis ("pod", "data") of more than one
    rank, "data" first: the data ranks' sums are added over "data", then
    over "pod"."""
    if mesh is None or mesh.device_mesh is None:
        return []
    return [(mesh.device_mesh.get_group(a), mesh.shape[a])
            for a in reversed(batch_axes(mesh)) if mesh.shape[a] > 1]


def _data_dim(m: torch.Tensor) -> Optional[int]:
    """The tensor dim the "data" axis splits in ``m`` (ZeRO-1), or
    None."""
    if not is_placed(m):
        return None
    return shard_dims(m.placements)[
        list(m.device_mesh.mesh_dim_names).index("data")]


def _data_part(x: torch.Tensor, m: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's part of ``x`` (a leaf's model shard, or a tensor of
    its shape) at ``m``'s data placement: a view."""
    d = _data_dim(m)
    if d is None:
        return x
    n = mesh.shape["data"]
    return x.chunk(n, d)[mesh.coordinate("data")]


def _sum_over_data(x: torch.Tensor, m: torch.Tensor, groups
                   ) -> torch.Tensor:
    """``x`` of every data rank added in rank order, this rank's part at
    ``m``'s placement kept: a rank-ordered reduce-scatter over "data"
    (an all-reduce where ``m`` is not split there), then an all-reduce
    over "pod"."""
    d = _data_dim(m)
    for i, (group, n) in enumerate(groups):
        if i == 0 and d is not None:
            x = reduce_scatter(x, d, group, n)
        else:
            x = all_reduce(x, group, n)
    return x


def _norm_owners(coords: np.ndarray, m: Dict[str, torch.Tensor]
                 ) -> np.ndarray:
    """(ranks, leaves) bool: whether a rank's part of a leaf counts in
    the global norm, i.e. the rank is the first along every mesh axis
    that replicates the leaf's ``m`` (a part held by several ranks counts
    once); ``coords`` (ranks, mesh dims) holds each rank's coordinate."""
    own = np.zeros((len(coords), len(m)), dtype=bool)
    for j, x in enumerate(m.values()):
        rep = [i for i, d in enumerate(shard_dims(x.placements))
               if d is None]
        own[:, j] = (coords[:, rep] == 0).all(axis=1)
    return own


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
    ``mesh`` (``launch.mesh``; ``init_train_state(params,
    train_state_shardings(cfg, mesh, params))``), and then ``batch`` is
    this data rank's part, as the module docstring says."""
    groups = _batch_groups(mesh)
    data = 1
    for _, n in groups:
        data *= n
    split = split_of(mesh)
    if mesh is not None and mesh.device_mesh is not None:
        grid = np.array(mesh.device_mesh.mesh.tolist())
        coords = np.zeros((grid.size, grid.ndim), dtype=np.int64)
        for c, r in np.ndenumerate(grid):
            coords[r] = c

    def value_and_grad(params: LM, names, leaves, batch):
        loss, parts = loss_fn(params, cfg, batch, remat=remat,
                              seq_spec=seq_spec)
        # a leaf the loss does not read (the encoder's ``embed``: its
        # frames go through ``frontend``) gets a zero gradient, as
        # ``jax.grad`` gives it
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), parts["aux"].detach(), dict(zip(names, grads))

    def loss_and_grads(params: LM, m, batch):
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
            # microbatches' are; each rank keeps its part at m's
            # placement
            with torch.no_grad():
                lsum, asum = _sum_over_data(torch.stack([lsum, asum]),
                                            lsum, groups)
                for n in names:
                    gsum[n] = _sum_over_data(gsum[n], m[n], groups)
        k = accum * data
        return lsum / k, asum / k, {n: g.div_(k) for n, g in gsum.items()}

    def mesh_norm(grads, m) -> Optional[torch.Tensor]:
        """The global norm from every rank's parts of the gradient (each
        part counted once), gathered over the default group (which the
        mesh spans), the same bits on every rank; None on one
        process."""
        if mesh is None or mesh.device_mesh is None:
            return None
        sq = torch.stack([sq_sum(g) for g in grads.values()])
        ranks = all_gather(sq[None], 0, dist.group.WORLD, len(coords))
        own = torch.tensor(_norm_owners(coords, m).tolist(),
                           device=sq.device)
        return global_norm(torch.where(own, ranks, 0).sum(0))

    def train_step(state: TrainState, batch: Dict[str, Any]):
        params, opt = state.params, state.opt
        with local_params(params, split) as local:
            with use_split(split):
                loss, aux, grads = loss_and_grads(params, opt.m, batch)
            grads, gnorm = clip_by_global_norm(grads, clip,
                                               mesh_norm(grads, opt.m))
            # 1-based schedule step: lr > 0 from the very first update
            lr = warmup_cosine(state.step + 1, peak_lr, warmup, total_steps)
            with torch.no_grad():
                parts = {n: _data_part(x, opt.m[n], mesh)
                         for n, x in local.items()}
            mine = AdamWState(m={n: _local(x) for n, x in opt.m.items()},
                              v={n: _local(x) for n, x in opt.v.items()},
                              count=opt.count)
            _, mine = adamw_update(grads, mine, parts, lr)
            with torch.no_grad():
                # the data ranks' new parts joined on each rank
                for n, x in local.items():
                    d = _data_dim(opt.m[n])
                    if d is not None:
                        x.copy_(all_gather(parts[n], d, groups[0][0],
                                           groups[0][1]))
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm, "lr": lr}
        opt = AdamWState(opt.m, opt.v, mine.count)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def _local(x: torch.Tensor) -> torch.Tensor:
    return x.to_local() if is_placed(x) else x


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
