"""The model's compute split over the mesh's "model" axis, and the
deterministic collectives it and the train step need.

The reference jits its train step with each parameter placed by its
spec, and XLA's partitioner (GSPMD) runs every sharded product on its
shard. Here the blocks (``models/split.py``) run on the local shards
that ``models.param_specs`` place, with these ops between split and
replicated compute (a ``ModelSplit`` is this rank's model group):

- ``col(x, w)``: a replicated ``x`` times a column shard of ``w``;
  backward x's gradient (this rank's partial sum over the columns)
  summed over the group;
- ``row(x, w)``: this rank's part of the contracted dim of ``x`` times
  the matching row shard of ``w``; forward the partial products summed
  over the group, backward the gradients as they are;
- ``copy_in(x)``: a replicated tensor entering other split compute;
  forward ``x``, backward its gradient summed over the group;
- ``gather(x, dim)``: the ranks' parts of ``dim`` joined for replicated
  compute; backward this rank's part of the gradient;
- ``gather_sum(x, dim)``: the same for split compute (a sharded weight
  each rank reads whole); backward the ranks' gradients summed, this
  rank's part kept (a reduce-scatter);
- ``regroup(x, parts)``: a fused projection's column shard (``[a |
  b]``, contiguous) traded by ``all_to_all_single`` so that each rank
  holds its channels of every part; backward the inverse trade.

A product's partial sums are added over the group in float32 and
rounded once to the product's type, whatever that type is: the whole
product rounds its float32 sum once, so a bfloat16 model split over
"model" computes what the unsplit model does but for the order of its
float32 additions (and each product reduces its own partial sums, as
the whole products round their own). Every sum over ranks is
rank-ordered: ``reduce_scatter`` hands each rank every rank's copy of
its part (``all_to_all_single``) and adds them in rank order;
``all_reduce`` is that reduce-scatter and an all-gather. So each rank of a group gets the same bits, run to run, on
gloo and on NCCL (whose own all-reduce fixes no order), for the ring's
bytes. On gloo a CUDA tensor goes through the host, since gloo has no
CUDA all-to-all.

``record_collectives`` lists these collectives as they run, by the
reference's names and with their result bytes (a reduce-scatter's part,
an all-reduce's whole), for the dry run (``launch/dryrun.py``), which
then leaves out the raw collectives they are made of.

``local_params(model, split)`` makes each placed parameter of a model,
inside a ``with`` block, a parameter over its local tensor (no copy),
and tells ``split`` which dim "model" splits in each.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .sharding import is_placed, shard_dims

# the lists of (collective, result bytes) that ``record_collectives``
# blocks are filling, and how deep the helpers below are in their raw
# collectives
_RECORDERS: List[list] = []
_INSIDE = [0]


@contextlib.contextmanager
def record_collectives() -> Iterator[List[Tuple[str, float]]]:
    """Inside the block every collective of this module is appended to
    the yielded list as (reference name, result bytes)."""
    events: List[Tuple[str, float]] = []
    _RECORDERS.append(events)
    try:
        yield events
    finally:
        _RECORDERS.remove(events)


def inside_collective() -> bool:
    """Whether a collective of this module is running (its raw
    collectives are recorded under its own name instead)."""
    return _INSIDE[0] > 0


def _note(kind: str, t: torch.Tensor) -> None:
    for events in _RECORDERS:
        events.append((kind, float(t.numel() * t.element_size())))


@contextlib.contextmanager
def _hidden():
    _INSIDE[0] += 1
    try:
        yield
    finally:
        _INSIDE[0] -= 1


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _wait(t: torch.Tensor) -> torch.Tensor:
    funcol = _funcol()
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` joined along dim 0 in rank order."""
    if _via_host(x, group):
        return _gather0(x.cpu(), group).to(x.device)
    funcol = _funcol()
    gather = getattr(funcol, "all_gather_single", None) or \
        funcol.all_gather_tensor
    with _hidden():
        return _wait(gather(x.contiguous(), 0, group))


def _trade0(x: torch.Tensor, out_splits, in_splits, group) -> torch.Tensor:
    """``all_to_all_single`` along dim 0 (equal parts when the splits are
    None)."""
    if _via_host(x, group):
        return _trade0(x.cpu(), out_splits, in_splits, group).to(x.device)
    with _hidden():
        return _wait(_funcol().all_to_all_single(x.contiguous(), out_splits,
                                                 in_splits, group))


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order."""
    if n == 1:
        return x
    out = _gather0(x.movedim(dim, 0), group).movedim(0, dim)
    _note("all-gather", out)
    return out


def _reduce_scatter(x: torch.Tensor, dim: int, group, n: int
                    ) -> torch.Tensor:
    xt = x.movedim(dim, 0)
    parts = _trade0(xt, None, None, group).reshape(
        n, xt.shape[0] // n, *xt.shape[1:])
    out = parts[0]
    for r in range(1, n):
        out = out + parts[r]
    return out.movedim(0, dim)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int
                   ) -> torch.Tensor:
    """``x`` summed over the group's ranks in rank order, this rank's
    part of ``dim`` (which ``n`` divides) kept."""
    if n == 1:
        return x
    out = _reduce_scatter(x, dim, group, n)
    _note("reduce-scatter", out)
    return out


def all_reduce(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """``x`` summed over the group's ranks in rank order, the same bits
    on every rank: a rank-ordered reduce-scatter of the flattened ``x``
    and an all-gather."""
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = -flat.numel() % n
    if pad:
        flat = F.pad(flat, (0, pad))
    part = _reduce_scatter(flat, 0, group, n)
    out = _gather0(part, group)[:x.numel()].reshape(x.shape)
    _note("all-reduce", out)
    return out


class ModelSplit:
    """This rank's model group: ``group``, its ``size`` and this rank's
    index ``rank`` in it; ``dim_of(leaf)`` is the dim "model" splits in a
    local parameter (``local_params``), None for a replicated one."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank
        self._dims: Dict[int, Optional[int]] = {}

    def __repr__(self) -> str:
        return f"ModelSplit(rank {self.rank} of {self.size})"

    def register(self, leaf: torch.Tensor, dim: Optional[int]) -> None:
        self._dims[id(leaf)] = dim

    def forget(self) -> None:
        self._dims.clear()

    def dim_of(self, leaf: torch.Tensor) -> Optional[int]:
        return self._dims.get(id(leaf))

    def span(self, n: int) -> Tuple[int, int]:
        """This rank's [lo, hi) of ``n`` items cut in ``size`` equal
        parts."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        lo, hi = self.span(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    # -- collectives with their gradients ---------------------------------

    def col(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` (``layers.matmul``'s types) for a replicated ``x``
        and this rank's columns of ``w``; x's gradient summed over the
        group in float32."""
        return _ColProduct.apply(x, w, self)

    def row(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x @ w`` (``layers.matmul``'s types) summed over the group in
        float32, for this rank's part of the contracted dim of ``x`` and
        the matching rows of ``w``."""
        return _RowProduct.apply(x, w, self)

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self, dim, False)

    def gather_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return _Gather.apply(x, self, dim, True)

    def regroup(self, x: torch.Tensor, parts: int) -> torch.Tensor:
        """x (..., parts * c / size), this rank's contiguous columns of a
        fused projection of ``parts`` parts of c columns each -> (...,
        parts, c / size): this rank's channels of every part."""
        return _Regroup.apply(x, self, parts)

    # -- leaves -------------------------------------------------------------

    def whole_for_split(self, leaf: torch.Tensor) -> torch.Tensor:
        """A leaf that split compute reads whole: a sharded one gathered
        (its gradient reduce-scattered back), a replicated one copied in
        (its gradient summed over the group)."""
        d = self.dim_of(leaf)
        return self.copy_in(leaf) if d is None else self.gather_sum(leaf, d)

    def whole_for_rep(self, leaf: torch.Tensor) -> torch.Tensor:
        """A leaf that replicated compute reads whole: a sharded one
        gathered (each rank keeps its part of the gradient), a replicated
        one as it is."""
        d = self.dim_of(leaf)
        return leaf if d is None else self.gather(leaf, d)

    def local(self, leaf: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's part of ``dim`` of a leaf for split compute: a leaf
        sharded there as it is, a replicated one copied in and cut."""
        d = self.dim_of(leaf)
        if d == dim % leaf.ndim:
            return leaf
        return self.chunk(self.whole_for_split(leaf), dim)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32: a narrower product's float32 sums, not yet
    rounded."""
    return torch.matmul(a.float(), b.float())


def _weight_grad(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """The gradient of ``w`` in ``x @ w``: over every leading dim of x
    for a 2-D w, per batch for a batched one."""
    if w.ndim == 2:
        return x.reshape(-1, x.shape[-1]).mT @ g.reshape(-1, g.shape[-1])
    return x.mT @ g


def _operands(x: torch.Tensor, w: torch.Tensor):
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t), w.to(t)


class _ColProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sp):
        xc, wc = _operands(x, w)
        ctx.sp, ctx.dtypes = sp, (x.dtype, w.dtype)
        ctx.save_for_backward(xc, wc)
        return xc @ wc

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        sp, (xt, wt) = ctx.sp, ctx.dtypes
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = all_reduce(_mm32(g, w.mT), sp.group, sp.size).to(xt)
        if ctx.needs_input_grad[1]:
            gw = _weight_grad(x, g, w).to(wt)
        return gx, gw, None


class _RowProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, sp):
        xc, wc = _operands(x, w)
        ctx.dtypes = (x.dtype, w.dtype)
        ctx.save_for_backward(xc, wc)
        return all_reduce(_mm32(xc, wc), sp.group, sp.size).to(xc.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        xt, wt = ctx.dtypes
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g @ w.mT).to(xt)
        if ctx.needs_input_grad[1]:
            gw = _weight_grad(x, g, w).to(wt)
        return gx, gw, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        return all_reduce(g, sp.group, sp.size), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, dim, summed):
        ctx.sp, ctx.dim, ctx.summed = sp, dim, summed
        return all_gather(x, dim, sp.group, sp.size)

    @staticmethod
    def backward(ctx, g):
        sp, dim = ctx.sp, ctx.dim
        if ctx.summed:
            return reduce_scatter(g, dim, sp.group, sp.size), None, None, \
                None
        return sp.chunk(g, dim).contiguous(), None, None, None


def _regroup_plan(n: int, rank: int, parts: int):
    """The order of this rank's ``parts`` blocks by destination, and the
    blocks it sends to and takes from each rank: block j (part j //
    n's channel chunk j % n, with blocks numbered part-major) lies on
    rank j // parts and goes to rank j % n."""
    mine = [rank * parts + i for i in range(parts)]
    order = sorted(range(parts), key=lambda i: (mine[i] % n, i))
    send = [sum(1 for j in mine if j % n == r) for r in range(n)]
    take = [sum(1 for p in range(parts) if (p * n + rank) // parts == r)
            for r in range(n)]
    return order, send, take


def _trade_blocks(x: torch.Tensor, order, send, take, group):
    """x (parts, rows, c) blocks in ``order`` traded; (parts, rows, c)."""
    rows = x.shape[1] * x.shape[2]
    x = x[list(order)] if list(order) != list(range(len(order))) else x
    out = _trade0(x.reshape(-1), [t * rows for t in take],
                  [s * rows for s in send], group)
    return out.reshape(-1, x.shape[1], x.shape[2])


class _Regroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, parts):
        n = sp.size
        order, send, take = _regroup_plan(n, sp.rank, parts)
        ctx.sp, ctx.plan, ctx.shape = sp, (order, send, take), x.shape
        c = x.shape[-1] // parts
        blocks = x.reshape(-1, parts, c).transpose(0, 1)
        out = _trade_blocks(blocks, order, send, take, sp.group)
        _note("all-to-all", out)
        return out.transpose(0, 1).reshape(*x.shape[:-1], parts, c)

    @staticmethod
    def backward(ctx, g):
        order, send, take = ctx.plan
        parts, c = g.shape[-2], g.shape[-1]
        blocks = g.reshape(-1, parts, c).transpose(0, 1)
        back = _trade_blocks(blocks, range(parts), take, send, ctx.sp.group)
        inv = [0] * parts
        for pos, i in enumerate(order):
            inv[i] = pos
        back = back[inv]
        _note("all-to-all", back)
        return back.transpose(0, 1).reshape(ctx.shape), None, None


# ---------------------------------------------------------------------------
# the split of a mesh, and the model's local parameters
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar[Optional[ModelSplit]] = \
    contextvars.ContextVar("repro_torch_model_split", default=None)


def split_of(mesh) -> Optional[ModelSplit]:
    """The ``ModelSplit`` of this rank on ``mesh``; None on a mesh whose
    "model" size is 1 or that has no ``DeviceMesh``."""
    if mesh is None or mesh.device_mesh is None or \
            mesh.shape.get("model", 1) == 1:
        return None
    return ModelSplit(mesh.device_mesh.get_group("model"),
                      mesh.shape["model"], mesh.coordinate("model"))


@contextlib.contextmanager
def use_split(split: Optional[ModelSplit]) -> Iterator[None]:
    """``split`` is ``current_split()`` inside the block."""
    token = _CURRENT.set(split)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_split() -> Optional[ModelSplit]:
    return _CURRENT.get()


def model_dim(x: torch.Tensor) -> Optional[int]:
    """The tensor dim the mesh's "model" axis splits in a placed leaf
    (None when it is replicated there, or not placed)."""
    if not is_placed(x):
        return None
    names = x.device_mesh.mesh_dim_names
    if not names or "model" not in names:
        return None
    return shard_dims(x.placements)[list(names).index("model")]


@contextlib.contextmanager
def local_params(model: nn.Module, split: Optional[ModelSplit] = None
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """Inside the block each placed parameter of ``model`` is a parameter
    over its local tensor (the same storage; ``requires_grad`` kept), its
    model dim registered with ``split``; yields every parameter by name
    (a plain one is itself). The placed leaves come back after the
    block (and ``split`` forgets the local ones: an id is only a
    name while its tensor lives)."""
    placed = dict(model.named_parameters())
    try:
        for name, p in placed.items():
            if not is_placed(p):
                continue
            with torch.no_grad():
                loc = nn.Parameter(p.to_local(), requires_grad=p.requires_grad)
            path, _, leaf = name.rpartition(".")
            model.get_submodule(path)._parameters[leaf] = loc
            if split is not None:
                split.register(loc, model_dim(p))
        yield dict(model.named_parameters())
    finally:
        if split is not None:
            split.forget()
        for name, p in placed.items():
            path, _, leaf = name.rpartition(".")
            model.get_submodule(path)._parameters[leaf] = p
