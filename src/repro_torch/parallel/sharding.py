"""Sharding rules for the (pod, data, model) production mesh;
counterpart of ``repro/parallel/sharding.py``.

Conventions, the reference's:
  batch dims        -> ("pod", "data") when divisible, else replicated
  TP param dims     -> "model" (``models.layers.spec_for``, applied by
                       ``models.param_specs`` beside the port's inits)
  KV caches         -> batch over ("pod", "data"); the sequence dim over
                       ``kv_seq_axis`` when one is given
  optimizer m/v     -> ZeRO-1: also sharded over "data" on the first
                       divisible unsharded dim

The port cannot import ``jax.sharding``, so it has its own
``PartitionSpec`` (a tuple with the reference's equality) and
``NamedSharding`` (a spec on a ``launch.mesh.Mesh``, turned into DTensor
placements, one a mesh dim). Trees are nested dicts, lists and tuples
(``torch.utils._pytree``); a ``PartitionSpec`` is a leaf.

``whole`` is the inverse of ``NamedSharding.place``: a leaf's whole
value, gathered from a DTensor, or the tensor itself (the leaves of a
1 x 1 mesh are plain tensors). ``local_part`` is this rank's part of a
whole value at given placements, cut without communication. The train
step, ``train.loop.elastic_remesh`` and the checkpoint share both.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils import _pytree as pytree


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names (split over them, major to minor). A tuple of one name
    is that name, as ``jax.sharding.PartitionSpec`` compares them; specs
    of different lengths differ (``P(None, None) != P(None)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def _is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


class NamedSharding:
    """``spec`` on ``mesh``. ``placements`` are the DTensor placements, one
    a mesh dim: ``Shard(d)`` on every mesh dim that tensor dim d is split
    over (a dim split over ("pod", "data") is ``Shard(d)`` on both, pod
    first: JAX's major-to-minor order, DTensor's order of mesh dims),
    else ``Replicate()``."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.shape)
        out = [Replicate()] * len(names)
        for d, part in enumerate(self.spec):
            if part is None:
                continue
            axes = (part,) if isinstance(part, str) else tuple(part)
            unknown = [a for a in axes if a not in names]
            if unknown:
                raise ValueError(f"{self.spec}: no mesh axis {unknown} in "
                                 f"{self.mesh!r}")
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(f"{self.spec}: a dim split over {axes} "
                                 f"must name them in the mesh's order")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is on a mesh of one device; else a DTensor over the
        mesh's ``DeviceMesh``: each rank passes the whole tensor and keeps
        a copy of its part (``local_part``; no communication; a copy, so
        the whole's storage is not kept alive by a view of it)."""
        if self.mesh.size == 1:
            return x
        if self.mesh.device_mesh is None:
            raise RuntimeError(f"{self.mesh!r} has no devices to place on "
                               "(a mesh given as data)")
        from torch.distributed.tensor import DTensor
        dm, pl = self.mesh.device_mesh, self.placements
        stride = torch.empty(x.shape, device="meta").stride()
        part = local_part(x, dm, pl).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(part, dm, pl, run_check=False,
                                  shape=x.shape, stride=stride)

    def zeros(self, shape, dtype: torch.dtype, device) -> torch.Tensor:
        """Zeros of ``shape`` placed as ``place`` would place them, made
        as this rank's part alone (nothing whole is made)."""
        if self.mesh.size == 1:
            return torch.zeros(shape, dtype=dtype, device=device)
        from torch.distributed.tensor import DTensor
        dm, pl = self.mesh.device_mesh, self.placements
        part = part_slices(shape, shard_dims(pl), dm.shape,
                           dm.get_coordinate())
        local = torch.zeros([s.stop - s.start for s in part], dtype=dtype,
                            device=device)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, dm, pl, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


def is_placed(x: Any) -> bool:
    """Whether ``x`` is a DTensor (a leaf placed on a mesh of more than
    one device)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@torch.no_grad()
def whole(x: torch.Tensor) -> torch.Tensor:
    """A leaf's whole value: a DTensor gathered (every rank gets all of
    it, a plain tensor without gradients; a DTensor replicated on every
    mesh dim gives its local tensor, no copy), a plain tensor as it
    is."""
    return x.full_tensor() if is_placed(x) else x


def part_slices(shape, dims, mesh_shape, coord) -> tuple:
    """Where a rank's part lies in a whole leaf of ``shape``: mesh dim by
    mesh dim, the rank's ``torch.chunk`` (as ``distribute_tensor`` cuts)
    of the tensor dim ``dims[i]`` that mesh dim i splits (None: none),
    at the rank's ``coord`` on a mesh of ``mesh_shape``."""
    start, length = [0] * len(shape), list(shape)
    for i, d in enumerate(dims):
        if d is None:
            continue
        chunk = -(-length[d] // mesh_shape[i])
        lo = min(coord[i] * chunk, length[d])
        start[d] += lo
        length[d] = min(chunk, length[d] - lo)
    return tuple(slice(a, a + n) for a, n in zip(start, length))


def shard_dims(placements) -> list:
    """The tensor dim each mesh dim splits (a ``Shard``'s), else None."""
    from torch.distributed.tensor import Shard
    return [pl.dim if isinstance(pl, Shard) else None for pl in placements]


def local_part(x: torch.Tensor, device_mesh, placements) -> torch.Tensor:
    """This rank's part of the whole value ``x`` at ``placements`` on
    ``device_mesh`` (a view; no communication)."""
    return x[part_slices(x.shape, shard_dims(placements), device_mesh.shape,
                         device_mesh.get_coordinate())]


def local_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of the whole value ``x`` that ``like`` (a DTensor, or a
    plain tensor: then ``x`` itself) holds on this rank."""
    if not is_placed(like):
        return x
    return local_part(x, like.device_mesh, like.placements)


def from_local_like(local: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A DTensor with ``like``'s mesh, placements and global shape over
    this rank's ``local`` part; ``local`` itself when ``like`` is
    plain."""
    if not is_placed(like):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def _mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.shape else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _batch_total(mesh, axes) -> int:
    total = 1
    for a in axes:
        total *= _mesh_axis_size(mesh, a)
    return total


def batch_partition_spec(mesh, batch_size: int,
                         extra_dims: int = 1) -> PartitionSpec:
    """Spec for a tensor whose dim 0 is the global batch."""
    axes = batch_axes(mesh)
    if axes and batch_size % _batch_total(mesh, axes) == 0:
        return P(axes, *([None] * extra_dims))
    return P(*([None] * (extra_dims + 1)))


def input_specs_tree(mesh, batch_tree: Any) -> Any:
    """NamedShardings for a batch tree of tensors: dim 0 = batch on every
    leaf."""
    def one(leaf):
        spec = batch_partition_spec(mesh, leaf.shape[0], leaf.ndim - 1)
        return NamedSharding(mesh, spec)
    return pytree.tree_map(one, batch_tree)


def shardings_from_specs(mesh, specs: Any) -> Any:
    return pytree.tree_map(lambda s: NamedSharding(mesh, s), specs,
                           is_leaf=_is_spec)


def place(tree: Any, shardings: Any) -> Any:
    """Every tensor of ``tree`` placed by the ``NamedSharding`` at the same
    spot of ``shardings`` (``jax.device_put`` leaf by leaf)."""
    return pytree.tree_map(lambda x, s: s.place(x), tree, shardings)


def cache_specs(mesh, cache: Any, batch_size: int,
                kv_seq_axis: Optional[str] = None) -> Any:
    """NamedShardings for the port's decode cache (``init_cache``: a list
    of per-block dicts, batch at dim 0 of every leaf; the reference's
    stacked ``period`` leaves carry a depth dim before it). A leaf whose
    dim 0 is the batch takes the batch axes when they divide it;
    ``kv_seq_axis`` (e.g. "model"), if given, also shards dim 1 of the
    leaves of rank 3 or more (the KV cache's slots and their scales)
    where it divides them."""
    axes = batch_axes(mesh)
    shard_batch = axes and batch_size % _batch_total(mesh, axes) == 0

    def build(leaf):
        parts: list = [None] * leaf.ndim
        if shard_batch and leaf.ndim > 0 and leaf.shape[0] == batch_size:
            parts[0] = axes
        if (kv_seq_axis is not None and leaf.ndim >= 3
                and leaf.shape[1] % _mesh_axis_size(mesh, kv_seq_axis)
                == 0):
            parts[1] = kv_seq_axis
        return NamedSharding(mesh, P(*parts))

    return pytree.tree_map(build, cache)


def zero1_specs(param_specs: Any, param_shapes: Any, mesh,
                axis: str = "data") -> Any:
    """ZeRO-1 optimizer-state specs: the param spec plus ``axis`` on the
    first unsharded dim divisible by the axis size (else the param
    spec). ``param_shapes`` holds anything with a ``.shape``."""
    n = _mesh_axis_size(mesh, axis)

    def one(spec: PartitionSpec, shp) -> PartitionSpec:
        if n <= 1:
            return spec
        parts = list(spec) + [None] * (len(shp.shape) - len(spec))
        for i, (p_, dim) in enumerate(zip(parts, shp.shape)):
            if p_ is None and dim % n == 0 and dim > 0:
                parts[i] = axis
                return P(*parts)
        return spec

    return pytree.tree_map(one, param_specs, param_shapes, is_leaf=_is_spec)
