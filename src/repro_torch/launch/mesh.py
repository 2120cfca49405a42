"""Mesh construction; counterpart of ``repro/launch/mesh.py``.

Axes: ("pod", "data", "model"). One pod is 256 chips (16 x 16), two
pods 512. The reference builds a ``jax.sharding.Mesh`` over the devices
JAX sees; here a ``Mesh`` is the axis names and sizes, which is all the
sharding rules read (``mesh.shape``: name -> size), plus a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default
process group when it spans more than one rank:

- ``make_host_mesh(model)`` is (n // model, model) over the n ranks of
  the default process group, and 1 x 1 in a process without one. On a
  1 x 1 mesh there is no ``DeviceMesh``, and placing a tensor
  (``parallel.sharding.NamedSharding.place``) leaves it as it is, so
  one process on one card needs no process group. Over more ranks a
  tensor is placed with ``distribute_tensor``.
- ``make_production_mesh`` gives the 16 x 16 and 2 x 16 x 16 shapes as
  data, for the rule helpers and the dry run (ROADMAP Queue 1 item
  13i); no fleet stands behind it, so placing onto it raises.
- ``mesh_context(mesh)`` makes ``mesh`` the current one
  (``current_mesh()``) inside a ``with`` block, as ``jax.set_mesh``.

Functions, not module-level constants, so importing touches no process
group.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, Optional, Sequence

import torch.distributed as dist


class Mesh:
    """Named mesh axes: ``shape`` (name -> size, in the mesh's order),
    ``axis_names``, ``size``, and ``device_mesh``, the ``DeviceMesh``
    over the ranks (None on a mesh of one device or on a mesh given as
    data)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device_mesh=None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} vs axes "
                             f"{tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, shape)))
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape.values():
            n *= s
        return n

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({axes})"


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """(n // model, model) over the ranks of the default process group
    (tests, CPU processes); 1 x 1 without one. The ``DeviceMesh`` is on
    the card under the nccl backend and on the CPU otherwise."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    assert n % model == 0
    shape, axes = (n // model, model), ("data", "model")
    device_mesh = None
    if n > 1:
        from torch.distributed.device_mesh import init_device_mesh
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(kind, shape, mesh_dim_names=axes)
    return Mesh(shape, axes, device_mesh)


_CURRENT: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    """``mesh`` is ``current_mesh()`` inside the block (in this thread or
    task; nested blocks restore the outer mesh)."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT.get()
