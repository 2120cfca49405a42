"""Lane batching across devices and the bucket-callable cache;
counterpart of ``repro/core/distributed.py``.

The reference shards the *search* axis of ``jit(vmap(search))`` over a
device mesh. The port's engines (``core/genetic.search_kernel``,
``core/nsga.nsga_search_kernel``, ``core/baselines.baseline_kernel``)
already take a leading lane axis, so ``compile_batched_search`` only
chooses where lanes run: with one device it calls the lane function
once; with D devices and a lane count L divisible by D it runs L/D
contiguous lanes on each device and joins the results in lane order
(the reference's ``runner._search_mesh`` rule). The chunks run one after
the other from the calling thread: the engines synchronize inside their
loops, so two devices overlap only between those points.

``cached_compile`` is the reference's LRU with the same counters. Eager
torch has no trace to cache, so what an entry holds is the built lane
callable of a campaign bucket (its closure over the scorer, pinned by
``refs``); the campaign stats and the co-design service report the
counters.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device

# Built lane callables per (bucket signature, lane count, devices):
# LRU-bounded so a long campaign over many bucket shapes does not pin
# every scorer closure for the process lifetime.
KERNEL_CACHE_MAXSIZE = 128
_KERNEL_CACHE: "OrderedDict[object, tuple]" = OrderedDict()
_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}


def cached_compile(key, builder: Callable, *refs):
    """Return (building once) the callable registered under ``key``;
    ``refs`` keep the objects the key's components point at alive for
    the entry's lifetime. Least-recently-used entries are evicted past
    ``KERNEL_CACHE_MAXSIZE`` (an evicted callable is rebuilt on next
    use)."""
    entry = _KERNEL_CACHE.get(key)
    if entry is None:
        _CACHE_STATS["misses"] += 1
        entry = (builder(), refs)
        _KERNEL_CACHE[key] = entry
        while len(_KERNEL_CACHE) > KERNEL_CACHE_MAXSIZE:
            _KERNEL_CACHE.popitem(last=False)
            _CACHE_STATS["evictions"] += 1
    else:
        _CACHE_STATS["hits"] += 1
        _KERNEL_CACHE.move_to_end(key)
    return entry[0]


def kernel_cache_stats() -> dict:
    """Snapshot of the in-process cache counters + current size."""
    return dict(_CACHE_STATS, size=len(_KERNEL_CACHE))


def kernel_cache_clear() -> None:
    """Drop every cached callable and zero the counters (tests)."""
    _KERNEL_CACHE.clear()
    for k in _CACHE_STATS:
        _CACHE_STATS[k] = 0


def make_sharded_scorer(*_args, **_kwargs):
    """Removed in the reference (it was a deprecation wrapper) and kept
    there as this stub: build the scorer, then split its population
    rows with ``core.scoring.sharded_score_fn``."""
    raise ImportError(
        "distributed.make_sharded_scorer was removed; use "
        "core.scoring.build_scorer(space, ScorerSpec(objective, "
        "workloads=wl)) with scoring.sharded_score_fn (or import both "
        "from repro_torch.api)")


def lane_devices(device="cuda") -> List[torch.device]:
    """The devices a lane batch may spread over: every CUDA device
    present when ``device`` is a CUDA device, else ``device`` alone."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def search_devices(n_lanes: int, device="cuda") -> List[torch.device]:
    """The devices ``n_lanes`` lanes run on: all of ``lane_devices``
    when there are several and they divide the lane count, else
    ``device`` alone."""
    devs = lane_devices(device)
    if len(devs) <= 1 or n_lanes % len(devs):
        return [resolve_device(device)]
    return devs


def _chunk(x, i: int, c: int, dev: torch.device):
    if x is None:
        return None
    return x[i * c:(i + 1) * c].to(dev)


def _join(parts: list, home: torch.device):
    """Per-device outputs -> one output in lane order: tensors are
    concatenated on ``home``, numpy arrays concatenated, tuples and
    NamedTuples joined field by field, anything else taken from the
    first chunk (a wall time, an evaluation count)."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([p.to(home) for p in parts])
    if isinstance(first, np.ndarray) and first.ndim:
        return np.concatenate(parts)
    if isinstance(first, tuple):
        fields = [_join([p[j] for p in parts], home)
                  for j in range(len(first))]
        return (type(first)._make(fields) if hasattr(first, "_fields")
                else tuple(fields))
    return first


def compile_batched_search(search_one: Callable,
                           devices: Optional[Sequence] = None) -> Callable:
    """Lanes of independent searches, spread over ``devices``.

    ``search_one(device, *lanes)`` runs lane-major inputs (each with a
    leading lane axis L, or None) on ``device`` and returns its outputs
    with the same leading axis. With one device the returned callable
    calls it once; with D devices it needs L divisible by D (callers
    choose the devices with ``search_devices``), runs lanes
    ``[i L/D, (i+1) L/D)`` on device i and joins the outputs in lane
    order on the first device. ``devices`` defaults to the CUDA devices
    present (and raises without a GPU)."""
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else lane_devices("cuda"))
    if len(devs) == 1:
        dev = devs[0]

        def run_one(*lanes):
            return search_one(dev, *lanes)
        return run_one

    def run(*lanes):
        L = lanes[0].shape[0]
        if L % len(devs):
            raise ValueError(f"{L} lanes do not split over {len(devs)} "
                             "devices; choose them with search_devices")
        c = L // len(devs)
        parts = [search_one(d, *[_chunk(a, i, c, d) for a in lanes])
                 for i, d in enumerate(devs)]
        return _join(parts, devs[0])
    return run
