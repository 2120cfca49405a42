"""Checkpointing: a flattened tree in one npz with an atomic rename;
counterpart of ``repro/checkpoint/ckpt.py``, with its file names
(``step_<8 digits>_p<process>.npz``) and its ``keep`` rule.

A tree is any nesting of ``nn.Module``s (their ``state_dict`` keys, in
order), named tuples and dicts (fields and keys in order), tensors and
Python ints: for training, ``TrainState(params=LM,
opt=AdamWState(m, v, count), step)``, so the leaves are the model's
``state_dict`` keys, then ``m``, ``v``, ``count`` and ``step``. Leaf
``i`` is stored as ``leaf_<i>``, with its name and type in the
``__names__`` and ``__dtypes__`` arrays. numpy has no bfloat16 (no
``ml_dtypes`` on the card's machine), so a bfloat16 leaf is stored as
its bits in a uint16 array and comes back bit for bit.

Each process saves its own file under its index (``torch.distributed``'s
rank when initialized, else 0). ``restore`` maps the leaves back in
order and puts each on the device of the target's leaf: a module is
loaded in place, other tensors are made anew there.

A placed state (``train.loop``'s DTensor leaves) is saved as each
rank's part of each leaf, with the leaf's layout (the tensor dim each
mesh dim splits) and the rank's mesh coordinate. ``restore`` alone
moves such a state to another mesh: it reads the files of every rank
that saved the step, assembles each leaf whole and places it as the
target's leaf is placed (``parallel.sharding.local_like``), so a state
saved by 4 ranks on a (2, 2) mesh is restored by 2 ranks on a (1, 2)
one, or by one process into plain tensors.

The ranks save with no barrier between them, so ``latest_step`` is the
newest step whose files cover every rank of its mesh, and the old steps
are collected only below the newest ``keep`` such steps: a run that
dies between two ranks' saves resumes from the step before.
"""
from __future__ import annotations

import json
import math
import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import (from_local_like, is_placed, local_like,
                                 part_slices, shard_dims)


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _file(ckpt_dir: str, step: int, rank: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}_p{rank}.npz")


def _leaves(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, nn.Module):
        return [(prefix + k, v)
                for k, v in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for f in tree._fields
                for leaf in _leaves(getattr(tree, f), f"{prefix}{f}.")]
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items()
                for leaf in _leaves(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _to_numpy(x: Any) -> Tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        t = (x.to_local() if is_placed(x) else x).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    if isinstance(x, int):
        return np.asarray(x, np.int64), "int"
    raise TypeError(f"checkpoint: cannot store a {type(x).__name__} leaf")


def _from_numpy(arr: np.ndarray, dtype: str, like: Any) -> Any:
    """The whole value ``arr`` as ``like`` holds it: an int, a tensor on
    its device, or this rank's part of a DTensor placed as ``like``."""
    if dtype == "int":
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if is_placed(like):
        return from_local_like(
            local_like(t, like).contiguous().to(like.to_local().device),
            like)
    return t.to(like.device)


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _leaves(tree)
    arrays, dtypes = {}, []
    for i, (_, x) in enumerate(leaves):
        arrays[f"leaf_{i}"], dt = _to_numpy(x)
        dtypes.append(dt)
    arrays["__names__"] = np.asarray([n for n, _ in leaves])
    arrays["__dtypes__"] = np.asarray(dtypes)
    layouts = [shard_dims(x.placements) if is_placed(x) else None
               for _, x in leaves]
    if any(lay is not None for lay in layouts):
        placed = next(x for _, x in leaves if is_placed(x))
        dm = placed.device_mesh
        arrays["__placed__"] = np.asarray(json.dumps({
            "mesh": list(dm.shape), "coord": dm.get_coordinate(),
            "layouts": layouts,
            "shapes": [list(x.shape) if lay is not None else None
                       for (_, x), lay in zip(leaves, layouts)]}))
    final = _file(ckpt_dir, step, _process_index())
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, final)  # atomic: no torn checkpoints on crash
    _gc(ckpt_dir, keep)
    return final


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = set()
    for f in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)_p\d+\.npz$", f)
        if m:
            steps.add(int(m.group(1)))
    return sorted(steps)


def _is_whole(ckpt_dir: str, step: int) -> bool:
    """Whether every rank that saved ``step`` finished its file: rank 0's
    file names the mesh of a placed save, whose every rank must have
    one; a save that is not placed needs only rank 0's (every rank can
    restore from it)."""
    try:
        with np.load(_file(ckpt_dir, step, 0)) as data:
            if "__placed__" not in data:
                return True
            n = math.prod(json.loads(str(data["__placed__"]))["mesh"])
    except FileNotFoundError:
        return False
    return all(os.path.exists(_file(ckpt_dir, step, r))
               for r in range(1, n))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step that every rank finished saving: after a crash
    between two ranks' saves of a step, the one before it."""
    steps = [s for s in list_steps(ckpt_dir) if _is_whole(ckpt_dir, s)]
    return steps[-1] if steps else None


def _rebuild(target: Any, it) -> Any:
    if isinstance(target, nn.Module):
        with torch.no_grad():
            for _, v in target.state_dict(keep_vars=True).items():
                new = next(it)
                if is_placed(v):
                    v.to_local().copy_(new.to_local())
                else:
                    v.copy_(new)
        return target
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_rebuild(getattr(target, f), it)
                              for f in target._fields))
    if isinstance(target, dict):
        return {k: _rebuild(v, it) for k, v in target.items()}
    return next(it)


def _whole_leaves(ckpt_dir: str, step: int, data) -> List[np.ndarray]:
    """Every leaf of a placed save whole, from the files of every rank
    that saved ``step``."""
    meta = json.loads(str(data["__placed__"]))
    n = math.prod(meta["mesh"])
    files = [_file(ckpt_dir, step, r) for r in range(n)]
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise ValueError(f"checkpoint step {step} was saved by {n} ranks; "
                         f"missing {missing}")
    out: List[Any] = [None] * len(meta["layouts"])
    for f in files:
        with np.load(f) as part:
            pm = json.loads(str(part["__placed__"]))
            for i, lay in enumerate(meta["layouts"]):
                arr = part[f"leaf_{i}"]
                if lay is None:
                    out[i] = arr
                    continue
                if out[i] is None:
                    out[i] = np.empty(meta["shapes"][i], arr.dtype)
                out[i][part_slices(meta["shapes"][i], lay, pm["mesh"],
                                   pm["coord"])] = arr
    return out


def restore(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target``, each leaf on the device
    of the target's leaf (a module in place) and, where the target's
    leaf is a DTensor, placed as it is (see the module docstring). A
    rank with no file of its own reads rank 0's."""
    path = _file(ckpt_dir, step, _process_index())
    if not os.path.exists(path):
        path = _file(ckpt_dir, step, 0)
    with np.load(path) as data:
        names, dtypes = list(data["__names__"]), list(data["__dtypes__"])
        leaves = _leaves(target)
        if len(names) != len(leaves):
            raise ValueError(
                f"checkpoint at {path} has {len(names)} leaves but the "
                f"target tree has {len(leaves)} — wrong model/config?")
        if "__placed__" in data:
            arrays = _whole_leaves(ckpt_dir, step, data)
        else:
            arrays = [data[f"leaf_{i}"] for i in range(len(names))]
    values = []
    for i, ((name, leaf), arr) in enumerate(zip(leaves, arrays)):
        if isinstance(leaf, torch.Tensor) and (
                tuple(arr.shape) != tuple(leaf.shape)):
            raise ValueError(
                f"checkpoint leaf {i} ({names[i]}) shape {arr.shape} != "
                f"target {name} {tuple(leaf.shape)} — checkpoint from a "
                "different config?")
        values.append(_from_numpy(arr, str(dtypes[i]), leaf))
    return _rebuild(target, iter(values))


def _gc(ckpt_dir: str, keep: int) -> None:
    """Removes the steps older than the newest ``keep`` that every rank
    finished; a newer step that some rank has not finished stays."""
    whole = [s for s in list_steps(ckpt_dir) if _is_whole(ckpt_dir, s)]
    if len(whole) <= keep:
        return
    for s in list_steps(ckpt_dir):
        if s >= whole[-keep]:
            break
        for f in os.listdir(ckpt_dir):
            if f.startswith(f"step_{s:08d}_"):
                # every rank collects the old steps: another may have
                # removed this file first
                try:
                    os.remove(os.path.join(ckpt_dir, f))
                except FileNotFoundError:
                    pass
