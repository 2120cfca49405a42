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
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


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
        t = x.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    if isinstance(x, int):
        return np.asarray(x, np.int64), "int"
    raise TypeError(f"checkpoint: cannot store a {type(x).__name__} leaf")


def _from_numpy(arr: np.ndarray, dtype: str, like: Any) -> Any:
    if dtype == "int":
        return int(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
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
    final = os.path.join(ckpt_dir,
                         f"step_{step:08d}_p{_process_index()}.npz")
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


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def _rebuild(target: Any, it) -> Any:
    if isinstance(target, nn.Module):
        with torch.no_grad():
            for _, v in target.state_dict(keep_vars=True).items():
                v.copy_(next(it))
        return target
    if isinstance(target, tuple) and hasattr(target, "_fields"):
        return type(target)(*(_rebuild(getattr(target, f), it)
                              for f in target._fields))
    if isinstance(target, dict):
        return {k: _rebuild(v, it) for k, v in target.items()}
    return next(it)


def restore(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target``, each leaf on the device
    of the target's leaf (a module in place)."""
    path = os.path.join(ckpt_dir,
                        f"step_{step:08d}_p{_process_index()}.npz")
    with np.load(path) as data:
        names, dtypes = list(data["__names__"]), list(data["__dtypes__"])
        leaves = _leaves(target)
        if len(names) != len(leaves):
            raise ValueError(
                f"checkpoint at {path} has {len(names)} leaves but the "
                f"target tree has {len(leaves)} — wrong model/config?")
        values = []
        for i, (name, leaf) in enumerate(leaves):
            arr = data[f"leaf_{i}"]
            if isinstance(leaf, torch.Tensor) and (
                    tuple(arr.shape) != tuple(leaf.shape)):
                raise ValueError(
                    f"checkpoint leaf {i} ({names[i]}) shape {arr.shape} != "
                    f"target {name} {tuple(leaf.shape)} — checkpoint from a "
                    "different config?")
            values.append(_from_numpy(arr, str(dtypes[i]), leaf))
    return _rebuild(target, iter(values))


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = list_steps(ckpt_dir)
    for s in steps[:-keep]:
        for f in os.listdir(ckpt_dir):
            if f.startswith(f"step_{s:08d}_"):
                os.remove(os.path.join(ckpt_dir, f))
