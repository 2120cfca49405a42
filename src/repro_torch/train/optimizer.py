"""AdamW, global-norm clipping and the warmup-cosine schedule;
counterpart of ``repro/train/optimizer.py``.

A tree here is a dict from parameter name to tensor, in the order of
``LM.named_parameters()`` (``params_of``); the optimizer state mirrors
it with float32 ``m`` and ``v``. The formulas are the reference's, not
``torch.optim.AdamW``'s (whose decoupled decay rounds differently):
``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, ``step = (m /
bc1) / (sqrt(v / bc2) + eps)`` and ``p - lr (step + wd p)``, all in
float32, then cast to the parameter's type. XLA on the CPU contracts
the two moment updates into fused multiply-adds; here ``b1 m`` and
``b2 v`` are rounded before the add (tests/test_torch_train.py states
the bound).

Where the reference returns new trees, the port updates the parameters
and ``m``/``v`` in place, one leaf at a time, so at full width the
float32 temporaries of one leaf are all that is alive beside the state.
The step counter and the schedule are host numbers (float32 values, as
the reference's traced scalars are), so an update reads nothing back
from the device. The clip's norm adds the float32 squares in float64
(``sq_sum``), so a gradient cut in parts over ranks gives the norm the
whole gives (the reference adds them in float32).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Tree = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    m: Tree
    v: Tree
    count: int


def params_of(params: Union[nn.Module, Tree]) -> Tree:
    """The parameter tree of a module (name -> parameter), or a tree as
    it is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def adamw_init(params: Union[nn.Module, Tree]) -> AdamWState:
    """float32 zeros beside every parameter, on its device."""
    tree = params_of(params)

    def z(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(m={k: z(p) for k, p in tree.items()},
                      v={k: z(p) for k, p in tree.items()}, count=0)


@torch.no_grad()
def sq_sum(g: torch.Tensor) -> torch.Tensor:
    """The sum of a gradient's float32 squares, added in float64 (0-dim):
    a leaf cut in parts gives, part sum by part sum, the float64 sum of
    the whole to a few units of float64's last place, so the float32 norm
    rounded from it does not depend on the cut (but at a float32
    rounding boundary)."""
    return torch.sum(torch.square(g.float()), dtype=torch.float64)


@torch.no_grad()
def global_norm(sq: torch.Tensor) -> torch.Tensor:
    """The float32 global norm from the leaves' float64 square sums
    (``sq_sum``; a 1-d tensor in leaf order)."""
    return torch.sqrt(torch.sum(sq)).float()


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scales every gradient by min(1, max_norm / max(norm, 1e-12)), the
    norm taken over all leaves (``global_norm`` of their ``sq_sum``s,
    unless ``norm`` is given: the train step's over a mesh, from every
    rank's parts); in place (each leaf through a float32 copy, cast back
    to its type). Returns (grads, norm), the norm a 0-dim float32 tensor
    on the gradients' device (not read here)."""
    if norm is None:
        norm = global_norm(torch.stack([sq_sum(g) for g in grads.values()]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, norm


@torch.no_grad()
def adamw_update(grads: Tree, state: AdamWState,
                 params: Union[nn.Module, Tree], lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> Tuple[Tree, AdamWState]:
    """One AdamW step, leaf by leaf and in place (parameters, ``m`` and
    ``v``). ``grads`` is consumed: each gradient leaves it once its leaf
    is updated, so its memory goes back before the next leaf's
    temporaries are made. The leaves are plain tensors of one shape a
    name; the train step over a mesh passes this rank's parts (views of
    its parameters at ``m`` and ``v``'s placement): the step is
    elementwise, so a part takes the bits the whole leaf would. Returns
    (params, the state with count + 1)."""
    tree = params_of(params)
    count = state.count + 1
    t, one = np.float32(count), np.float32(1.0)
    bc1 = float(one - np.float32(b1) ** t)
    bc2 = float(one - np.float32(b2) ** t)
    for name in list(grads):
        m, v, p = state.m[name], state.v[name], tree[name]
        gf = grads.pop(name).float()
        m.mul_(b1).add_(gf * (1 - b1))
        v.mul_(b2).add_((gf * (1 - b2)).mul_(gf))
        del gf
        step = m / bc1
        step.div_(torch.sqrt(v / bc2).add_(eps))
        pf = p.float()
        step.add_(pf * weight_decay).mul_(lr)
        p.copy_(pf.sub_(step))
    return tree, AdamWState(m=state.m, v=state.v, count=count)


def warmup_cosine(step: int, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor * peak_lr`` at ``total``; float32 arithmetic, as the
    reference's, returned as a Python float."""
    f = np.float32
    s = f(step)
    warm = s / f(max(warmup, 1))
    prog = np.clip((s - f(warmup)) / f(max(total - warmup, 1)), f(0), f(1))
    cos = f(floor) + (f(1) - f(floor)) * f(0.5) * (
        f(1) + np.cos(f(math.pi) * prog, dtype=np.float32))
    return float(f(peak_lr) * (warm if s < f(warmup) else cos))
