"""Mixture-of-experts FFN: top-k routing with capacity-based dispatch;
counterpart of ``repro/models/moe.py``.

Tokens are dispatched into a dense (E, C + 1, d) buffer by the cumsum
rank (no sort of the tokens, static shapes), each expert's FFN runs as
one batched product over its rows, and the outputs are combined with the
renormalised gate values. A token past its expert's capacity C is
dropped in that slot: it writes zeros into the buffer's overflow row C
and takes nothing back. The reference's points of rounding and order
are kept bit for bit: float32 router logits and softmax, top-k with ties
to the lower expert index (``lax.top_k``), ranks in token order slot by
slot, the combine accumulated in float32 slot by slot and cast once.

The expert products are plain batched matrix products (the reference
leaves its einsums to XLA; no Pallas kernel), so they go through
``layers.matmul``. The expert weights shard on their ff dim over the
model axis and the router is replicated (``MoE.SHARD_DIMS``, the
reference's specs), so the experts' products are tensor-parallel while
the routing stays whole.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import matmul


class MoE(nn.Module):
    """Expert weights: ``router`` (d, E) float32 in any model type,
    ``gate``, ``up`` (E, d, ff) and ``down`` (E, ff, d) in the model's
    type, drawn as the reference draws them (normal times 1/sqrt(d), and
    1/sqrt(ff) for ``down``, in float32, then cast) from ``gen`` one
    after another; without gradients until ``LM.train()``."""

    # the model-axis dim of each weight (the reference's init_moe specs)
    SHARD_DIMS = {"router": None, "gate": 2, "up": 2, "down": 1}

    def __init__(self, gen: torch.Generator, d: int, ff: int,
                 n_experts: int, dtype: torch.dtype):
        super().__init__()

        def draw(shape, std, dt):
            w = torch.randn(shape, generator=gen, device=gen.device,
                            dtype=torch.float32) * std
            return nn.Parameter(w.to(dt), requires_grad=False)
        std = 1.0 / math.sqrt(d)
        self.router = draw((d, n_experts), std, torch.float32)
        self.gate = draw((n_experts, d, ff), std, dtype)
        self.up = draw((n_experts, d, ff), std, dtype)
        self.down = draw((n_experts, ff, d), 1.0 / math.sqrt(ff), dtype)


def init_moe(gen: torch.Generator, d: int, ff: int, n_experts: int,
             dtype: torch.dtype) -> MoE:
    """The reference's ``init_moe`` (its specs: ``MoE.SHARD_DIMS``): a
    ``MoE``."""
    return MoE(gen, d, ff, n_experts, dtype)


def top_k_lower_index(probs: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, largest
    first, equal values in ascending index order, as ``lax.top_k``
    (``torch.topk`` promises no order among ties): a stable descending
    sort's first k."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float = 1.25, drop_free: bool = False) -> int:
    """Rows an expert takes for T tokens: T k when ``drop_free``, else
    ``int(max(1, round(capacity_factor k T / E)))`` with Python's
    ``round`` (half to even), as the reference."""
    if drop_free:
        return T * top_k
    return int(max(1, round(capacity_factor * top_k * T / n_experts)))


def route(p: MoE, xf: torch.Tensor, top_k: int, C: int):
    """The routing of the tokens ``xf`` (T, d): (probs (T, E) float32,
    the renormalised gate values (T, k), the expert indices (T, k), and
    a list of k (expert, row, keep) triples of (T,) tensors, one a slot:
    a kept token's row is its rank within its expert (token order, slot
    by slot, the earlier slots' counts first), a dropped one's is C)."""
    E = p.router.shape[1]
    logits = xf.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, top_k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    base_count = torch.zeros((E,), dtype=torch.long, device=xf.device)
    slots = []
    for slot in range(top_k):
        e_id = gate_idx[:, slot]
        onehot = F.one_hot(e_id, E)
        rank_in_e = torch.cumsum(onehot, dim=0) - onehot
        pos = (rank_in_e * onehot).sum(1) + base_count[e_id]
        base_count = base_count + onehot.sum(0)
        keep = pos < C
        slots.append((e_id, torch.where(keep, pos, C), keep))
    return probs, gate_vals, gate_idx, slots


def moe_ffn(p: MoE, x: torch.Tensor, top_k: int,
            capacity_factor: float = 1.25, drop_free: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's type, aux: the float32
    Switch-style load-balance loss E sum(mean(probs) mean(onehot(top1)))).

    ``drop_free`` sizes the capacity at the worst case, T k, so no token
    is dropped (decode, where T is the batch). T is the call's B S: a
    padded token would take capacity, so callers pass none."""
    B, S, d = x.shape
    E = p.router.shape[1]
    T = B * S
    xf = x.reshape(T, d)
    C = capacity(T, top_k, E, capacity_factor, drop_free)
    probs, gate_vals, gate_idx, slots = route(p, xf, top_k, C)
    # the dispatch buffer with one overflow row (C) an expert: a dropped
    # token writes zeros there, so the order of those duplicate writes
    # (undefined for index_put on the card) cannot show
    buf = x.new_zeros((E, C + 1, d))
    for e_id, pos, keep in slots:
        buf = buf.index_put((e_id, pos),
                            torch.where(keep[:, None], xf,
                                        torch.zeros_like(xf)))
    h = F.silu(matmul(buf, p.gate)) * matmul(buf, p.up)
    out = matmul(h, p.down)                                 # (E, C + 1, d)
    y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
    for slot, (e_id, pos, keep) in enumerate(slots):
        y = y + out[e_id, pos].float() * (gate_vals[:, slot] * keep)[:, None]
    me = probs.mean(0)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d).to(x.dtype), aux
