"""Basic LM building blocks: norms, RoPE, MLPs, initializers; counterpart
of ``repro/models/layers.py``.

Parameters are ``nn.Parameter``s in the reference's (d_in, d_out)
layout, applied as ``x @ w`` (not ``nn.Linear``'s transposed weight), so
a reference array carries across unchanged (``convert.py``); products
go through ``matmul``, which gives operands of mixed types the
reference's result type. They are made with ``requires_grad=False``
(serving); ``LM.train()`` switches a model to training. The reference's
inits return a ``PartitionSpec`` beside each weight; here each module
states the model-axis dim of its weights beside its init (``MLP.
SHARD_DIMS``, ``moe.MoE.SHARD_DIMS``, ``transformer.Block.shard_dims``),
``spec_for`` turns one into a spec, and ``transformer.param_specs``
gives the whole model's.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.sharding import PartitionSpec as P

MODEL_AXIS = "model"


def _shardable(dim: int, n_shards: int) -> bool:
    return n_shards > 0 and dim % n_shards == 0


def spec_for(shape: Tuple[int, ...], shard_dim: Optional[int],
             n_shards: int) -> P:
    """PartitionSpec sharding ``shard_dim`` over the model axis when
    divisible, else fully replicated."""
    if shard_dim is None or not _shardable(shape[shard_dim], n_shards):
        return P(*([None] * len(shape)))
    parts = [None] * len(shape)
    parts[shard_dim] = MODEL_AXIS
    return P(*parts)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: float = 1.0) -> nn.Parameter:
    """A (d_in, d_out) weight, standard normal times ``scale / sqrt(d_in)``
    drawn in float32 on ``gen``'s device, then cast to ``dtype``."""
    std = scale / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32) * std
    return nn.Parameter(w.to(dtype), requires_grad=False)


def zeros_param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the type ``jnp.matmul`` gives: both operands promoted
    to their common type first (``jnp.result_type``; float32 frames @ a
    bfloat16 weight is a float32 product), where ``torch.matmul`` refuses
    mixed types. Operands of one type are multiplied as they are."""
    if a.dtype != b.dtype:
        t = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(t), b.to(t)
    return a @ b


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the ``(1 + scale)`` gain, cast back."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in float32 (biased variance) with gain ``scale`` and
    ``bias``, cast back to x's type."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the two halves of the head dimension (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    ang = positions[..., :, None, None].float() * freqs         # (...,S,1,hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Dense FFN weights: ``up`` and ``down``, plus ``gate`` when gated
    (SwiGLU). The reference draws ``up``, ``gate``, ``down`` from three
    split keys; here they come one after another from ``gen``."""

    # the model-axis dim of each weight (the reference's init_mlp specs)
    SHARD_DIMS = {"up": 1, "gate": 1, "down": 0}

    def __init__(self, gen: torch.Generator, d: int, ff: int, gated: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.up = dense_init(gen, d, ff, dtype)
        self.gate = dense_init(gen, d, ff, dtype) if gated else None
        self.down = dense_init(gen, ff, d, dtype)


def init_mlp(gen: torch.Generator, d: int, ff: int, gated: bool,
             dtype: torch.dtype) -> MLP:
    """The reference's ``init_mlp`` (its specs: ``MLP.SHARD_DIMS``): an
    ``MLP``."""
    return MLP(gen, d, ff, gated, dtype)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU when ``p.gate`` is set, else GELU (tanh approximation, the
    default of ``jax.nn.gelu``)."""
    if p.gate is not None:
        h = F.silu(matmul(x, p.gate)) * matmul(x, p.up)
    else:
        h = F.gelu(matmul(x, p.up), approximate="tanh")
    return matmul(h, p.down)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE in float32; logits (..., V), labels (...) integer."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
