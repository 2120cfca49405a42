"""Gradient compression with error feedback; counterpart of
``repro/parallel/compression.py``.

int8 symmetric quantisation of gradients before the data-parallel
all-reduce, with a per-tensor scale and an error-feedback residual so
that the compression noise is unbiased over steps (1-bit/8-bit SGD).
The pure functions work on any device; ``compressed_grad_mean`` is the
all-reduce itself, over a ``torch.distributed`` process group where the
reference's runs inside ``shard_map`` over a mesh axis.

The arithmetic is the reference's as XLA compiles it under ``jit``, bit
for bit: the division of max|x| by 127 is a product with float32(1 /
127), and the residual ``corrected - q * scale`` is one fused
multiply-add (one rounding; here exact products and one rounded
subtraction). The reference run eagerly divides and
rounds the product first, so it may differ by one ULP of the scale, one
quantisation step of q and so of the residual (ROADMAP's divergences).
``compressed_grad_mean`` sums the ranks' rounded scales, as a psum across
devices does; the reference run under ``jax.vmap`` on one device lets
XLA fuse a scale's product into that sum (one rounding fewer), so the
two may differ in the mean's last bit.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

# float32(1 / 127): XLA turns the reference's division by the constant 127
# into a product with its float32 reciprocal under jit
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale 0-dim): scale = max(max|x|, 1e-12) / 127, q =
    round(x / scale) (half to even, as ``jnp.round``) clipped to
    [-127, 127]."""
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) * _INV_127
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_compress(g: torch.Tensor, residual: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Returns (q, scale, new_residual): compresses g + residual (in
    float32) and carries the quantisation error forward. The error
    ``corrected - q * scale`` is rounded once, as the fused multiply-add
    XLA compiles: the scale is split into its top 12 significant bits and
    the rest, so each product with q (at most 7 bits) is exact, and
    ``corrected - q * scale_hi`` is exact too (the two are within a
    factor of 2, or q is 0), which leaves one rounding, in the last
    subtraction. No contraction of these products into a multiply-add can
    change a bit, so the card and the CPU agree."""
    corrected = g.float() + residual
    q, scale = compress_int8(corrected)
    scale_hi = (scale.view(torch.int32) & ~0xFFF).view(torch.float32)
    qf = q.float()
    new_residual = (corrected - qf * scale_hi) - qf * (scale - scale_hi)
    return q, scale, new_residual


def init_residuals(grads: Any) -> Any:
    """float32 zeros of each leaf's shape, on its device, in the same
    nesting of dicts, lists and tuples."""
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads)


def compressed_grad_mean(grads: Any, residuals: Any,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> Tuple[Any, Any]:
    """Across the ranks of ``group`` (the default group if None): each
    leaf error-feedback compressed, then the all-reduces the reference's
    psums are — the int8 values summed as int32, the scales, the count
    of ranks — and the mean ``qsum * (ssum / n) / n`` in the leaf's type.
    Returns (mean grads, new residuals). The int8 payload is what the
    reference counts as crossing the interconnect; the sum itself needs
    int32, as XLA's does."""
    def one(g, r):
        q, scale, new_r = error_feedback_compress(g, r)
        qsum = q.to(torch.int32)
        ssum = scale.reshape(1).clone()
        n = torch.ones((1,), dtype=torch.float32, device=g.device)
        for t in (qsum, ssum, n):
            dist.all_reduce(t, group=group)
        mean = qsum.float() * (ssum[0] / n[0]) / n[0]
        return mean.to(g.dtype), new_r

    leaves, spec = pytree.tree_flatten(grads)
    res_leaves, res_spec = pytree.tree_flatten(residuals)
    if res_spec != spec:
        raise ValueError("compressed_grad_mean: residuals are not nested "
                         "as the gradients")
    pairs = [one(g, r) for g, r in zip(leaves, res_leaves)]
    return (pytree.tree_unflatten([m for m, _ in pairs], spec),
            pytree.tree_unflatten([r for _, r in pairs], spec))
