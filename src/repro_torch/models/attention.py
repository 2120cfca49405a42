"""Attention; counterpart of ``repro/models/attention.py``.

``blockwise_attention`` is the training, prefill and encoder path. It
expands GQA and calls ``kernels/ops.flash_mha``: on CUDA tensors that is
the hand-written flash-attention kernel (``csrc/flash_attention.cu``),
on CPU tensors its plain version, a chunked online softmax with
O(S x chunk) memory as the reference's ``blockwise_attention`` computes.
It is differentiable: its gradient is the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``) on CUDA tensors and its plain version
on CPU tensors, where the reference differentiates its jnp scan.
``decode_attention`` is the single-query step against the KV cache
(bf16, float32, or the int8 ``kv_quant`` cache with its scales): on CUDA
tensors the hand-written GQA decode kernel (``kernels/
decode_attention.py``, ``csrc/decode_attention.cu``), which reads the
cache in place, on CPU tensors its plain version; the reference runs
plain einsums there (no Pallas kernel). ``cross_attention``
(llama-3.2-vision's image layers) runs the same two kernels: the flash
kernel, not causal, for a whole sequence, and the decode kernel's cross
route for one decode step.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.decode_attention import (cross_decode_attention_kernel,
                                        decode_attention_kernel)
from ..kernels.ops import flash_mha

NEG_INF = -1.0e30


def _expand_kv(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, H, hd), each KV head repeated for its
    group of H // KV query heads (``jnp.repeat``: heads 0..G-1 read KV
    head 0, and so on). Written as a broadcast and a reshape, the values
    of ``repeat_interleave``: its gradient sums each group into its KV
    head, as ``jnp.repeat``'s VJP does, by a reduction over the group
    axis (a fixed order), where ``repeat_interleave``'s index backward
    may add with atomics on the card."""
    B, T, kv, hd = x.shape
    if kv == n_heads:
        return x
    g = n_heads // kv
    return x[:, :, :, None].expand(B, T, kv, g, hd).reshape(B, T, n_heads,
                                                            hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, T, KV, hd). Returns (B, S, H, hd).

    window > 0 restricts key j to q_pos - window < j <= q_pos; q_offset
    shifts query positions (prefill continuation). The reference's scan
    chunks (``chunk_q``/``chunk_k``) have no counterpart: the kernel's
    tiles and the plain version's chunks are their own.
    """
    H = q.shape[2]
    return flash_mha(q, _expand_kv(k, H), _expand_kv(v, H), causal=causal,
                     window=window, q_offset=q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     q_position: torch.Tensor, window: int = 0,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step decode. q: (B, 1, H, hd); caches: (B, T, KV, hd);
    kv_positions: (B, T) (negative = empty slot); q_position: (B,);
    ``k_scale``/``v_scale`` (B, T, KV) float32 with the int8 cache.

    GQA-native as in the reference: q is contracted against the
    unexpanded cache (query heads kv*G .. kv*G + G - 1 against KV head
    kv); scores in float32, the int8 scales folded into the scores and
    the weights, softmax, the weights rounded to the value type, then
    the product with V in float32, cast to q's type
    (``kernels/decode_attention.py`` lists the rounding points)."""
    return decode_attention_kernel(q, k_cache, v_cache, kv_positions,
                                   q_position, window, k_scale, v_scale)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    decode: bool = False) -> torch.Tensor:
    """Full (non-causal) cross attention; k, v come from the modality
    frontend. q: (B, S, H, hd); k, v: (B, T_src, KV, hd). Returns (B, S,
    H, hd) in q's type.

    The reference forms float32 scores against the expanded k, divides
    them by sqrt(float32(hd)) (a product with float32(1 / sqrt(hd))
    under jit), takes a float32 softmax and keeps p in float32 for p . v.
    A sequence (train, prefill) goes through ``flash_mha(causal=False)``
    with GQA expanded, keys masked at the true T_src: on CUDA tensors the
    flash kernel (bfloat16: the scores scaled after the product, and P
    split into two bf16 terms for P . V, so near float32 p), on CPU
    tensors its plain version (q scaled before the product). With
    ``decode`` (one query, the cross cache) it is the decode kernel's
    cross route, ``kernels/decode_attention.
    cross_decode_attention_kernel``: the reference's form (the product
    scale, p in float32), GQA-native."""
    if decode:
        return cross_decode_attention_kernel(q, k, v)
    H = q.shape[2]
    return flash_mha(q, _expand_kv(k, H), _expand_kv(v, H), causal=False)
