"""Entry points around the kernels; counterpart of
``repro/kernels/ops.py`` (``imc_gemm``, ``flash_mha``), plus
``FlashAttention``, the autograd function that gives ``flash_mha`` the
gradient kernel (the reference differentiates its jnp attention).

The JAX wrappers pad to TPU block multiples and cut the padding off
again: ``imc_gemm`` M to 8/128 and N to 128, ``flash_mha`` S and T to
the attention blocks. The Hopper kernels mask their ragged edges
themselves, so only ``imc_gemm``'s K (whole crossbars) is padded here.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_bwd
from .imc_matmul import imc_matmul


def imc_gemm(x_q: torch.Tensor, w: torch.Tensor, xbar_rows: int = 256,
             adc_bits: int = 8, w_scale: float = 1.0) -> torch.Tensor:
    """Bit-serial crossbar GEMM of any (M, K) int32 codes in [0, 255]
    and (K, N) float32 weights -> (M, N) float32. K is zero-padded to a
    multiple of ``xbar_rows``: padded rows carry code 0 and weight 0,
    so they add exact zeros to the last crossbar's sums."""
    pad = (-x_q.shape[1]) % int(xbar_rows)
    if pad:
        x_q = torch.nn.functional.pad(x_q, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return imc_matmul(x_q.contiguous(), w.contiguous(), xbar_rows=xbar_rows,
                      adc_bits=adc_bits, w_scale=w_scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its gradient. The forward is the forward
    kernel (or its plain version on CPU tensors), saving q, k, v, the
    output and, where the gradient kernel will read it (CUDA tensors,
    either route, an input needing a gradient), the forward's
    log-sum-exp; the backward is ``flash_attention_bwd``: the
    hand-written gradient kernel on CUDA tensors, its plain version on
    CPU tensors, never a fallback. Inputs are (B, H, L, hd) views."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int):
        lse = None
        if q.is_cuda and any(ctx.needs_input_grad[:3]):
            out, lse = flash_attention(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset,
                                       return_lse=True)
        else:
            out = flash_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, causal=causal,
                                         window=window, q_offset=q_offset,
                                         lse=lse)
        return dq, dk, dv, None, None, None


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0, block_q: int = 128,
              block_k: int = 128, q_offset: int = 0) -> torch.Tensor:
    """(B, S, H, hd) x (B, T, H, hd)^2 -> (B, S, H, hd). GQA should be
    expanded by the caller (``models/attention.py:_expand_kv``).

    The reference folds to (B*H, S, hd) with a transpose; here the kernel
    reads the (B, H, S, hd) transposed views through their strides and
    writes its output in the same layout, so the result is a contiguous
    (B, S, H, hd) tensor and nothing is copied. Keys are masked at their
    true length T (the reference masks at its padded T when not causal;
    ROADMAP Queue 3). ``block_q``/``block_k`` are accepted and unused;
    ``q_offset`` shifts the query positions (prefill continuation).
    Differentiable through ``FlashAttention``: the gradient kernel runs
    when an input requires a gradient and the caller takes one."""
    del block_q, block_k
    out = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), bool(causal), int(window),
                               int(q_offset))
    return out.transpose(1, 2)
