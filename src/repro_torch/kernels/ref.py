"""The oracles of the kernels; counterpart of ``repro/kernels/ref.py``.

The reference keeps pure-jnp oracles beside its Pallas kernels. Here
the plain PyTorch versions that every wrapper runs on CPU tensors are
those oracles; these functions give them the reference's names and
signatures.
"""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_plain
from .imc_fused import imc_fused_plain
from .imc_matmul import imc_matmul_plain


def imc_matmul_ref(x_q: torch.Tensor, w: torch.Tensor, *,
                   xbar_rows: int = 256, adc_bits: int = 8,
                   w_scale: float = 1.0) -> torch.Tensor:
    """Bit-serial crossbar GEMM oracle: (M, K) int codes in [0, 255] x
    (K, N) float32 -> (M, N) float32, K a multiple of ``xbar_rows``
    (``imc_matmul_plain``)."""
    return imc_matmul_plain(x_q, w, xbar_rows=xbar_rows, adc_bits=adc_bits,
                            w_scale=w_scale)


def imc_fused_ref(x_q: torch.Tensor, w: torch.Tensor,
                  eps_pos: torch.Tensor, eps_neg: torch.Tensor, rows, *,
                  sub: int, adc_bits: int = 8) -> torch.Tensor:
    """Single-design oracle of the fused kernel: x_q (B, K) codes; w,
    eps_pos, eps_neg (K, N); ``rows`` the design's crossbar row count (a
    number or a 0-dim tensor). Returns (B, N) at the analog code scale
    (``imc_fused_plain`` with one design)."""
    table = torch.as_tensor(rows, dtype=torch.float32,
                            device=w.device).reshape(1)
    idx = torch.zeros((1,), dtype=torch.int32, device=w.device)
    return imc_fused_plain(x_q, w, eps_pos[None], eps_neg[None], idx, table,
                           sub=sub, adc_bits=adc_bits)[0]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Softmax attention oracle. q: (BH, S, hd); k, v: (BH, T, hd); the
    result in q's type (``flash_attention_plain``)."""
    return flash_attention_plain(q, k, v, causal=causal, window=window)
