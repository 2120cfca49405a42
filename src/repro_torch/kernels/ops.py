"""Padded entry points around the crossbar kernels; counterpart of
``repro/kernels/ops.py`` (``imc_gemm``; ``flash_mha`` comes with the LM
stack).

The JAX wrapper also pads M to 8/128 and N to 128 rows of TPU block
alignment and cuts them off again; the Hopper kernel masks its ragged M
and N edges itself, so only K is padded here.
"""
from __future__ import annotations

import torch

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
