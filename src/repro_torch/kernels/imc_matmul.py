"""Bit-serial IMC crossbar GEMM; counterpart of
``repro/kernels/imc_matmul.py`` (the Pallas TPU kernel ``_imc_kernel``)
and of its oracle ``repro/kernels/ref.py::imc_matmul_ref``.

x_q (M, K) int32 activation codes in [0, 255] times w (K, N) float32
pre-noised weights, K a multiple of the crossbar row count R
(``kernels/ops.imc_gemm`` pads). Each R-row K-tile is one crossbar: its
8 activation bit-plane column sums are quantized by the ADC at full
scale ``w_scale * R / 4`` (``kernels/adc.py``) and shift-accumulated.

``imc_matmul`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/imc_matmul.cu`` (or raises), on CPU
tensors it runs the plain PyTorch version ``imc_matmul_plain``. Its
``launches`` attribute counts kernel launches.

Summation order. ``imc_matmul_plain`` defines it: the R terms of each
bit-plane sum in k order, then within each crossbar tile the ADC'd
planes added for bits 0..7, then the tiles added in order 0..T-1, each
step a separately rounded float32 operation. The kernel computes whole
tiles in the CTAs of a thread-block cluster and combines them in that
tile order across the cluster's ranks and rounds; its bit-plane sums
add only the terms whose bit is set, in ascending k (a skipped term is
an exact zero, and the sums start at +0.0, so for finite weights no bit
moves). It relies on no step being exact, so it equals the plain
version bit for bit for any ``w_scale`` and ADC width; at
``w_scale != 1`` the ADC step is not a power of two and the tile values
round when added, so combining the tiles in another order would change
bits (``tests/test_torch_kernels.py`` shows both). The JAX oracle and
the Pallas interpret run add the R terms in XLA's dot order instead; a
pre-ADC sum within a few ULP of a .5 code boundary could round the
other way there. ``tests/test_torch_kernels.py`` holds the plain
version to them at the ``tests/test_kernels.py`` bound.
"""
from __future__ import annotations

import torch

from . import build
from .adc import WEIGHT_BITS, adc_full_scale, adc_quantize
from .imc_fused import _check

# elements of the (8, M, n_tiles, chunk) bit-plane sum the plain version
# holds at once; wider products are processed in column chunks (the
# columns are independent, so chunking does not change the arithmetic)
_PLAIN_MAX_ELEMENTS = 1 << 27


def imc_matmul_plain(x_q: torch.Tensor, w: torch.Tensor, *, xbar_rows: int,
                     adc_bits: int = 8, w_scale: float = 1.0
                     ) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (M, K) x (K, N) -> (M, N)
    float32, K a multiple of ``xbar_rows``."""
    M, K = x_q.shape
    N = w.shape[1]
    R = int(xbar_rows)
    if K % R:
        raise ValueError(f"K={K} is not a multiple of xbar_rows={R}")
    T = K // R
    planes = torch.stack([((x_q.long() >> b) & 1).float()
                          for b in range(WEIGHT_BITS)])
    planes = planes.reshape(WEIGHT_BITS, M, T, R)
    wt = w.float().reshape(T, R, N)
    fs = adc_full_scale(float(R), w_scale)
    chunk = max(1, _PLAIN_MAX_ELEMENTS // max(1, WEIGHT_BITS * M * T))
    out = torch.zeros((M, N), dtype=torch.float32, device=w.device)
    for n0 in range(0, N, chunk):
        wc = wt[:, :, n0:n0 + chunk]
        # (8, M, T, chunk) bit-plane sums, k added in order
        part = torch.zeros((WEIGHT_BITS, M, T, wc.shape[2]),
                           dtype=torch.float32, device=w.device)
        for k in range(R):
            part += planes[:, :, :, k, None] * wc[None, None, :, k, :]
        q = adc_quantize(part, fs, adc_bits)
        # bits 0..7 within a tile, then tiles in order
        tile = torch.zeros_like(q[0])
        for b in range(WEIGHT_BITS):
            tile += q[b] * float(1 << b)
        for t in range(T):
            out[:, n0:n0 + chunk] += tile[:, t]
    return out


def imc_matmul(x_q: torch.Tensor, w: torch.Tensor, *, xbar_rows: int,
               adc_bits: int = 8, w_scale: float = 1.0) -> torch.Tensor:
    """Bit-serial crossbar GEMM (shapes as in ``imc_matmul_plain``). CUDA
    tensors launch ``csrc/imc_matmul.cu``; CPU tensors take the plain
    version."""
    if x_q.device.type == "cpu":
        return imc_matmul_plain(x_q, w, xbar_rows=xbar_rows,
                                adc_bits=adc_bits, w_scale=w_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"imc_matmul: unsupported device {x_q.device}")
    dev = x_q.device
    _check("x_q", x_q, torch.int32, 2, dev)
    _check("w", w, torch.float32, 2, dev)
    M, K = x_q.shape
    N = w.shape[1]
    R = int(xbar_rows)
    if w.shape[0] != K:
        raise ValueError(f"imc_matmul: x_q {tuple(x_q.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if R < 1 or K % R or not 1 <= adc_bits <= 16:
        raise ValueError(f"imc_matmul: bad xbar_rows={R} for K={K} or "
                         f"adc_bits={adc_bits}")
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    lib = build.load("imc_matmul")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_matmul_launch(
        x_q.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, R, adc_bits,
        float(adc_full_scale(float(R), w_scale)), stream)
    if err != 0:
        raise RuntimeError(f"imc_matmul kernel launch failed: CUDA error "
                           f"{err}")
    imc_matmul.launches += 1
    return out


imc_matmul.launches = 0
