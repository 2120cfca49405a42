"""Fused IMC crossbar evaluation: gather -> noise -> GEMM -> ADC, one pass.

Counterpart of ``repro/kernels/imc_fused.py`` (the Pallas TPU kernel
``_fused_kernel``) and of its oracle ``repro/kernels/ref.py::
imc_fused_ref``. The accuracy model's hot loop evaluates, per design, a
noisy bit-serial crossbar GEMM: resolve the design's ``xbar_rows`` by
value-table gather, inject conductance variability into the
differential weight pairs, accumulate per-sub-tile bit-plane partial
sums and ADC-quantize each physical crossbar's column sums
(``kernels/adc.py`` conventions).

Two wrappers of the hand-written Hopper kernel ``csrc/imc_fused.cu``;
on CUDA tensors each launches it (or raises), on CPU tensors each runs
its plain PyTorch version, and each counts its launches in its
``launches`` attribute:

- ``imc_fused_gemm_keyed`` (the accuracy model's route) draws each
  design's noise inside the kernel from ``split(fold_in(k_noise,
  flat), 3)`` with the threefry of ``csrc/threefry.cuh``, bit for bit
  as ``repro_torch/random.py`` draws it, and returns the output-noise
  field too; plain version ``imc_fused_keyed_plain``;
- ``imc_fused_gemm`` takes the standard-normal fields
  ``eps_pos``/``eps_neg``, as the Pallas kernel does; plain version
  ``imc_fused_plain``.

Summation order. Every term of a bit-plane sum is 0 or ``w_eff``
exactly, so the only rounding is in the additions. The plain version
adds the ``k`` terms of a sub-tile in order, then the sub-tile sums of
a crossbar in order; the kernel adds only the set bits' terms, in the
same order, which gives the same bits (a skipped term is a zero added
to an accumulator that is never -0.0). So they agree bit for bit; an
ADC code that sits on a rounding boundary would otherwise flip with the
order. Against the JAX einsum order they agree to the
``tests/test_kernels.py`` tolerance.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import random as jr
from . import build
from .adc import WEIGHT_BITS, adc_full_scale, adc_quantize

# sigma(g~) / g_max polynomial coefficients (c0 + c1 g + ... + c4 g^4),
# fitted to the Wan et al. RRAM data; the CUDA kernel carries the same
# float32 values.
SIGMA_POLY = np.array([0.010, 0.150, -0.133, -0.0005, 0.0396], np.float32)
_C = tuple(float(c) for c in SIGMA_POLY)


def sigma_of_g(g_norm: torch.Tensor) -> torch.Tensor:
    """Conductance-dependent std (normalized to g_max)."""
    g2 = g_norm * g_norm
    s = (_C[0] + _C[1] * g_norm + _C[2] * g2 + _C[3] * (g_norm * g2)
         + _C[4] * (g2 * g2))
    return torch.clamp(s, 0.0, 0.5)


def ir_drop_factor(xbar_rows, activity: float = 0.5,
                   beta: float = 0.04):
    """Approximate IR-drop attenuation of the column current; ``beta *
    activity`` folds in Python double before the float32 multiply."""
    return 1.0 - beta * activity * (xbar_rows / 512.0)


def noisy_weights(w: torch.Tensor, eps_pos: torch.Tensor,
                  eps_neg: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Differential-pair conductance mapping + variability + IR drop:
    ``w`` (K, N), eps (P, K, N), rows (P,) -> w_eff (P, K, N)."""
    g_pos = torch.clamp(w, 0.0, 1.0)
    g_pos = torch.clamp(g_pos + sigma_of_g(g_pos) * eps_pos, 0.0, 1.0)
    g_neg = torch.clamp(-w, 0.0, 1.0)
    g_neg = torch.clamp(g_neg + sigma_of_g(g_neg) * eps_neg, 0.0, 1.0)
    return (g_pos - g_neg) * ir_drop_factor(rows)[:, None, None]


def imc_fused_plain(x_q: torch.Tensor, w: torch.Tensor,
                    eps_pos: torch.Tensor, eps_neg: torch.Tensor,
                    rows_idx: torch.Tensor, row_table: torch.Tensor, *,
                    sub: int, adc_bits: int = 8) -> torch.Tensor:
    """Plain PyTorch version of the kernel, batched over designs.

    x_q (B, K) int activation codes in [0, 255]; w (K, N) float32;
    eps_pos/eps_neg (P, K, N); rows_idx (P,) indices into row_table
    (V,) float32 row counts. Returns (P, B, N) float32 at the analog
    code scale. K is zero-padded to a multiple of ``sub``."""
    idx = rows_idx.long().clamp(0, row_table.shape[0] - 1)
    rows = row_table.float()[idx]                              # (P,)
    w_eff = noisy_weights(w.float(), eps_pos, eps_neg, rows)
    tiles = crossbar_sums(x_q, w_eff, rows, sub=sub)
    fs = adc_full_scale(rows)[:, None, None, None, None]
    q = adc_quantize(tiles, fs, adc_bits)
    pow2 = (1 << torch.arange(WEIGHT_BITS, device=q.device)).float()
    return torch.sum(q * pow2[None, :, None, None, None], dim=(1, 3))


def crossbar_sums(x_q: torch.Tensor, w_eff: torch.Tensor,
                  rows: torch.Tensor, *, sub: int) -> torch.Tensor:
    """The bit-plane crossbar column sums before the ADC: x_q (B, K),
    w_eff (P, K, N), rows (P,) -> (P, 8, B, G, N) with G = the sub-tile
    count; slot g of design p holds its crossbar g's sum (zero past its
    last crossbar). ``k`` terms added in order within a sub-tile, then
    the sub-tile sums of a crossbar in order."""
    P, K, N = w_eff.shape
    B = x_q.shape[0]
    pad = (-K) % sub
    n_sub = (K + pad) // sub
    xp = torch.nn.functional.pad(x_q.long(), (0, pad))
    wt = torch.nn.functional.pad(w_eff, (0, 0, 0, pad))
    wt = wt.reshape(P, n_sub, sub, N)
    planes = torch.stack([((xp >> b) & 1).float()
                          for b in range(WEIGHT_BITS)])
    planes = planes.reshape(WEIGHT_BITS, B, n_sub, sub)
    # (P, 8, B, n_sub, N) sub-tile sums, k added in order
    partial = torch.zeros((P, WEIGHT_BITS, B, n_sub, N),
                          dtype=torch.float32, device=w_eff.device)
    for k in range(sub):
        partial += planes[None, :, :, :, k, None] * wt[:, None, None, :, k, :]
    # crossbar groups of `rows` rows, sub-tiles added in order
    sub_idx = torch.arange(n_sub, dtype=torch.float32, device=rows.device)
    grp = torch.floor(sub_idx[None, :] * float(sub) / rows[:, None])
    tiles = torch.zeros_like(partial)                   # (P, 8, B, G, N)
    for s in range(n_sub):
        onehot = (grp[:, s, None] == sub_idx[None, :]).float()  # (P, G)
        tiles += partial[:, :, :, s, None, :] * onehot[:, None, None, :,
                                                         None]
    return tiles


def imc_fused_keyed_plain(x_q: torch.Tensor, w: torch.Tensor,
                          k_noise: torch.Tensor, flat: torch.Tensor,
                          rows_idx: torch.Tensor, row_table: torch.Tensor,
                          *, sub: int, adc_bits: int = 8
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the keyed kernel: each design's noise drawn by
    ``random.py`` from ``split(fold_in(k_noise, flat[p]), 3)`` (eps_pos
    and eps_neg on the untiled (K, N) weight shape, the output noise on
    (B, N)), then ``imc_fused_plain``. k_noise (2,) and flat (P,) int64.
    Returns (raw (P, B, N), z_out (P, B, N))."""
    k = jr.split(jr.fold_in(k_noise, flat), 3)
    eps_pos = jr.normal(k[:, 0], w.shape)
    eps_neg = jr.normal(k[:, 1], w.shape)
    z_out = jr.normal(k[:, 2], (x_q.shape[0], w.shape[1]))
    raw = imc_fused_plain(x_q, w, eps_pos, eps_neg, rows_idx, row_table,
                          sub=sub, adc_bits=adc_bits)
    return raw, z_out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has {t.dim()} dims, expected {ndim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_params(fn: str, sub: int, adc_bits: int,
                  row_table: torch.Tensor) -> None:
    if not (1 <= adc_bits <= 16 and sub >= 1 and row_table.shape[0] >= 1):
        raise ValueError(f"{fn}: bad sub={sub}, adc_bits={adc_bits} or "
                         "empty row_table")


def imc_fused_gemm(x_q: torch.Tensor, w: torch.Tensor,
                   eps_pos: torch.Tensor, eps_neg: torch.Tensor,
                   rows_idx: torch.Tensor, row_table: torch.Tensor, *,
                   sub: int, adc_bits: int = 8) -> torch.Tensor:
    """Fused population crossbar evaluation (shapes as in
    ``imc_fused_plain``). CUDA tensors launch ``csrc/imc_fused.cu``;
    CPU tensors take the plain version."""
    if x_q.device.type == "cpu":
        return imc_fused_plain(x_q, w, eps_pos, eps_neg, rows_idx,
                               row_table, sub=sub, adc_bits=adc_bits)
    if x_q.device.type != "cuda":
        raise ValueError(f"imc_fused_gemm: unsupported device {x_q.device}")
    dev = x_q.device
    _check("x_q", x_q, torch.int32, 2, dev)
    _check("w", w, torch.float32, 2, dev)
    _check("eps_pos", eps_pos, torch.float32, 3, dev)
    _check("eps_neg", eps_neg, torch.float32, 3, dev)
    _check("rows_idx", rows_idx, torch.int32, 1, dev)
    _check("row_table", row_table, torch.float32, 1, dev)
    P, K, N = eps_pos.shape
    B = x_q.shape[0]
    if (x_q.shape[1] != K or tuple(w.shape) != (K, N)
            or eps_neg.shape != eps_pos.shape or rows_idx.shape[0] != P):
        raise ValueError("imc_fused_gemm: inconsistent shapes x_q "
                         f"{tuple(x_q.shape)}, w {tuple(w.shape)}, eps "
                         f"{tuple(eps_pos.shape)}/{tuple(eps_neg.shape)}, "
                         f"rows_idx {tuple(rows_idx.shape)}")
    _check_params("imc_fused_gemm", sub, adc_bits, row_table)
    out = torch.empty((P, B, N), dtype=torch.float32, device=dev)
    lib = build.load("imc_fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_fused_launch(
        x_q.data_ptr(), w.data_ptr(), eps_pos.data_ptr(),
        eps_neg.data_ptr(), rows_idx.data_ptr(), row_table.data_ptr(),
        out.data_ptr(), P, B, K, N, sub, adc_bits, row_table.shape[0],
        stream)
    if err != 0:
        raise RuntimeError(f"imc_fused kernel launch failed: CUDA error "
                           f"{err}")
    imc_fused_gemm.launches += 1
    return out


imc_fused_gemm.launches = 0


def imc_fused_gemm_keyed(x_q: torch.Tensor, w: torch.Tensor,
                         k_noise: torch.Tensor, flat: torch.Tensor,
                         rows_idx: torch.Tensor, row_table: torch.Tensor, *,
                         sub: int, adc_bits: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused population crossbar evaluation with the noise drawn in the
    kernel (shapes as in ``imc_fused_keyed_plain``): k_noise (2,) int64
    key, flat (P,) int64 design indices (their low 32 bits are folded
    in, as ``random.fold_in`` does). Returns (raw, z_out), both
    (P, B, N). CUDA tensors launch ``csrc/imc_fused.cu``; CPU tensors
    take the plain version."""
    if x_q.device.type == "cpu":
        return imc_fused_keyed_plain(x_q, w, k_noise, flat, rows_idx,
                                     row_table, sub=sub, adc_bits=adc_bits)
    if x_q.device.type != "cuda":
        raise ValueError(f"imc_fused_gemm_keyed: unsupported device "
                         f"{x_q.device}")
    dev = x_q.device
    _check("x_q", x_q, torch.int32, 2, dev)
    _check("w", w, torch.float32, 2, dev)
    _check("k_noise", k_noise, torch.int64, 1, dev)
    _check("flat", flat, torch.int64, 1, dev)
    _check("rows_idx", rows_idx, torch.int32, 1, dev)
    _check("row_table", row_table, torch.float32, 1, dev)
    B, K = x_q.shape
    N, P = w.shape[1], flat.shape[0]
    if (k_noise.shape[0] != 2 or w.shape[0] != K
            or rows_idx.shape[0] != P):
        raise ValueError("imc_fused_gemm_keyed: inconsistent shapes x_q "
                         f"{tuple(x_q.shape)}, w {tuple(w.shape)}, k_noise "
                         f"{tuple(k_noise.shape)}, flat {tuple(flat.shape)}, "
                         f"rows_idx {tuple(rows_idx.shape)}")
    if K * N >= 2 ** 32 or B * N >= 2 ** 31:
        raise ValueError("imc_fused_gemm_keyed: the draw's counters index "
                         "(K, N) and (B, N) in 32 bits")
    _check_params("imc_fused_gemm_keyed", sub, adc_bits, row_table)
    out = torch.empty((P, B, N), dtype=torch.float32, device=dev)
    z_out = torch.empty((P, B, N), dtype=torch.float32, device=dev)
    lib = build.load("imc_fused")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_fused_keyed_launch(
        x_q.data_ptr(), w.data_ptr(), k_noise.data_ptr(), flat.data_ptr(),
        rows_idx.data_ptr(), row_table.data_ptr(), out.data_ptr(),
        z_out.data_ptr(), P, B, K, N, sub, adc_bits, row_table.shape[0],
        stream)
    if err != 0:
        raise RuntimeError(f"imc_fused keyed kernel launch failed: CUDA "
                           f"error {err}")
    imc_fused_gemm_keyed.launches += 1
    return out, z_out


imc_fused_gemm_keyed.launches = 0


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """``random.normal``'s transform of 32-bit words (int64 tensor of
    values in ``[0, 2^32)``): on CUDA tensors through the device code of
    ``csrc/threefry.cuh`` that the keyed kernel draws with, on CPU
    tensors through ``random.normal_of_bits``. A check of the kernel's
    draw on any set of words (every uniform the draw can make is 2^23
    words), not a step of the accuracy model."""
    if bits.device.type == "cpu":
        return jr.normal_of_bits(bits)
    _check("bits", bits, torch.int64, bits.dim(), bits.device)
    if bits.numel() >= 2 ** 31:
        raise ValueError("normal_of_bits: more than 2^31 words")
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    lib = build.load("imc_fused")
    err = lib.normal_of_bits_launch(
        bits.data_ptr(), out.data_ptr(), bits.numel(),
        torch.cuda.current_stream(bits.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"normal_of_bits kernel launch failed: CUDA "
                           f"error {err}")
    normal_of_bits.launches += 1
    return out


normal_of_bits.launches = 0
