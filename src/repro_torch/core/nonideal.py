"""RRAM non-idealities and the batched accuracy model (paper §IV-H,
Eq. 4); counterpart of ``repro/core/nonideal.py``.

Conductance variability g = g_t + sigma(g_t) * eps, eps ~ N(0, 1), with
sigma the ``SIGMA_POLY`` quartic; IR drop as a row-depth-dependent
attenuation; bit-serial 8-bit activations with per-crossbar ADC
quantization (``kernels/adc.py``); 1% additive output noise. Accuracy
is a logistic map of the output SNR of calibration GEMMs pushed through
the noisy crossbar, calibrated so the clean 8-bit baselines of §IV-H
degrade by a few percent.

``make_accuracy_model`` returns a function ``(P, n) genomes -> (P, W)``
accuracies. Every design draws its noise from ``fold_in(k_noise,
flat_index(design))`` under ``CALIB_SEED`` with the bit-exact threefry
port (``repro_torch/random.py``), so a design's score is a pure function
of the design, on every backend and device, as in the reference.

Backends (the crossbar-GEMM route):
  'jnp'  — the reference's einsum path, in ``torch.einsum``, noise
           drawn on the host;
  'ref'  — the fused dataflow through ``imc_fused_keyed_plain`` (the
           host draws, then ``imc_fused_plain``): the plain route the
           kernel is held to;
  'cuda' — the fused Hopper kernel (``imc_fused_gemm_keyed`` on CUDA
           tensors), which draws the noise itself: no host draw;
  'auto' — 'cuda' on a CUDA device, 'jnp' on the CPU.

``accuracy_proxy_host`` keeps the reference's host-side oracle: one
Python iteration per genome, static crossbar tiling through
``noisy_crossbar_gemm``, whose bit-serial GEMM is the ``imc_matmul``
Hopper kernel (``use_kernel=True``, via ``kernels/ops.imc_gemm``) or its
plain version. It draws the same per-design noise as the batched model,
so the two agree to float tolerance.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import random as jr
from ..device import resolve_device
from ..kernels.adc import adc_full_scale, adc_quantize
from ..kernels.imc_fused import (imc_fused_gemm_keyed,
                                 imc_fused_keyed_plain, noisy_weights,
                                 sigma_of_g)
from ..kernels.imc_matmul import imc_matmul_plain
from ..kernels.ops import imc_gemm
from .cost_model import pointwise
from .search_space import SearchSpace
from .workloads import Workload, WorkloadArrays, WorkloadBuilder
from .tracing import traced_closure

OUTPUT_NOISE_FRAC = 0.01  # 1% output-referred noise [58]

BACKENDS = ("auto", "cuda", "ref", "jnp")

# Calibration data / noise base seed: part of the *model*, not of the
# search — every search path scores a given design identically.
CALIB_SEED = 20260415

# Clean 8-bit baseline accuracies (paper §IV-H).
BASELINE_ACC = {
    "resnet18": 0.9488, "vgg16": 0.9789, "alexnet": 0.9350,
    "mobilenetv3": 0.7003,
}
_DEFAULT_BASE_ACC = 0.90

# Logistic SNR(dB) -> retained-accuracy map (full retention above
# ~35 dB, collapse below ~10 dB).
_SNR_MID_DB = 18.0
_SNR_SCALE_DB = 4.0
_ACC_FLOOR = 0.35


def resolve_backend(backend: str, device: torch.device) -> str:
    """'auto' -> 'cuda' on a CUDA device, 'jnp' on the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "jnp"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError("backend 'cuda' runs the Hopper kernel and needs "
                         "device='cuda'")
    return backend


@traced_closure
def quantize_activations(x: torch.Tensor) -> torch.Tensor:
    """8-bit DAC: [0, 1] activations -> int32 codes in [0, 255]."""
    return torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.int32)


def apply_conductance_noise(key: torch.Tensor,
                            g_norm: torch.Tensor) -> torch.Tensor:
    """Conductance variability: ``g_norm`` plus ``sigma_of_g(g_norm)``
    times standard normals drawn from ``key`` on its shape, clipped to
    [0, 1]."""
    eps = jr.normal(key, g_norm.shape)
    return torch.clamp(g_norm + sigma_of_g(g_norm) * eps, 0.0, 1.0)


@traced_closure
def _noised_weights(k_pos: torch.Tensor, k_neg: torch.Tensor,
                    w: torch.Tensor, xbar_rows: int) -> torch.Tensor:
    """Differential-pair conductance mapping + variability + IR drop at
    a static row count: w (K, N) -> w_eff (K, N). The eps fields are
    drawn on the untiled (K, N) weight shape, as the batched model
    draws them, so both paths see the same noise from the same key."""
    rows = torch.tensor([float(xbar_rows)], device=w.device)
    eps_pos = jr.normal(k_pos, w.shape)[None]
    eps_neg = jr.normal(k_neg, w.shape)[None]
    return noisy_weights(w, eps_pos, eps_neg, rows)[0]


def noisy_crossbar_gemm(key: torch.Tensor, x: torch.Tensor,
                        w: torch.Tensor, xbar_rows: int, adc_bits: int = 8,
                        use_kernel: bool = False) -> torch.Tensor:
    """Reference noisy IMC GEMM at a static ``xbar_rows``: weights in
    [-1, 1] mapped to differential conductance pairs with variability
    and IR drop, 8-bit bit-serial activations, per-crossbar ADC
    (``kernels/adc.py``), 1% output noise. x (B, K) float in [0, 1] and
    w (K, N) on the key's device -> (B, N) at the analog activation
    scale.

    ``use_kernel=True`` runs the bit-serial GEMM through
    ``kernels/ops.imc_gemm`` (the Hopper kernel on CUDA tensors);
    otherwise through ``imc_matmul_plain`` on the padded operands."""
    x_q = quantize_activations(x)
    ks = jr.split(key, 3)
    w_eff = _noised_weights(ks[0], ks[1], w, xbar_rows)
    if use_kernel:
        y_q = imc_gemm(x_q, w_eff, xbar_rows=xbar_rows, adc_bits=adc_bits)
    else:
        pad = (-x_q.shape[1]) % xbar_rows
        y_q = imc_matmul_plain(
            torch.nn.functional.pad(x_q, (0, pad)),
            torch.nn.functional.pad(w_eff, (0, 0, 0, pad)),
            xbar_rows=xbar_rows, adc_bits=adc_bits)
    # a true division, as the reference's eager ``y_q / 255.0`` is
    y = y_q / torch.tensor(255.0, device=y_q.device)
    std = torch.std(y, correction=0)  # jnp.std: the population std
    return y + OUTPUT_NOISE_FRAC * std * jr.normal(ks[2], y.shape)


def calibration_data(key: torch.Tensor, n_calib: int, calib_k: int,
                     calib_n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared calibration GEMM operands: activations in [0, 1] and
    weights ~ 0.3 * N(0, 1) (clipped by the conductance mapping)."""
    ks = jr.split(key)
    x = jr.uniform(ks[0], (n_calib, calib_k))
    w = jr.normal(ks[1], (calib_k, calib_n)) * 0.3
    return x, w


def flat_index_strides(space: SearchSpace) -> np.ndarray:
    """(n,) mixed-radix strides of the space: a genome's flat index is
    ``genome @ strides`` (space sizes stay below 2^31)."""
    cards = space.cardinalities.astype(np.int64)
    return np.concatenate(
        [np.cumprod(cards[::-1])[::-1][1:], [1]]).astype(np.int64)


def genome_flat_index(space: SearchSpace,
                      genomes: torch.Tensor) -> torch.Tensor:
    """(P, n) index genomes -> (P,) int64 flat (mixed-radix) index, the
    per-design noise key's ``fold_in`` data (the reference's int32
    values: space sizes stay below 2^31)."""
    strides = torch.as_tensor(flat_index_strides(space),
                              device=genomes.device)
    return (genomes.long() * strides).sum(-1)


def _workload_accuracy_params(
        workloads: Union[WorkloadArrays, Sequence[Workload]],
) -> Tuple[np.ndarray, np.ndarray]:
    """(base_acc (W,), depth_penalty (W,)) of a packed workload set or
    a plain Workload sequence."""
    if isinstance(workloads, WorkloadArrays):
        names = workloads.names
        n_layers = np.bincount(workloads.seg_ids,
                               minlength=len(names)).astype(np.float32)
    else:
        names = [w.name for w in workloads]
        n_layers = np.asarray([w.n_layers for w in workloads], np.float32)
    base = np.asarray([BASELINE_ACC.get(n, _DEFAULT_BASE_ACC)
                       for n in names], np.float32)
    # deeper models accumulate more noise
    pen = np.clip(1.0 - 0.002 * n_layers, 0.8, 1.0).astype(np.float32)
    return base, pen


@traced_closure
def _snr_to_accuracy(snr_db: torch.Tensor, base: torch.Tensor,
                     depth_pen: torch.Tensor) -> torch.Tensor:
    keep = pointwise(torch.sigmoid, (snr_db - _SNR_MID_DB) / _SNR_SCALE_DB)
    return base * (_ACC_FLOOR + (1.0 - _ACC_FLOOR) * keep) * depth_pen


def make_accuracy_model(space: SearchSpace,
                        workloads: Optional[WorkloadArrays] = None, *,
                        key: Optional[torch.Tensor] = None,
                        n_calib: int = 32, calib_k: int = 256,
                        calib_n: int = 32, adc_bits: int = 8,
                        builder: Optional[WorkloadBuilder] = None,
                        backend: str = "auto", device="cuda"
                        ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Batched accuracy model on ``device``: (P, n) genomes -> (P, W).

    Genome-dependent parameters (xbar_rows, bits_cell) resolve by
    value-table gather; the reduction axis is split into static
    sub-tiles of ``gcd(rows values)`` rows and each design groups them
    into crossbars of its own row count before the ADC.

    Joint co-search: pass a ``WorkloadBuilder`` as ``builder`` instead
    of fixed ``workloads`` (exactly one of the two). Each genome's clean
    base accuracy and depth penalty then come from its own arch slice;
    the noise key folds in the flat index of the whole joint genome
    (int64 end to end: it passes 2^24 in the joint spaces)."""
    if (workloads is None) == (builder is None):
        raise ValueError("pass exactly one of workloads / builder")
    dev = resolve_device(device)
    backend = resolve_backend(backend, dev)
    key = jr.PRNGKey(CALIB_SEED, dev) if key is None else key.to(dev)
    ks = jr.split(key)
    k_calib, k_noise = ks[0], ks[1]
    x, w = calibration_data(k_calib, n_calib, calib_k, calib_n)
    x_q = quantize_activations(x)
    # a true division by 255 on every device: CUDA PyTorch would turn a
    # division by the Python scalar into a reciprocal multiply
    c255 = torch.tensor(255.0, device=dev)
    y_ref = x_q.float() @ w / c255  # clean quantized GEMM

    table = torch.as_tensor(space.value_table(), device=dev)
    rows_i = space.index("xbar_rows")
    bits_i = (space.index("bits_cell")
              if "bits_cell" in space.names else None)
    row_values = space.values[rows_i].astype(np.int64)
    sub = int(np.gcd.reduce(row_values))  # static sub-tile row count
    pad = (-calib_k) % sub
    n_sub = (calib_k + pad) // sub
    # static bit-plane decomposition of the shared activations (jnp path)
    xp = torch.nn.functional.pad(x_q, (0, pad))
    planes = torch.stack([((xp >> b) & 1).float() for b in range(8)])
    planes = planes.reshape(8, n_calib, n_sub, sub)
    sub_rows = torch.arange(n_sub, dtype=torch.float32, device=dev) * sub
    group_idx = torch.arange(n_sub, dtype=torch.float32, device=dev)
    pow2 = (1 << torch.arange(8, device=dev)).float()  # exact 2^b
    if builder is None:
        base_np, pen_np = _workload_accuracy_params(workloads)
        base_acc = torch.as_tensor(base_np, device=dev)[None, :]
        depth_pen = torch.as_tensor(pen_np, device=dev)[None, :]
    strides = torch.as_tensor(flat_index_strides(space), device=dev)
    row_table_f = torch.as_tensor(row_values.astype(np.float32), device=dev)
    x_q_c = x_q.contiguous()
    w_c = w.contiguous()
    k_noise = k_noise.contiguous()

    @traced_closure
    def einsum_path(genomes, flat):
        # the design's fold_in key -> eps fields on the untiled (K, N)
        # weight shape and the output noise
        k = jr.split(jr.fold_in(k_noise, flat), 3)
        eps_pos = jr.normal(k[:, 0], w.shape)
        eps_neg = jr.normal(k[:, 1], w.shape)
        rows = table[rows_i, genomes[:, rows_i]]                 # (P,)
        w_eff = noisy_weights(w, eps_pos, eps_neg, rows)
        wt = torch.nn.functional.pad(w_eff, (0, 0, 0, pad))
        wt = wt.reshape(w_eff.shape[0], n_sub, sub, -1)
        partial = torch.einsum("qbsk,pskn->pqbsn", planes, wt)
        grp = torch.floor(sub_rows[None, :] / rows[:, None])   # (P, n_sub)
        onehot = (grp[:, :, None] == group_idx[None, None, :]).float()
        tiles = torch.einsum("pqbsn,psg->pqbgn", partial, onehot)
        fs = adc_full_scale(rows)[:, None, None, None, None]
        q = adc_quantize(tiles, fs, adc_bits)
        raw = torch.sum(q * pow2[None, :, None, None, None], dim=(1, 3))
        return raw, jr.normal(k[:, 2], raw.shape[1:])

    @traced_closure
    def accuracy(genomes: torch.Tensor) -> torch.Tensor:
        genomes = genomes.to(dev).long()
        flat = (genomes * strides).sum(dim=1)
        if backend == "jnp":
            raw, z_out = einsum_path(genomes, flat)
        else:
            rows_idx = genomes[:, rows_i].to(torch.int32).contiguous()
            fused = (imc_fused_gemm_keyed if backend == "cuda"
                     else imc_fused_keyed_plain)
            raw, z_out = fused(x_q_c, w_c, k_noise, flat, rows_idx,
                               row_table_f, sub=sub, adc_bits=adc_bits)
        y = raw / c255                                         # (P, B, N)
        std = torch.std(y, dim=(1, 2), correction=0, keepdim=True)
        y = y + OUTPUT_NOISE_FRAC * std * z_out
        err = torch.mean((y - y_ref[None]) ** 2, dim=(1, 2))
        sig = torch.mean(y_ref ** 2)
        snr_db = 10.0 * pointwise(torch.log10,
                                  sig / torch.clamp(err, min=1e-12))
        if bits_i is not None:
            bits = table[bits_i, genomes[:, bits_i]]
            cpw = torch.clamp(torch.floor(
                torch.full_like(bits, 8.0) / bits), min=1.0)
            # multi-cell averaging
            snr_db = snr_db + 10.0 * pointwise(torch.log10, cpw)
        if builder is None:
            return _snr_to_accuracy(snr_db[:, None], base_acc, depth_pen)
        wt = builder(genomes)
        # 1 - 0.002 * n_layers as XLA compiles it: one fused multiply-add
        pen = torch.clamp(jr._fma(torch.full_like(wt.n_layers, -0.002),
                                  wt.n_layers, torch.ones_like(wt.n_layers)),
                          0.8, 1.0)                                # (P, W)
        return _snr_to_accuracy(snr_db[:, None], wt.base_acc, pen)

    accuracy.backend = backend
    return accuracy


def accuracy_proxy_host(space: SearchSpace, genomes: np.ndarray,
                        workloads: Union[WorkloadArrays,
                                         Sequence[Workload]],
                        *, key: Optional[torch.Tensor] = None,
                        n_calib: int = 32, calib_k: int = 256,
                        calib_n: int = 32, adc_bits: int = 8,
                        use_kernel: bool = False, device="cuda"
                        ) -> np.ndarray:
    """Host-side per-genome oracle of ``make_accuracy_model``: (P, n)
    genomes -> (P, W) float32 accuracies.

    One Python iteration per genome, static crossbar tiling through
    ``noisy_crossbar_gemm`` on ``device`` (the ``imc_matmul`` kernel
    with ``use_kernel=True``). Same calibration data, per-design noise
    keys and ADC as the batched model. The SNR is host float64
    arithmetic, cast to float32 before the accuracy map, as in the
    reference."""
    dev = resolve_device(device)
    key = jr.PRNGKey(CALIB_SEED, dev) if key is None else key.to(dev)
    ks = jr.split(key)
    x, w = calibration_data(ks[0], n_calib, calib_k, calib_n)
    x_q = quantize_activations(x)
    y_ref = x_q.float() @ w / torch.tensor(255.0, device=dev)

    genomes = np.asarray(genomes)
    table = space.value_table()
    rows_i = space.index("xbar_rows")
    bits_i = (space.index("bits_cell")
              if "bits_cell" in space.names else None)
    base, pen = map(torch.as_tensor, _workload_accuracy_params(workloads))
    flat = genomes.astype(np.int64) @ flat_index_strides(space)

    accs = np.zeros((genomes.shape[0], base.shape[0]), np.float32)
    for pi in range(genomes.shape[0]):
        rows = int(table[rows_i, genomes[pi, rows_i]])
        bits = (float(table[bits_i, genomes[pi, bits_i]])
                if bits_i is not None else 1.0)
        cpw = max(1.0, float(np.floor(8.0 / bits)))
        k = jr.fold_in(ks[1], int(flat[pi]))
        y = noisy_crossbar_gemm(k, x, w, xbar_rows=rows,
                                adc_bits=adc_bits, use_kernel=use_kernel)
        err = float(torch.mean((y - y_ref) ** 2))
        sig = float(torch.mean(y_ref ** 2))
        snr_db = 10.0 * np.log10(sig / max(err, 1e-12))
        snr_db += 10.0 * np.log10(cpw)
        accs[pi] = _snr_to_accuracy(torch.tensor(np.float32(snr_db)), base,
                                    pen).numpy()
    return accs
