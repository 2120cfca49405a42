"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function (no PyTorch
headers, so ``nvcc`` takes seconds, not minutes). It is compiled at
first use for ``sm_90a`` into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), under a file name that carries a
hash of the source, of the ``csrc/*.cuh`` headers it includes, directly
or through another header (the shared ADC, ``adc.cuh``; the predicated
bit-plane adds, ``predicated_add.cuh``; the threefry draw,
``threefry.cuh``; the flash kernels' tensor-core routes, the gradient's
header including the forward's, and their float32 routes' split-TF32
helpers, ``tf32x3.cuh``; the RG-LRU scans' coefficients,
``rglru_coeffs.cuh``) and of the flags, so an edited source or header
rebuilds. The library is written to a temporary name and renamed into place, so
concurrent processes never load a half-written file. ``set_build_dir``
points the builds elsewhere (the campaign's ``--compile-cache``): a
second process given the same directory finds every library built and
runs no ``nvcc``.

Nothing here runs at import time: the CPU tests import every module,
and this machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# the C signature of every kernel's launch function; a pointer or the
# stream is c_void_p, an int c_int, a stride c_longlong (ctypes would cut a
# pointer or a 64-bit stride otherwise)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "imc_fused": {
        # x_q, w, eps_pos, eps_neg, rows_idx, row_table, out,
        # P, B, K, N, sub, adc_bits, n_table, stream
        "imc_fused_launch": (_P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _P),
        # x_q, w, key, flat, rows_idx, row_table, out, z_out,
        # P, B, K, N, sub, adc_bits, n_table, stream
        "imc_fused_keyed_launch": (_P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _P),
        # bits, out, n, stream
        "normal_of_bits_launch": (_P, _P, _I, _P),
    },
    "imc_matmul": {
        # x_q, w, out, M, K, N, R, adc_bits, full_scale, stream
        "imc_matmul_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
        # M, K, N, R, &cluster, &columns: what the launch picks (a report)
        "imc_matmul_plan": (_I, _I, _I, _I, _P, _P),
    },
    "flash_attention": {
        # q, k, v, o, B, H, S, T, hd, (batch, head, seq) strides of q, k,
        # v and o, causal, window, q_offset, scale, is_bf16, lse (null or
        # the log-sum-exp rows), stream
        "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   *(_L,) * 12, _I, _I, _I, _F, _I, _P, _P),
    },
    "flash_attention_bwd": {
        # q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, T, hd, the
        # (batch, head, seq) strides of the eight views (24 long longs),
        # causal, window, q_offset, scale, stream: the split-TF32 entry
        # (float32) and the bf16 tensor cores' (bfloat16)
        "flash_attention_bwd_launch": (*(_P,) * 10, _I, _I, _I, _I, _I, _P,
                                       _I, _I, _I, _F, _P),
        "flash_attention_bwd_wgmma_launch": (*(_P,) * 10, _I, _I, _I, _I, _I,
                                             _P, _I, _I, _I, _F, _P),
    },
    "decode_attention": {
        # q, k, v, k_scale, v_scale, pos, qpos, out, scores, stats, part,
        # vidx, arrivals, B, T, KV, G, hd, window, splits, L, scale,
        # is_bf16, cache_type, route (0 split, 1 grouped, 2 cross), stream
        "decode_attention_launch": (*(_P,) * 13, *(_I,) * 8, _F, _I, _I,
                                    _I, _P),
    },
    "rglru_scan": {
        # x, a_param, alpha_i, beta_i, alpha_r, beta_r, h, work, carry, B,
        # S, W, is_bf16, stream
        "rglru_scan_launch": (*(_P,) * 9, _I, _I, _I, _I, _P),
    },
    "rglru_scan_bwd": {
        # x, a_param, alpha_i, beta_i, alpha_r, beta_r, dh, hcarry, dx,
        # grads, work, B, S, W, is_bf16, stream
        "rglru_scan_bwd_launch": (*(_P,) * 11, _I, _I, _I, _I, _P),
    },
    "mlstm_scan": {
        # q, k, v, i_pre, f_pre, C, n, m, h, arrivals, B, S, H, hd, stream
        "mlstm_scan_launch": (*(_P,) * 10, _I, _I, _I, _I, _P),
    },
    "slstm_scan": {
        # gates, r, c, n, m, h, hs, cs, ns, ms (null unless saving), B, S,
        # w, is_bf16, stream
        "slstm_scan_launch": (*(_P,) * 10, _I, _I, _I, _I, _P),
    },
    "mlstm_scan_bwd": {
        # q, k, v, i_pre, f_pre, C0, n0, m0, dh, dq, dk, dv, di, df, gate,
        # sc, ch, nall, p0, p1, p2, B, S, H, hd, stream
        "mlstm_scan_bwd_launch": (*(_P,) * 21, _I, _I, _I, _I, _P),
    },
    "slstm_scan_bwd": {
        # gates, r, h0, hs, cs, ns, ms, dhs, dgates, part, dr, arrivals, B,
        # S, w, is_bf16, stream
        "slstm_scan_bwd_launch": (*(_P,) * 12, _I, _I, _I, _I, _P),
    },
}

# a source's own headers: `#include "<name>.cuh"` lines, resolved in csrc/
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+\.cuh)"', re.MULTILINE)

_LOADED: Dict[str, ctypes.CDLL] = {}
# zeroed int32 scratch a kernel leaves zero after every launch (counters,
# flags), kept by (kernel, device)
_WORKSPACES: Dict[tuple, "torch.Tensor"] = {}


def set_build_dir(path) -> Path:
    """Build (and load) the libraries under ``path`` from now on; a
    library loaded from another directory is loaded again from there,
    built first if it is not there yet."""
    global BUILD_DIR
    path = Path(path).resolve()
    if path != BUILD_DIR:
        BUILD_DIR = path
        _LOADED.clear()
    return BUILD_DIR


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return nvcc


def _headers(src: str) -> List[str]:
    """Every ``csrc/*.cuh`` that ``src`` includes, directly or through
    another such header, sorted."""
    found, todo = set(), list(_INCLUDE.findall(src))
    while todo:
        header = todo.pop()
        if header not in found:
            found.add(header)
            todo += _INCLUDE.findall((CSRC / header).read_text())
    return sorted(found)


def _library_path(name: str) -> Path:
    """``build/kernels/lib<name>_<hash>.so``, the hash taken over the
    source, every ``csrc/*.cuh`` it includes (directly or not) and the
    flags, so an edit to any of them rebuilds."""
    src = (CSRC / f"{name}.cu").read_text()
    digest = hashlib.sha256(src.encode())
    for header in _headers(src):
        digest.update(header.encode() + (CSRC / header).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = _library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc``
    per source, all started together. Returns each build's compiler
    log (``-Xptxas -v`` register and shared-memory report); raises
    ``RuntimeError`` with the log when a build fails."""
    started = [(n, *_start(n)) for n in names]
    logs: Dict[str, str] = {}
    for name, out, tmp, proc in started:
        if proc is None:
            logs[name] = "(cached)"
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it if needed, with
    ``argtypes``/``restype`` declared for its launch functions."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def workspace(name: str, device, n: int):
    """At least ``n`` zeroed int32 entries on ``device`` for kernel
    ``name``, kept for its later launches there (a larger set replaces a
    smaller one). The kernel returns every entry it used to zero before
    it ends, so launches reuse the buffer, and a CUDA graph that
    captured one replays it; launches that share it run in stream order
    (PyTorch's current stream)."""
    import torch
    key = (name, torch.device(device))
    have = _WORKSPACES.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros((max(n, 4096),), dtype=torch.int32,
                           device=device)
        _WORKSPACES[key] = have
    return have


def build_timed(names: Optional[List[str]] = None) -> Dict[str, object]:
    """``build`` with its wall time, for the chip smoke report."""
    t0 = time.perf_counter()
    logs = build(tuple(SIGNATURES) if names is None else names)
    return {"seconds": time.perf_counter() - t0, "logs": logs}
