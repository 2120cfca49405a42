"""Blockwise (flash) attention; counterpart of
``repro/kernels/flash_attention.py`` (the Pallas TPU kernel
``_flash_kernel``) and of its oracle ``repro/kernels/ref.py::
attention_ref``.

q (B, H, S, hd), k and v (B, H, T, hd): views that may be transposes
of (B, S, H, hd) tensors (``ops.flash_mha`` passes them, so nothing is
copied; the reference's (BH, S, hd) fold is ``x.unsqueeze(1)``). For
each query row i the softmax runs over the keys j with
``j < T`` (the true length: nothing here is padded), ``i + q_offset >=
j`` when causal and ``(i + q_offset) - j < window`` when ``window > 0``.
Accumulation is float32 with a running max, denominator and accumulator;
the output has the input's type. A query row that sees no key at all is
undefined (no caller makes one).

``flash_attention`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/flash_attention.cu`` (or raises), on
CPU tensors it runs the plain PyTorch version ``flash_attention_plain``.
Its ``launches`` attribute counts kernel launches, and ``routes`` which
route each took (``route`` names it). The kernel has two routes, by
type: bfloat16 runs on the tensor cores (``csrc/flash_attention_wgmma.
cuh``: TMA loads, wgmma, P split into two bf16 terms for P.V,
``"wgmma"``), float32 on the tensor cores too, each product split into
three TF32 products (``csrc/tf32x3.cuh``: mma.sync, ``"tf32x3"``). TMA
needs 16-byte aligned bases and strides, so a bfloat16 view without
them raises.

``flash_attention_bwd`` is the gradient: on CUDA tensors the
hand-written ``csrc/flash_attention_bwd.cu`` (the JAX package has no
Pallas backward; it differentiates the jnp attention), on CPU tensors
``flash_attention_bwd_plain``. It counts its launches the same way, and
in ``routes`` which route each launch took (``route`` picks it, and
the wrapper calls that route's own C entry): bfloat16, every head dim
up to 256, on the tensor cores (``csrc/flash_attention_bwd_wgmma.cuh``,
``"wgmma"``), float32 as split TF32 (``"tf32x3"``). Both read the
log-sum-exp that the forward stores when asked (``return_lse``).
``ops.FlashAttention`` ties the two together for autograd.

The plain version and the float32 kernels scale q by ``1/sqrt(hd)``
before the dot product, as the Pallas kernel does. The bfloat16 kernel
scales the float32 score after the product instead (q * scale rounded
to bf16 would lose bits), as ``models/attention.py:blockwise_attention``
and ``attention_ref`` do; the differences are a few float32 ULP. All
use the Pallas kernel's finite ``NEG_INF``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1.0e30
MAX_HEAD_DIM = 256
LOG2E = 1.4426950408889634
# the bfloat16 kernels' log-sum-exp rows of one (batch, head) are S rounded
# up to this (csrc/flash_attention_wgmma.cuh's lse_rows, its block's rows)
LSE_BLOCK = 128
# csrc/flash_attention_wgmma.cuh's ENCODE_ERROR: the launch returns it plus
# the CUresult when a TMA tensor map is refused, minus 1 when libcuda's
# cuTensorMapEncodeTiled entry point is missing
_ENCODE_ERROR = 20000
# the plain version's query and key chunks, as blockwise_attention's
_CHUNK = 512


def _visible(q_pos: torch.Tensor, k_pos: torch.Tensor, T: int, causal: bool,
             window: int) -> torch.Tensor:
    """(n_q, n_k) mask of the keys each query position sees."""
    mask = (k_pos < T)[None, :]
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window > 0:
        mask = mask & ((q_pos[:, None] - k_pos[None, :]) < window)
    return mask


def lse_rows(S: int) -> int:
    """The rows of one (batch, head) in the bfloat16 kernels' log-sum-
    exp buffer: S rounded up to ``LSE_BLOCK``."""
    return -(-S // LSE_BLOCK) * LSE_BLOCK


def route(dtype: torch.dtype) -> str:
    """The route of ``flash_attention`` and ``flash_attention_bwd`` on
    CUDA tensors, by type: ``"wgmma"`` (bfloat16, bf16 tensor-core
    products) or ``"tf32x3"`` (float32, each product as three TF32
    tensor-core products)."""
    return "wgmma" if dtype == torch.bfloat16 else "tf32x3"


def bwd_route(dtype: torch.dtype, hd: int) -> str:
    """The route of ``flash_attention_bwd`` on CUDA tensors at a head dim
    ``hd``: ``route(dtype)``, since both routes take every head dim up
    to ``MAX_HEAD_DIM``."""
    del hd
    return route(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          q_offset: int = 0, return_lse: bool = False):
    """Plain PyTorch version: a chunked online softmax, as
    ``models/attention.py:blockwise_attention`` computes it, so memory
    stays O(S x chunk). Key chunks that no query of a chunk sees (wholly
    above its causal diagonal or below its window) are skipped, as the
    kernel skips them. With ``return_lse`` it also returns each row's
    log-sum-exp of the scaled scores in base 2, ``(m + log l) * log2 e``
    (float32, q's leading dims and S), as the bfloat16 kernel stores
    it."""
    *lead, S, hd = q.shape
    T = k.shape[-2]
    scale = 1.0 / float(hd) ** 0.5
    qf = q.reshape(-1, S, hd).float() * scale
    kf = k.reshape(-1, T, hd).float()
    vf = v.reshape(-1, T, hd).float()
    BH, dev = qf.shape[0], q.device
    out = torch.empty((BH, S, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((BH, S), dtype=torch.float32, device=dev)
    for i0 in range(0, S, _CHUNK):
        i1 = min(S, i0 + _CHUNK)
        q_pos = torch.arange(i0, i1, device=dev) + q_offset
        lo, hi = i0 + q_offset, i1 - 1 + q_offset
        m = torch.full((BH, i1 - i0), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((BH, i1 - i0), dtype=torch.float32, device=dev)
        acc = torch.zeros((BH, i1 - i0, hd), dtype=torch.float32, device=dev)
        for j0 in range(0, T, _CHUNK):
            j1 = min(T, j0 + _CHUNK)
            if (causal and j0 > hi) or (window > 0 and lo - (j1 - 1)
                                        >= window):
                continue
            k_pos = torch.arange(j0, j1, device=dev)
            s = qf[:, i0:i1] @ kf[:, j0:j1].transpose(1, 2)
            s = torch.where(_visible(q_pos, k_pos, T, causal, window)[None],
                            s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vf[:, j0:j1]
            m = m_new
        den = torch.clamp(l, min=1e-30)
        out[:, i0:i1] = (acc / den[..., None]).to(q.dtype)
        lse[:, i0:i1] = (m + torch.log(den)) * LOG2E
    out = out.reshape(*lead, S, hd)
    return (out, lse.reshape(*lead, S)) if return_lse else out


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *, causal: bool = True,
                              window: int = 0, q_offset: int = 0):
    """Plain PyTorch version of the gradient: (dq, dk, dv) of
    ``flash_attention`` at (q, k, v) given its output ``o`` and the
    output's gradient ``do``, by the explicit formula in float32, in
    query and key chunks as ``flash_attention_plain`` (O(S x chunk)
    memory): lse by an online max and sum, D = sum(do * o), then per
    chunk pair P = exp(s - lse), dS = P (do v^T - D), dv += P^T do,
    dk += dS^T (q scale), dq += dS k scale. Gradients come back in the
    inputs' type."""
    *lead, S, hd = q.shape
    T = k.shape[-2]
    scale = 1.0 / float(hd) ** 0.5
    qf = q.reshape(-1, S, hd).float() * scale
    kf = k.reshape(-1, T, hd).float()
    vf = v.reshape(-1, T, hd).float()
    dof = do.reshape(-1, S, hd).float()
    dd = (dof * o.reshape(-1, S, hd).float()).sum(dim=-1)
    BH, dev = qf.shape[0], q.device
    dq = torch.zeros((BH, S, hd), dtype=torch.float32, device=dev)
    dk = torch.zeros((BH, T, hd), dtype=torch.float32, device=dev)
    dv = torch.zeros((BH, T, hd), dtype=torch.float32, device=dev)

    def chunks(i0, i1):
        """The key chunks some query of rows [i0, i1) sees, with the
        scores and the mask of each."""
        lo, hi = i0 + q_offset, i1 - 1 + q_offset
        q_pos = torch.arange(i0, i1, device=dev) + q_offset
        for j0 in range(0, T, _CHUNK):
            j1 = min(T, j0 + _CHUNK)
            if (causal and j0 > hi) or (window > 0 and lo - (j1 - 1)
                                        >= window):
                continue
            vis = _visible(q_pos, torch.arange(j0, j1, device=dev), T,
                           causal, window)[None]
            s = qf[:, i0:i1] @ kf[:, j0:j1].transpose(1, 2)
            yield j0, j1, torch.where(vis, s, NEG_INF), vis

    for i0 in range(0, S, _CHUNK):
        i1 = min(S, i0 + _CHUNK)
        m = torch.full((BH, i1 - i0), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((BH, i1 - i0), dtype=torch.float32, device=dev)
        for _, _, s, _ in chunks(i0, i1):
            m_new = torch.maximum(m, s.amax(dim=-1))
            l = l * torch.exp(m - m_new) + torch.exp(
                s - m_new[..., None]).sum(dim=-1)
            m = m_new
        lse = m + torch.log(l)
        for j0, j1, s, vis in chunks(i0, i1):
            p = torch.where(vis, torch.exp(s - lse[..., None]), 0.0)
            dp = dof[:, i0:i1] @ vf[:, j0:j1].transpose(1, 2)
            ds = p * (dp - dd[:, i0:i1, None])
            dv[:, j0:j1] += p.transpose(1, 2) @ dof[:, i0:i1]
            dk[:, j0:j1] += ds.transpose(1, 2) @ qf[:, i0:i1]
            dq[:, i0:i1] += ds @ kf[:, j0:j1]
    return ((dq * scale).to(q.dtype).reshape(q.shape),
            dk.to(k.dtype).reshape(k.shape), dv.to(v.dtype).reshape(v.shape))


def _check(q, k, v):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise TypeError(f"flash_attention: {name} is {t.dtype}; q, k "
                            "and v must all be float32 or all bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} has shape "
                             f"{tuple(t.shape)}; expected (B, H, L, hd)")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim is not "
                             "contiguous")
    lead, hd = q.shape[:-2], q.shape[-1]
    if k.shape[:-2] != lead or v.shape != k.shape or k.shape[-1] != hd:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")


def tma_alignment_error(t: torch.Tensor) -> Optional[str]:
    """What of a (B, H, L, hd) view the bfloat16 kernel's TMA loads
    cannot take, or None: the base address and the batch, head and
    sequence strides of dims longer than 1 must be multiples of 16
    bytes. The (B, H, S, hd) view of a contiguous (B, S, H, hd) bf16
    tensor meets this when hd is a multiple of 8."""
    if t.data_ptr() % 16:
        return "base address"
    for dim, name in enumerate(("batch", "head", "sequence")):
        if t.shape[dim] > 1 and t.stride(dim) * t.element_size() % 16:
            return f"{name} stride"
    return None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, return_lse: bool = False):
    """Blockwise attention (shapes as in the module docstring). CUDA
    tensors launch ``csrc/flash_attention.cu`` (bfloat16 on the tensor
    cores in bf16, float32 on the tensor cores as split TF32); CPU
    tensors take the plain version. ``return_lse`` also returns each
    row's log-sum-exp in base 2 (float32, (B, H, S)), as the plain
    version computes it: on the card both routes store it, as a view of
    a (B, H, ``lse_rows(S)``) buffer whose rows past S hold 0, which the
    gradient reads; the output is bit for bit the one without it."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset,
                                     return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, hd = q.shape
    T = k.shape[-2]
    if B * H > 65535:
        raise ValueError(f"flash_attention: {B * H} batch x heads exceed "
                         "the grid's 65535")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            bad = tma_alignment_error(t)
            if bad is not None:
                raise ValueError(f"flash_attention: {name}'s {bad} is not a "
                                 "multiple of 16 bytes, which the bfloat16 "
                                 "kernel's TMA loads need")
    out = torch.empty_like(q)  # keeps q's layout (a transposed view too)
    lse = (torch.empty((B, H, lse_rows(S)), dtype=torch.float32,
                       device=q.device) if return_lse else None)
    lib = build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, S,
        T, hd, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3],
        int(bool(causal)), int(window), int(q_offset),
        1.0 / float(hd) ** 0.5, int(q.dtype == torch.bfloat16),
        None if lse is None else lse.data_ptr(), stream)
    if err >= _ENCODE_ERROR - 1:
        raise RuntimeError("flash_attention: cuTensorMapEncodeTiled "
                           + ("not found" if err == _ENCODE_ERROR - 1 else
                              f"failed with CUresult {err - _ENCODE_ERROR}"))
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    flash_attention.routes[route(q.dtype)] += 1
    return out if lse is None else (out, lse[..., :S])


flash_attention.launches = 0
flash_attention.routes = {"wgmma": 0, "tf32x3": 0}


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it in rows padded to 16 bytes (a view of the
    head dim) when TMA cannot read ``t`` itself (``tma_alignment_error``):
    a gradient autograd hands over may have any layout."""
    if tma_alignment_error(t) is None:
        return t
    hd = t.shape[-1]
    buf = t.new_zeros((*t.shape[:-1], -(-hd // 8) * 8))
    buf[..., :hd] = t
    return buf[..., :hd]


def _check_lse(lse: torch.Tensor, B: int, H: int, S: int) -> None:
    """Raises unless ``lse`` is what ``flash_attention(...,
    return_lse=True)`` returns for (B, H, S): a float32 (B, H, S) view at
    the base of a (B, H, ``lse_rows(S)``) buffer, whose rows the gradient
    reads (the bfloat16 route whole rows at a time)."""
    rows = lse_rows(S)
    if (lse.shape != (B, H, S) or lse.dtype != torch.float32
            or lse.stride() != (H * rows, rows, 1)
            or lse.storage_offset() != 0
            or lse.untyped_storage().nbytes() < 4 * B * H * rows):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} strides {lse.stride()} is not the "
                         f"forward's ({B}, {H}, {S}) view of ({B}, {H}, "
                         f"{rows}) float32 rows")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        lse: Optional[torch.Tensor] = None):
    """The gradient (dq, dk, dv) of ``flash_attention`` (shapes as in the
    module docstring; ``o`` its output, ``do`` the output's gradient,
    both (B, H, S, hd)). CUDA tensors launch ``csrc/flash_attention_bwd.
    cu`` by the route ``bwd_route`` names, recorded in ``routes``:
    bfloat16 on the tensor cores in bf16 (D = rowsum(dO o), dk and dv
    per 128 keys (64 at a padded head dim of 256), dq per 128 query
    rows), float32 on the tensor cores as split TF32 (dq and D with 16
    query rows a warp, then dk and dv with 16 keys a warp). Both read
    the forward's ``lse``, as ``flash_attention(..., return_lse=True)``
    returns it; without it the wrapper runs the
    forward kernel once more to get it, a launch counted in
    ``flash_attention.launches``. Float32 accumulation and no atomics on
    both, so a launch repeats bit for bit. CPU tensors take
    ``flash_attention_bwd_plain`` (``lse`` unused). The gradients have
    the inputs' type and layout (a transposed view's strides too)."""
    _check(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} must be q's {tuple(q.shape)}")
    for name, t in (("o", o), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"flash_attention_bwd: {name} is {t.dtype} on "
                            f"{t.device}, q {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    if do.stride(-1) != 1 or o.stride(-1) != 1:
        do, o = do.contiguous(), o.contiguous()
    B, H, S, hd = q.shape
    T = k.shape[-2]
    if B * H > 65535:
        raise ValueError(f"flash_attention_bwd: {B * H} batch x heads "
                         "exceed the grid's 65535")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if T == 0:
        return dq.zero_(), dk, dv
    path = bwd_route(q.dtype, hd)
    if path == "wgmma":
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
    if lse is None:
        _, lse = flash_attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, return_lse=True)
    _check_lse(lse, B, H, S)
    dd = torch.empty((B * H * lse_rows(S),), dtype=torch.float32,
                     device=q.device)
    views = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*(x for t in views
                                         for x in t.stride()[:3]))
    lib = build.load("flash_attention_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (*(t.data_ptr() for t in views), lse.data_ptr(), dd.data_ptr(),
            B, H, S, T, hd, ctypes.cast(strides, ctypes.c_void_p),
            int(bool(causal)), int(window), int(q_offset),
            1.0 / float(hd) ** 0.5)
    # one C entry a route: the route counted below is the one launched
    if path == "wgmma":
        err = lib.flash_attention_bwd_wgmma_launch(*args, stream)
    else:
        err = lib.flash_attention_bwd_launch(*args, stream)
    if err >= _ENCODE_ERROR - 1:
        raise RuntimeError("flash_attention_bwd: cuTensorMapEncodeTiled "
                           + ("not found" if err == _ENCODE_ERROR - 1 else
                              f"failed with CUresult {err - _ENCODE_ERROR}"))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.routes[path] += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.routes = {"wgmma": 0, "tf32x3": 0}
