"""The mLSTM scan; the port's kernel for the reference's ``lax.scan`` of
xLSTM's matrix-memory cell in ``repro/models/recurrent.py:116``
(``mlstm_sequence``, the scan at ``:124``, the cell ``_mlstm_cell`` at
``:101``; the JAX package has no Pallas kernel there).

q, k, v (B, S, H, hd) float32 (k already divided by sqrt(hd)), the gate
pre-activations i_pre, f_pre (B, S, H) float32 and the state C (B, H, hd,
hd), n (B, H, hd), m (B, H) float32. Each step is the cell with
exponential gating and the max-state stabiliser:

    log_f = -softplus(-f_pre),  m' = max(log_f + m, i_pre),
    i_g = exp(i_pre - m'),      f_g = exp(log_f + m - m'),
    C' = f_g C + i_g (v k^T),   n' = f_g n + i_g k,
    h = (C' q) / max(|n' . q|, 1).

The call updates the state in place and returns h (B, S, H, hd) float32.
One entry serves prefill (S tokens from the zero state, m = -1e30) and
decode (S = 1 from the cache), so the two share one arithmetic: a
prefill of N tokens followed by one decode step leaves the state of a
prefill of N + 1 tokens, bit for bit. Where the reference's prefill
reruns the scan to get the final state, this call returns it at once.

``mlstm_scan`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/mlstm_scan.cu`` (or raises), on CPU
tensors it runs the plain PyTorch version ``mlstm_scan_plain``, a loop
over t of the cell. Its ``launches`` attribute counts kernel launches
and ``routes`` counts them by the head width the kernel was
instantiated for. The kernel has no backward yet: a CUDA call that
would need a gradient raises, naming ROADMAP Queue 1 item 13k; on the
CPU the plain loop is differentiable by autograd.

The kernel rounds as the plain loop's tensor operations do (no fused
multiply-adds), so the state C, n, m it carries is the plain loop's.
Its gates take one exp where the formula has two and keep those bits:
m' is one of log_f + m and i_pre, so one gate is exactly 1 and the other
exp(-|d|) with d = (log_f + m) - i_pre (the kernel picks i_g = 1 where
d <= 0, f_g = 1 otherwise). Only the two dot products C' q and
n' . q are summed in another order (each lane adds its columns j =
lane, lane + 32, ... in order, then the 32 lanes' partial sums are
added pairwise at distances 16, 8, 4, 2, 1; ``kernel_order_dot`` is
that sum in plain PyTorch). The kernel and the plain loop differ by
those sums and the last bits of the transcendental functions, within
1e-5 of max|h|.
"""
from __future__ import annotations

import torch

from . import build
from .rglru_scan import softplus

# the head widths the kernel is instantiated for (csrc/mlstm_scan.cu)
HEAD_DIMS = (16, 32, 64, 128, 256, 512)
M_INIT = -1e30


def init_state(B: int, H: int, hd: int, device) -> tuple:
    """The zero state: C (B, H, hd, hd), n (B, H, hd) zero, m (B, H) at
    -1e30, float32."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((B, H, hd, hd), **f32),
            torch.zeros((B, H, hd), **f32),
            torch.full((B, H), M_INIT, **f32))


def gates(i_pre: torch.Tensor, f_pre: torch.Tensor, m: torch.Tensor):
    """(i_g, f_g, m') of one step from the (B, H) pre-activations and the
    stabiliser m, as the reference's cell rounds them."""
    log_f = -softplus(-f_pre)
    lfm = log_f + m
    m_new = torch.maximum(lfm, i_pre)
    return torch.exp(i_pre - m_new), torch.exp(lfm - m_new), m_new


def mlstm_scan_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     i_pre: torch.Tensor, f_pre: torch.Tensor,
                     C: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version: the cell step by step on (B, H) slices,
    from copies of the state (autograd keeps the first step's inputs);
    the final state is written into C, n, m (detached: the state is a
    cache, never differentiated). Returns h (B, S, H, hd) float32."""
    Ct, nt, mt = C.clone(), n.clone(), m.clone()
    out = []
    for t in range(q.shape[1]):
        i_g, f_g, mt = gates(i_pre[:, t], f_pre[:, t], mt)
        kt = k[:, t]
        Ct = f_g[..., None, None] * Ct + i_g[..., None, None] * (
            v[:, t, :, :, None] * kt[..., None, :])
        nt = f_g[..., None] * nt + i_g[..., None] * kt
        num = torch.einsum("bhij,bhj->bhi", Ct, q[:, t])
        den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", nt,
                                                 q[:, t])), min=1.0)
        out.append(num / den[..., None])
    with torch.no_grad():
        C.copy_(Ct)
        n.copy_(nt)
        m.copy_(mt)
    if not out:
        return torch.empty_like(q)
    return torch.stack(out, dim=1)


def kernel_order_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j a_j b_j over the last axis (hd) in the kernel's order:
    lane l adds its products at j = l, l + 32, ... one at a time from 0,
    then the 32 lanes' sums are added pairwise at distances 16, 8, 4, 2,
    1 (the kernel adds a chunk's partial sums in that tree after the
    chunk, partly by ``__shfl_xor_sync``; a + b == b + a, so the tree's
    pairs give the same bits however they are laid out). Products and
    sums are rounded to float32 one at a time, as the kernel's
    ``__fmul_rn``/``__fadd_rn``."""
    hd = a.shape[-1]
    cols = -(-hd // 32)    # columns a lane; a lane past hd adds 0
    prod = a * b
    if cols * 32 > hd:
        prod = torch.cat([prod, prod.new_zeros(prod.shape[:-1] +
                                               (cols * 32 - hd,))], dim=-1)
    prod = prod.reshape(prod.shape[:-1] + (cols, 32))
    acc = torch.zeros_like(prod[..., 0, :])
    for c in range(cols):
        acc = acc + prod[..., c, :]
    width = 32
    while width > 1:
        width //= 2
        acc = acc[..., :width] + acc[..., width:2 * width]
    return acc[..., 0]


def _check(q, k, v, i_pre, f_pre, C, n, m) -> None:
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan: q has shape {tuple(q.shape)}; "
                         "expected (B, S, H, hd)")
    B, S, H, hd = q.shape
    want = {"q": (q, (B, S, H, hd)), "k": (k, (B, S, H, hd)),
            "v": (v, (B, S, H, hd)), "i_pre": (i_pre, (B, S, H)),
            "f_pre": (f_pre, (B, S, H)), "C": (C, (B, H, hd, hd)),
            "n": (n, (B, H, hd)), "m": (m, (B, H))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or \
                t.device != q.device:
            raise ValueError(f"mlstm_scan: {name} is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"float32 {shape} on {q.device}")
    for name, t in (("C", C), ("n", n), ("m", m)):
        if not t.is_contiguous():
            raise ValueError(f"mlstm_scan: the state {name} is updated in "
                             "place and must be contiguous")


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, C: torch.Tensor,
               n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The mLSTM scan (shapes as in the module docstring); updates C, n,
    m in place and returns h. CUDA tensors launch ``csrc/mlstm_scan.cu``;
    CPU tensors take the plain version."""
    _check(q, k, v, i_pre, f_pre, C, n, m)
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i_pre, f_pre, C, n, m)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_pre, f_pre, C, n, m)):
        raise NotImplementedError(
            "the mLSTM scan kernel has no backward yet: ROADMAP Queue 1 "
            "item 13k (xlstm training, the backward kernels of the mLSTM "
            "and sLSTM scans)")
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: unsupported device {q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan: head width {hd} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    if S == 0:
        return torch.empty_like(q)
    # the kernel copies q, k and v rows by TMA: 16-byte aligned bases
    q, k, v = (t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in (q, k, v))
    i_pre, f_pre = i_pre.contiguous(), f_pre.contiguous()
    h = torch.empty_like(q)
    arrivals = build.workspace("mlstm_scan", q.device, B * H)
    lib = build.load("mlstm_scan")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mlstm_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(),
        f_pre.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        h.data_ptr(), arrivals.data_ptr(), B, S, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan kernel launch failed: CUDA error "
                           f"{err}")
    mlstm_scan.launches += 1
    mlstm_scan.routes[f"hd{hd}"] += 1
    return h


mlstm_scan.launches = 0
mlstm_scan.routes = {f"hd{hd}": 0 for hd in HEAD_DIMS}
