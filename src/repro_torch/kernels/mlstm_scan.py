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
instantiated for. A CUDA call that needs a gradient goes through
``MLSTMScan``, whose backward launches ``csrc/mlstm_scan_bwd.cu``
(``mlstm_scan_backward``, seven kernels a call; its plain version
``mlstm_scan_backward_plain``, counted in ``mlstm_scan_backward.launches``)
from the inputs and a copy of the starting state; on the CPU the plain
loop is differentiable by autograd.

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
1e-5 of max|h|. The gradient's kernels follow the plain backward's steps
and differ from it by their sums' order and their rounding (fused
updates; C^T dh scaled by 1 / den after the product): the matrix
gradients within 1e-5 of their largest entry, the gates' within 1e-4
(their Q recurrence adds each step's rounding over the sequence).
"""
from __future__ import annotations

import torch

from . import build
from .rglru_scan import softplus

# the head widths the kernel is instantiated for (csrc/mlstm_scan.cu)
HEAD_DIMS = (16, 32, 64, 128, 256, 512)
# rows of the matrix a partial sum of the backward's scans covers (a row
# group, csrc/mlstm_scan_bwd.cu RW): a sum across rows is written as
# hd / SCAN_ROWS partials a step, added in row-group order
SCAN_ROWS = 4
# kernels a backward call launches
BACKWARD_KERNELS = 7
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
        # max(|s|, 1) by torch.maximum: its gradient at |s| == 1 is
        # halved, as jnp.maximum's (torch.clamp's is not)
        s = torch.abs(torch.einsum("bhj,bhj->bh", nt, q[:, t]))
        den = torch.maximum(s, torch.ones_like(s))
        out.append(num / den[..., None])
    with torch.no_grad():
        C.copy_(Ct)
        n.copy_(nt)
        m.copy_(mt)
    if not out:
        return torch.empty_like(q)
    return torch.stack(out, dim=1)


def tie_weight(d: torch.Tensor) -> torch.Tensor:
    """The share of the stabiliser's gradient that goes to log_f + m in
    m' = max(log_f + m, i_pre), for d = (log_f + m) - i_pre: 1 where
    d > 0, 0 where d < 0 and one half at a tie, as ``jnp.maximum`` and
    ``torch.maximum`` split it."""
    return torch.where(d > 0, 1.0, torch.where(d == 0, 0.5, 0.0))


def gate_chain(DI: torch.Tensor, DF: torch.Tensor, w: torch.Tensor,
               sgf: torch.Tensor, carry: torch.Tensor):
    """One reverse step of the gates' chain through the stabiliser:
    DI = i_g dL/di_g and DF = f_g dL/df_g of this step, ``w`` its
    ``tie_weight``, ``sgf`` = sigmoid(-f_pre) (d log_f / d f_pre) and
    ``carry`` dL/dm' from the next step. Returns (d i_pre, d f_pre, the
    carry into the previous step)."""
    a = carry - (DI + DF)           # dL/dm' in all
    dlfm = DF + w * a               # dL/d(log_f + m)
    return DI + (1.0 - w) * a, dlfm * sgf, dlfm


def mlstm_scan_backward_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, i_pre: torch.Tensor,
                              f_pre: torch.Tensor, C: torch.Tensor,
                              n: torch.Tensor, m: torch.Tensor,
                              dh: torch.Tensor):
    """Plain PyTorch version of the scan's gradient: (dq, dk, dv
    (B, S, H, hd), d i_pre, d f_pre (B, S, H)), float32, for the output
    gradient ``dh`` of the scan from the state C, n, m (read, not
    changed; not differentiated). ``csrc/mlstm_scan_bwd.cu`` takes these
    steps with sums split by row group and some products in other places
    (C^T dh scaled by 1 / den_t after the product, G^T's update by q_t /
    den_t, the updates fused), which round otherwise:

    - forward: the gates, n_t, s_t = n_t . q_t, den_t = max(|s_t|, 1);
      C_t again and dq_C = C_t^T dnum_t with dnum_t = dh_t (1 / den_t);
      hh_t = q_t . dq_C (= dnum_t . C_t q_t = dh_t . h_t); ds_t =
      -(hh_t (1 / den_t)) sel_t, sel_t the derivative of max(|s|, 1) (sign(s)
      where |s| > 1, half of it at |s| == 1, as ``jnp.maximum`` splits a
      tie);
    - reverse: G_t = dnum_t q_t^T + f_{t+1} G_{t+1} (dL/dC_t), G_t k_t
      and G_t^T v_t, dN_t = ds_t q_t + f_{t+1} dN_{t+1} (dL/dn_t); dq =
      dq_C + ds n_t, dk = i_g (G^T v + dN), dv = i_g G k;
    - the gates: DI_t = i_g (v^T G k + dN . k), DF_t = f_g <G_t, C_{t-1}>
      + f_g dN . n_{t-1}, where f_g <G_t, C_{t-1}> = Q_t is taken from
      Q_t = hh_t + Q_{t+1} - i_g v^T G_t k_t (Q_S = 0; <G_t, C_t> two
      ways), so C is never needed in reverse, and Q_t = 0 where f_g is
      exactly 0 (the first step from the zero state: its true value, where
      the recurrence would leave rounding); then ``gate_chain``.

    The state is no input of the gradient (the reference trains from the
    zero state)."""
    B, S, H, hd = q.shape
    out = [torch.zeros_like(q) for _ in range(3)] + \
        [torch.zeros_like(i_pre) for _ in range(2)]
    if S == 0:
        return tuple(out)
    dh = dh.float()
    Ct, nt, mt = C.detach().clone(), n.detach().clone(), m.detach().clone()
    ig, fg, wt, sgf, ns, dnum, dqC, hh, ds = ([] for _ in range(9))
    with torch.no_grad():
        for t in range(S):
            i_g, f_g, m_new = gates(i_pre[:, t], f_pre[:, t], mt)
            wt.append(tie_weight((-softplus(-f_pre[:, t]) + mt)
                                 - i_pre[:, t]))
            sgf.append(torch.sigmoid(-f_pre[:, t]))
            mt = m_new
            kt = k[:, t]
            ns.append(nt)
            nt = f_g[..., None] * nt + i_g[..., None] * kt
            s = torch.einsum("bhj,bhj->bh", nt, q[:, t])
            rden = 1.0 / torch.clamp(torch.abs(s), min=1.0)
            sel = torch.where(torch.abs(s) > 1, torch.sign(s), torch.where(
                torch.abs(s) == 1, 0.5 * torch.sign(s), torch.zeros_like(s)))
            Ct = f_g[..., None, None] * Ct + i_g[..., None, None] * (
                v[:, t, :, :, None] * kt[..., None, :])
            dn_t = dh[:, t] * rden[..., None]
            dq_c = torch.einsum("bhij,bhi->bhj", Ct, dn_t)
            h2 = torch.einsum("bhj,bhj->bh", q[:, t], dq_c)
            ig.append(i_g)
            fg.append(f_g)
            dnum.append(dn_t)
            dqC.append(dq_c)
            hh.append(h2)
            ds.append(-(h2 * rden) * sel)
        ns.append(nt)
        G = torch.zeros_like(Ct)
        dN = torch.zeros_like(nt)
        Q = torch.zeros_like(mt)
        carry = torch.zeros_like(mt)
        dq, dk, dv, di, df = out
        for t in range(S - 1, -1, -1):
            if t + 1 < S:
                G = fg[t + 1][..., None, None] * G
                dN = fg[t + 1][..., None] * dN
            G = G + dnum[t][..., :, None] * q[:, t, :, None, :]
            dN = ds[t][..., None] * q[:, t] + dN
            Gk = torch.einsum("bhij,bhj->bhi", G, k[:, t])
            GTv = torch.einsum("bhij,bhi->bhj", G, v[:, t])
            vGk = torch.einsum("bhi,bhi->bh", v[:, t], Gk)
            dq[:, t] = dqC[t] + ds[t][..., None] * ns[t + 1]
            dk[:, t] = ig[t][..., None] * (GTv + dN)
            dv[:, t] = ig[t][..., None] * Gk
            DI = ig[t] * (vGk + torch.einsum("bhj,bhj->bh", dN, k[:, t]))
            Q = torch.where(fg[t] == 0, 0.0, (hh[t] + Q) - ig[t] * vGk)
            DF = Q + fg[t] * torch.einsum("bhj,bhj->bh", dN, ns[t])
            di[:, t], df[:, t], carry = gate_chain(DI, DF, wt[t], sgf[t],
                                                   carry)
    return tuple(out)


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


def _forward_kernel(q, k, v, i_pre, f_pre, C, n, m) -> torch.Tensor:
    """One launch of ``csrc/mlstm_scan.cu`` (inputs checked): updates C,
    n, m in place and returns h."""
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan: head width {hd} is not one of the "
                         f"kernel's {HEAD_DIMS}")
    if S == 0:
        return torch.empty_like(q)
    q, k, v = _aligned(q, k, v)
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


def _aligned(*ts):
    """Contiguous copies of ``ts`` whose bases are 16-byte aligned (the
    kernels copy their rows by TMA or cp.async)."""
    return tuple(t.contiguous() if t.data_ptr() % 16 == 0 else t.clone(
        memory_format=torch.contiguous_format) for t in ts)


def _state_not_differentiated(name: str, state) -> None:
    """The scans' Functions give the state no gradient: refuse a state
    that asks for one rather than drop it."""
    if any(t.requires_grad for t in state):
        raise ValueError(f"{name}: the state is not differentiated; pass "
                         "state tensors that do not require a gradient")


class MLSTMScan(torch.autograd.Function):
    """The scan on the card with its gradient: the forward launches
    ``csrc/mlstm_scan.cu`` (the state C, n, m updated in place, as
    ``mlstm_scan``) and keeps q, k, v, the gates and a copy of the state
    it started from; the backward launches ``csrc/mlstm_scan_bwd.cu``.
    The state is not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C, n, m):
        start = (C.clone(), n.clone(), m.clone())
        h = _forward_kernel(q, k, v, i_pre, f_pre, C, n, m)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, *start)
        return h

    @staticmethod
    def backward(ctx, dh):
        return (*mlstm_scan_backward(*ctx.saved_tensors, dh), None, None,
                None)


def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor, C: torch.Tensor,
               n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The mLSTM scan (shapes as in the module docstring); updates C, n,
    m in place and returns h. CUDA tensors launch ``csrc/mlstm_scan.cu``
    (through ``MLSTMScan`` when a gradient is needed); CPU tensors take
    the plain version."""
    _check(q, k, v, i_pre, f_pre, C, n, m)
    if q.device.type == "cpu":
        return mlstm_scan_plain(q, k, v, i_pre, f_pre, C, n, m)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan: unsupported device {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, i_pre, f_pre)):
        _state_not_differentiated("mlstm_scan", (C, n, m))
        return MLSTMScan.apply(q, k, v, i_pre, f_pre, C, n, m)
    return _forward_kernel(q, k, v, i_pre, f_pre, C, n, m)


mlstm_scan.launches = 0
mlstm_scan.routes = {f"hd{hd}": 0 for hd in HEAD_DIMS}


def mlstm_scan_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        C: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
                        dh: torch.Tensor):
    """The scan's gradient for the output gradient ``dh`` (B, S, H, hd)
    from the state C, n, m (read, not changed): (dq, dk, dv, d i_pre,
    d f_pre) float32. CUDA tensors launch ``csrc/mlstm_scan_bwd.cu``
    (seven kernels); CPU tensors take ``mlstm_scan_backward_plain``."""
    _check(q, k, v, i_pre, f_pre, C, n, m)
    if dh.shape != q.shape or dh.device != q.device:
        raise ValueError(f"mlstm_scan_backward: dh is {tuple(dh.shape)} on "
                         f"{dh.device}; expected {tuple(q.shape)} on "
                         f"{q.device}")
    if q.device.type == "cpu":
        return mlstm_scan_backward_plain(q, k, v, i_pre, f_pre, C, n, m, dh)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm_scan_backward: unsupported device "
                         f"{q.device}")
    B, S, H, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"mlstm_scan_backward: head width {hd} is not one "
                         f"of the kernel's {HEAD_DIMS}")
    if S == 0:
        return (*(torch.zeros_like(q) for _ in range(3)),
                torch.zeros_like(i_pre), torch.zeros_like(f_pre))
    q, k, v, dh, C, n = _aligned(q, k, v, dh.float(), C, n)
    i_pre, f_pre, m = i_pre.contiguous(), f_pre.contiguous(), m.contiguous()
    dq, dk, dv, nall = (torch.empty_like(q) for _ in range(4))
    di, df = torch.empty_like(i_pre), torch.empty_like(i_pre)
    f32 = dict(dtype=torch.float32, device=q.device)
    gate, sc, ch = (torch.empty((B, S, H, 4), **f32) for _ in range(3))
    parts = torch.empty((3, hd // SCAN_ROWS, B, S, H), **f32)
    lib = build.load("mlstm_scan_bwd")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.mlstm_scan_bwd_launch(
        *(t.data_ptr() for t in (q, k, v, i_pre, f_pre, C, n, m, dh, dq, dk,
                                 dv, di, df, gate, sc, ch, nall, *parts)),
        B, S, H, hd, stream)
    if err != 0:
        raise RuntimeError(f"mlstm_scan_bwd kernel launch failed: CUDA error"
                           f" {err}")
    mlstm_scan_backward.launches += 1
    return dq, dk, dv, di, df


mlstm_scan_backward.launches = 0
