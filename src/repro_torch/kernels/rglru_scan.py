"""The RG-LRU scan and its gradient; the port's kernels for the
reference's ``lax.associative_scan`` in ``repro/models/recurrent.py:64``
(``rglru_sequence``, the scan at ``:73``) and for JAX's autodiff of it
through ``_rglru_coeffs`` (``:54``); the JAX package has no Pallas kernel
there.

x (B, S, W) post-conv inputs, float32 or bfloat16, and the five float32
(W,) parameters of the block's ``lru`` leaf: the coefficients
``rglru_coeffs`` (the reference's ``_rglru_coeffs``) and the recurrence
h_t = a_t h_{t-1} + b_t from h_0 = 0, carried in float32 and returned in
x's type.

``rglru_scan`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/rglru_scan.cu`` (or raises), on CPU
tensors it runs the plain PyTorch version ``rglru_scan_plain``, a loop
over t, differentiable by autograd. A CUDA call that needs a gradient
goes through ``RGLRUScan``, whose backward launches
``csrc/rglru_scan_bwd.cu`` (``rglru_scan_backward``; its plain version
``rglru_scan_backward_plain``) from the inputs and the forward's carry
buffer. Each wrapper's ``launches`` attribute counts its kernel's
launches.

The reference's associative scan combines the steps in a tree; the
plain version takes them in order. The kernel is a chunked scan: tiles
of ``SCAN_CHANNELS`` channels x ``SCAN_STEPS`` steps, each cut into
sub-chunks of ``SCAN_SUB`` steps; a sub-chunk's h is the plain
recurrence from its carry, and the carry is the previous sub-chunk's
aggregate, h_in' = (a_1 ... a_n) h_in + (its h from 0), taken in order
across tiles (tests/test_torch_recurrent.py emulates that arithmetic
in plain PyTorch). All of them round as the plain tensor operations do
(no fused multiply-adds); the kernel and the plain loop differ by the
carries' products and the last bits of the transcendental functions,
within 1e-5 of max|h| in float32. The backward kernel runs the same
time tiles in reverse, narrower (``SCAN_BWD_CHANNELS`` channels) and
cut into sub-chunks of ``SCAN_BWD_SUB`` steps, a thread each: h into
each sub-chunk from the forward's carry at the tile start, and the g
carries, g_t = dh_t + a_{t+1} g_{t+1}, into each from the successor
tile's carry, both through the sub-chunks' aggregates combined in a
Kogge-Stone tree across a tile's 32 sub-chunks (the tile's carry out
of the whole tree's); its parameter gradients summed a thread's steps
in order, then a tile's sub-chunks pairwise a group of four (a warp)
and the eight groups in order, then over the tiles in order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build

RGLRU_C = 8.0
# the kernel's tile (csrc/rglru_scan.cu CW, TS, TS / SUBS)
SCAN_CHANNELS = 32
SCAN_STEPS = 256
SCAN_SUB = 32
# the backward kernel's tile (csrc/rglru_scan_bwd.cu CW, TS, SUB)
SCAN_BWD_CHANNELS = 8
SCAN_BWD_SUB = 8


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` with no threshold
    (``F.softplus`` turns linear above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def rglru_coeffs(x: torch.Tensor, a_param: torch.Tensor,
                 alpha_i: torch.Tensor, beta_i: torch.Tensor,
                 alpha_r: torch.Tensor, beta_r: torch.Tensor):
    """(a_t, b_t) of the recurrence, float32, x's shape: the gates
    i_t = sigmoid(x alpha_i + beta_i), r_t = sigmoid(x alpha_r +
    beta_r), log a_t = (-8 softplus(a_param)) r_t and b_t =
    sqrt(max(1 - a_t^2, 1e-8)) (i_t x), as the reference rounds them."""
    xf = x.float()
    i_t = torch.sigmoid(xf * alpha_i + beta_i)
    r_t = torch.sigmoid(xf * alpha_r + beta_r)
    log_a = -RGLRU_C * softplus(a_param) * r_t
    a_t = torch.exp(log_a)
    b_t = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-8)
                     ) * (i_t * xf)
    return a_t, b_t


def rglru_scan_plain(x: torch.Tensor, a_param: torch.Tensor,
                     alpha_i: torch.Tensor, beta_i: torch.Tensor,
                     alpha_r: torch.Tensor, beta_r: torch.Tensor
                     ) -> torch.Tensor:
    """Plain PyTorch version: the coefficients at once, then the
    recurrence step by step in float32; h in x's type."""
    a_t, b_t = rglru_coeffs(x, a_param, alpha_i, beta_i, alpha_r, beta_r)
    h = torch.zeros_like(a_t[:, 0])
    out = []
    for t in range(x.shape[1]):
        h = a_t[:, t] * h + b_t[:, t]
        out.append(h.to(x.dtype))
    if not out:
        return torch.empty_like(x)
    return torch.stack(out, dim=1)


def rglru_scan_backward_plain(x: torch.Tensor, a_param: torch.Tensor,
                              alpha_i: torch.Tensor, beta_i: torch.Tensor,
                              alpha_r: torch.Tensor, beta_r: torch.Tensor,
                              dh: torch.Tensor):
    """Plain PyTorch version of the scan's gradient: (dx in x's type,
    d a_param, d alpha_i, d beta_i, d alpha_r, d beta_r float32 (W,)) for
    the output gradient ``dh`` (B, S, W). The coefficients as
    ``rglru_coeffs`` computes them, h forward in float32, the reverse
    recurrence g_t = dh_t + a_{t+1} g_{t+1}, da_t = g_t h_{t-1}, db_t =
    g_t, then the chain rule through the coefficients element by element
    in the order ``csrc/rglru_scan_bwd.cu`` rounds it, the parameter
    gradients summed over B and S. The clamp's gradient goes wholly to
    1 - a^2 at a tie (``torch.clamp``'s convention; the reference's
    ``jnp.maximum`` halves it there), which never arises: 1 - a^2 is 0
    or at least 2^-24 in float32, never float32(1e-8)."""
    xf = x.float()
    i_t = torch.sigmoid(xf * alpha_i + beta_i)
    r_t = torch.sigmoid(xf * alpha_r + beta_r)
    nc = -RGLRU_C * softplus(a_param)
    log_a = nc * r_t
    a_t = torch.exp(log_a)
    e2 = torch.exp(2.0 * log_a)
    u = 1.0 - e2
    s = torch.sqrt(torch.clamp(u, min=1e-8))
    ix = i_t * xf
    b_t = s * ix
    B, S, W = x.shape
    h = torch.zeros_like(a_t[:, 0])
    h_prev = torch.empty_like(a_t)
    for t in range(S):
        h_prev[:, t] = h
        h = a_t[:, t] * h + b_t[:, t]
    dhf = dh.float()
    g = torch.empty_like(a_t)
    c = torch.zeros_like(h)
    for t in range(S - 1, -1, -1):
        g[:, t] = dhf[:, t] + c
        c = a_t[:, t] * g[:, t]
    da = g * h_prev
    dix = g * s
    du = torch.where(u >= 1e-8, (g * ix) / (2.0 * s), torch.zeros_like(u))
    dlog_a = da * a_t - 2.0 * (du * e2)
    dzi = (dix * xf) * (i_t * (1.0 - i_t))
    dzr = (dlog_a * nc) * (r_t * (1.0 - r_t))
    dx = dix * i_t + dzi * alpha_i + dzr * alpha_r
    dims = (0, 1)
    d_a = ((dlog_a * r_t).sum(dims) * -RGLRU_C) * torch.sigmoid(a_param)
    return (dx.to(x.dtype), d_a, (dzi * xf).sum(dims), dzi.sum(dims),
            (dzr * xf).sum(dims), dzr.sum(dims))


def _check(name: str, x: torch.Tensor, params) -> None:
    """x (B, S, W) float32 or bfloat16 and five float32 (W,) parameters
    on x's device, or raise."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}; "
                         "expected (B, S, W)")
    W = x.shape[2]
    for t in params:
        if t.shape != (W,) or t.dtype != torch.float32 or \
                t.device != x.device:
            raise ValueError(f"{name}: a parameter is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"float32 ({W},) on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: x is {x.dtype}")


def _tiles(name: str, B: int, S: int, W: int) -> int:
    tiles = B * -(-W // SCAN_CHANNELS) * -(-S // SCAN_STEPS)
    if tiles >= 2 ** 31:
        raise ValueError(f"{name}: {tiles} tiles exceed the grid's "
                         "2^31 - 1")
    return tiles


def backward_tiles(B: int, S: int, W: int):
    """(tiles, int32 workspace entries) of the backward kernel's launch at
    x (B, S, W): two counters, then a 64-bit carry word a (tile, channel)
    and a 64-bit partial-sum word a (tile, parameter, channel)."""
    tiles = B * -(-W // SCAN_BWD_CHANNELS) * -(-S // SCAN_STEPS)
    return tiles, 2 + 2 * (1 + 5) * SCAN_BWD_CHANNELS * tiles


def _forward_kernel(x: torch.Tensor, params):
    """One launch of ``csrc/rglru_scan.cu``: (h, the carry buffer, each
    tile's outgoing float32 h at tile x 32 + channel)."""
    B, S, W = x.shape
    tiles = _tiles("rglru_scan", B, S, W)
    x = x.contiguous()
    params = tuple(t.contiguous() for t in params)
    h = torch.empty_like(x)
    work = build.workspace("rglru_scan", x.device, 2 + tiles)
    carry = torch.empty((max(1, tiles) * SCAN_CHANNELS,),
                        dtype=torch.float32, device=x.device)
    lib = build.load("rglru_scan")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rglru_scan_launch(
        x.data_ptr(), *(t.data_ptr() for t in params), h.data_ptr(),
        work.data_ptr(), carry.data_ptr(), B, S, W,
        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: CUDA error "
                           f"{err}")
    rglru_scan.launches += 1
    return h, carry


class RGLRUScan(torch.autograd.Function):
    """The scan on the card with its gradient: the forward launches
    ``csrc/rglru_scan.cu`` and keeps x, the parameters and the launch's
    carry buffer; the backward launches ``csrc/rglru_scan_bwd.cu``."""

    @staticmethod
    def forward(ctx, x, a_param, alpha_i, beta_i, alpha_r, beta_r):
        h, carry = _forward_kernel(x, (a_param, alpha_i, beta_i, alpha_r,
                                       beta_r))
        ctx.save_for_backward(x, a_param, alpha_i, beta_i, alpha_r, beta_r,
                              carry)
        return h

    @staticmethod
    def backward(ctx, dh):
        *inputs, carry = ctx.saved_tensors
        return rglru_scan_backward(*inputs, dh, carry)


def rglru_scan(x: torch.Tensor, a_param: torch.Tensor,
               alpha_i: torch.Tensor, beta_i: torch.Tensor,
               alpha_r: torch.Tensor, beta_r: torch.Tensor) -> torch.Tensor:
    """The RG-LRU scan (shapes as in the module docstring). CUDA tensors
    launch ``csrc/rglru_scan.cu`` (through ``RGLRUScan`` when a gradient
    is needed); CPU tensors take the plain version."""
    params = (a_param, alpha_i, beta_i, alpha_r, beta_r)
    _check("rglru_scan", x, params)
    if x.device.type == "cpu":
        return rglru_scan_plain(x, *params)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *params)):
        return RGLRUScan.apply(x, *params)
    return _forward_kernel(x, params)[0]


rglru_scan.launches = 0


def rglru_scan_backward(x: torch.Tensor, a_param: torch.Tensor,
                        alpha_i: torch.Tensor, beta_i: torch.Tensor,
                        alpha_r: torch.Tensor, beta_r: torch.Tensor,
                        dh: torch.Tensor,
                        carry: Optional[torch.Tensor] = None):
    """The scan's gradient for the output gradient ``dh`` (B, S, W): (dx
    in x's type, d a_param, d alpha_i, d beta_i, d alpha_r, d beta_r).
    CUDA tensors launch ``csrc/rglru_scan_bwd.cu`` on ``carry``, the
    carry buffer of the forward launch on the same inputs (required
    there); CPU tensors take ``rglru_scan_backward_plain``."""
    params = (a_param, alpha_i, beta_i, alpha_r, beta_r)
    _check("rglru_scan_backward", x, params)
    if dh.shape != x.shape or dh.device != x.device:
        raise ValueError(f"rglru_scan_backward: dh is {tuple(dh.shape)} on "
                         f"{dh.device}; expected {tuple(x.shape)} on "
                         f"{x.device}")
    if x.device.type == "cpu":
        return rglru_scan_backward_plain(x, *params, dh)
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan_backward: unsupported device "
                         f"{x.device}")
    B, S, W = x.shape
    f_tiles = _tiles("rglru_scan_backward", B, S, W)
    if carry is None or carry.dtype != torch.float32 or \
            carry.device != x.device or \
            carry.numel() < max(1, f_tiles) * SCAN_CHANNELS:
        raise ValueError("rglru_scan_backward: needs the forward launch's "
                         f"float32 carry buffer of {max(1, f_tiles)} x "
                         f"{SCAN_CHANNELS} entries on {x.device}")
    tiles, work_n = backward_tiles(B, S, W)
    if work_n >= 2 ** 31:
        raise ValueError(f"rglru_scan_backward: {tiles} tiles need a "
                         f"workspace of {work_n} entries, over 2^31 - 1")
    x = x.contiguous()
    dh = dh.to(x.dtype).contiguous()
    params = tuple(t.contiguous() for t in params)
    dx = torch.empty_like(x)
    if tiles == 0:
        return (dx, *(torch.zeros_like(t) for t in params))
    grads = torch.empty((5, W), dtype=torch.float32, device=x.device)
    work = build.workspace("rglru_scan_bwd", x.device, work_n)
    lib = build.load("rglru_scan_bwd")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rglru_scan_bwd_launch(
        x.data_ptr(), *(t.data_ptr() for t in params), dh.data_ptr(),
        carry.data_ptr(), dx.data_ptr(), grads.data_ptr(), work.data_ptr(),
        B, S, W, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd kernel launch failed: CUDA "
                           f"error {err}")
    rglru_scan_backward.launches += 1
    return (dx, *grads.unbind(0))


rglru_scan_backward.launches = 0
