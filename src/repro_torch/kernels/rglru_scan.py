"""The RG-LRU scan; the port's kernel for the reference's
``lax.associative_scan`` in ``repro/models/recurrent.py:64``
(``rglru_sequence``, the scan at ``:73``; the JAX package has no Pallas
kernel there).

x (B, S, W) post-conv inputs, float32 or bfloat16, and the five float32
(W,) parameters of the block's ``lru`` leaf: the coefficients
``rglru_coeffs`` (the reference's ``_rglru_coeffs``, ``:54``) and the
recurrence h_t = a_t h_{t-1} + b_t from h_0 = 0, carried in float32 and
returned in x's type.

``rglru_scan`` is the wrapper: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/rglru_scan.cu`` (or raises), on CPU
tensors it runs the plain PyTorch version ``rglru_scan_plain``, a loop
over t. Its ``launches`` attribute counts kernel launches. The kernel
has no backward yet: a CUDA call that would need a gradient raises,
naming ROADMAP Queue 1 item 13j; on the CPU the plain version is
differentiable by autograd.

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
within 1e-5 of max|h| in float32.
"""
from __future__ import annotations

import torch

from . import build

RGLRU_C = 8.0
# the kernel's tile (csrc/rglru_scan.cu CW, TS, TS / SUBS)
SCAN_CHANNELS = 32
SCAN_STEPS = 256
SCAN_SUB = 32


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


def rglru_scan(x: torch.Tensor, a_param: torch.Tensor,
               alpha_i: torch.Tensor, beta_i: torch.Tensor,
               alpha_r: torch.Tensor, beta_r: torch.Tensor) -> torch.Tensor:
    """The RG-LRU scan (shapes as in the module docstring). CUDA tensors
    launch ``csrc/rglru_scan.cu``; CPU tensors take the plain version."""
    params = (a_param, alpha_i, beta_i, alpha_r, beta_r)
    if x.dim() != 3:
        raise ValueError(f"rglru_scan: x has shape {tuple(x.shape)}; "
                         "expected (B, S, W)")
    B, S, W = x.shape
    for t in params:
        if t.shape != (W,) or t.dtype != torch.float32 or \
                t.device != x.device:
            raise ValueError(f"rglru_scan: a parameter is {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}; expected "
                             f"float32 ({W},) on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rglru_scan: x is {x.dtype}")
    if x.device.type == "cpu":
        return rglru_scan_plain(x, *params)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *params)):
        raise NotImplementedError(
            "the RG-LRU scan kernel has no backward yet: ROADMAP Queue 1 "
            "item 13j (recurrentgemma training, the scan's backward "
            "kernel)")
    if x.device.type != "cuda":
        raise ValueError(f"rglru_scan: unsupported device {x.device}")
    tiles = B * -(-W // SCAN_CHANNELS) * -(-S // SCAN_STEPS)
    if tiles >= 2 ** 31:
        raise ValueError(f"rglru_scan: {tiles} tiles exceed the grid's "
                         "2^31 - 1")
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
    return h


rglru_scan.launches = 0
