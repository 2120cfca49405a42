"""Recurrent sequence mixers; counterpart of ``repro/models/recurrent.py``:
the RG-LRU (recurrentgemma/Griffin) with its causal depthwise conv1d,
h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t), and xLSTM's mLSTM (matrix
memory) and sLSTM (scalar memory) cells, with exponential gating and the
max-state stabiliser.

The RG-LRU's full-sequence form is the scan kernel
``kernels/rglru_scan.py`` (on CUDA tensors the hand-written
``csrc/rglru_scan.cu``, on CPU tensors its plain loop), where the
reference runs ``lax.associative_scan``; its decode step is plain tensor
code. The mLSTM and sLSTM run on the scan kernels
``kernels/mlstm_scan.py`` and ``kernels/slstm_scan.py`` (the
hand-written ``csrc/mlstm_scan.cu`` and ``csrc/slstm_scan.cu``), where
the reference runs ``lax.scan`` over its cells; their sequence and step
forms are the same scan (a step is S = 1), and both update the state's
tensors in place (the reference returns a new state). In training their
gradients are the backward kernels ``csrc/mlstm_scan_bwd.cu`` and
``csrc/slstm_scan_bwd.cu`` (the RG-LRU's ``csrc/rglru_scan_bwd.cu``).

All functions take pre-projected inputs; the projections live in
``transformer.py``'s blocks. ``p`` is the block's ``lru`` leaf, any
mapping of ``a_param``, ``alpha_i``, ``beta_i``, ``alpha_r`` and
``beta_r`` (float32 (w,) tensors, float32 in a bfloat16 model too).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..kernels.mlstm_scan import init_state as mlstm_zero_state
from ..kernels.mlstm_scan import mlstm_scan
from ..kernels.rglru_scan import RGLRU_C, rglru_coeffs, rglru_scan
from ..kernels.slstm_scan import init_state as slstm_zero_state
from ..kernels.slstm_scan import slstm_scan

__all__ = ["RGLRU_C", "causal_conv1d", "causal_conv1d_step",
           "rglru_sequence", "rglru_step", "MLSTMState", "mlstm_init_state",
           "mlstm_sequence", "mlstm_step", "SLSTMState", "slstm_init_state",
           "slstm_sequence", "slstm_step"]


# ---------------------------------------------------------------------------
# Causal depthwise conv1d (width W) used by the RG-LRU block
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); w: (W, C) depthwise taps. y_t = sum_k w_{W-1-k}
    x_{t-k}, added tap by tap in float32 (k = 0..W-1), in x's type."""
    W, S = w.shape[0], x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k in range(W):
        shifted = F.pad(x, (0, 0, k, 0))[:, :S]
        out = out + shifted.float() * w[W - 1 - k].float()
    return out.to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); conv_state: (B, W-1, C) past inputs (oldest first).
    Returns (y_t in x_t's type, the next state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)   # (B, W, C)
    wf, taps = window.float(), w.float()
    y = wf[:, 0] * taps[0]
    for j in range(1, w.shape[0]):
        y = y + wf[:, j] * taps[j]
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _params(p: Mapping[str, torch.Tensor]):
    return (p["a_param"], p["alpha_i"], p["beta_i"], p["alpha_r"],
            p["beta_r"])


def rglru_sequence(x: torch.Tensor, p: Mapping[str, torch.Tensor]
                   ) -> torch.Tensor:
    """x: (B, S, w) post-conv inputs -> h: (B, S, w) in x's type, h_0 = 0
    (the scan kernel on CUDA tensors)."""
    return rglru_scan(x, *_params(p))


def rglru_step(x_t: torch.Tensor, h_prev: torch.Tensor,
               p: Mapping[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, w); h_prev: (B, w) float32. Returns (h in x_t's type, h
    in float32, the next state)."""
    a_t, b_t = rglru_coeffs(x_t, *_params(p))
    h = a_t * h_prev + b_t
    return h.to(x_t.dtype), h


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, exponential gating)
# ---------------------------------------------------------------------------

class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, hd, hd) float32
    n: torch.Tensor  # (B, H, hd) float32
    m: torch.Tensor  # (B, H) float32


def mlstm_init_state(B: int, H: int, hd: int,
                     device: DeviceLike = "cuda") -> MLSTMState:
    """The zero state (m at -1e30), on the card unless ``device`` says
    otherwise."""
    return MLSTMState(*mlstm_zero_state(B, H, hd, resolve_device(device)))


def mlstm_sequence(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor,
                   state: Optional[MLSTMState] = None) -> torch.Tensor:
    """q/k/v: (B, S, H, hd) float32; i_pre/f_pre: (B, S, H). Returns h
    (B, S, H, hd) from ``state`` (the zero state when None), which is
    left holding the final state (the scan kernel on CUDA tensors)."""
    B, S, H, hd = q.shape
    if state is None:
        state = mlstm_init_state(B, H, hd, q.device)
    return mlstm_scan(q, k, v, i_pre, f_pre, *state)


def mlstm_step(state: MLSTMState, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, i_pre: torch.Tensor, f_pre: torch.Tensor
               ) -> Tuple[MLSTMState, torch.Tensor]:
    """One token: q/k/v (B, H, hd), i_pre/f_pre (B, H). Updates the
    state's tensors in place (the reference returns new ones) and returns
    (state, h (B, H, hd)); the same scan as ``mlstm_sequence`` with S =
    1, so a sequence and its steps carry the same bits."""
    h = mlstm_scan(q[:, None], k[:, None], v[:, None], i_pre[:, None],
                   f_pre[:, None], *state)
    return state, h[:, 0]


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, diagonal recurrence)
# ---------------------------------------------------------------------------

class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, w) float32
    n: torch.Tensor  # (B, w) float32
    m: torch.Tensor  # (B, w) float32
    h: torch.Tensor  # (B, w) float32


def slstm_init_state(B: int, w: int,
                     device: DeviceLike = "cuda") -> SLSTMState:
    """The zero state (m at -1e30), on the card unless ``device`` says
    otherwise."""
    return SLSTMState(*slstm_zero_state(B, w, resolve_device(device)))


def slstm_sequence(gates: torch.Tensor, r: torch.Tensor,
                   state: Optional[SLSTMState] = None) -> torch.Tensor:
    """gates: (B, S, w, 4) pre-activations (z, i, f, o) in the model's
    type; r: (w, 4) float32. Returns h (B, S, w) float32 from ``state``
    (the zero state when None), which is left holding the final state
    (the scan kernel on CUDA tensors)."""
    B, S, w, _ = gates.shape
    if state is None:
        state = slstm_init_state(B, w, gates.device)
    return slstm_scan(gates, r, *state)


def slstm_step(state: SLSTMState, gates: torch.Tensor, r: torch.Tensor
               ) -> Tuple[SLSTMState, torch.Tensor]:
    """One token: gates (B, w, 4). Updates the state's tensors in place
    and returns (state, h (B, w) float32)."""
    return state, slstm_scan(gates[:, None], r, *state)[:, 0]
