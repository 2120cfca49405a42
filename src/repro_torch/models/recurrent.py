"""Recurrent sequence mixers; counterpart of ``repro/models/recurrent.py``
for its RG-LRU half (recurrentgemma/Griffin): the causal depthwise conv1d
and the RG-LRU, h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t).

The full-sequence form is the scan kernel ``kernels/rglru_scan.py`` (on
CUDA tensors the hand-written ``csrc/rglru_scan.cu``, on CPU tensors its
plain loop), where the reference runs ``lax.associative_scan``. The
decode step is plain tensor code. xLSTM's mLSTM and sLSTM cells are not
ported yet (ROADMAP Queue 1 item 13c): their functions raise.

All functions take pre-projected inputs; the projections live in
``transformer.py``'s blocks. ``p`` is the block's ``lru`` leaf, any
mapping of ``a_param``, ``alpha_i``, ``beta_i``, ``alpha_r`` and
``beta_r`` (float32 (w,) tensors, float32 in a bfloat16 model too).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import RGLRU_C, rglru_coeffs, rglru_scan

__all__ = ["RGLRU_C", "causal_conv1d", "causal_conv1d_step",
           "rglru_sequence", "rglru_step"]


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
# mLSTM / sLSTM (xlstm): not ported yet
# ---------------------------------------------------------------------------

def _unported(name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (xlstm's mLSTM/sLSTM cells) is not ported yet: ROADMAP "
            "Queue 1 item 13c")
    fn.__name__ = name
    return fn


mlstm_init_state = _unported("mlstm_init_state")
mlstm_sequence = _unported("mlstm_sequence")
mlstm_step = _unported("mlstm_step")
slstm_init_state = _unported("slstm_init_state")
slstm_sequence = _unported("slstm_sequence")
slstm_step = _unported("slstm_step")
