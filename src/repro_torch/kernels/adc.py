"""The ADC quantization model every crossbar simulation of the port
shares (counterpart of ``repro/kernels/adc.py``).

Signed mid-tread ADC, code range ``[-2^(b-1), 2^(b-1) - 1]``::

    delta = full_scale / 2^(bits - 1)
    q(x)  = clip(round(x / delta), -2^(b-1), 2^(b-1) - 1) * delta

``round`` is half to even (``torch.round``; ``rintf`` in the CUDA
kernel). The division is a true division by ``delta``, never a
multiplication by its reciprocal: ``delta`` is moved onto ``x``'s
device as a tensor, because CUDA PyTorch turns a division by a Python
scalar into a multiplication by its reciprocal.
"""
from __future__ import annotations

import torch

# 8-bit activations streamed as bit-serial planes everywhere.
WEIGHT_BITS = 8


def adc_full_scale(xbar_rows, w_scale: float = 1.0):
    """Analog full-scale range of one column sum for an R-row tile."""
    return w_scale * xbar_rows / 4.0


def adc_quantize(x: torch.Tensor, full_scale, bits: int = 8) -> torch.Tensor:
    """Signed-delta mid-tread ADC transfer function. ``full_scale`` is a
    number or a tensor broadcasting against ``x``."""
    full_scale = torch.as_tensor(full_scale, dtype=torch.float32,
                                 device=x.device)
    delta = full_scale / (2.0 ** (bits - 1))
    lo = -(2.0 ** (bits - 1))
    hi = 2.0 ** (bits - 1) - 1.0
    return torch.clamp(torch.round(x / delta), lo, hi) * delta
