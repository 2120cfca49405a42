"""Device resolution shared by every entry point of the port.

Entry points take an explicit ``device`` and default to ``"cuda"``.
Without a CUDA device they raise; they never drop to the CPU on their
own (the tests pass ``device="cpu"``). On CUDA, TF32 is switched off
for matmuls and convolutions: the crossbar models sum 0/1 bit planes
against float32 weights before an ADC threshold, and TF32 rounding
would move quantization codes.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Validate ``device`` ("cuda", "cuda:N" or "cpu") and return it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "by default, pass device='cpu' to run it on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use cuda or cpu")
    return dev
