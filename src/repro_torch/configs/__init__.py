"""Architecture registry: the 10 assigned archs (+ reduced smoke
variants) and the input-shape set; the port's own copy of
``repro/configs/``, value for value.

Every full config matches the assignment table exactly; ``reduced=True``
returns a same-family miniature for CPU smoke tests. In the port the
configs feed ``core.workloads.from_arch_config`` (the ``sram_lm_archs``
scenario), the example's qwen3-4b projection and the LM stack
(``models/``, ``serve/``, ``train/``), which runs all ten: the dense
archs (qwen3-4b, qwen2.5-3b, glm4-9b, phi4-mini), the RG-LRU hybrid
recurrentgemma-9b, xlstm-350m (alternating sLSTM and mLSTM blocks), the
mixture-of-experts phi3.5-moe and mixtral-8x22b, llama-3.2-vision and
hubert-xlarge's encoder.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from ..models import ArchConfig

ARCH_IDS = (
    "recurrentgemma_9b", "phi4_mini_3_8b", "qwen3_4b", "glm4_9b",
    "qwen2_5_3b", "xlstm_350m", "mixtral_8x22b", "phi3_5_moe",
    "llama32_vision_11b", "hubert_xlarge",
)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str, reduced: bool = False) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f".{arch_id}", __package__)
    return mod.reduced() if reduced else mod.full()


def all_configs(reduced: bool = False) -> List[ArchConfig]:
    return [get_config(a, reduced) for a in ARCH_IDS]


def cell_runnable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell.
    Skips are inherent architecture properties (DESIGN.md §4)."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k":
        if not cfg.is_decoder:
            return False, "encoder-only: no decode"
        if not cfg.sub_quadratic:
            return False, ("pure full-attention arch: 500k decode requires "
                           "sub-quadratic attention (skip per brief)")
    return True, ""
