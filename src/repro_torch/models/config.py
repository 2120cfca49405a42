"""Architecture config of the assigned LM architectures; counterpart of
``repro/models/config.py``, field for field (``torch_dtype`` replaces
``jnp_dtype``)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[str, ...] = ("attn",)   # block kinds, tiled over depth
    # MoE
    n_experts: int = 1
    top_k: int = 1
    capacity_factor: float = 1.25
    # attention details
    rope: bool = True
    rope_theta: float = 10000.0
    qk_norm: bool = False
    qkv_bias: bool = False
    window: int = 0               # sliding window for "attn" blocks (0=full)
    local_window: int = 2048      # window for "local_attn" blocks
    causal: bool = True           # False => encoder (bidirectional)
    # recurrent
    rnn_width: int = 0            # RG-LRU width (default d_model)
    conv1d_size: int = 4
    # modality frontend (stub: precomputed embeddings via input_specs)
    frontend: str = "none"        # none | audio | vision
    frontend_dim: int = 512       # audio frame feature dim
    n_img_tokens: int = 1024      # vision token count
    d_vision: int = 1024          # vision embedding dim
    # misc
    gated_mlp: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    kv_quant: bool = False        # int8 KV cache (per-slot/kv-head scales)
    loss: str = "clm"             # clm | frame_ce
    # citation tag from the assignment table
    source: str = ""

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def is_decoder(self) -> bool:
        return self.causal

    @property
    def sub_quadratic(self) -> bool:
        """True if decoding at 500k context is O(1)-state or windowed."""
        kinds = set(self.pattern)
        full_attn = "attn" in kinds and self.window == 0
        full_attn |= "cross_attn" in kinds and self.window == 0
        return not full_attn

    def layout(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.pattern))
        return (self.pattern * reps)[: self.n_layers]

    def schedule(self):
        """(pattern, n_full_periods, remainder_kinds) for scan grouping."""
        m = len(self.pattern)
        n_full = self.n_layers // m
        rem = self.layout()[n_full * m:]
        return self.pattern, n_full, rem

    @property
    def rnn_w(self) -> int:
        return self.rnn_width or self.d_model

    def param_count(self) -> float:
        """Analytic parameter count (for 6ND roofline math)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        dht = self.n_heads * self.head_dim
        dkv = self.n_kv_heads * self.head_dim
        total = v * d  # embed
        if self.frontend == "audio":
            total += self.frontend_dim * d
        if self.frontend == "vision":
            total += self.d_vision * d
        for kind in self.layout():
            if kind in ("attn", "local_attn"):
                total += d * (dht + 2 * dkv) + dht * d
            elif kind == "cross_attn":
                total += d * dht + 2 * self.d_vision * dkv + dht * d
            elif kind == "rglru":
                w = self.rnn_w
                total += d * 2 * w + w * d + self.conv1d_size * w + 5 * w
            elif kind in ("mlstm", "slstm"):
                w = 2 * d
                total += d * 2 * w + 3 * w * w + w * d
                continue  # no separate FFN
            if self.n_experts > 1:
                total += d * self.n_experts + self.n_experts * 3 * d * ff
            elif ff:
                total += d * ff * (2 if self.gated_mlp else 1) + ff * d
        total += v * d  # unembed
        return float(total)

    def active_param_count(self) -> float:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.n_experts <= 1:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dead = (self.n_experts - self.top_k) * 3 * d * ff
        return self.param_count() - dead * len(
            [k for k in self.layout() if k not in ("rglru", "mlstm", "slstm")])
