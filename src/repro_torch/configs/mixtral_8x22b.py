"""mixtral-8x22b [moe]: 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from ..models import ArchConfig

_BASE = dict(name="mixtral_8x22b", family="moe", n_experts=8, top_k=2,
             window=4096)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=32768, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, dtype="float32",
        **{**_BASE, "n_experts": 4, "window": 16})
