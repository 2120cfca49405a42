"""phi3.5-moe-42b-a6.6b [moe]: 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from ..models import ArchConfig

_BASE = dict(name="phi3_5_moe", family="moe", n_experts=16, top_k=2)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, dtype="float32",
        **{**_BASE, "n_experts": 4})
