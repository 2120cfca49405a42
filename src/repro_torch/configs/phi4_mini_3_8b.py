"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from ..models import ArchConfig

_BASE = dict(name="phi4_mini_3_8b", family="dense")


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=200064, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=48, n_heads=6, n_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=128, dtype="float32", **_BASE)
