"""qwen3-4b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from ..models import ArchConfig

_BASE = dict(name="qwen3_4b", family="dense", qk_norm=True)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=9728, vocab_size=151936, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, dtype="float32", **_BASE)
