"""qwen2.5-3b [dense]: GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B; hf]"""
from ..models import ArchConfig

_BASE = dict(name="qwen2_5_3b", family="dense", qkv_bias=True)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, head_dim=128,
        d_ff=11008, vocab_size=151936, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, dtype="float32", **_BASE)
