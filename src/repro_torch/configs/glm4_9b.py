"""glm4-9b [dense]: RoPE, GQA kv=2. [hf:THUDM/glm-4-9b; hf]"""
from ..models import ArchConfig

_BASE = dict(name="glm4_9b", family="dense")


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab_size=151552, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, dtype="float32", **_BASE)
