"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1:2 pattern.
[arXiv:2402.19427; unverified]"""
from ..models import ArchConfig

_BASE = dict(
    name="recurrentgemma_9b", family="hybrid",
    pattern=("rglru", "rglru", "local_attn"),
)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab_size=256000, rnn_width=4096, local_window=2048,
        gated_mlp=True, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=128, rnn_width=64, local_window=16,
        dtype="float32", **_BASE)
