"""xlstm-350m [ssm]: alternating sLSTM + mLSTM blocks.
[arXiv:2405.04517; unverified]"""
from ..models import ArchConfig

_BASE = dict(name="xlstm_350m", family="ssm", pattern=("slstm", "mlstm"),
             rope=False)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, head_dim=256,
        d_ff=0, vocab_size=50304, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
        d_ff=0, vocab_size=128, dtype="float32", **_BASE)
