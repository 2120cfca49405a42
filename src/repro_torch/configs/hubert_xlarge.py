"""hubert-xlarge [audio]: encoder-only (no decode shapes). Modality
frontend is a STUB: input_specs() provides precomputed frame embeddings.
[arXiv:2106.07447; unverified]"""
from ..models import ArchConfig

_BASE = dict(name="hubert_xlarge", family="audio", causal=False,
             frontend="audio", loss="frame_ce", gated_mlp=False,
             rope=False)


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
        d_ff=5120, vocab_size=504, frontend_dim=512, **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, head_dim=8,
        d_ff=64, vocab_size=96, frontend_dim=16, dtype="float32", **_BASE)
