"""llama-3.2-vision-11b [vlm]: cross-attn image layers every 5th layer.
Modality frontend is a STUB: input_specs() provides precomputed patch
embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from ..models import ArchConfig

_BASE = dict(name="llama32_vision_11b", family="vlm",
             pattern=("attn", "attn", "attn", "cross_attn", "attn"),
             frontend="vision")


def full() -> ArchConfig:
    return ArchConfig(
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=128256, n_img_tokens=1600, d_vision=4096,
        **_BASE)


def reduced() -> ArchConfig:
    return ArchConfig(
        n_layers=5, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
        d_ff=64, vocab_size=128, n_img_tokens=8, d_vision=16,
        dtype="float32", **_BASE)
