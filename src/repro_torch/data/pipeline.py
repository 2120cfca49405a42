"""Deterministic synthetic token pipeline; counterpart of
``repro/data/pipeline.py``, the same numpy code, so its batches are the
reference's bit for bit.

Stateless by step: batch(step) is a pure function of (seed, step,
shard), so a resume is bit-exact (the checkpoint only needs the step
counter; ``train/loop.py`` calls ``seek``), and every process makes
exactly its own shard without coordination. The process index and count
come from ``torch.distributed`` when it is initialized, else 0 and 1.

Token stream: a Zipfian unigram mixture with Markov bigram structure so
the LM loss actually decreases (pure uniform noise would pin CE at
log V). Labels = next token (the loss shifts internally). Batches are
numpy arrays; the train step moves them to its device.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..models import ArchConfig


def _process_index_count():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class SyntheticTokenPipeline:
    def __init__(self, cfg: ArchConfig, global_batch: int, seq_len: int,
                 seed: int = 0, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.cfg = cfg
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.seed = seed
        pi, pc = _process_index_count()
        self.pi = pi if process_index is None else process_index
        self.pc = pc if process_count is None else process_count
        assert global_batch % self.pc == 0
        self.local_batch = global_batch // self.pc
        self.step = 0
        v = cfg.vocab_size
        rng = np.random.default_rng(seed)
        # fixed Markov structure shared by all hosts
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._succ = rng.integers(0, v, size=(v, 4))  # 4 likely successors

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def seek(self, step: int) -> None:
        self.step = step

    def _tokens(self, step: int) -> np.ndarray:
        v = self.cfg.vocab_size
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.pi)
        B, S = self.local_batch, self.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.choice(v, size=B, p=self._unigram)
        follow = rng.random((B, S)) < 0.75
        succ_pick = rng.integers(0, 4, size=(B, S))
        fresh = rng.choice(v, size=(B, S), p=self._unigram)
        for t in range(1, S):
            nxt = self._succ[toks[:, t - 1], succ_pick[:, t]]
            toks[:, t] = np.where(follow[:, t], nxt, fresh[:, t])
        return toks

    def next_batch(self) -> Dict[str, np.ndarray]:
        toks = self._tokens(self.step)
        self.step += 1
        batch = {"tokens": toks, "labels": toks.copy()}
        cfg = self.cfg
        if cfg.frontend == "audio":
            rng = np.random.default_rng(self.seed + self.step)
            batch = {
                "frames": rng.standard_normal(
                    (self.local_batch, self.seq_len, cfg.frontend_dim)
                ).astype(np.float32),
                "labels": toks,
            }
        if cfg.frontend == "vision":
            rng = np.random.default_rng(self.seed + self.step)
            batch["image_embeds"] = rng.standard_normal(
                (self.local_batch, cfg.n_img_tokens, cfg.d_vision)
            ).astype(np.float32)
        return batch


def make_batch_specs(cfg: ArchConfig, global_batch: int, seq_len: int,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """Shape-and-type stand-ins for one global batch: tensors on the
    ``meta`` device (the reference's ``jax.ShapeDtypeStruct``s)."""
    dt = dtype or cfg.torch_dtype

    def spec(shape, t):
        return torch.empty(shape, dtype=t, device="meta")
    specs = {}
    if cfg.frontend == "audio":
        specs["frames"] = spec((global_batch, seq_len, cfg.frontend_dim), dt)
    else:
        specs["tokens"] = spec((global_batch, seq_len), torch.int32)
    specs["labels"] = spec((global_batch, seq_len), torch.int32)
    if cfg.frontend == "vision":
        specs["image_embeds"] = spec(
            (global_batch, cfg.n_img_tokens, cfg.d_vision), dt)
    return specs
