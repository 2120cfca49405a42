"""Batched serving engine with continuous batching; counterpart of
``repro/serve/engine.py``.

Fixed-slot design (vLLM-style, without paging): ``n_slots`` concurrent
sequences share one decode step; finished sequences free their slot and
queued requests are prefilled into it. Prefill is per request (batch 1;
its cache is copied into the slot, every tensor of every layer's dict
along its batch axis: KV caches and their positions and scales, the
RG-LRU's h and conv window, the mLSTM's C, n, m and the sLSTM's c, n,
m, h); decode is one step for all slots every iteration. Decoding is greedy (the first maximum, as
``jnp.argmax``); ``greedy`` and ``seed`` are taken and kept as the
reference takes them (its ``greedy`` selects nothing else and its key
from ``seed`` is never used), so a call that passes them runs in both.

``stats`` counts what the engine did, for the serving report: prefill
and decode wall seconds (host clock; each phase ends in a device-to-host
read of its tokens, so the device work is inside the interval), prefill
tokens (prompt lengths) and decode tokens (one per active slot per
step).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import ArchConfig
from ..models.transformer import LM, decode_step, init_cache, prefill


@dataclasses.dataclass
class LMRequest:
    """One LM generation request."""
    rid: int
    prompt: np.ndarray               # (S,) integer tokens
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine
    output: Optional[List[int]] = None


class ServeEngine:
    def __init__(self, params: LM, cfg: ArchConfig, n_slots: int = 4,
                 max_len: int = 256, greedy: bool = True, seed: int = 0,
                 device: DeviceLike = "cuda"):
        if not cfg.is_decoder:
            raise ValueError(f"{cfg.name} is encoder-only and cannot be "
                             "served")
        self.device = resolve_device(device)
        on = params.embed.device
        if (on.type, on.index) != (self.device.type, self.device.index):
            raise ValueError(f"params are on {on}, the engine on "
                             f"{self.device}")
        self.params, self.cfg = params, cfg
        self.n_slots, self.max_len = n_slots, max_len
        # the reference's sampling arguments, kept as it keeps them: decode
        # is argmax there too, and its key is never split
        self.greedy, self.seed = greedy, seed
        self.cache = init_cache(cfg, n_slots, max_len, self.device)
        self.positions = np.zeros((n_slots,), np.int64)
        self.active = np.zeros((n_slots,), bool)
        self.slot_req: List[Optional[LMRequest]] = [None] * n_slots
        self.queue: Deque[LMRequest] = deque()
        self.done: Dict[int, LMRequest] = {}
        self.stats = {"prefill_s": 0.0, "prefill_tokens": 0,
                      "decode_s": 0.0, "decode_tokens": 0,
                      "decode_steps": 0}

    # -- public API ---------------------------------------------------------
    def submit(self, req: LMRequest) -> None:
        self.queue.append(req)

    @torch.inference_mode()
    def run(self, max_iters: int = 10_000) -> Dict[int, LMRequest]:
        it = 0
        while (self.queue or self.active.any()) and it < max_iters:
            self._admit()
            self._step()
            it += 1
        return self.done

    # -- internals ----------------------------------------------------------
    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.active[slot] or not self.queue:
                continue
            req = self.queue.popleft()
            req.output = []
            t0 = time.perf_counter()
            tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                     dtype=torch.long, device=self.device)
            last_logits, pcache = prefill(self.params, self.cfg,
                                          {"tokens": tokens},
                                          cache_len=self.max_len)
            self._write_slot(slot, pcache)
            tok = int(torch.argmax(last_logits[0]))
            self.stats["prefill_s"] += time.perf_counter() - t0
            self.stats["prefill_tokens"] += len(req.prompt)
            req.output.append(tok)
            self.slot_req[slot] = req
            self.positions[slot] = len(req.prompt)
            self.active[slot] = True

    def _write_slot(self, slot: int, pcache) -> None:
        """Copy a batch-1 prefill cache into slot ``slot`` of the shared
        cache, layer by layer: row 0 of each tensor into row ``slot``
        (a recurrent layer's whole state, as its KV cache)."""
        for dst, src in zip(self.cache, pcache):
            for name, t in dst.items():
                t[slot] = src[name][0]

    def _step(self) -> None:
        if not self.active.any():
            return
        t0 = time.perf_counter()
        toks = np.zeros((self.n_slots, 1), np.int64)
        for slot in range(self.n_slots):
            if self.active[slot] and self.slot_req[slot].output:
                toks[slot, 0] = self.slot_req[slot].output[-1]
        logits, self.cache = decode_step(
            self.params, self.cfg, torch.as_tensor(toks, device=self.device),
            self.cache, torch.as_tensor(self.positions, device=self.device))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["decode_tokens"] += int(self.active.sum())
        self.stats["decode_steps"] += 1
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            req = self.slot_req[slot]
            tok = int(nxt[slot])
            req.output.append(tok)
            self.positions[slot] += 1
            hit_eos = req.eos_id is not None and tok == req.eos_id
            full = len(req.output) >= req.max_new_tokens
            oom = self.positions[slot] >= self.max_len - 1
            if hit_eos or full or oom:
                self.active[slot] = False
                self.slot_req[slot] = None
                self.done[req.rid] = req
