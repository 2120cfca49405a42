"""The LM; counterpart of ``repro/models/transformer.py`` for the block
kinds ``attn``, ``local_attn`` (qwen3-4b, qwen2.5-3b, glm4-9b,
phi4-mini: dense GQA with optional QKV bias and q/k norm; hubert-xlarge's
bidirectional encoder), ``cross_attn`` (llama-3.2-vision's gated image
layers), ``rglru`` (recurrentgemma-9b's RG-LRU blocks beside its local
attention), the top-k mixture-of-experts FFN (``moe.py``: phi3.5-moe,
mixtral-8x22b) and ``mlstm``, ``slstm`` (xlstm-350m's alternating xLSTM
blocks, which have no FFN; their recurrences are the scan kernels
``kernels/mlstm_scan.py`` and ``kernels/slstm_scan.py``), with the
vision and audio frontends, which take precomputed embeddings.

Parameters are an ``LM`` module: ``embed``, ``final_ln``, ``unembed``,
``frontend`` (frontend_dim, d) for the audio frontend and ``vis_proj``
(d_vision, d_vision) for the vision one, and ``blocks``, an
``nn.ModuleList`` with one ``Block`` per layer in layer order. The
reference stacks each pattern position's blocks over depth
(``period/pos{i}``) for its ``lax.scan``; here depth is a Python
loop, so the layers are a plain list and ``convert.
from_reference_lm_params`` unstacks them. The model serves and trains:
parameters take gradients after ``LM.train()`` (``init_params`` returns
the serving mode, gradients off), and ``forward`` in the train
mode recomputes each period block in the backward pass (``torch.utils.
checkpoint``, one per block, as the reference's ``jax.checkpoint``),
carrying each block's auxiliary loss. Attention's gradient is the
hand-written backward kernel (``kernels/ops.FlashAttention``), the
RG-LRU scan's ``csrc/rglru_scan_bwd.cu`` (``kernels/rglru_scan.py``).

The cache is a list with one dict per layer. An attention layer's:
``k``, ``v`` (B, cap, KV, hd) in the model's type, or int8 with
``k_scale``, ``v_scale`` (B, cap, KV) float32 when ``cfg.kv_quant``
(symmetric per slot and KV head, ``_kv_quantize``); ``pos`` (B, cap)
int64, -1 = empty. An ``rglru`` layer's: ``h`` (B, w) float32 and
``conv`` (B, conv1d_size - 1, w) in the model's type. An ``mlstm``
layer's: ``C`` (B, H, hd, hd), ``n`` (B, H, hd), ``m`` (B, H) float32
with hd = 2 d / H; an ``slstm`` layer's: ``c``, ``n``, ``m``, ``h``
(B, d) float32 (m starts at -1e30 in both). A ``cross_attn`` layer's:
``k``, ``v`` (B, n_img_tokens, KV, hd) in the model's type, the image
keys and values that prefill computes and decode reads. Prefill and decode
write it in place (the reference returns a new pytree; in place saves a
copy of the whole cache per step) and return the same list. The slot
rules are the reference's: position p lives in slot ``p % cap`` for
windowed layers (a ring buffer) and in slot ``min(p, cap - 1)`` for full
ones.

Three modes share one block implementation:
  train   — full sequence, no cache (blockwise attention; the xLSTM
            scans from the zero state)
  prefill — full sequence, fills the cache
  decode  — one token, reads and updates the cache

Types follow the reference's promotion: every product goes through
``layers.matmul``, so float32 inputs against bfloat16 weights (the data
pipeline's float32 ``frames`` and ``image_embeds``) give float32
products, as ``jnp.matmul`` does. A bfloat16 hubert fed float32 frames
thus runs its whole trunk in float32 (attention on the flash kernels'
float32 route); ``image_embeds @ vis_proj`` is cast to the model's type,
as the reference casts it.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from ..kernels.decode_attention import inv_sqrt_hd
from ..kernels.mlstm_scan import M_INIT
from . import recurrent as rec
from .attention import (blockwise_attention, cross_attention,
                        decode_attention)
from .config import ArchConfig
from .layers import (MLP, apply_rope, cross_entropy, dense_init, matmul,
                     mlp, rms_norm, spec_for, zeros_param)
from .moe import MoE, moe_ffn
from ..parallel.sharding import PartitionSpec
from ..parallel.tensor_parallel import current_split

MOE_AUX_WEIGHT = 0.01
PORTED_KINDS = ("attn", "local_attn", "cross_attn", "rglru", "mlstm",
                "slstm")
# block kinds without the pre-norm dense FFN (xLSTM's blocks)
_NO_FFN = ("mlstm", "slstm")
# an rglru block's float32 (w,) gate and decay leaves and their init values
_LRU_INIT = (("a_param", 0.5), ("alpha_i", 1.0), ("beta_i", 0.0),
             ("alpha_r", 1.0), ("beta_r", 0.0))

Cache = List[Dict[str, torch.Tensor]]


def _check_ported(cfg: ArchConfig, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(kind)


# ---------------------------------------------------------------------------
# Block init
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One block. ``attn``/``local_attn``: pre-norm attention (``ln``,
    ``wq``, ``wk``, ``wv``, ``wo``; ``bq``/``bk``/``bv`` with QKV bias;
    ``q_norm``/``k_norm`` with q/k norm). ``cross_attn``: the same
    attention over the image tokens (``wk``, ``wv`` take d_vision
    inputs), gated by ``gate_attn`` and its FFN by ``gate_mlp``, 0-dim
    float32 parameters that start at 0 (so a fresh model's image layers
    add nothing). ``rglru``: pre-norm RG-LRU
    mixer (``ln``, ``w_in`` (d, 2w) for the branch and its gate, ``conv``
    (conv1d_size, w) float32 taps, ``lru`` the five float32 (w,) leaves
    ``a_param`` 0.5, ``alpha_i`` 1, ``beta_i`` 0, ``alpha_r`` 1,
    ``beta_r`` 0, ``w_out`` (w, d)). Both then a pre-norm dense FFN
    (``ln2``, ``ffn``). ``mlstm``: pre-norm mLSTM mixer of width w = 2d
    and H heads of w / H (``ln``, ``w_up`` (d, 2w) for the branch and its
    gate, ``wq``/``wk``/``wv`` (w, w), ``w_if`` (w, 2H) for the input and
    forget gates, ``w_down`` (w, d)); ``slstm``: pre-norm sLSTM mixer of
    width d (``ln``, ``w_gates`` (d, 4d), ``r`` (d, 4) float32 recurrent
    weights drawn as 0.1 x normal, ``w_out`` (d, d)); the xLSTM blocks
    have no FFN. Norm gains, biases and gates start at zero, as in the
    reference. With ``cfg.n_experts > 1`` the FFN is a ``MoE``
    (``router``, ``gate``, ``up``, ``down``)."""

    def __init__(self, gen: torch.Generator, cfg: ArchConfig, kind: str):
        super().__init__()
        _check_ported(cfg, kind)
        d, dt, dev = cfg.d_model, cfg.torch_dtype, gen.device
        self.ln = zeros_param((d,), dt, dev)
        if kind == "rglru":
            self._init_rglru(gen, cfg)
        elif kind == "mlstm":
            self._init_mlstm(gen, cfg)
        elif kind == "slstm":
            self._init_slstm(gen, cfg)
        else:
            self._init_attn(gen, cfg, kind)
        if kind not in _NO_FFN:
            self.ln2 = zeros_param((d,), dt, dev)
            if cfg.n_experts > 1:
                self.ffn = MoE(gen, d, cfg.d_ff, cfg.n_experts, dt)
            else:
                self.ffn = MLP(gen, d, cfg.d_ff, cfg.gated_mlp, dt)

    def _init_mlstm(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        d, dt, H = cfg.d_model, cfg.torch_dtype, cfg.n_heads
        w = 2 * d
        self.w_up = dense_init(gen, d, 2 * w, dt)
        self.wq = dense_init(gen, w, w, dt)
        self.wk = dense_init(gen, w, w, dt)
        self.wv = dense_init(gen, w, w, dt)
        self.w_if = dense_init(gen, w, 2 * H, dt)
        self.w_down = dense_init(gen, w, d, dt)

    def _init_slstm(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        d, dt = cfg.d_model, cfg.torch_dtype
        self.w_gates = dense_init(gen, d, 4 * d, dt)
        self.r = nn.Parameter(
            torch.randn((d, 4), generator=gen, device=gen.device,
                        dtype=torch.float32) * 0.1, requires_grad=False)
        self.w_out = dense_init(gen, d, d, dt)

    def _init_rglru(self, gen: torch.Generator, cfg: ArchConfig) -> None:
        d, dt, dev, w = cfg.d_model, cfg.torch_dtype, gen.device, cfg.rnn_w
        f32 = dict(dtype=torch.float32, device=dev)
        self.w_in = dense_init(gen, d, 2 * w, dt)
        self.w_out = dense_init(gen, w, d, dt)
        self.conv = nn.Parameter(
            torch.randn((cfg.conv1d_size, w), generator=gen, **f32) * 0.1,
            requires_grad=False)
        self.lru = nn.ParameterDict({
            name: nn.Parameter(torch.full((w,), value, **f32),
                               requires_grad=False)
            for name, value in _LRU_INIT})

    def _init_attn(self, gen: torch.Generator, cfg: ArchConfig,
                   kind: str) -> None:
        d, dt, dev = cfg.d_model, cfg.torch_dtype, gen.device
        dht = cfg.n_heads * cfg.head_dim
        dkv = cfg.n_kv_heads * cfg.head_dim
        kv_src = cfg.d_vision if kind == "cross_attn" else d
        self.wq = dense_init(gen, d, dht, dt)
        self.wk = dense_init(gen, kv_src, dkv, dt)
        self.wv = dense_init(gen, kv_src, dkv, dt)
        self.wo = dense_init(gen, dht, d, dt)
        if cfg.qkv_bias:
            self.bq = zeros_param((dht,), dt, dev)
            self.bk = zeros_param((dkv,), dt, dev)
            self.bv = zeros_param((dkv,), dt, dev)
        if cfg.qk_norm:
            self.q_norm = zeros_param((cfg.head_dim,), dt, dev)
            self.k_norm = zeros_param((cfg.head_dim,), dt, dev)
        if kind == "cross_attn":
            self.gate_attn = zeros_param((), torch.float32, dev)
            self.gate_mlp = zeros_param((), torch.float32, dev)

    @staticmethod
    def shard_dims(cfg: ArchConfig, kind: str,
                   n_shards: int) -> Dict[str, int]:
        """The model-axis dim of each sharded leaf of a ``kind`` block
        (dotted names under the block; a leaf not named is replicated:
        norm gains, biases, gates, ``w_if``, ``r``), the reference's
        ``init_block`` specs. Attention shards its heads (wq's columns,
        wo's rows) when they divide by ``n_shards``, else d_model."""
        _check_ported(cfg, kind)
        if kind == "rglru":
            dims = {"w_in": 1, "w_out": 0, "conv": 1,
                    **{f"lru.{name}": 0 for name, _ in _LRU_INIT}}
        elif kind == "mlstm":
            dims = {"w_up": 1, "wq": 1, "wk": 1, "wv": 1, "w_down": 0}
        elif kind == "slstm":
            dims = {"w_gates": 1, "w_out": 0}
        else:
            heads = n_shards > 0 and cfg.n_heads % n_shards == 0
            dims = {"wq": 1 if heads else 0, "wk": 0, "wv": 0,
                    "wo": 0 if heads else 1}
        if kind not in _NO_FFN:
            ffn = MoE if cfg.n_experts > 1 else MLP
            dims.update({f"ffn.{n}": d for n, d in ffn.SHARD_DIMS.items()})
        return dims


def init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> Block:
    return Block(gen, cfg, kind)


def init_cache_block(cfg: ArchConfig, kind: str, B: int, cache_len: int,
                     device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """Empty cache of one block (windowed layers keep only the window; the
    int8 cache and its scales under ``cfg.kv_quant``; a ``cross_attn``
    block's image keys and values; an ``rglru`` block's state and conv
    window; an ``mlstm`` or ``slstm`` block's zero state, m at -1e30), on
    the card unless ``device`` says otherwise; raises without one."""
    _check_ported(cfg, kind)
    device = resolve_device(device)
    if kind == "cross_attn":
        shape = (B, cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                for n in ("k", "v")}
    if kind == "mlstm":
        H = cfg.n_heads
        return rec.mlstm_init_state(B, H, _mlstm_width(cfg) // H,
                                    device)._asdict()
    if kind == "slstm":
        return rec.slstm_init_state(B, cfg.d_model, device)._asdict()
    if kind == "rglru":
        w = cfg.rnn_w
        return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
                "conv": torch.zeros((B, cfg.conv1d_size - 1, w),
                                    dtype=cfg.torch_dtype, device=device)}
    if kind == "attn" and cfg.window:
        cache_len = min(cache_len, cfg.window)
    if kind == "local_attn":
        cache_len = min(cache_len, cfg.local_window)
    shape = (B, cache_len, cfg.n_kv_heads, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.kv_quant else cfg.torch_dtype
    cache = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    cache["pos"] = torch.full((B, cache_len), -1, dtype=torch.long,
                              device=device)
    return cache


# ---------------------------------------------------------------------------
# Block apply
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[0], x.shape[1], n, hd)


# float32(1 / 127): XLA turns the reference's division by the constant 127
# into a product with its float32 reciprocal under jit, as its engine and
# model functions run
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., KV, hd) -> (int8 values, per-(..., KV) float32 scale):
    symmetric per slot and KV head, scale = max|x| / 127 (at least
    1e-10), values round(x / scale) (half to even, as ``jnp.round``)
    clipped to [-127, 127]. Bit for bit the reference's jitted
    ``_kv_quantize``."""
    xf = x.float()
    scale = torch.clamp(torch.amax(torch.abs(xf), dim=-1) * _INV_127,
                        min=1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _write_kv(cfg: ArchConfig, cache: Dict[str, torch.Tensor], bidx,
              slots, k: torch.Tensor, v: torch.Tensor,
              pos: torch.Tensor) -> None:
    """Write k, v and their positions into the cache's slots in place,
    quantised first under ``cfg.kv_quant``."""
    if cfg.kv_quant:
        k, k_scale = _kv_quantize(k)
        v, v_scale = _kv_quantize(v)
        cache["k_scale"][bidx, slots] = k_scale
        cache["v_scale"][bidx, slots] = v_scale
    # a float32 trunk (float32 frames in a bfloat16 model) writes into the
    # cache's type, as the reference's ``.at[].set`` casts
    cache["k"][bidx, slots] = k.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = pos


def _attn_qkv(p: Block, cfg: ArchConfig, x: torch.Tensor,
              kv_input: torch.Tensor):
    q = matmul(x, p.wq)
    k = matmul(kv_input, p.wk)
    v = matmul(kv_input, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = _split_heads(q, cfg.n_heads, cfg.head_dim)
    k = _split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _ffn_apply(p, cfg: ArchConfig, x: torch.Tensor, mode: str):
    """The block's FFN: (y, aux). A ``MoE`` routes with drop-free
    capacity in decode (T is the batch there), as the reference."""
    if isinstance(p, MoE):
        return moe_ffn(p, x, cfg.top_k, cfg.capacity_factor,
                       drop_free=(mode == "decode"))
    return mlp(p, x), 0.0


def apply_block(cfg: ArchConfig, kind: str, p: Block, x: torch.Tensor, *,
                mode: str, cache: Optional[Dict[str, torch.Tensor]] = None,
                vis_embeds: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None, split=None):
    """x: (B, S, d). Returns (x, cache, aux_loss); ``cache`` is updated in
    place in the prefill and decode modes. ``vis_embeds`` (B,
    n_img_tokens, d_vision) feeds a ``cross_attn`` block's keys and
    values in the train and prefill modes. With ``split`` (a
    ``parallel.tensor_parallel.ModelSplit``) ``p`` holds this rank's
    shards and the block runs split over the model axis
    (``models/split.py``)."""
    _check_ported(cfg, kind)
    if split is not None:
        from . import split as _split
        return _split.apply_block(cfg, kind, p, x, mode=mode, cache=cache,
                                  vis_embeds=vis_embeds,
                                  positions=positions, split=split)
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if kind in _NO_FFN:
        mix = _mlstm_mix if kind == "mlstm" else _slstm_mix
        return x + mix(cfg, p, h, mode, cache), cache, 0.0
    if kind == "cross_attn":
        gate = torch.tanh(p.gate_attn).to(x.dtype)
        x = x + gate * _cross_mix(cfg, p, h, mode, cache, vis_embeds)
        y, aux = _ffn_apply(p.ffn, cfg, rms_norm(x, p.ln2, cfg.norm_eps),
                            mode)
        return x + torch.tanh(p.gate_mlp).to(x.dtype) * y, cache, aux
    if kind == "rglru":
        x = x + _rglru_mix(cfg, p, h, mode, cache)
    else:
        x = x + _attn_mix(cfg, kind, p, h, mode, cache, positions)
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    y, aux = _ffn_apply(p.ffn, cfg, h2, mode)
    return x + y, cache, aux


def _attn_window(cfg: ArchConfig, kind: str) -> int:
    return cfg.local_window if kind == "local_attn" else cfg.window


def _rope_and_cache(cfg: ArchConfig, window: int, q: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, mode: str, cache,
                    positions: torch.Tensor):
    """RoPE on q and k (B, S, heads, hd), and in the prefill and decode
    modes k and v written into the cache: decode's one position into its
    slot, prefill's last positions that fit into theirs. Returns (q,
    k)."""
    B, S = q.shape[0], q.shape[1]
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
        cap = cache["k"].shape[1]
        pos = positions[:, 0]
        if window > 0:          # ring buffer for windowed layers
            slot = pos % cap
        else:                   # full cache sized to max position
            slot = torch.clamp(pos, max=cap - 1)
        _write_kv(cfg, cache, torch.arange(B, device=q.device), slot,
                  k[:, 0], v[:, 0], pos)
    elif mode == "prefill":
        cap = cache["k"].shape[1]
        take = min(cap, S)
        # ring-buffer invariant: position p lives in slot p % cap, so
        # decode's writes land consistently
        slots = positions[:, S - take:] % cap            # (B, take)
        _write_kv(cfg, cache, torch.arange(B, device=q.device)[:, None],
                  slots, k[:, S - take:], v[:, S - take:],
                  positions[:, S - take:])
    return q, k


def _attn_mix(cfg: ArchConfig, kind: str, p: Block, h: torch.Tensor,
              mode: str, cache, positions) -> torch.Tensor:
    """The attention branch's output projection, (B, S, d)."""
    B, S, _ = h.shape
    window = _attn_window(cfg, kind)
    q, k, v = _attn_qkv(p, cfg, h, h)
    q, k = _rope_and_cache(cfg, window, q, k, v, mode, cache, positions)
    if mode == "decode":
        o = decode_attention(q, cache["k"], cache["v"], cache["pos"],
                             positions[:, 0], window=window,
                             k_scale=cache.get("k_scale"),
                             v_scale=cache.get("v_scale"))
    else:
        # prefill attends over the unquantised k and v, as the reference
        o = blockwise_attention(q, k, v, causal=cfg.causal, window=window)
    return matmul(o.reshape(B, S, -1), p.wo)


def _cross_mix(cfg: ArchConfig, p: Block, h: torch.Tensor, mode: str,
               cache, vis: Optional[torch.Tensor]) -> torch.Tensor:
    """The cross-attention branch's output projection, (B, S, d), before
    its gate. Train and prefill project the image tokens ``vis`` to k and
    v (prefill stores them in the cache); decode reads them from the
    cache, and its q is ``h @ wq`` alone, without the bias or q norm
    that ``_attn_qkv`` applies in the other modes, as the reference."""
    B, S, _ = h.shape
    if mode == "decode":
        q = _split_heads(matmul(h, p.wq), cfg.n_heads, cfg.head_dim)
        o = cross_attention(q, cache["k"], cache["v"], decode=True)
    else:
        q, k, v = _attn_qkv(p, cfg, h, vis)
        if mode == "prefill":
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        o = cross_attention(q, k, v)
    return matmul(o.reshape(B, S, -1), p.wo)


def _rglru_mix(cfg: ArchConfig, p: Block, h: torch.Tensor, mode: str,
               cache) -> torch.Tensor:
    """The RG-LRU branch's output projection, (B, S, d): the conv and
    the recurrence on one half of ``w_in``'s output, gated by GELU of the
    other. Prefill stores the last h rounded to the model's type, then
    float32, and the last W - 1 inputs of the conv (the zero state stays
    when S < W - 1), as the reference; decode stores the unrounded
    float32 h."""
    w = cfg.rnn_w
    xin = h @ p.w_in
    xr, gate = xin[..., :w], xin[..., w:]
    if mode == "decode":
        xr1, conv_state = rec.causal_conv1d_step(xr[:, 0], cache["conv"],
                                                 p.conv)
        h_new, h_f32 = rec.rglru_step(xr1, cache["h"], p.lru)
        o = h_new[:, None] * F.gelu(gate, approximate="tanh")
        cache["h"].copy_(h_f32)
        cache["conv"].copy_(conv_state)
    else:
        hseq = rec.rglru_sequence(rec.causal_conv1d(xr, p.conv), p.lru)
        o = hseq * F.gelu(gate, approximate="tanh")
        if mode == "prefill":
            W, S = cfg.conv1d_size, h.shape[1]
            cache["h"].copy_(hseq[:, -1].float())
            if S >= W - 1:
                cache["conv"].copy_(xr[:, S - (W - 1):].to(cfg.torch_dtype))
    return o @ p.w_out


# the cache leaves of the xLSTM scans' states, in their fields' order
MLSTM_STATE = ("C", "n", "m")
SLSTM_STATE = ("c", "n", "m", "h")


def _mlstm_width(cfg: ArchConfig) -> int:
    """The mLSTM block's width w = 2 d; its heads are w / H wide (512 at
    xlstm-350m's full width, not ``cfg.head_dim``)."""
    return 2 * cfg.d_model


def _fresh_state(cache: Dict[str, torch.Tensor]) -> None:
    """Put a cache's xLSTM state back to the zero state (m at -1e30) in
    place: prefill starts from it whatever the cache held, as the
    reference's."""
    for name, t in cache.items():
        if name == "m":
            t.fill_(M_INIT)
        else:
            t.zero_()


def _scan_state(cache, mode: str, state_cls, names, part=None):
    """The state an xLSTM scan starts from: None in the train mode (the
    zero state), else the cache's leaves ``names`` (put back to the zero
    state first in prefill), the scan updating them in place; with
    ``part`` (lo, hi), a contiguous copy of their slice [lo, hi) of dim
    1 instead (a rank's heads or channels)."""
    if mode == "train":
        return None
    if mode == "prefill":
        _fresh_state(cache)
    if part is None:
        return state_cls(*(cache[n] for n in names))
    lo, hi = part
    return state_cls(*(cache[n][:, lo:hi].contiguous() for n in names))


def _mlstm_mix(cfg: ArchConfig, p: Block, h: torch.Tensor, mode: str,
               cache) -> torch.Tensor:
    """The mLSTM branch's output projection, (B, S, d): q, k, v and the
    gate pre-activations from one half of ``w_up``'s output, the scan
    from the zero state (train, prefill: the cache's state, left holding
    the final state) or from the cache (decode: one step), gated by SiLU
    of the other half. The reference's rounding points: q, k, v and the
    gates are products in the model's type cast to float32; k is then
    multiplied by float32(1 / sqrt(float32(w / H))), as XLA compiles the
    reference's division by that constant under jit; SiLU is x
    sigmoid(x) on the gate in the model's type; the output is cast back
    before ``w_down``."""
    B, S, _ = h.shape
    w, H = _mlstm_width(cfg), cfg.n_heads
    hd = w // H
    up = h @ p.w_up
    xb, gate = up[..., :w], up[..., w:]
    q = _split_heads(xb @ p.wq, H, hd).float()
    k = _split_heads(xb @ p.wk, H, hd).float() * inv_sqrt_hd(hd)
    v = _split_heads(xb @ p.wv, H, hd).float()
    ifg = (xb @ p.w_if).float()
    i_pre, f_pre = ifg[..., :H], ifg[..., H:]
    state = _scan_state(cache, mode, rec.MLSTMState, MLSTM_STATE)
    o = rec.mlstm_sequence(q, k, v, i_pre, f_pre, state)
    o = o.reshape(B, S, w) * (gate * torch.sigmoid(gate)).float()
    return o.to(cfg.torch_dtype) @ p.w_down


def _slstm_mix(cfg: ArchConfig, p: Block, h: torch.Tensor, mode: str,
               cache) -> torch.Tensor:
    """The sLSTM branch's output projection, (B, S, d): the gate
    pre-activations ``h @ w_gates`` in the model's type (gate j of
    channel c in column 4c + j), the scan from the zero state (train,
    prefill: the cache's state, left holding the final state) or from the
    cache (decode), its float32 h cast to the model's type before
    ``w_out``."""
    B, S, d = h.shape
    gates = (h @ p.w_gates).reshape(B, S, d, 4)
    state = _scan_state(cache, mode, rec.SLSTMState, SLSTM_STATE)
    o = rec.slstm_sequence(gates, p.r, state)
    return o.to(cfg.torch_dtype) @ p.w_out


# ---------------------------------------------------------------------------
# Whole-model init / apply
# ---------------------------------------------------------------------------

class LM(nn.Module):
    """The whole model's parameters (see the module docstring)."""

    # the model-axis dim of the leaves outside the blocks (the reference's
    # init_params specs; vis_proj is replicated)
    SHARD_DIMS = {"embed": 1, "frontend": 1, "unembed": 1}

    def __init__(self, gen: torch.Generator, cfg: ArchConfig):
        super().__init__()
        kinds = cfg.layout()
        for kind in dict.fromkeys(kinds):
            _check_ported(cfg, kind)
        d, v, dt = cfg.d_model, cfg.vocab_size, cfg.torch_dtype
        self.embed = nn.Parameter(
            (torch.randn((v, d), generator=gen, device=gen.device,
                         dtype=torch.float32) / d ** 0.5).to(dt),
            requires_grad=False)
        if cfg.frontend == "audio":
            self.frontend = dense_init(gen, cfg.frontend_dim, d, dt)
        if cfg.frontend == "vision":
            self.vis_proj = dense_init(gen, cfg.d_vision, cfg.d_vision, dt)
        self.final_ln = zeros_param((d,), dt, gen.device)
        self.unembed = dense_init(gen, d, v, dt)
        self.blocks = nn.ModuleList(init_block(gen, cfg, kind)
                                    for kind in kinds)

    def train(self, mode: bool = True) -> "LM":
        """Training mode also makes every parameter take gradients;
        ``eval()`` (serving) turns them off again."""
        super().train(mode)
        self.requires_grad_(mode)
        return self


def init_params(gen: torch.Generator, cfg: ArchConfig) -> LM:
    """Seeded parameters on ``gen``'s device, drawn in float32 and cast to
    the config's type, in serving mode (no gradients; ``.train()`` turns
    them on). The reference draws from split JAX keys, so the two
    packages' inits differ; ``convert.from_reference_lm_params`` carries
    the reference's across."""
    return LM(gen, cfg).eval()


def param_specs(cfg: ArchConfig, n_shards: int = 0
                ) -> Dict[str, PartitionSpec]:
    """The spec of every parameter of ``init_params(gen, cfg)`` over
    ``n_shards`` model shards, keyed by its name (``embed``,
    ``blocks.{layer}.{leaf}``: ``named_parameters``' names, which
    ``convert.from_reference_lm_params`` writes): the reference's
    ``init_params`` specs, whose depth-stacked ``period`` leaves carry a
    leading None the port's unstacked layers do not. The shapes come from
    the port's own init run under ``FakeTensorMode``, which allocates
    nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        model = LM(torch.Generator().manual_seed(0), cfg)
    dims = dict(LM.SHARD_DIMS)
    for i, kind in enumerate(cfg.layout()):
        dims.update({f"blocks.{i}.{leaf}": d for leaf, d in
                     Block.shard_dims(cfg, kind, n_shards).items()})
    return {name: spec_for(tuple(p.shape), dims.get(name), n_shards)
            for name, p in model.named_parameters()}


def init_cache(cfg: ArchConfig, B: int, cache_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """Empty cache of every block, on the card unless ``device`` says
    otherwise; raises without one."""
    device = resolve_device(device)
    return [init_cache_block(cfg, kind, B, cache_len, device)
            for kind in cfg.layout()]


def _embed_inputs(params: LM, cfg: ArchConfig, batch) -> torch.Tensor:
    """The audio frontend's ``frames @ frontend`` (in the promoted type:
    float32 frames give a float32 trunk), else the token rows of
    ``embed`` (the reference's ``embed[tokens]``) in the model's type.
    ``F.embedding``'s gradient adds each row's occurrences in a fixed
    order on the CPU and on the card; the index-put behind
    ``embed[tokens]``'s gradient adds them by atomics on a CPU with
    several threads, so repeated steps would differ in their last
    bits."""
    if cfg.frontend == "audio":
        return matmul(batch["frames"], params.frontend)
    return F.embedding(batch["tokens"], params.embed).to(cfg.torch_dtype)


def _vis_kv_source(params: LM, cfg: ArchConfig, batch
                   ) -> Optional[torch.Tensor]:
    """``image_embeds @ vis_proj`` in the model's type, or None (no
    vision frontend, or a decode step: it reuses the cross cache)."""
    if cfg.frontend != "vision" or "image_embeds" not in batch:
        return None
    return matmul(batch["image_embeds"], params.vis_proj).to(cfg.torch_dtype)


def _trunk(params: LM, cfg: ArchConfig, batch, mode: str,
           cache: Optional[Cache], positions: Optional[torch.Tensor],
           remat: bool = False):
    """The blocks from the embedding to the final norm: (x, cache, aux).
    Under a current ``ModelSplit`` (``parallel.tensor_parallel.
    use_split``) the model holds this rank's shards and every block runs
    split (``models/split.py``); the split is passed to each block, so a
    block recomputed in the backward pass runs split too."""
    sp = current_split()
    if sp is None:
        x = _embed_inputs(params, cfg, batch)
    else:
        from . import split as _split
        x = _split.embed_inputs(params, cfg, batch, sp)
    B, S = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    vis = _vis_kv_source(params, cfg, batch)
    if vis is None and mode != "decode" and "cross_attn" in cfg.layout():
        # the reference fails here too (None @ wk)
        raise ValueError(f"{cfg.name}: the {mode} mode needs "
                         "batch['image_embeds'] (B, n_img_tokens, d_vision) "
                         "for its cross-attention layers")
    use_cache = mode in ("prefill", "decode")
    pattern, n_full, _ = cfg.schedule()
    n_period = n_full * len(pattern)
    # the reference's aux0; each block's auxiliary loss (a MoE FFN's load
    # balance term, 0 for a dense one) is added in layer order
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (kind, blk) in enumerate(zip(cfg.layout(), params.blocks)):
        if remat and mode == "train" and i < n_period and \
                torch.is_grad_enabled() and (
                    x.requires_grad or any(p.requires_grad
                                           for p in blk.parameters())):
            # keep only the block's input; its activations are recomputed
            # in the backward pass (the reference's jax.checkpoint of its
            # period blocks; the ``rem`` blocks run plain there too)
            x, a = checkpoint(_block_train, cfg, kind, blk, x, positions,
                              vis, sp, use_reentrant=False)
        else:
            x, _, a = apply_block(cfg, kind, blk, x, mode=mode,
                                  cache=cache[i] if use_cache else None,
                                  vis_embeds=vis, positions=positions,
                                  split=sp)
        if isinstance(a, torch.Tensor):   # a dense FFN's 0 adds nothing
            aux = aux + a
    x = rms_norm(x, params.final_ln, cfg.norm_eps)
    return x, (cache if use_cache else None), aux


def _block_train(cfg: ArchConfig, kind: str, blk: Block, x: torch.Tensor,
                 positions: torch.Tensor, vis: Optional[torch.Tensor],
                 split=None):
    """A train-mode block: (x, aux)."""
    x, _, a = apply_block(cfg, kind, blk, x, mode="train", vis_embeds=vis,
                          positions=positions, split=split)
    return x, a


def _vocab_split(params: LM):
    """The current ``ModelSplit`` when it splits ``unembed`` over the
    vocabulary, else None."""
    sp = current_split()
    return sp if sp is not None and sp.dim_of(params.unembed) == 1 else None


def _unembed(params: LM, x: torch.Tensor) -> torch.Tensor:
    """``x @ unembed``, whole (from the vocabulary's shards, gathered,
    where the current ``ModelSplit`` splits it)."""
    sp = _vocab_split(params)
    if sp is None:
        return matmul(x, params.unembed)
    return sp.gather(sp.col(x, params.unembed), -1)


def check_seq_spec(seq_spec) -> None:
    """``seq_spec`` (a ``PartitionSpec`` of the residual stream (B, S, d),
    the reference's sequence parallelism) against the current mesh
    (``launch.mesh.current_mesh``): an axis the mesh lacks, or no
    current mesh, raises ValueError. The residual stream stays whole on
    every rank between blocks (``models/split.py``), so the spec moves no
    value."""
    if seq_spec is None:
        return
    from ..launch.mesh import current_mesh
    from ..parallel.sharding import NamedSharding
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(f"seq_spec {seq_spec} needs a current mesh "
                         "(launch.mesh.mesh_context)")
    if len(seq_spec) > 3:
        raise ValueError(f"seq_spec {seq_spec}: the residual stream has 3 "
                         "dims")
    NamedSharding(mesh, seq_spec).placements


def forward(params: LM, cfg: ArchConfig, batch, *, mode: str = "train",
            cache: Optional[Cache] = None,
            positions: Optional[torch.Tensor] = None, remat: bool = True,
            seq_spec=None
            ) -> Tuple[torch.Tensor, Optional[Cache], torch.Tensor]:
    """Returns (logits, cache, aux_loss); ``batch["tokens"]`` is (B, S)
    (``batch["frames"]`` (B, S, frontend_dim) with the audio frontend;
    ``batch["image_embeds"]`` (B, n_img_tokens, d_vision) beside the
    tokens with the vision one, except in the decode mode). In the train
    mode with gradients enabled, ``remat`` checkpoints each block of the
    pattern's whole periods (one ``torch.utils.checkpoint`` a block; the
    ``rem`` blocks after them run plain, as the reference's). ``aux`` is
    the blocks' auxiliary losses summed in layer order from a float32
    zero (a MoE FFN's load-balance term; 0 without experts).
    ``seq_spec``: the reference's sharding of the residual stream
    between blocks, checked by ``check_seq_spec``; it changes no
    value."""
    check_seq_spec(seq_spec)
    x, cache, aux = _trunk(params, cfg, batch, mode, cache, positions,
                           remat)
    return _unembed(params, x), cache, aux


def loss_fn(params: LM, cfg: ArchConfig, batch, remat: bool = True,
            seq_spec=None):
    """Mean next-token CE (``frame_ce``: per-frame CE) plus the MoE
    auxiliary term; differentiable. Returns (loss, {"ce", "aux"}). Where
    the current ``ModelSplit`` splits ``unembed`` over the vocabulary the
    CE is vocabulary-parallel (``models/split.vocab_parallel_ce``)."""
    check_seq_spec(seq_spec)
    x, _, aux = _trunk(params, cfg, batch, "train", None, None, remat)
    labels = batch["labels"]
    sp = _vocab_split(params)
    logits = matmul(x, params.unembed) if sp is None else \
        sp.col(x, params.unembed)
    if cfg.loss != "frame_ce":
        logits, labels = logits[:, :-1], labels[:, 1:]
    if sp is None:
        loss = cross_entropy(logits, labels)
    else:
        from . import split as _split
        loss = _split.vocab_parallel_ce(logits, labels, sp)
    return loss + MOE_AUX_WEIGHT * aux, {"ce": loss, "aux": aux}


def prefill(params: LM, cfg: ArchConfig, batch, cache_len: int):
    """Full-sequence prefill: returns (last_logits (B, V), cache). The
    batch size comes from ``tokens``, else from ``frames`` (the encoder).
    Only the last position is unembedded (the reference unembeds every
    position and keeps the last; each row is its own product)."""
    first = batch["tokens"] if "tokens" in batch else batch["frames"]
    cache = init_cache(cfg, first.shape[0], cache_len, first.device)
    x, cache, _ = _trunk(params, cfg, batch, "prefill", cache, None)
    return _unembed(params, x[:, -1]), cache


def decode_step(params: LM, cfg: ArchConfig, token: torch.Tensor,
                cache: Cache, position: torch.Tensor):
    """token: (B, 1) int; position: (B,) int current absolute position.
    Returns (logits (B, V), cache)."""
    x, cache, _ = _trunk(params, cfg, {"tokens": token}, "decode", cache,
                         position[:, None])
    return _unembed(params, x[:, 0]), cache
