"""The model's compute split over the mesh's "model" axis, as XLA's
partitioner splits the reference's jitted step over the parameters'
specs (``models.param_specs``).

``transformer``'s trunk, loss and unembedding come here when a
``parallel.tensor_parallel.ModelSplit`` is current (``use_split``): the
blocks then hold this rank's local shards (``local_params``), and the
residual stream (B, S, d) is whole and the same on every rank of the
model group between blocks. Per leaf the compute is the cheapest that
the placement allows:

- attention with its heads split (``wq``'s columns, ``wo``'s rows, when
  M divides the heads): this rank's H / M query heads; ``wk`` and
  ``wv`` (split over their input dim) gathered whole, one at a time, and
  only the KV heads that its query heads read projected in training (all
  of them in prefill and decode, whose cache stays whole on every
  rank); each local query head reads its group's KV head (``_expand``:
  a broadcast, so the gradient is a reduction); the output's partial
  sums added over the group;
- attention whose heads M does not divide (``wq``'s rows, ``wo``'s
  columns): q, k and v as partial sums over d, added over the group, the
  attention itself whole on every rank, the output's columns gathered;
- the dense FFN and the experts over ff (the routing runs whole on every
  rank, from the same bits);
- the RG-LRU over its channels: ``w_in``'s contiguous column shard holds
  whole halves (``[branch | gate]`` at M = 2: rank 0 all of the branch),
  so its output columns are traded (``regroup``) until each rank holds
  its channels of both halves; ``conv``, ``lru`` and ``w_out`` read
  those channels;
- the mLSTM over its heads when M divides them: ``w_up``'s output traded
  as ``w_in``'s, the branch gathered whole for the columns of ``wq``,
  ``wk``, ``wv`` (this rank's heads) and for the replicated ``w_if``;
  with fewer heads than ranks the block runs whole on every rank;
- the sLSTM over its channels (``w_gates``' columns are channel-major, so
  a contiguous shard holds its channels' four gates);
- ``embed``'s and the audio ``frontend``'s column shard, gathered before
  the first norm; ``unembed`` over the vocabulary with a
  vocabulary-parallel cross entropy (each rank's max, sum of
  exponentials and gold logit gathered; no rank holds the whole
  logits).

Every product that crosses the split goes through ``ModelSplit.col`` (a
column shard) or ``ModelSplit.row`` (a row shard), which add the ranks'
partial sums in float32 and round them once, so a bfloat16 model split
computes what the unsplit one does but for the order of float32
additions. A block whose leaves are not placed as its split needs (a
width that M does not divide) runs whole on every rank, its sharded
leaves gathered one at a time. Prefill and decode write recurrent
states and KV caches whole on every rank (``cache_specs``' placement:
batch only).
"""
from __future__ import annotations

import contextlib
import functools
import itertools
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..kernels.decode_attention import inv_sqrt_hd
from ..parallel.tensor_parallel import ModelSplit, all_gather
from . import recurrent as rec
from . import transformer as T
from .attention import (_expand_kv, blockwise_attention, cross_attention,
                        decode_attention)
from .config import ArchConfig
from .layers import matmul, mlp, rms_norm
from .moe import MoE, moe_ffn


@contextlib.contextmanager
def _whole_leaves(sp: ModelSplit, blk):
    """Inside the block every sharded leaf of ``blk`` (a module) is its
    whole value, gathered for replicated compute."""
    swapped = []
    for mod in blk.modules():
        for name, t in list(mod._parameters.items()):
            if t is not None and sp.dim_of(t) is not None:
                swapped.append((mod, name, t))
                mod._parameters[name] = sp.whole_for_rep(t)
    try:
        yield
    finally:
        for mod, name, t in swapped:
            mod._parameters[name] = t


def _values(sp: ModelSplit, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` (no gradient: prefill and
    decode's cache writes)."""
    return all_gather(x, dim, sp.group, sp.size)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _heads(cfg: ArchConfig, sp: ModelSplit):
    """(Hl, q0, lo, hi, idx): this rank's query heads q0 .. q0 + Hl - 1,
    the KV heads [lo, hi) they read, and each local head's KV head less
    lo."""
    G = cfg.n_heads // cfg.n_kv_heads
    Hl = cfg.n_heads // sp.size
    q0 = sp.rank * Hl
    kv = [(q0 + i) // G for i in range(Hl)]
    return Hl, q0, kv[0], kv[-1] + 1, [g - kv[0] for g in kv]


def _all_heads(cfg: ArchConfig) -> List[int]:
    """Each query head's KV head (``attention._expand_kv``'s map)."""
    G = cfg.n_heads // cfg.n_kv_heads
    return [i // G for i in range(cfg.n_heads)]


def _regular(idx: List[int], n: int) -> bool:
    """Whether heads ``idx`` read ``n`` KV heads in equal groups, as the
    GQA kernels map them (head i -> i // (len / n))."""
    g = len(idx) // n
    return len(idx) % n == 0 and idx == [i // g for i in range(len(idx))]


def _expand(x: torch.Tensor, idx: List[int]) -> torch.Tensor:
    """x (B, T, n, ...) -> (B, T, len(idx), ...), head i reading x's head
    idx[i] (runs of equal entries): ``attention._expand_kv`` where the
    runs are equal, else broadcasts and a cat; the gradient sums each
    run into its head by a reduction."""
    if _regular(idx, x.shape[2]):
        return _expand_kv(x, len(idx))
    pieces = [x[:, :, j:j + 1].expand(*x.shape[:2], len(list(run)),
                                      *x.shape[3:])
              for j, run in itertools.groupby(idx)]
    return torch.cat(pieces, 2)


def _gqa_view(t: torch.Tensor, lo: int, hi: int, idx: List[int]
              ) -> torch.Tensor:
    """A cache leaf (B, T, KV, ...) as this rank's query heads read it:
    the KV heads [lo, hi) when they are read in equal groups, else
    expanded to one a query head."""
    t = t[:, :, lo:hi]
    return t if _regular(idx, hi - lo) else _expand(t, idx)


def _heads_qkv(cfg: ArchConfig, sp: ModelSplit, p, h: torch.Tensor,
               kv_input: torch.Tensor, lo: int, hi: int):
    """This rank's q heads and the KV heads [lo, hi): q (B, S, Hl, hd), k,
    v (B, T, hi - lo, hd), biases and q/k norms as ``_attn_qkv``."""
    hd, Hl = cfg.head_dim, cfg.n_heads // sp.size
    cols = slice(lo * hd, hi * hd)
    q = sp.col(h, sp.local(p.wq, 1))
    k = sp.col(kv_input, sp.whole_for_split(p.wk)[:, cols])
    v = sp.col(kv_input, sp.whole_for_split(p.wv)[:, cols])
    if cfg.qkv_bias:
        q = q + sp.local(p.bq, 0)
        k = k + sp.whole_for_split(p.bk)[cols]
        v = v + sp.whole_for_split(p.bv)[cols]
    q = T._split_heads(q, Hl, hd)
    k = T._split_heads(k, hi - lo, hd)
    v = T._split_heads(v, hi - lo, hd)
    if cfg.qk_norm:
        # the replicated gains copied in as float32, the type rms_norm
        # computes in, so that the ranks' parts of their gradients (from
        # their own heads) are added in float32
        q = rms_norm(q, sp.copy_in(p.q_norm.float()), cfg.norm_eps)
        k = rms_norm(k, sp.copy_in(p.k_norm.float()), cfg.norm_eps)
    return q, k, v


def _rows_qkv(cfg: ArchConfig, sp: ModelSplit, p, h: torch.Tensor,
              kv_input: torch.Tensor):
    """q, k, v whole (all heads) as partial sums over the input dim
    (``wq``, ``wk``, ``wv`` split over their rows), added over the
    group; biases and q/k norms replicated."""
    hs = sp.local(h, -1)
    ks = hs if kv_input is h else sp.local(kv_input, -1)
    q = sp.row(hs, sp.local(p.wq, 0))
    k = sp.row(ks, sp.local(p.wk, 0))
    v = sp.row(ks, sp.local(p.wv, 0))
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = T._split_heads(q, cfg.n_heads, cfg.head_dim)
    k = T._split_heads(k, cfg.n_kv_heads, cfg.head_dim)
    v = T._split_heads(v, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v


def _attend(cfg: ArchConfig, kind: str, q, k, v, mode: str, cache,
            positions, lo: int, idx: List[int]) -> torch.Tensor:
    """``transformer._attn_mix``'s attention (its RoPE and cache write
    shared) for query heads that read the KV heads ``lo + idx[i]`` of k
    and v (all of the cache's KV heads in prefill and decode)."""
    window = T._attn_window(cfg, kind)
    q, k = T._rope_and_cache(cfg, window, q, k, v, mode, cache, positions)
    hi = lo + idx[-1] + 1
    if mode == "decode":
        scales = {n: None if cache.get(n) is None
                  else _gqa_view(cache[n], lo, hi, idx)
                  for n in ("k_scale", "v_scale")}
        return decode_attention(q, _gqa_view(cache["k"], lo, hi, idx),
                                _gqa_view(cache["v"], lo, hi, idx),
                                cache["pos"], positions[:, 0],
                                window=window, **scales)
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    return blockwise_attention(q, _expand(k, idx), _expand(v, idx),
                               causal=cfg.causal, window=window)


def _attn_mix(cfg: ArchConfig, kind: str, sp: ModelSplit, p, h, mode,
              cache, positions) -> torch.Tensor:
    B, S, _ = h.shape
    wq = sp.dim_of(p.wq)
    if wq == 1:
        Hl, _, lo, hi, idx = _heads(cfg, sp)
        train = mode == "train"
        q, k, v = _heads_qkv(cfg, sp, p, h, h, lo if train else 0,
                             hi if train else cfg.n_kv_heads)
        o = _attend(cfg, kind, q, k, v, mode, cache, positions,
                    0 if train else lo, idx)
        return sp.row(o.reshape(B, S, -1), sp.local(p.wo, 0))
    if wq == 0:
        q, k, v = _rows_qkv(cfg, sp, p, h, h)
        o = _attend(cfg, kind, q, k, v, mode, cache, positions, 0,
                    _all_heads(cfg))
        return sp.gather(sp.col(o.reshape(B, S, -1), sp.local(p.wo, 1)), -1)
    with _whole_leaves(sp, p):
        return T._attn_mix(cfg, kind, p, h, mode, cache, positions)


def _cross_mix(cfg: ArchConfig, sp: ModelSplit, p, h, mode, cache, vis):
    """``transformer._cross_mix`` split as ``_attn_mix``."""
    B, S, _ = h.shape
    wq = sp.dim_of(p.wq)
    if wq == 1:
        Hl, _, lo, hi, idx = _heads(cfg, sp)
        if mode == "decode":
            q = T._split_heads(sp.col(h, sp.local(p.wq, 1)), Hl,
                               cfg.head_dim)
            o = cross_attention(q, _gqa_view(cache["k"], lo, hi, idx),
                                _gqa_view(cache["v"], lo, hi, idx),
                                decode=True)
        else:
            train = mode == "train"
            q, k, v = _heads_qkv(cfg, sp, p, h, vis, lo if train else 0,
                                 hi if train else cfg.n_kv_heads)
            if mode == "prefill":
                cache["k"].copy_(k)
                cache["v"].copy_(v)
                k, v = k[:, :, lo:hi], v[:, :, lo:hi]
            o = cross_attention(q, _expand(k, idx), _expand(v, idx))
        return sp.row(o.reshape(B, S, -1), sp.local(p.wo, 0))
    if wq == 0:
        if mode == "decode":
            q = sp.row(sp.local(h, -1), sp.local(p.wq, 0))
            q = T._split_heads(q, cfg.n_heads, cfg.head_dim)
            o = cross_attention(q, cache["k"], cache["v"], decode=True)
        else:
            q, k, v = _rows_qkv(cfg, sp, p, h, vis)
            if mode == "prefill":
                cache["k"].copy_(k)
                cache["v"].copy_(v)
            o = cross_attention(q, k, v)
        return sp.gather(sp.col(o.reshape(B, S, -1), sp.local(p.wo, 1)), -1)
    with _whole_leaves(sp, p):
        return T._cross_mix(cfg, p, h, mode, cache, vis)


# ---------------------------------------------------------------------------
# FFNs
# ---------------------------------------------------------------------------

def _mlp(sp: ModelSplit, p, x: torch.Tensor) -> torch.Tensor:
    """``layers.mlp`` (the experts' too, batched) over ff: this rank's
    columns of ``up`` and ``gate``, its rows of ``down``."""
    if p.gate is not None:
        h = F.silu(sp.col(x, p.gate)) * sp.col(x, p.up)
    else:
        h = F.gelu(sp.col(x, p.up), approximate="tanh")
    return sp.row(h, p.down)


def _ffn(cfg: ArchConfig, sp: ModelSplit, p, x: torch.Tensor, mode: str):
    """The block's FFN over ff: (y, aux)."""
    if isinstance(p, MoE):
        if sp.dim_of(p.up) != 2 or sp.dim_of(p.down) != 1:
            with _whole_leaves(sp, p):
                return T._ffn_apply(p, cfg, x, mode)
        return moe_ffn(p, x, cfg.top_k, cfg.capacity_factor,
                       drop_free=(mode == "decode"),
                       ffn=functools.partial(_mlp, sp))
    if sp.dim_of(p.up) != 1 or sp.dim_of(p.down) != 0:
        with _whole_leaves(sp, p):
            return mlp(p, x), 0.0
    return _mlp(sp, p, x), 0.0


# ---------------------------------------------------------------------------
# recurrent mixers
# ---------------------------------------------------------------------------

def _state_out(sp: ModelSplit, cache, names, parts) -> None:
    """The ranks' state slices joined into the whole cache leaves."""
    for n, t in zip(names, parts):
        cache[n].copy_(_values(sp, t, 1))


def _rglru_mix(cfg: ArchConfig, sp: ModelSplit, p, h, mode, cache):
    w = cfg.rnn_w
    if w % sp.size or sp.dim_of(p.w_in) != 1 or sp.dim_of(p.conv) != 1 \
            or sp.dim_of(p.w_out) != 0:
        with _whole_leaves(sp, p):
            return T._rglru_mix(cfg, p, h, mode, cache)
    lo, hi = sp.span(w)
    xin = sp.regroup(sp.col(h, p.w_in), 2)
    xr, gate = xin[..., 0, :], xin[..., 1, :]
    if mode == "decode":
        conv = cache["conv"][..., lo:hi].contiguous()
        xr1, conv_state = rec.causal_conv1d_step(xr[:, 0], conv, p.conv)
        h_new, h_f32 = rec.rglru_step(xr1, cache["h"][:, lo:hi], p.lru)
        o = h_new[:, None] * F.gelu(gate, approximate="tanh")
        cache["h"].copy_(_values(sp, h_f32, 1))
        cache["conv"].copy_(_values(sp, conv_state, 2))
    else:
        hseq = rec.rglru_sequence(rec.causal_conv1d(xr, p.conv), p.lru)
        o = hseq * F.gelu(gate, approximate="tanh")
        if mode == "prefill":
            W, S = cfg.conv1d_size, h.shape[1]
            cache["h"].copy_(_values(sp, hseq[:, -1].float(), 1))
            if S >= W - 1:
                cache["conv"].copy_(_values(
                    sp, xr[:, S - (W - 1):].to(cfg.torch_dtype), 2))
    return sp.row(o, p.w_out)


def _mlstm_mix(cfg: ArchConfig, sp: ModelSplit, p, h, mode, cache):
    B, S, _ = h.shape
    w, H = T._mlstm_width(cfg), cfg.n_heads
    if H % sp.size or w % sp.size or any(
            sp.dim_of(t) != 1 for t in (p.w_up, p.wq, p.wk, p.wv)) \
            or sp.dim_of(p.w_down) != 0:
        with _whole_leaves(sp, p):
            return T._mlstm_mix(cfg, p, h, mode, cache)
    hd, Hl = w // H, H // sp.size
    h0 = sp.rank * Hl
    up = sp.regroup(sp.col(h, p.w_up), 2)
    xb, gate = sp.gather(up[..., 0, :], -1), up[..., 1, :]
    q = T._split_heads(sp.col(xb, p.wq), Hl, hd).float()
    k = T._split_heads(sp.col(xb, p.wk), Hl, hd).float() * inv_sqrt_hd(hd)
    v = T._split_heads(sp.col(xb, p.wv), Hl, hd).float()
    ifg = sp.copy_in((xb @ p.w_if).float())
    i_pre, f_pre = ifg[..., h0:h0 + Hl], ifg[..., H + h0:H + h0 + Hl]
    state = T._scan_state(cache, mode, rec.MLSTMState, T.MLSTM_STATE,
                          (h0, h0 + Hl))
    o = rec.mlstm_sequence(q, k, v, i_pre, f_pre, state)
    if state is not None:
        _state_out(sp, cache, T.MLSTM_STATE, state)
    o = o.reshape(B, S, w // sp.size) * (gate * torch.sigmoid(gate)).float()
    return sp.row(o.to(cfg.torch_dtype), p.w_down)


def _slstm_mix(cfg: ArchConfig, sp: ModelSplit, p, h, mode, cache):
    B, S, d = h.shape
    if d % sp.size or sp.dim_of(p.w_gates) != 1 or \
            sp.dim_of(p.w_out) != 0:
        with _whole_leaves(sp, p):
            return T._slstm_mix(cfg, p, h, mode, cache)
    lo, hi = sp.span(d)
    gates = sp.col(h, p.w_gates).reshape(B, S, hi - lo, 4)
    state = T._scan_state(cache, mode, rec.SLSTMState, T.SLSTM_STATE,
                          (lo, hi))
    o = rec.slstm_sequence(gates, sp.local(p.r, 0), state)
    if state is not None:
        _state_out(sp, cache, T.SLSTM_STATE, state)
    return sp.row(o.to(cfg.torch_dtype), p.w_out)


# ---------------------------------------------------------------------------
# blocks, embedding, unembedding, loss
# ---------------------------------------------------------------------------

def apply_block(cfg: ArchConfig, kind: str, p, x: torch.Tensor, *,
                mode: str, cache: Optional[Dict[str, torch.Tensor]],
                vis_embeds: Optional[torch.Tensor],
                positions: Optional[torch.Tensor], split: ModelSplit):
    """``transformer.apply_block`` on this rank's shards: (x, cache,
    aux), x whole and the same on every rank of the group."""
    sp = split
    h = rms_norm(x, p.ln, cfg.norm_eps)
    if kind in T._NO_FFN:
        mix = _mlstm_mix if kind == "mlstm" else _slstm_mix
        return x + mix(cfg, sp, p, h, mode, cache), cache, 0.0
    if kind == "cross_attn":
        gate = torch.tanh(p.gate_attn).to(x.dtype)
        x = x + gate * _cross_mix(cfg, sp, p, h, mode, cache, vis_embeds)
        y, aux = _ffn(cfg, sp, p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), mode)
        return x + torch.tanh(p.gate_mlp).to(x.dtype) * y, cache, aux
    if kind == "rglru":
        x = x + _rglru_mix(cfg, sp, p, h, mode, cache)
    else:
        x = x + _attn_mix(cfg, kind, sp, p, h, mode, cache, positions)
    y, aux = _ffn(cfg, sp, p.ffn, rms_norm(x, p.ln2, cfg.norm_eps), mode)
    return x + y, cache, aux


def embed_inputs(params, cfg: ArchConfig, batch, sp: ModelSplit
                 ) -> torch.Tensor:
    """``transformer._embed_inputs`` from the column shard of ``embed``
    (or of the audio ``frontend``), gathered whole."""
    leaf = params.frontend if cfg.frontend == "audio" else params.embed
    if sp.dim_of(leaf) != 1:
        return T._embed_inputs(params, cfg, batch)
    if cfg.frontend == "audio":
        x = matmul(batch["frames"], leaf)
    else:
        x = F.embedding(batch["tokens"], leaf).to(cfg.torch_dtype)
    return sp.gather(x, -1)


class _VocabParallelCE(torch.autograd.Function):
    """Per-position CE of logits split over the vocabulary (this rank's
    V / M columns): in float32, each rank's max, sum of exponentials
    (from its own max) and gold logit (0 off its columns) gathered, the
    sums taken in rank order; the gradient softmax - onehot on this
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, sp):
        lf = logits.float()
        Vl = lf.shape[-1]
        lab = labels.long() - sp.rank * Vl
        mine = (lab >= 0) & (lab < Vl)
        lab = torch.where(mine, lab, torch.zeros_like(lab))
        m = lf.amax(-1)
        s = torch.exp(lf - m[..., None]).sum(-1)
        gold = torch.gather(lf, -1, lab[..., None])[..., 0]
        gold = torch.where(mine, gold, torch.zeros_like(gold))
        stats = all_gather(torch.stack([m, s, gold])[None], 0, sp.group,
                           sp.size)
        top = stats[:, 0].amax(0)
        total = stats[0, 1] * torch.exp(stats[0, 0] - top)
        g = stats[0, 2]
        for r in range(1, sp.size):
            total = total + stats[r, 1] * torch.exp(stats[r, 0] - top)
            g = g + stats[r, 2]
        logz = top + torch.log(total)
        ctx.save_for_backward(logits, logz, lab, mine)
        return logz - g

    @staticmethod
    def backward(ctx, g):
        logits, logz, lab, mine = ctx.saved_tensors
        p = torch.exp(logits.float() - logz[..., None])
        p.scatter_add_(-1, lab[..., None], -mine.float()[..., None])
        return (p * g[..., None]).to(logits.dtype), None, None


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor,
                      sp: ModelSplit) -> torch.Tensor:
    """Mean CE of logits split over the vocabulary (this rank's V / M
    columns), the same on every rank (``layers.cross_entropy``'s
    counterpart)."""
    return torch.mean(_VocabParallelCE.apply(logits, labels, sp))
