"""GQA decode attention against the KV cache; the port's kernel for the
reference's single-query step ``repro/models/attention.py:96``
(``decode_attention``, plain einsums: the JAX package has no Pallas
kernel there).

q (B, 1, H, hd) against the caches k, v (B, T, KV, hd) with slot
positions ``kv_positions`` (B, T) (negative = empty) and the query's
position ``q_position`` (B,). H = KV * G: query heads kv*G .. kv*G +
G - 1 read KV head kv (the reference's reshape of q to (B, 1, KV, G,
hd)). The caches are float32, bfloat16, or int8 with float32
scales ``k_scale``/``v_scale`` (B, T, KV) (the ``kv_quant`` cache).
The reference's rounding points, in order:

1. s = q . k, float32 accumulation (int8 k cast to q's type first,
   exact for |k| <= 127);
2. s * k_scale (int8), then s / sqrt(hd) (a float32 division);
3. slots with pos < 0, pos > q_position or, when window > 0,
   q_position - pos >= window get the finite ``NEG_INF``;
4. the float32 softmax over all T slots;
5. p * v_scale (int8), then p rounded to the value type: the cache's
   (float32, bfloat16), or q's for the int8 cache;
6. p . v, float32 accumulation, cast to q's type.

``decode_attention_kernel`` is the wrapper: on CUDA tensors it launches
the hand-written Hopper kernel ``csrc/decode_attention.cu`` (or raises),
on CPU tensors it runs the plain PyTorch version
``decode_attention_plain``. Its ``launches`` attribute counts kernel
calls, ``routes`` counts them by cache type, and ``grouped`` counts the
calls that took the grouped route (below).

``cross_decode_attention_kernel`` is the same kernel's cross route, the
reference's ``cross_attention`` (``repro/models/attention.py:140``) at
one query against the image keys of the cross cache (float32 or
bfloat16): no positions, every slot visible; s * float32(1 / sqrt(hd)),
the product XLA compiles the reference's division into under jit (its
model functions run under jit or inside ``lax.scan``, which compiles its
body); p kept in float32 for p . v (the bf16 cache's instantiation with
a float32 p). Its plain version is ``cross_decode_attention_plain``, and
it counts its own ``launches``.

The kernel cuts T into 32-slot chunks dealt round robin to splits
(``split_len``); a block serves one split of a KV head's query heads,
on one of three routes (``launch_plan``):

- the split route (float32 caches, G <= 4, and an int8 cache under a
  float32 q): 4 query heads a block on the CUDA cores. Because p is
  rounded after it is normalised (step 5), a one-pass online softmax
  would round un-normalised weights, so it runs two launches: pass 1
  compacts each split's visible slots and stores their scores and the
  split's row max and sum; pass 2 combines the splits' statistics in
  split order into the row's max and sum, forms and rounds p, and writes
  each split's partial p . v, and the last block of a row to finish adds
  the partials in split order (an arrival counter picks the block, never
  the order);
- the grouped route (G > 4 with a bfloat16 q on the bfloat16 or int8
  cache): the same two passes with up to 16 query heads of a KV head a
  block, both products on the tensor cores (``mma.sync`` bf16, float32
  sums), so each visible slot's K and V are read once a pass; at most
  ``GROUPED_MAX_SPLITS`` splits while T <= ``GROUPED_MAX_SPLITS`` x
  ``GROUPED_MAX_SPLIT_LEN`` (a longer cache takes splits of
  ``GROUPED_MAX_SPLIT_LEN`` slots), and pass 2 in blocks of
  ``GROUPED_DIMS`` head dims, each folding its own dims;
- the cross route: one launch; every split's (max, sum, unnormalised
  p . v) folded in split order by the last block, divided by the row's
  sum once after the fold (p stays float32 and is never rounded).

No atomics in any sum: two launches are bitwise equal, and the counters
are zero after every launch, so a CUDA graph can replay it.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import build

NEG_INF = -1.0e30
MAX_HEAD_DIM = 256
# blocks the splits aim for: one wave of two blocks on each of the H100's
# 132 SMs
SPLIT_BLOCKS = 264
# slots of a chunk; the splits take chunks round robin
CHUNK = 32
# the most slots a split takes (its scores sit in shared memory)
MAX_SPLIT_LEN = 2048
# query heads a block serves (csrc/decode_attention.cu GH)
HEADS_PER_BLOCK = 4
# the grouped route's heads a block (csrc/decode_attention.cu GG), its
# most slots a split (the scores of 16 heads beside the K ring), the
# splits it stops at (each block of pass 2 folds one partial a split;
# more where T needs them at its most slots a split) and the head dims a
# pass-2 block owns (DS)
GROUPED_HEADS = 16
GROUPED_MAX_SPLIT_LEN = 1024
GROUPED_MAX_SPLITS = 16
GROUPED_DIMS = 64
# shared memory the cross route stages a split's V rows in
CROSS_V_BYTES = 96 * 1024
# csrc/decode_attention.cu's route codes
ROUTE_CODES = {"split": 0, "grouped": 1, "cross": 2}
# the cache's type -> (its code in csrc/decode_attention.cu, its name in
# ``decode_attention_kernel.routes``)
_ROUTES = {torch.float32: (0, "float32"), torch.bfloat16: (1, "bfloat16"),
           torch.int8: (2, "int8")}


def split_len(B: int, KV: int, G: int, T: int, heads: int, max_len: int,
              max_splits: int) -> int:
    """Candidate slots a block of the kernel takes: T cut into ``CHUNK``-
    slot chunks, dealt round robin to enough splits that the B x KV x
    ceil(G / heads) x splits blocks come near ``SPLIT_BLOCKS`` without
    passing it (one wave), and no more than ``max_splits``; each split
    takes a whole number of chunks, at most ``max_len`` slots, so a T
    longer than ``max_splits`` x ``max_len`` takes more splits. ``heads``,
    ``max_len``, ``max_splits``: the route's (``launch_plan``)."""
    units = B * KV * -(-G // heads)
    chunks = -(-max(1, T) // CHUNK)
    want = max(1, min(chunks, SPLIT_BLOCKS // max(1, units), max_splits))
    per = min(-(-chunks // want), max(1, max_len // CHUNK))
    return per * CHUNK


def kernel_width(hd: int) -> int:
    """The head-dim width the kernel is compiled for that holds ``hd``
    (csrc/decode_attention.cu's instantiations)."""
    return next(w for w in (32, 64, 128, MAX_HEAD_DIM) if hd <= w)


def launch_plan(B: int, T: int, KV: int, G: int, hd: int,
                q_dtype: torch.dtype, cache_dtype: torch.dtype,
                cross: bool = False) -> tuple:
    """(route, query heads a block, split length L, splits) of a call:
    the cross route for cross attention; the grouped route where G > 4
    and a bfloat16 q meets the bfloat16 or int8 cache (at most
    ``GROUPED_MAX_SPLITS`` splits while they hold T); else the split
    route. The cross route's L keeps a split's V rows within
    ``CROSS_V_BYTES``; the split and cross routes' splits are bounded by
    the wave (``SPLIT_BLOCKS``) alone."""
    max_splits = SPLIT_BLOCKS
    if cross:
        route, heads = "cross", HEADS_PER_BLOCK
        max_len = CROSS_V_BYTES // (kernel_width(hd) * cache_dtype.itemsize)
    elif G > HEADS_PER_BLOCK and q_dtype == torch.bfloat16 and \
            cache_dtype in (torch.bfloat16, torch.int8):
        route, heads, max_len = "grouped", GROUPED_HEADS, \
            GROUPED_MAX_SPLIT_LEN
        max_splits = GROUPED_MAX_SPLITS
    else:
        route, heads, max_len = "split", HEADS_PER_BLOCK, MAX_SPLIT_LEN
    L = split_len(B, KV, G, T, heads, max_len, max_splits)
    return route, heads, L, n_splits(T, L)


def n_splits(T: int, L: int) -> int:
    """Splits of ``L`` candidate slots that cover T."""
    return -(-(-(-max(1, T) // CHUNK)) // (L // CHUNK))


def visible_slots(kv_positions: torch.Tensor, q_position: torch.Tensor,
                  window: int = 0) -> torch.Tensor:
    """(B, T) mask of the slots the query sees."""
    valid = (kv_positions >= 0) & (kv_positions <= q_position[:, None])
    if window > 0:
        valid = valid & ((q_position[:, None] - kv_positions) < window)
    return valid


def sqrt_hd(hd: int) -> float:
    """sqrt(hd) rounded to float32, as ``jnp.sqrt(jnp.float32(hd))``
    (the double root rounds to the correctly rounded float32 one)."""
    return float(np.float32(math.sqrt(hd)))


def inv_sqrt_hd(hd: int) -> float:
    """float32(1 / sqrt(float32(hd))), the constant XLA multiplies by where
    the reference divides by ``jnp.sqrt(jnp.float32(hd))`` under jit."""
    return float(np.float32(1.0) / np.float32(math.sqrt(hd)))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, kv_positions: torch.Tensor,
                           q_position: torch.Tensor, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version (shapes and steps as in the module
    docstring): q reshaped to (B, 1, KV, G, hd) and contracted against
    the unexpanded cache in float32 (products of bf16 or int8 values are
    exact in float32), the softmax over all T slots."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    quant = k_scale is not None
    qf = q.reshape(B, 1, KV, H // KV, hd).float()
    kc = k_cache.to(q.dtype) if quant else k_cache
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, kc.float())
    if quant:
        s = s * k_scale.transpose(1, 2)[:, None, :, None, :]
    s = s / sqrt_hd(hd)
    valid = visible_slots(kv_positions, q_position, window)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if quant:
        p = p * v_scale.transpose(1, 2)[:, None, :, None, :]
        vt = q.dtype
    else:
        vt = v_cache.dtype
    out = torch.einsum("bqkgs,bskd->bqkgd", p.to(vt).float(),
                       v_cache.to(vt).float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def cross_decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the cross route (module docstring): the
    scores in float32 against the unexpanded k, times float32(1 /
    sqrt(hd)), the softmax over every slot, p . v in float32 with p
    unrounded, cast to q's type."""
    B, _, H, hd = q.shape
    KV = k.shape[2]
    qf = q.reshape(B, 1, KV, H // KV, hd).float()
    s = torch.einsum("bqkgd,bskd->bqkgs", qf, k.float()) * inv_sqrt_hd(hd)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _check(q, k_cache, v_cache, kv_positions, q_position, k_scale,
           v_scale):
    dev = q.device
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q has shape {tuple(q.shape)}; "
                         "expected (B, 1, H, hd)")
    B, _, H, hd = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape or \
            k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k_cache "
                         f"{tuple(k_cache.shape)}, v_cache "
                         f"{tuple(v_cache.shape)} do not match")
    T, KV = k_cache.shape[1], k_cache.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"decode_attention: {H} query heads over {KV} KV "
                         "heads")
    if kv_positions.shape != (B, T) or q_position.shape != (B,):
        raise ValueError(f"decode_attention: kv_positions "
                         f"{tuple(kv_positions.shape)}, q_position "
                         f"{tuple(q_position.shape)}; expected ({B}, {T}) "
                         f"and ({B},)")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention: give both k_scale and v_scale "
                         "or neither")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: q is {q.dtype}")
    if k_scale is not None:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("decode_attention: scales need the int8 cache, "
                            f"got {k_cache.dtype}")
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if t.shape != (B, T, KV) or t.dtype != torch.float32:
                raise ValueError(f"decode_attention: {name} is {t.dtype} "
                                 f"{tuple(t.shape)}; expected float32 "
                                 f"({B}, {T}, {KV})")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention: caches {k_cache.dtype}, "
                        f"{v_cache.dtype} for q {q.dtype}; the float cache "
                        "has q's type, the int8 one needs scales")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_positions", kv_positions),
                    ("q_position", q_position), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on "
                             f"{dev}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")


def decode_attention_kernel(q: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor,
                            kv_positions: torch.Tensor,
                            q_position: torch.Tensor, window: int = 0,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Decode attention (shapes as in the module docstring). CUDA tensors
    launch ``csrc/decode_attention.cu`` (counted in ``routes`` by cache
    type, and in ``grouped`` where the grouped route ran: ``launch_plan``);
    CPU tensors take the plain version. The
    caches, positions and scales are read in place (contiguous, int64
    positions); nothing of the cache is copied or cast."""
    _check(q, k_cache, v_cache, kv_positions, q_position, k_scale, v_scale)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, kv_positions,
                                      q_position, window, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("kv_positions", kv_positions), ("k_scale", k_scale),
                    ("v_scale", v_scale)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
    if kv_positions.dtype != torch.int64:
        raise TypeError(f"decode_attention: kv_positions is "
                        f"{kv_positions.dtype}; the cache keeps int64")
    out, launched = _launch(q, k_cache, v_cache, k_scale, v_scale,
                            kv_positions,
                            q_position.to(torch.int64).contiguous(), window,
                            sqrt_hd(q.shape[-1]), _ROUTES[k_cache.dtype][0],
                            False)
    if launched:
        decode_attention_kernel.launches += 1
        decode_attention_kernel.routes[_ROUTES[k_cache.dtype][1]] += 1
        decode_attention_kernel.grouped += int(launched == "grouped")
    return out


decode_attention_kernel.launches = 0
decode_attention_kernel.routes = {"float32": 0, "bfloat16": 0, "int8": 0}
decode_attention_kernel.grouped = 0


def _launch(q, k_cache, v_cache, k_scale, v_scale, pos, q_pos, window: int,
            scale: float, cache_type: int, cross: bool) -> tuple:
    """The route's launches of ``csrc/decode_attention.cu`` on checked
    CUDA tensors, with the scratch they need; returns (the output, the
    route that ran, or None: an empty batch or cache gives zeros without
    the kernel)."""
    B, _, H, hd = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    route, heads, L, splits = launch_plan(B, T, KV, G, hd, q.dtype,
                                          k_cache.dtype, cross)
    units = B * KV * -(-G // heads)
    # the grouped route's pass 2 folds each unit's head dims in slices
    width = max(kernel_width(hd), GROUPED_DIMS) if route == "grouped" \
        else hd
    slices = units * (width // GROUPED_DIMS if route == "grouped" else 1)
    if slices > 65535:
        raise ValueError(f"decode_attention: {slices} batch x KV head x "
                         "head group blocks exceed the grid's 65535")
    q = q.contiguous()
    out = torch.empty_like(q)
    if B == 0 or T == 0:
        return out.zero_(), None
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty((2 * units * heads * splits,), **f32)
    part = torch.empty((units * splits * heads * width,), **f32)
    scores = vidx = None
    if route != "cross":
        scores = torch.empty((units * splits * heads * L,), **f32)
        vidx = torch.empty((B * splits * (L + 1),), dtype=torch.int32,
                           device=q.device)
    arrivals = build.workspace("decode_attention", q.device, slices)
    lib = build.load("decode_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        None if pos is None else pos.data_ptr(),
        None if q_pos is None else q_pos.data_ptr(), out.data_ptr(),
        None if scores is None else scores.data_ptr(), stats.data_ptr(),
        part.data_ptr(), None if vidx is None else vidx.data_ptr(),
        arrivals.data_ptr(), B, T, KV, G, hd, int(window), splits, L, scale,
        int(q.dtype == torch.bfloat16), cache_type, ROUTE_CODES[route],
        stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed on the "
                           f"{route} route: CUDA error {err}")
    return out, route


def cross_decode_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor) -> torch.Tensor:
    """The cross route (module docstring): q (B, 1, H, hd) against the
    cross cache's k, v (B, T, KV, hd), all float32 or all bfloat16.
    CUDA tensors launch ``csrc/decode_attention.cu``'s cross route, one
    device kernel (counted in this function's ``launches``); CPU tensors
    take ``cross_decode_attention_plain``. The cache is read in place."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or \
            v.shape != k.shape or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"cross_decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; expected "
                         "(B, 1, H, hd) and (B, T, KV, hd)")
    B, _, H, hd = q.shape
    KV = k.shape[2]
    if KV == 0 or H % KV:
        raise ValueError(f"cross_decode_attention: {H} query heads over "
                         f"{KV} KV heads")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"cross_decode_attention: q {q.dtype}, k {k.dtype},"
                        f" v {v.dtype}; all float32 or all bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"cross_decode_attention: k on {k.device}, v on "
                         f"{v.device}, q on {q.device}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"cross_decode_attention: head dim {hd} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if q.device.type == "cpu":
        return cross_decode_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"cross_decode_attention: unsupported device "
                         f"{q.device}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("cross_decode_attention: k and v must be "
                         "contiguous")
    out, launched = _launch(q, k, v, None, None, None, None, 0,
                            inv_sqrt_hd(hd), _ROUTES[k.dtype][0], True)
    cross_decode_attention_kernel.launches += int(launched is not None)
    return out


cross_decode_attention_kernel.launches = 0
