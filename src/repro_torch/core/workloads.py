"""Workload descriptors for IMC co-optimization (paper §III-A, §IV-J);
counterpart of ``repro/core/workloads.py`` (the fixed workload zoo,
``WorkloadArrays`` and ``pack``).

A workload is a sequence of GEMM layers. Each layer is (M, K, N):
  M — number of input vectors per inference (conv: H_out*W_out; LM: tokens)
  K — reduction dim (conv: Cin*kh*kw)
  N — output dim
MACs = M*K*N, weights = K*N. Depthwise convs are encoded (M=HW, K=kh*kw,
N=C). The packed arrays stay host numpy; the cost model moves them to
its device. ``from_arch_config`` exports the assigned LM architectures
(``configs/``). The joint co-search families and builder are not
ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

WEIGHT_BITS = 8  # all models quantized to 8-bit weights/activations (§IV)


@dataclasses.dataclass
class Workload:
    name: str
    layers: np.ndarray  # (L, 3) float64 [M, K, N]
    stored_weights: float  # weights the chip must hold (>= active for MoE)

    @property
    def n_layers(self) -> int:
        return int(self.layers.shape[0])


def _wl(name: str, layers: Sequence[Tuple[float, float, float]],
        stored_weights: Optional[float] = None) -> Workload:
    arr = np.asarray(layers, dtype=np.float64)
    if stored_weights is None:
        stored_weights = float(np.sum(arr[:, 1] * arr[:, 2]))
    return Workload(name=name, layers=arr, stored_weights=stored_weights)


# ---------------------------------------------------------------------------
# Paper CNN workloads (ImageNet-shape unless noted)
# ---------------------------------------------------------------------------

def _conv(hw: int, cin: int, k: int, cout: int) -> Tuple[float, float, float]:
    return (float(hw * hw), float(cin * k * k), float(cout))


def _dw(hw: int, c: int, k: int) -> Tuple[float, float, float]:
    return (float(hw * hw), float(k * k), float(c))


def _fc(cin: int, cout: int) -> Tuple[float, float, float]:
    return (1.0, float(cin), float(cout))


def resnet18() -> Workload:
    L: List[Tuple[float, float, float]] = [_conv(112, 3, 7, 64)]
    spec = [(64, 64, 56, 2), (64, 128, 28, 2), (128, 256, 14, 2), (256, 512, 7, 2)]
    for cin, cout, hw, nblk in spec:
        for b in range(nblk):
            c_in = cin if b == 0 else cout
            L.append(_conv(hw, c_in, 3, cout))
            L.append(_conv(hw, cout, 3, cout))
        if cin != cout:
            L.append(_conv(hw, cin, 1, cout))  # projection shortcut
    L.append(_fc(512, 1000))
    return _wl("resnet18", L)


def resnet50() -> Workload:
    L: List[Tuple[float, float, float]] = [_conv(112, 3, 7, 64)]
    spec = [(64, 256, 56, 3), (256, 512, 28, 4), (512, 1024, 14, 6),
            (1024, 2048, 7, 3)]
    for cin, cout, hw, nblk in spec:
        mid = cout // 4
        for b in range(nblk):
            c_in = cin if b == 0 else cout
            L.append(_conv(hw, c_in, 1, mid))
            L.append(_conv(hw, mid, 3, mid))
            L.append(_conv(hw, mid, 1, cout))
        L.append(_conv(hw, cin, 1, cout))
    L.append(_fc(2048, 1000))
    return _wl("resnet50", L)


def vgg16() -> Workload:
    L = [_conv(224, 3, 3, 64), _conv(224, 64, 3, 64),
         _conv(112, 64, 3, 128), _conv(112, 128, 3, 128),
         _conv(56, 128, 3, 256), _conv(56, 256, 3, 256), _conv(56, 256, 3, 256),
         _conv(28, 256, 3, 512), _conv(28, 512, 3, 512), _conv(28, 512, 3, 512),
         _conv(14, 512, 3, 512), _conv(14, 512, 3, 512), _conv(14, 512, 3, 512),
         _fc(25088, 4096), _fc(4096, 4096), _fc(4096, 1000)]
    return _wl("vgg16", L)


def alexnet() -> Workload:
    L = [(55.0 * 55, 3.0 * 121, 64.0), (27.0 * 27, 64.0 * 25, 192.0),
         (13.0 * 13, 192.0 * 9, 384.0), (13.0 * 13, 384.0 * 9, 256.0),
         (13.0 * 13, 256.0 * 9, 256.0),
         _fc(9216, 4096), _fc(4096, 4096), _fc(4096, 1000)]
    return _wl("alexnet", L)


def mobilenetv3() -> Workload:
    """MobileNetV3-Large (approximate inverted-residual table)."""
    L: List[Tuple[float, float, float]] = [_conv(112, 3, 3, 16)]
    # (hw, cin, exp, cout, k)
    blocks = [
        (112, 16, 16, 16, 3), (56, 16, 64, 24, 3), (56, 24, 72, 24, 3),
        (28, 24, 72, 40, 5), (28, 40, 120, 40, 5), (28, 40, 120, 40, 5),
        (14, 40, 240, 80, 3), (14, 80, 200, 80, 3), (14, 80, 184, 80, 3),
        (14, 80, 184, 80, 3), (14, 80, 480, 112, 3), (14, 112, 672, 112, 3),
        (7, 112, 672, 160, 5), (7, 160, 960, 160, 5), (7, 160, 960, 160, 5),
    ]
    for hw, cin, exp, cout, k in blocks:
        if exp != cin:
            L.append(_conv(hw, cin, 1, exp))
        L.append(_dw(hw, exp, k))
        L.append(_conv(hw, exp, 1, cout))
    L.append(_conv(7, 160, 1, 960))
    L.append(_fc(960, 1280))
    L.append(_fc(1280, 1000))
    return _wl("mobilenetv3", L)


def densenet201() -> Workload:
    L: List[Tuple[float, float, float]] = [_conv(112, 3, 7, 64)]
    growth, c = 32, 64
    for hw, nlayer in [(56, 6), (28, 12), (14, 48), (7, 32)]:
        for _ in range(nlayer):
            L.append(_conv(hw, c, 1, 4 * growth))
            L.append(_conv(hw, 4 * growth, 3, growth))
            c += growth
        if hw != 7:
            L.append(_conv(hw // 2, c, 1, c // 2))
            c //= 2
    L.append(_fc(c, 1000))
    return _wl("densenet201", L)


# ---------------------------------------------------------------------------
# Paper transformer workloads
# ---------------------------------------------------------------------------

def _transformer_layers(seq: int, d: int, ff: int, n_layers: int,
                        vocab: int, d_head_total: Optional[int] = None,
                        ) -> List[Tuple[float, float, float]]:
    dht = d_head_total or d
    L: List[Tuple[float, float, float]] = []
    for _ in range(n_layers):
        L.append((float(seq), float(d), float(3 * dht)))   # QKV
        L.append((float(seq), float(dht), float(d)))       # out proj
        L.append((float(seq), float(d), float(ff)))        # FFN up
        L.append((float(seq), float(ff), float(d)))        # FFN down
    L.append((float(seq), float(d), float(vocab)))         # unembed
    return L


def vit_b16() -> Workload:
    L = [(196.0, 768.0, 768.0)]  # patch embedding as GEMM (16*16*3 = 768)
    L += _transformer_layers(197, 768, 3072, 12, 1000)
    return _wl("vit_b16", L)


def mobilebert() -> Workload:
    """MobileBERT: 24 bottleneck blocks, d=512, intra=128, seq=128."""
    L: List[Tuple[float, float, float]] = []
    seq, d, intra = 128.0, 512.0, 128.0
    for _ in range(24):
        L.append((seq, d, intra))            # bottleneck in
        L.append((seq, intra, 3 * intra))    # QKV
        L.append((seq, intra, intra))        # attn out
        for _ in range(4):                   # stacked FFNs
            L.append((seq, intra, 4 * intra))
            L.append((seq, 4 * intra, intra))
        L.append((seq, intra, d))            # bottleneck out
    L.append((seq, d, 30522.0))
    return _wl("mobilebert", L)


def gpt2_medium(seq: int = 1024) -> Workload:
    L = _transformer_layers(seq, 1024, 4096, 24, 50257)
    return _wl("gpt2_medium", L)


# ---------------------------------------------------------------------------
# Assigned LM architectures as IMC workloads
# ---------------------------------------------------------------------------

def from_arch_config(cfg, seq: int = 512) -> Workload:
    """Export one of the 10 assigned architecture configs as an IMC
    workload (per-layer GEMMs at sequence length ``seq``, batch 1).

    Recurrent blocks (RG-LRU, xLSTM) export their projection GEMMs; the
    diagonal state recurrence itself is an elementwise vector op with
    negligible crossbar cost. MoE blocks export top-k active expert
    GEMMs and report full expert storage via ``stored_weights``.
    """
    L: List[Tuple[float, float, float]] = []
    stored_extra = 0.0
    s, d = float(seq), float(cfg.d_model)
    dht = float(cfg.n_heads * cfg.head_dim)
    dkv = float(cfg.n_kv_heads * cfg.head_dim)
    for kind in cfg.layout():
        if kind in ("attn", "local_attn", "cross_attn"):
            L.append((s, d, dht + 2 * dkv))   # fused QKV
            L.append((s, dht, d))
        elif kind == "rglru":
            w = float(cfg.rnn_width or cfg.d_model)
            L.append((s, d, 2 * w))           # x/gate in-proj
            L.append((s, w, d))               # out proj
        elif kind in ("mlstm", "slstm"):
            w = 2.0 * d                        # proj_factor 2 up/down
            L.append((s, d, 2 * w))
            L.append((s, w, d))
        else:
            raise ValueError(kind)
        if cfg.n_experts > 1 and kind not in ("rglru", "mlstm", "slstm"):
            ff = float(cfg.d_ff)
            k = float(cfg.top_k)
            L.append((s, d, k * 2 * ff))      # active experts (gated up)
            L.append((s, k * ff, d))
            stored_extra += (cfg.n_experts - cfg.top_k) * (3 * d * ff)
        elif cfg.d_ff:
            ff = float(cfg.d_ff)
            mult = 2.0 if cfg.gated_mlp else 1.0
            L.append((s, d, mult * ff))
            L.append((s, ff, d))
    L.append((s, d, float(cfg.vocab_size)))   # unembed
    active = float(np.sum(np.asarray(L)[:, 1] * np.asarray(L)[:, 2]))
    return Workload(name=cfg.name, layers=np.asarray(L, dtype=np.float64),
                    stored_weights=active + stored_extra)


# ---------------------------------------------------------------------------
# Workload sets & padded array packing for the vectorized cost model
# ---------------------------------------------------------------------------

PAPER_4 = ("resnet18", "vgg16", "alexnet", "mobilenetv3")
PAPER_9 = PAPER_4 + ("mobilebert", "densenet201", "resnet50", "vit_b16",
                     "gpt2_medium")

_REGISTRY = {
    "resnet18": resnet18, "resnet50": resnet50, "vgg16": vgg16,
    "alexnet": alexnet, "mobilenetv3": mobilenetv3,
    "densenet201": densenet201, "vit_b16": vit_b16,
    "mobilebert": mobilebert, "gpt2_medium": gpt2_medium,
}


def get_workload(name: str) -> Workload:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r}; valid workloads: "
            + ", ".join(sorted(_REGISTRY))) from None


def get_workload_set(names: Sequence[str]) -> List[Workload]:
    return [get_workload(n) for n in names]


@dataclasses.dataclass
class WorkloadArrays:
    """Packed host arrays for the population cost model.

    Two layouts are carried:
      padded  — (W, Lmax, 3) + mask (kept for parity with the reference)
      flat    — (Ltot, 3) + segment ids: the cost model computes
                per-layer terms over the ragged flat axis and
                segment-sums to (P, W).
    """
    names: Tuple[str, ...]
    layers: np.ndarray        # (W, Lmax, 3) float32 (padded)
    mask: np.ndarray          # (W, Lmax) float32
    stored_weights: np.ndarray  # (W,) float32
    flat_layers: np.ndarray   # (Ltot, 3) float32
    seg_ids: np.ndarray       # (Ltot,) int32 workload index per layer

    @property
    def n_workloads(self) -> int:
        return len(self.names)


def pack(workloads: Sequence[Workload]) -> WorkloadArrays:
    lmax = max(w.n_layers for w in workloads)
    W = len(workloads)
    layers = np.zeros((W, lmax, 3), dtype=np.float32)
    mask = np.zeros((W, lmax), dtype=np.float32)
    stored = np.zeros((W,), dtype=np.float32)
    flat, segs = [], []
    for i, w in enumerate(workloads):
        layers[i, : w.n_layers] = w.layers
        layers[i, w.n_layers:] = 1.0  # benign pad (masked out)
        mask[i, : w.n_layers] = 1.0
        stored[i] = w.stored_weights
        flat.append(w.layers.astype(np.float32))
        segs.append(np.full((w.n_layers,), i, np.int32))
    return WorkloadArrays(names=tuple(w.name for w in workloads),
                          layers=layers, mask=mask, stored_weights=stored,
                          flat_layers=np.concatenate(flat, axis=0),
                          seg_ids=np.concatenate(segs, axis=0))
