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
(``configs/``).

Joint co-search: a ``WorkloadFamily`` (``resnet_family``,
``vit_family``) turns architecture knobs into genome columns, and a
``WorkloadBuilder`` maps each genome's arch slice to padded per-genome
workload tensors by a mixed-radix index and table gathers on the
genomes' device.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

WEIGHT_BITS = 8  # all models quantized to 8-bit weights/activations (§IV)


@dataclasses.dataclass
class Workload:
    name: str
    layers: np.ndarray  # (L, 3) float64 [M, K, N]
    stored_weights: float  # weights the chip must hold (>= active for MoE)
    # per-layer weight precision (L,) in bits; None = WEIGHT_BITS
    # everywhere. Only the joint co-search families vary it.
    weight_bits: Optional[np.ndarray] = None

    @property
    def n_layers(self) -> int:
        return int(self.layers.shape[0])

    @property
    def layer_weight_bits(self) -> np.ndarray:
        if self.weight_bits is None:
            return np.full((self.n_layers,), float(WEIGHT_BITS))
        return np.asarray(self.weight_bits, dtype=np.float64)


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


# ---------------------------------------------------------------------------
# Workload families: architecture dimensions as searchable genome slices
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArchParam:
    """One searchable architecture dimension of a workload family."""
    name: str
    values: Tuple[float, ...]


@dataclasses.dataclass
class WorkloadFamily:
    """A parameterized model family whose architecture knobs become extra
    genome dimensions in a joint co-search (``joint_space``).
    ``build(cfg)`` maps a {param: value} dict to a ``Workload`` (with
    per-layer ``weight_bits``); ``base_accuracy(cfg)`` is the clean
    accuracy of that architecture."""
    name: str
    params: Tuple[ArchParam, ...]
    build: Callable[[dict], Workload]
    base_accuracy: Callable[[dict], float]

    def __post_init__(self):
        self._combos_cache: Optional[List[dict]] = None
        self._built_cache: Optional[List[Workload]] = None

    @property
    def cardinalities(self) -> Tuple[int, ...]:
        return tuple(len(p.values) for p in self.params)

    @property
    def n_combos(self) -> int:
        return int(np.prod(self.cardinalities))

    def combos(self) -> List[dict]:
        """All {param: value} configs in mixed-radix order (the first
        param is the most significant digit), the builder's index
        order."""
        if self._combos_cache is None:
            self._combos_cache = [
                dict(zip((p.name for p in self.params), vals))
                for vals in itertools.product(*(p.values for p in self.params))
            ]
        return self._combos_cache

    def built(self) -> List[Workload]:
        if self._built_cache is None:
            self._built_cache = [self.build(c) for c in self.combos()]
        return self._built_cache

    def build_at(self, idx: Sequence[int]) -> Workload:
        cfg = {p.name: p.values[int(i)] for p, i in zip(self.params, idx)}
        return self.build(cfg)

    def accuracy_at(self, idx: Sequence[int]) -> float:
        cfg = {p.name: p.values[int(i)] for p, i in zip(self.params, idx)}
        return float(self.base_accuracy(cfg))

    @property
    def n_layers(self) -> int:
        """Max layer count over the family (padded tensor depth)."""
        return max(w.n_layers for w in self.built())


def _resnet_at(cfg: dict) -> Workload:
    """Uniform basic-block ResNet: depth d -> (d-2)//8 blocks per stage
    (d=18 reproduces ``resnet18()`` exactly at width 1.0)."""
    depth = int(cfg["depth"])
    wm = float(cfg["width_mult"])
    nblk = (depth - 2) // 8
    ch = [max(8, int(round(c * wm))) for c in (64, 128, 256, 512)]
    L: List[Tuple[float, float, float]] = [_conv(112, 3, 7, ch[0])]
    cin = ch[0]
    for cout, hw in zip(ch, (56, 28, 14, 7)):
        for b in range(nblk):
            c_in = cin if b == 0 else cout
            L.append(_conv(hw, c_in, 3, cout))
            L.append(_conv(hw, cout, 3, cout))
        if cin != cout:
            L.append(_conv(hw, cin, 1, cout))  # projection shortcut
        cin = cout
    L.append(_fc(ch[3], 1000))
    arr = np.asarray(L, dtype=np.float64)
    n = arr.shape[0]
    wb = np.full((n,), float(cfg.get("wbits_late", WEIGHT_BITS)))
    wb[: n // 2] = float(cfg.get("wbits_early", WEIGHT_BITS))
    return Workload(name=f"resnet_d{depth}_w{wm:g}",
                    layers=arr,
                    stored_weights=float(np.sum(arr[:, 1] * arr[:, 2])),
                    weight_bits=wb)


def _resnet_base_acc(cfg: dict) -> float:
    """Clean top-1 anchored at ResNet18/ImageNet = 0.698; depth and
    width follow the published ResNet scaling trend, low-precision
    weights cost accuracy (stronger for 4-bit)."""
    depth = float(cfg["depth"])
    wm = float(cfg["width_mult"])
    bits = 0.5 * (float(cfg.get("wbits_early", 8))
                  + float(cfg.get("wbits_late", 8)))
    acc = (0.698 + 0.045 * np.log2(depth / 18.0)
           + 0.030 * np.log2(wm)
           - 0.040 * (8.0 - bits) / 4.0)
    return float(np.clip(acc, 0.30, 0.92))


def resnet_family() -> WorkloadFamily:
    return WorkloadFamily(
        name="resnet_family",
        params=(ArchParam("depth", (10.0, 18.0, 26.0, 34.0)),
                ArchParam("width_mult", (0.5, 1.0, 1.5)),
                ArchParam("wbits_early", (4.0, 8.0)),
                ArchParam("wbits_late", (4.0, 8.0))),
        build=_resnet_at,
        base_accuracy=_resnet_base_acc)


def _vit_at(cfg: dict) -> Workload:
    depth = int(cfg["depth"])
    heads = int(cfg["heads"])
    ff_ratio = float(cfg["ff_ratio"])
    d = 768
    L = [(196.0, 768.0, 768.0)]  # patch embedding (16*16*3 = 768)
    L += _transformer_layers(197, d, int(ff_ratio * d), depth, 1000,
                             d_head_total=heads * 64)
    arr = np.asarray(L, dtype=np.float64)
    wb = np.full((arr.shape[0],), float(cfg.get("wbits", WEIGHT_BITS)))
    return Workload(name=f"vit_d{depth}_h{heads}_f{ff_ratio:g}",
                    layers=arr,
                    stored_weights=float(np.sum(arr[:, 1] * arr[:, 2])),
                    weight_bits=wb)


def _vit_base_acc(cfg: dict) -> float:
    """Clean top-1 anchored at ViT-B/16 (depth 12, heads 12, ff 4x,
    8-bit) = 0.779."""
    acc = (0.779 + 0.050 * np.log2(float(cfg["depth"]) / 12.0)
           + 0.020 * np.log2(float(cfg["heads"]) / 12.0)
           + 0.020 * np.log2(float(cfg["ff_ratio"]) / 4.0)
           - 0.040 * (8.0 - float(cfg.get("wbits", 8))) / 4.0)
    return float(np.clip(acc, 0.30, 0.92))


def vit_family() -> WorkloadFamily:
    return WorkloadFamily(
        name="vit_family",
        params=(ArchParam("depth", (6.0, 12.0)),
                ArchParam("heads", (6.0, 12.0)),
                ArchParam("ff_ratio", (2.0, 4.0)),
                ArchParam("wbits", (4.0, 8.0))),
        build=_vit_at,
        base_accuracy=_vit_base_acc)


_FAMILY_REGISTRY = {
    "resnet_family": resnet_family,
    "vit_family": vit_family,
}

FAMILY_NAMES = tuple(sorted(_FAMILY_REGISTRY))


def get_family(name: str) -> WorkloadFamily:
    try:
        return _FAMILY_REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown workload family {name!r}; valid families: "
            + ", ".join(sorted(_FAMILY_REGISTRY))) from None


class WorkloadTensors(NamedTuple):
    """Per-genome workload descriptors from a ``WorkloadBuilder``.
    Leading axes are the genomes' batch axes, then the workload slot W.
    ``layers`` pads with benign 1.0 rows (masked out), ``wbits`` with
    8.0."""
    layers: torch.Tensor    # (..., W, Lmax, 3)
    mask: torch.Tensor      # (..., W, Lmax)
    wbits: torch.Tensor     # (..., W, Lmax)
    stored: torch.Tensor    # (..., W)
    base_acc: torch.Tensor  # (..., W)
    n_layers: torch.Tensor  # (..., W)


def _pack_combo_tables(workloads: Sequence[Workload], lmax: int):
    C = len(workloads)
    layers = np.ones((C, lmax, 3), dtype=np.float32)
    mask = np.zeros((C, lmax), dtype=np.float32)
    wbits = np.full((C, lmax), float(WEIGHT_BITS), dtype=np.float32)
    stored = np.zeros((C,), dtype=np.float32)
    nl = np.zeros((C,), dtype=np.float32)
    for i, w in enumerate(workloads):
        layers[i, : w.n_layers] = w.layers
        mask[i, : w.n_layers] = 1.0
        wbits[i, : w.n_layers] = w.layer_weight_bits
        stored[i] = w.stored_weights
        nl[i] = w.n_layers
    return layers, mask, wbits, stored, nl


@dataclasses.dataclass(frozen=True)
class _BuilderSlot:
    cols: Tuple[int, ...]       # genome columns, most-significant first
    radices: Tuple[int, ...]    # cardinalities matching ``cols``
    layers: np.ndarray          # (C, Lmax, 3)
    mask: np.ndarray            # (C, Lmax)
    wbits: np.ndarray           # (C, Lmax)
    stored: np.ndarray          # (C,)
    base_acc: np.ndarray        # (C,)
    n_layers: np.ndarray        # (C,)


@dataclasses.dataclass(frozen=True)
class WorkloadBuilder:
    """Genome arch slice -> padded workload tensors.

    Every architecture combo of every family slot is built once on the
    host and packed into gather tables (one shared Lmax); a call is a
    mixed-radix index and table gathers on the genomes' device, whose
    copies of the tables are made once per device."""
    names: Tuple[str, ...]
    lmax: int
    slots: Tuple[_BuilderSlot, ...]
    _tables: Dict[torch.device, tuple] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def n_workloads(self) -> int:
        return len(self.names)

    def device_tables(self, device: torch.device) -> tuple:
        """The slots' gather tables on ``device`` (converted once)."""
        if device not in self._tables:
            self._tables[device] = tuple(
                {f: torch.as_tensor(getattr(s, f), device=device)
                 for f in WorkloadTensors._fields}
                for s in self.slots)
        return self._tables[device]

    def __call__(self, genomes: torch.Tensor) -> WorkloadTensors:
        g = genomes.long()
        per = {f: [] for f in WorkloadTensors._fields}
        for s, tables in zip(self.slots, self.device_tables(g.device)):
            idx = torch.zeros(g.shape[:-1], dtype=torch.int64,
                              device=g.device)
            for c, rad in zip(s.cols, s.radices):
                idx = idx * rad + g[..., c]
            for field in WorkloadTensors._fields:
                per[field].append(tables[field][idx])
        ax = g.dim() - 1
        return WorkloadTensors(**{k: torch.stack(v, dim=ax)
                                  for k, v in per.items()})


def make_workload_builder(space, workloads: Sequence[Union[Workload,
                                                           WorkloadFamily]]
                          ) -> WorkloadBuilder:
    """The genome-slice -> workload-tensor map. ``workloads`` may mix
    fixed ``Workload``s (constant slots) and ``WorkloadFamily``s (their
    params must be ``"<family>.<param>"`` columns of ``space``, as
    ``joint_space`` lays them out)."""
    from .nonideal import BASELINE_ACC, _DEFAULT_BASE_ACC
    built: List[List[Workload]] = []
    for w in workloads:
        built.append(w.built() if isinstance(w, WorkloadFamily) else [w])
    lmax = max(w.n_layers for combos in built for w in combos)
    slots = []
    for w, combos in zip(workloads, built):
        layers, mask, wbits, stored, nl = _pack_combo_tables(combos, lmax)
        if isinstance(w, WorkloadFamily):
            cols = tuple(space.names.index(f"{w.name}.{p.name}")
                         for p in w.params)
            radices = w.cardinalities
            base = np.asarray([w.base_accuracy(c) for c in w.combos()],
                              dtype=np.float32)
        else:
            cols, radices = (), ()
            base = np.asarray([BASELINE_ACC.get(w.name, _DEFAULT_BASE_ACC)],
                              dtype=np.float32)
        slots.append(_BuilderSlot(cols=cols, radices=radices, layers=layers,
                                  mask=mask, wbits=wbits, stored=stored,
                                  base_acc=base, n_layers=nl))
    names = tuple(w.name for w in workloads)
    return WorkloadBuilder(names=names, lmax=lmax, slots=tuple(slots))
