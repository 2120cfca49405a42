"""Carries the reference's state across into the port.

The co-design system has no weights. Its "parameters" are the PRNG
keys, the search-space value tables, the hardware constants, the
workloads and packed workload arrays, the LM architecture configs, the
calibration GEMM operands and genome populations. The LM stack it
serves has weights: ``from_reference_lm_params`` carries them. Each ``from_reference_*``
function takes them as the JAX side produces them (numpy arrays, or
objects exposing the same fields as numpy arrays) and returns the
port's tensors and dataclasses, so a test can feed both packages
exactly the same state. Tensors land on ``device``, which defaults to
``"cuda"`` like every entry point of the port (``device.resolve_device``).
Nothing here imports the reference package: objects are read by their
field names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .core.cost_model import HWConstants
from .core.search_space import SearchSpace
from .core.workloads import Workload, WorkloadArrays
from .device import resolve_device
from .models import ArchConfig
from .models.transformer import LM, init_params


def from_reference_key(key, device="cuda") -> torch.Tensor:
    """A raw threefry key (or a batch of keys) of uint32 values, shape
    (..., 2) -> the port's int64 key tensor."""
    arr = np.asarray(key)
    if arr.shape[-1] != 2 or arr.dtype != np.uint32:
        raise TypeError("expected raw uint32 threefry key data of shape "
                        f"(..., 2), got {arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.astype(np.int64),
                           device=resolve_device(device))


def from_reference_space(space) -> SearchSpace:
    """A reference ``SearchSpace`` (hardware-only or joint) -> the
    port's."""
    return SearchSpace(
        names=tuple(space.names),
        values=tuple(np.asarray(v, np.float32) for v in space.values),
        mem_type=str(space.mem_type),
        tech_is_variable=bool(space.tech_is_variable),
        n_arch=int(space.n_arch))


def from_reference_constants(constants) -> HWConstants:
    """A reference ``HWConstants`` dataclass -> the port's."""
    return HWConstants(**dataclasses.asdict(constants))


def from_reference_workload_arrays(wa) -> WorkloadArrays:
    """A reference ``WorkloadArrays`` (numpy fields) -> the port's."""
    return WorkloadArrays(
        names=tuple(wa.names),
        layers=np.asarray(wa.layers, np.float32),
        mask=np.asarray(wa.mask, np.float32),
        stored_weights=np.asarray(wa.stored_weights, np.float32),
        flat_layers=np.asarray(wa.flat_layers, np.float32),
        seg_ids=np.asarray(wa.seg_ids, np.int32))


def from_reference_workload(wl) -> Workload:
    """A reference ``Workload`` -> the port's (float64 layers and
    per-layer weight bits, None where the reference has none)."""
    wb = wl.weight_bits
    return Workload(name=str(wl.name),
                    layers=np.array(wl.layers, np.float64),
                    stored_weights=float(wl.stored_weights),
                    weight_bits=None if wb is None
                    else np.array(wb, np.float64))


def from_reference_arch_config(cfg) -> ArchConfig:
    """A reference ``ArchConfig`` -> the port's, read field by field."""
    return ArchConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(ArchConfig)})


def from_reference_calibration(x, w, device="cuda"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibration GEMM operands (activations (B, K), weights (K, N))
    -> float32 tensors."""
    dev = resolve_device(device)
    # np.array copies: arrays the reference hands out are read-only
    return (torch.as_tensor(np.array(x, np.float32), device=dev),
            torch.as_tensor(np.array(w, np.float32), device=dev))


def from_reference_genomes(genomes, device="cuda") -> torch.Tensor:
    """An integer genome population (..., n) -> int64 tensor."""
    return torch.as_tensor(np.asarray(genomes).astype(np.int64),
                           device=resolve_device(device))


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            _flatten(leaf, f"{prefix}{name}.", out)
        else:
            out[prefix + name] = leaf


# the LM's leaves outside its blocks (the frontends' where the config has
# one)
_TOP_LEVEL = ("embed", "frontend", "vis_proj", "final_ln", "unembed")


def from_reference_lm_params(params, cfg: ArchConfig, device="cuda") -> LM:
    """The reference's ``init_params`` tree, as numpy arrays (``embed``,
    ``final_ln``, ``unembed``, ``frontend`` or ``vis_proj`` with a
    frontend, ``period/pos{i}`` with a leading depth axis, ``rem``), ->
    the port's ``LM`` with the same values in the config's type. Layer
    ``n * len(pattern) + i`` of the port is entry ``n`` of
    ``period/pos{i}``; the ``rem`` blocks follow. A nested
    leaf (an ``rglru`` block's ``lru`` dict) takes its dotted name
    (``lru.a_param``), and each leaf keeps the type of its port
    parameter (``conv``, ``lru``, an ``slstm`` block's ``r`` and a MoE
    FFN's ``ffn.router`` stay float32 in a bfloat16 model, and a ``cross_attn`` block's stacked
    ``gate_attn``/``gate_mlp`` unstack to 0-dim float32 parameters; the
    ``mlstm`` and ``slstm`` blocks have no ``ln2`` or ``ffn``, as the
    reference's).
    The module is built by a throwaway seeded init on the CPU, then
    overwritten, so every reference leaf must have a port counterpart
    and vice versa."""
    pattern, n_full, rem = cfg.schedule()
    leaves = {k: params[k] for k in _TOP_LEVEL if k in params}
    for layer in range(len(cfg.layout())):
        n, i = divmod(layer, len(pattern))
        block: Dict[str, np.ndarray] = {}
        if n < n_full:
            _flatten(params["period"][f"pos{i}"], "", block)
            block = {k: v[n] for k, v in block.items()}
        else:
            _flatten(params["rem"][layer - n_full * len(pattern)], "", block)
        leaves.update({f"blocks.{layer}.{k}": v for k, v in block.items()})
    model = init_params(torch.Generator().manual_seed(0), cfg)
    # float32 first: numpy has no bfloat16, and bf16 -> f32 -> bf16 is exact
    model.load_state_dict(
        {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in
         leaves.items()}, strict=True)
    return model.to(resolve_device(device))


def from_reference_train_state(state, cfg: ArchConfig, device="cuda"):
    """The reference's ``TrainState`` (params, AdamW ``m``, ``v`` and
    ``count``, ``step``), its arrays as numpy, -> the port's
    ``train.loop.TrainState``: the parameters as a training ``LM`` in
    the config's type, ``m`` and ``v`` as float32 trees keyed by the
    LM's parameter names (each through ``from_reference_lm_params`` at
    float32), the counters as ints."""
    from .train.loop import TrainState
    from .train.optimizer import AdamWState
    dev = resolve_device(device)
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def tree(t):
        return {k: p.detach() for k, p in from_reference_lm_params(
            t, cfg32, dev).named_parameters()}
    params = from_reference_lm_params(state.params, cfg, dev).train()
    opt = AdamWState(m=tree(state.opt.m), v=tree(state.opt.v),
                     count=int(np.asarray(state.opt.count)))
    return TrainState(params=params, opt=opt,
                      step=int(np.asarray(state.step)))


def to_reference_lm_tree(tree: Dict[str, torch.Tensor],
                         cfg: ArchConfig) -> Dict:
    """The reverse of ``from_reference_lm_params`` for a tree keyed by
    the LM's parameter names (gradients, AdamW moments): float32 numpy
    arrays in the reference's layout, each pattern position's layers
    stacked over depth. For comparing with the reference in tests."""
    pattern, n_full, rem = cfg.schedule()
    out: Dict = {k: tree[k].detach().float().cpu().numpy()
                 for k in _TOP_LEVEL if k in tree}

    def nest(flat: Dict[str, np.ndarray]) -> Dict:
        d: Dict = {}
        for k, v in flat.items():
            *path, leaf = k.split(".")
            node = d
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
        return d

    def layer(i: int) -> Dict[str, np.ndarray]:
        pre = f"blocks.{i}."
        return {k[len(pre):]: t.detach().float().cpu().numpy()
                for k, t in tree.items() if k.startswith(pre)}

    period = {}
    for i in range(len(pattern)):
        layers = [layer(n * len(pattern) + i) for n in range(n_full)]
        if layers:
            period[f"pos{i}"] = nest({k: np.stack([lay[k] for lay in layers])
                                      for k in layers[0]})
    out["period"] = period
    out["rem"] = [nest(layer(n_full * len(pattern) + j))
                  for j in range(len(rem))]
    return out
