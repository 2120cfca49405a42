"""Vectorized analytical IMC cost model (the CIMLoop role, §III-A);
counterpart of ``repro/core/cost_model.py``.

Given a population of hardware genomes and a packed workload set, this
computes energy (J) and latency (s) per (design × workload) and chip
area (mm²) per design by broadcasting over the population and the
ragged flat layer axis, reduced per workload with a one-hot segment
matmul (``torch.matmul`` in float64, as the reference leaves its
float32 one to XLA).

Tiled crossbar architecture (Fig. 2 of the paper):
  chip = G_per_chip tile groups × (T_per_router tiles + 1 router) + GLB
  tile = C_per_tile crossbar macros + I/O buffers
  macro = Xbar_rows × Xbar_cols cells + drivers + ONE 8-bit ADC
RRAM is weight-stationary (all weights on-chip or infeasible); SRAM
swaps weights in from LPDDR4. Constants are 32 nm NeuroSim/ISAAC-style
estimates scaled by technology node and operating voltage (Table 7).

Operation order follows the reference line by line. Two rules keep the
arithmetic the reference's: a division of a tensor by a Python constant
is a multiplication by the float32 reciprocal (``_div_const``), which is
what XLA compiles ``x / const`` into; a Python constant divided by a
tensor is a true division (``_rdiv``), never PyTorch's ``reciprocal() *
c``. Transcendental functions go through ``pointwise``, so a design's
score does not depend on where it sits in the population: PyTorch's
CPU kernels run the vector body and the scalar tail of a loop through
different float32 implementations, which differ in the last bit.

The joint co-search path (``evaluate_population_joint``) builds each
genome's layers from its arch slice (``workloads.WorkloadBuilder``):
padded (P, W * Lmax) layer axes whose pads are zeroed before every
segment sum, and per-layer weight precision in the cells-per-weight
mapping.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from .search_space import (TECH_32NM_INDEX, TECH_COST_ALPHA, TECH_NODES_NM,
                           TECH_VMAX, TECH_VMIN, V_NOM, SearchSpace)
from .workloads import WorkloadArrays, WorkloadBuilder


@dataclasses.dataclass(frozen=True)
class HWConstants:
    """32 nm reference constants."""
    e_mac_rram: float = 0.010e-12   # J per 1-bit MAC in the array
    e_mac_sram: float = 0.015e-12
    e_adc: float = 2.0e-12          # J per 8-bit conversion
    e_buf: float = 0.05e-12         # J per byte buffer access
    e_router: float = 0.5e-12       # J per byte per hop
    e_dram: float = 40.0e-12        # J per byte (LPDDR4)
    dram_bw: float = 25.6e9         # B/s (LPDDR4)
    noc_bytes_per_cycle: float = 16.0  # per router
    p_static_xbar: float = 30.0e-6  # W leak per macro
    p_static_tile: float = 5.0e-6   # W leak per tile
    base_min_cycle_ns: float = 1.0  # at 32nm, V=1.0
    cell_f2_rram: float = 4.0
    cell_f2_sram: float = 160.0
    adc_area_mm2: float = 0.0012
    driver_area_per_row_mm2: float = 1.7e-7
    tile_buf_area_mm2: float = 0.005
    router_area_mm2: float = 0.02
    glb_mb_per_mm2: float = 0.75    # SRAM density at 32nm
    max_duplication: float = 16.0   # router/IO-bound cap on replication
    weight_bits: float = 8.0
    # memory-cell scaling saturates below ~14nm — floor on the area
    # shrink factor
    mem_area_scale_floor: float = 0.30


class CostMetrics(NamedTuple):
    energy: torch.Tensor      # (P, W) joules
    latency: torch.Tensor     # (P, W) seconds
    area: torch.Tensor        # (P,) mm^2
    feasible: torch.Tensor    # (P,) bool — capacity feasibility (RRAM)
    cost: torch.Tensor        # (P,) normalized fabrication cost
    feasible_w: torch.Tensor  # (P, W) bool — per-workload capacity fit


# defaults for parameters a space fixes rather than searches
_PARAM_DEFAULTS = {
    "bits_cell": 1.0,               # SRAM: 1 bit per cell
    "t_per_router": 8.0,
    "g_per_chip": 16.0,
    "glb_kb": 2048.0,
    "t_cycle_ns": 1.0,
    "v_op_step": 1.0,
    "tech_idx": float(TECH_32NM_INDEX),
}


def _div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` for a Python constant ``c`` as the reference computes it:
    XLA rewrites it into ``x * float32(1 / float32(c))``."""
    return x * float(np.float32(1.0) / np.float32(c))


def pointwise(fn, x: torch.Tensor, *args) -> torch.Tensor:
    """The float32 tensor ``fn(x, *args)`` with the same bits wherever
    an element sits in ``x``. On the CPU it is evaluated in float64 and
    rounded once (the float32 vector body and scalar tail differ); on
    the GPU one device function computes every element, in float32."""
    if x.device.type == "cuda":
        return fn(x, *args)
    return fn(x.double(), *args).float()


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as a true float32 division."""
    return torch.full_like(x, c) / x


@dataclasses.dataclass(frozen=True)
class CostTables:
    """Everything the cost model reads, moved to a device once (a copy
    from host memory synchronizes the stream): the space's value table,
    the technology tables (Table 7), the flat layer columns (1, Ltot),
    the one-hot segment matrix (Ltot, W) and the stored weights (1, W).
    On the joint path (``joint``) the layer columns, stored weights,
    ``mask`` and ``wbits`` are per genome and filled in by
    ``with_layers``; the one-hot matrix is that of the padded
    (W * Lmax) layer axis."""
    values: torch.Tensor
    tech: Dict[str, torch.Tensor]
    M: Optional[torch.Tensor]
    K: Optional[torch.Tensor]
    N: Optional[torch.Tensor]
    seg_onehot: torch.Tensor
    stored_weights: Optional[torch.Tensor]
    mask: Optional[torch.Tensor] = None
    wbits: Optional[torch.Tensor] = None

    @staticmethod
    def _common(space: SearchSpace, device):
        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)
        tech = {"nm": dev(TECH_NODES_NM), "vmin": dev(TECH_VMIN),
                "vmax": dev(TECH_VMAX), "alpha": dev(TECH_COST_ALPHA)}
        return dev(space.value_table()), tech

    @staticmethod
    def of(space: SearchSpace, wl: WorkloadArrays, device) -> "CostTables":
        values, tech = CostTables._common(space, device)
        flat = torch.as_tensor(wl.flat_layers, device=device)
        seg = torch.as_tensor(wl.seg_ids, dtype=torch.int64, device=device)
        onehot = torch.nn.functional.one_hot(seg, wl.n_workloads).float()
        stored = torch.as_tensor(wl.stored_weights, device=device)
        return CostTables(values=values, tech=tech,
                          M=flat[None, :, 0], K=flat[None, :, 1],
                          N=flat[None, :, 2], seg_onehot=onehot,
                          stored_weights=stored[None, :])

    @staticmethod
    def joint(space: SearchSpace, builder: WorkloadBuilder,
              device) -> "CostTables":
        values, tech = CostTables._common(space, device)
        W, Lm = builder.n_workloads, builder.lmax
        seg = torch.arange(W, device=device).repeat_interleave(Lm)
        onehot = torch.nn.functional.one_hot(seg, W).float()
        return CostTables(values=values, tech=tech, M=None, K=None, N=None,
                          seg_onehot=onehot, stored_weights=None)

    def with_layers(self, builder: WorkloadBuilder,
                    genomes: torch.Tensor) -> "CostTables":
        """The joint tables with the layer tensors of ``genomes``
        (P, n) filled in: (P, W * Lmax) columns, mask and wbits."""
        wt = builder(genomes)
        P = genomes.shape[0]
        W, Lm = builder.n_workloads, builder.lmax
        layers = wt.layers.reshape(P, W * Lm, 3)
        return dataclasses.replace(
            self, M=layers[:, :, 0], K=layers[:, :, 1], N=layers[:, :, 2],
            stored_weights=wt.stored, mask=wt.mask.reshape(P, W * Lm),
            wbits=wt.wbits.reshape(P, W * Lm))


def _resolve(space: SearchSpace, table: torch.Tensor,
             genomes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Gather parameter values for each genome: dict of (P,) tensors.
    Parameters absent from the space take fixed defaults."""
    out = {}
    g = genomes.long()
    for i, name in enumerate(space.names):
        out[name] = table[i, g[:, i]]
    P = genomes.shape[0]
    for name, val in _PARAM_DEFAULTS.items():
        if name not in out:
            out[name] = torch.full((P,), val, dtype=torch.float32,
                                   device=table.device)
    return out


def _cost_core(space: SearchSpace, c: HWConstants, p: Dict[str, torch.Tensor],
               wt: CostTables) -> CostMetrics:
    """The reference's shared cost math over a (B, Lt) layer axis
    reduced to (P, W): the fixed path (B=1 flat layers, ``mask`` and
    ``wbits`` None, cells per weight per genome) or the joint path (B=P
    padded layers, pads zeroed by ``mask`` before every segment sum,
    cells per weight per layer from ``wbits``)."""
    is_rram = space.mem_type == "rram"
    M, K, N = wt.M, wt.K, wt.N
    seg_onehot, stored_weights = wt.seg_onehot, wt.stored_weights
    mask, wbits = wt.mask, wt.wbits

    rows, cols = p["xbar_rows"], p["xbar_cols"]
    n_xb = p["c_per_tile"] * p["t_per_router"] * p["g_per_chip"]
    bits_cell = p["bits_cell"]
    cpw = torch.ceil(_rdiv(c.weight_bits, bits_cell))   # cells per weight

    # --- technology / voltage scaling -------------------------------------
    tech_i = p["tech_idx"].long()
    tech_nm = wt.tech["nm"][tech_i]
    vmin = wt.tech["vmin"][tech_i]
    vmax = wt.tech["vmax"][tech_i]
    v_op = vmin + p["v_op_step"] * (vmax - vmin)
    tech_r = _div_const(tech_nm, 32.0)
    v_norm = _div_const(v_op, V_NOM)
    v_scale = v_norm * v_norm
    e_scale = tech_r * v_scale            # digital switching energy
    # ADCs scale weakly
    e_scale_adc = pointwise(torch.sqrt, tech_r) * v_scale
    area_scale = torch.clamp(tech_r * tech_r, min=c.mem_area_scale_floor)
    area_scale_analog = torch.clamp(tech_r, min=c.mem_area_scale_floor)
    v_gap = torch.clamp(v_op - 0.3, min=0.05)
    min_cycle = (c.base_min_cycle_ns * 1e-9 * tech_r
                 * pointwise(torch.pow, _rdiv(1.0 - 0.3, v_gap), 1.3))
    t_cycle = torch.maximum(p["t_cycle_ns"] * 1e-9, min_cycle)

    # --- per-layer crossbar mapping -----------------------------------------
    r_ = rows[:, None]
    c_ = cols[:, None]
    if wbits is None:
        cpw_ = cpw[:, None]
    else:
        cpw_ = torch.ceil(wbits / bits_cell[:, None])   # per-layer cells

    def sum_l(x):                                               # (P, W)
        # float64 segment sum, rounded once: XLA's float32 dot order
        # cannot be reproduced, and this keeps the port within ~1e-6 of
        # it on every registry configuration (ROADMAP Queue 3)
        if mask is not None:
            x = x * mask
        return (x.double() @ seg_onehot.double()).float()

    n_xb_row = torch.ceil(K / r_)
    n_xb_col = torch.ceil(N * cpw_ / c_)
    n_xb_layer = n_xb_row * n_xb_col

    # --- capacity / duplication / swap -------------------------------------
    # mapped-crossbar demand (whole crossbars per layer) drives capacity,
    # duplication and swapping (§IV-F)
    capacity_cells = n_xb * rows * cols                          # (P,)
    mapped_xbars = sum_l(n_xb_layer)                             # (P, W)
    extra_w = torch.clamp(stored_weights - sum_l(K * N), min=0.0)
    mapped_xbars = mapped_xbars + torch.ceil(
        extra_w * cpw[:, None] / (rows * cols)[:, None])
    mapped_cells = mapped_xbars * (rows * cols)[:, None]         # (P, W)
    cap_ok = mapped_xbars <= n_xb[:, None]
    feasible_w = cap_ok if is_rram else torch.ones_like(cap_ok)
    feasible = torch.all(feasible_w, dim=1)
    dup = torch.clamp(torch.floor(n_xb[:, None]
                                  / torch.clamp(mapped_xbars, min=1.0)),
                      1.0, c.max_duplication)
    if not is_rram:
        dup = torch.ones_like(dup)

    bitmacs = M * 8.0 * K * N * cpw_
    conversions = M * 8.0 * n_xb_row * (N * cpw_)
    act_bytes = M * (K + N)                      # 8-bit activations

    e_mac = c.e_mac_rram if is_rram else c.e_mac_sram
    hops = 1.0 + pointwise(torch.log2, p["g_per_chip"])[:, None]
    e_layer_dig = (bitmacs * e_mac + 2.0 * act_bytes * c.e_buf
                   + act_bytes * c.e_router * hops)
    e_layer_adc = conversions * c.e_adc

    # compute latency: ADC-muxed column readout, time-multiplexed if the
    # layer exceeds the chip's macro count, sped up by duplication
    tmux = torch.clamp(torch.ceil(n_xb_layer / n_xb[:, None]), min=1.0)
    l_compute = M * 8.0 * c_ * t_cycle[:, None] * tmux
    noc_bw = (c.noc_bytes_per_cycle * p["g_per_chip"] / t_cycle)  # B/s
    l_noc = act_bytes / noc_bw[:, None]

    # GLB spills: activations that do not fit the global buffer hit DRAM
    glb_bytes = p["glb_kb"][:, None] * 1024.0
    spill = torch.clamp(act_bytes - glb_bytes, min=0.0)
    e_spill = spill * c.e_dram
    l_spill = _div_const(spill, c.dram_bw)

    # DRAM (external) energy does not scale with the on-chip node
    E = (sum_l(e_layer_dig) * e_scale[:, None]
         + sum_l(e_layer_adc) * e_scale_adc[:, None]
         + sum_l(e_spill))
    L = sum_l(l_compute) / dup + sum_l(l_noc + l_spill)

    # SRAM weight swapping: the mapped capacity that does not fit on-chip
    # streams from DRAM as 8-bit weights each inference
    if not is_rram:
        swap_frac = torch.clamp(
            1.0 - capacity_cells[:, None] / torch.clamp(mapped_cells,
                                                        min=1.0),
            0.0, 1.0)
        swapped = stored_weights * swap_frac                    # bytes
        E = E + swapped * c.e_dram                              # external
        L = L + _div_const(swapped, c.dram_bw)

    # static power over the run
    p_static = (n_xb * c.p_static_xbar
                + p["t_per_router"] * p["g_per_chip"] * c.p_static_tile)
    E = E + p_static[:, None] * L * e_scale[:, None]

    # --- area ---------------------------------------------------------------
    f2_mm2 = (32.0e-6) ** 2  # F^2 in mm^2 at 32nm
    cell_f2 = c.cell_f2_rram if is_rram else c.cell_f2_sram
    macro_dig = rows * cols * cell_f2 * f2_mm2
    macro_ana = c.adc_area_mm2 + rows * c.driver_area_per_row_mm2
    tile_dig = p["c_per_tile"] * macro_dig + c.tile_buf_area_mm2
    tile_ana = p["c_per_tile"] * macro_ana
    group_dig = p["t_per_router"] * tile_dig + c.router_area_mm2
    group_ana = p["t_per_router"] * tile_ana
    glb_area = _div_const(_div_const(p["glb_kb"], 1024.0), c.glb_mb_per_mm2)
    A = 1.10 * (
        (p["g_per_chip"] * group_dig + glb_area) * area_scale
        + p["g_per_chip"] * group_ana * area_scale_analog)

    cost = wt.tech["alpha"][tech_i] * A
    return CostMetrics(energy=E, latency=L, area=A, feasible=feasible,
                       cost=cost, feasible_w=feasible_w)


def evaluate_population(space: SearchSpace, wl: WorkloadArrays,
                        genomes: torch.Tensor,
                        constants: HWConstants = HWConstants(),
                        tables: Optional[CostTables] = None) -> CostMetrics:
    """(P, n_params) integer genomes -> CostMetrics, on the genomes'
    device. ``tables`` are the device copies of the space and workload
    tables (built here when None)."""
    if tables is None:
        tables = CostTables.of(space, wl, genomes.device)
    p = _resolve(space, tables.values, genomes)
    return _cost_core(space, constants, p, tables)


def evaluate_population_joint(space: SearchSpace, builder: WorkloadBuilder,
                              genomes: torch.Tensor,
                              constants: HWConstants = HWConstants(),
                              tables: Optional[CostTables] = None
                              ) -> CostMetrics:
    """Joint co-search cost path: (P, n_hw + n_arch) genomes ->
    CostMetrics, the workload layers built from each genome's arch
    slice by ``builder``. With zero families this is the flat path's
    math up to summation order (pads are masked, not absent)."""
    if tables is None:
        tables = CostTables.joint(space, builder, genomes.device)
    p = _resolve(space, tables.values, genomes)
    return _cost_core(space, constants, p,
                      tables.with_layers(builder, genomes))


def make_evaluator(space: SearchSpace, wl: WorkloadArrays,
                   constants: HWConstants = HWConstants(),
                   device="cuda"):
    """Population evaluator with the tables moved to ``device`` once:
    genomes (P, n) -> CostMetrics."""
    tables = CostTables.of(space, wl, resolve_device(device))

    def evaluator(genomes: torch.Tensor) -> CostMetrics:
        return evaluate_population(space, wl, genomes, constants, tables)

    return evaluator


def make_joint_evaluator(space: SearchSpace, builder: WorkloadBuilder,
                         constants: HWConstants = HWConstants(),
                         device="cuda"):
    """Joint evaluator with the tables moved to ``device`` once: genomes
    (P, n_hw + n_arch) -> CostMetrics."""
    dev = resolve_device(device)
    tables = CostTables.joint(space, builder, dev)

    def evaluator(genomes: torch.Tensor) -> CostMetrics:
        return evaluate_population_joint(space, builder, genomes, constants,
                                         tables)

    return evaluator
