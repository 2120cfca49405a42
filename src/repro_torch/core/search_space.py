"""Discrete full-hierarchy IMC hardware search space (paper §III-B);
counterpart of ``repro/core/search_space.py``.

The genome is a vector of integer *indices*, one per parameter; each
parameter has a discrete value table:

  device:       Bits_cell                       (RRAM only; SRAM fixes 1)
  circuit:      Xbar_rows, Xbar_cols
  architecture: C_per_tile, T_per_router, G_per_chip, GLB
  system:       T_cycle, V_op, (optionally) technology node

The tables are host numpy, identical to the reference's; the cost model
moves them to the device once per scorer. ``joint_space`` appends the
workload-architecture columns of the joint co-search;
``reduced_rram_space`` is the exhaustively enumerable space of the
§III-C1 algorithm comparison.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

# Technology table (paper Table 7)
TECH_NODES_NM = np.array([90, 65, 45, 32, 22, 14, 10, 7], dtype=np.float32)
# Normalized fabrication cost per mm^2 (32nm = 1.0), paper Table 7.
TECH_COST_ALPHA = np.array(
    [0.413, 0.477, 0.606, 1.0, 1.282, 1.498, 2.243, 3.871], dtype=np.float32
)
# Voltage ranges per node (min, max), paper Table 7.
TECH_VMIN = np.array([0.95, 0.85, 0.75, 0.65, 0.65, 0.55, 0.50, 0.45],
                     dtype=np.float32)
TECH_VMAX = np.array([1.30, 1.20, 1.10, 1.00, 1.00, 0.90, 0.85, 0.80],
                     dtype=np.float32)
TECH_32NM_INDEX = 3

# Number of discrete V_op steps sampled within the node's range.
N_VOP_STEPS = 8
# Nominal voltage used for normalizing energy/delay scaling (32nm).
V_NOM = 0.85


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Ordered parameter names + float32 value tables. The genome holds
    one index per parameter; V_op is a fractional step in [0, 1]
    resolved against the technology node by the cost model."""

    names: Tuple[str, ...]
    values: Tuple[np.ndarray, ...]
    mem_type: str  # "rram" | "sram"
    tech_is_variable: bool
    # Trailing workload-architecture dimensions (joint co-search): the
    # genome is [hardware slice | arch slice], arch params named
    # "<family>.<param>"; 0 for hardware-only spaces.
    n_arch: int = 0

    @property
    def n_params(self) -> int:
        return len(self.names)

    @property
    def n_hw(self) -> int:
        return len(self.names) - self.n_arch

    @property
    def hw_names(self) -> Tuple[str, ...]:
        return self.names[: self.n_hw]

    @property
    def arch_names(self) -> Tuple[str, ...]:
        return self.names[self.n_hw:]

    def hw_slice(self, genomes):
        """Hardware columns of a (..., n_params) genome array."""
        return genomes[..., : self.n_hw]

    def arch_slice(self, genomes):
        """Architecture columns of a (..., n_params) genome array."""
        return genomes[..., self.n_hw:]

    @property
    def cardinalities(self) -> np.ndarray:
        return np.array([len(v) for v in self.values], dtype=np.int32)

    @property
    def size(self) -> int:
        return int(np.prod([len(v) for v in self.values], dtype=np.int64))

    def index(self, name: str) -> int:
        return self.names.index(name)

    def value_table(self) -> np.ndarray:
        """(n_params, max_card) padded table for vectorized gathers."""
        m = max(len(v) for v in self.values)
        out = np.zeros((self.n_params, m), dtype=np.float32)
        for i, v in enumerate(self.values):
            out[i, : len(v)] = v
            out[i, len(v):] = v[-1]  # pad with last value (never selected)
        return out

    def decode(self, genome) -> Dict[str, float]:
        """Decode a single genome (indices) into a {name: value} dict."""
        genome = np.asarray(genome)
        return {n: float(self.values[i][int(genome[i])])
                for i, n in enumerate(self.names)}


def _mk(names_values: Sequence[Tuple[str, Sequence[float]]], mem_type: str,
        tech_is_variable: bool) -> SearchSpace:
    names = tuple(n for n, _ in names_values)
    values = tuple(np.asarray(v, dtype=np.float32) for _, v in names_values)
    return SearchSpace(names=names, values=values, mem_type=mem_type,
                       tech_is_variable=tech_is_variable)


def rram_space(tech_variable: bool = False) -> SearchSpace:
    """RRAM weight-stationary space. Larger Xbar/tile/group ranges so all
    weights can fit on-chip (paper §III-B)."""
    nv = [
        ("bits_cell", [1.0, 2.0, 4.0]),
        ("xbar_rows", [64.0, 128.0, 256.0, 512.0]),
        ("xbar_cols", [64.0, 128.0, 256.0, 512.0]),
        ("c_per_tile", [2.0, 4.0, 8.0, 16.0, 32.0]),
        ("t_per_router", [2.0, 4.0, 8.0, 16.0]),
        ("g_per_chip", [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]),
        ("glb_kb", [128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0, 8192.0]),
        ("t_cycle_ns", [1.0, 2.0, 3.0, 5.0, 10.0]),
        ("v_op_step", list(np.linspace(0.0, 1.0,
                                       4 if tech_variable else N_VOP_STEPS))),
    ]
    if tech_variable:
        nv.append(("tech_idx", list(range(len(TECH_NODES_NM)))))
    return _mk(nv, "rram", tech_variable)


def sram_space(tech_variable: bool = False) -> SearchSpace:
    """SRAM weight-swapping space: bits_cell fixed at 1, wider GLB range
    (holds swapped weights too), smaller max tiling (area overhead)."""
    nv = [
        ("xbar_rows", [64.0, 128.0, 256.0, 512.0]),
        ("xbar_cols", [64.0, 128.0, 256.0, 512.0]),
        ("c_per_tile", [2.0, 4.0, 8.0, 16.0, 32.0]),
        ("t_per_router", [2.0, 4.0, 8.0, 16.0]),
        ("g_per_chip", [1.0, 2.0, 4.0, 8.0, 16.0, 32.0]),
        ("glb_kb", [512.0, 1024.0, 2048.0, 4096.0, 8192.0, 16384.0, 32768.0]),
        ("t_cycle_ns", [1.0, 2.0, 3.0, 5.0, 10.0]),
        ("v_op_step", list(np.linspace(0.0, 1.0,
                                       4 if tech_variable else N_VOP_STEPS))),
    ]
    if tech_variable:
        nv.append(("tech_idx", list(range(len(TECH_NODES_NM)))))
    return _mk(nv, "sram", tech_variable)


def reduced_rram_space() -> SearchSpace:
    """The reduced space of §III-C1 (Bits_cell, Xbar_rows, Xbar_cols,
    C_per_tile), 240 designs, searched by the Table 3 algorithm
    comparison against its exhaustive enumeration."""
    nv = [
        ("bits_cell", [1.0, 2.0, 4.0]),
        ("xbar_rows", [64.0, 128.0, 256.0, 512.0]),
        ("xbar_cols", [64.0, 128.0, 256.0, 512.0]),
        ("c_per_tile", [2.0, 4.0, 8.0, 16.0, 32.0]),
    ]
    return _mk(nv, "rram", False)


def joint_space(base: SearchSpace, families: Sequence) -> SearchSpace:
    """Append each family's architecture params to a hardware space as
    ``"<family>.<param>"`` columns after the hardware slice. With no
    families the base space is returned unchanged."""
    families = list(families)
    if not families:
        return base
    names = list(base.names)
    values = list(base.values)
    for fam in families:
        for p in fam.params:
            names.append(f"{fam.name}.{p.name}")
            values.append(np.asarray(p.values, dtype=np.float32))
    n_arch = base.n_arch + sum(len(f.params) for f in families)
    return SearchSpace(names=tuple(names), values=tuple(values),
                       mem_type=base.mem_type,
                       tech_is_variable=base.tech_is_variable,
                       n_arch=n_arch)


def get_space(mem_type: str, tech_variable: bool = False) -> SearchSpace:
    if mem_type == "rram":
        return rram_space(tech_variable)
    if mem_type == "sram":
        return sram_space(tech_variable)
    raise ValueError(f"unknown mem_type {mem_type!r}")
