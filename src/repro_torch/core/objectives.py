"""Objective functions and aggregation schemes (paper Eq. 3, §IV-C);
counterpart of ``repro/core/objectives.py``.

A score function maps CostMetrics -> (P,) scores (lower is better),
with the area constraint A <= A_constr and capacity feasibility folded
in as ``INFEASIBLE_PENALTY``. Aggregations over the workload axis:
``max`` (Eq. 3), ``mean`` and ``all`` (product, in log space). Units:
energy mJ, latency ms, area mm².

Kinds: ``edap``, ``edp``, ``energy``, ``delay``, ``area``, ``cost``,
``edap_cost``, ``edap_acc`` (§IV-H, Eq. 4) and ``acc_loss`` (the
accuracy-loss axis of joint fronts). ``min_accuracy > 0`` penalizes a
design whose accuracy on any workload falls below the bar. A
'+'-joined spec (``"edap:mean+cost"``) parses into a ``MultiObjective``
whose (P, D) score matrix the NSGA-II engine (``core/nsga.py``) sorts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from .cost_model import CostMetrics, pointwise

AREA_CONSTRAINT_MM2 = 800.0
# Penalty score for infeasible / over-area designs.
INFEASIBLE_PENALTY = 1.0e30

OBJECTIVE_KINDS = ("edap", "edp", "energy", "delay", "area", "cost",
                   "edap_cost", "edap_acc", "acc_loss")
AGGREGATIONS = ("max", "mean", "all")


def aggregate_scores(x: torch.Tensor, scheme: str) -> torch.Tensor:
    """Aggregate a (P, W) per-workload matrix over the workload axis."""
    if scheme == "max":
        return torch.amax(x, dim=1)
    if scheme == "mean":
        return torch.mean(x, dim=1)
    if scheme == "all":
        # product in log-space for numerical sanity
        return pointwise(torch.exp, torch.sum(
            pointwise(torch.log, torch.clamp(x, min=1e-30)), dim=1))
    raise ValueError(scheme)


def _need_accuracy(accuracy: Optional[torch.Tensor], what: str) -> None:
    if accuracy is None:
        raise ValueError(f"{what} needs the accuracy model")


@dataclasses.dataclass(frozen=True)
class Objective:
    """kind: one of OBJECTIVE_KINDS; aggregation: max | mean | all.
    ``min_accuracy > 0`` is a hard per-workload accuracy floor (0.0:
    off)."""
    kind: str = "edap"
    aggregation: str = "max"
    area_constraint: float = AREA_CONSTRAINT_MM2
    min_accuracy: float = 0.0

    def __call__(self, m: CostMetrics,
                 accuracy: Optional[torch.Tensor] = None) -> torch.Tensor:
        e_mj = aggregate_scores(m.energy * 1e3, self.aggregation)
        l_ms = aggregate_scores(m.latency * 1e3, self.aggregation)
        a = m.area
        if self.kind == "edap":
            s = e_mj * l_ms * a
        elif self.kind == "edp":
            s = e_mj * l_ms
        elif self.kind == "energy":
            s = e_mj
        elif self.kind == "delay":
            s = l_ms
        elif self.kind == "area":
            s = a
        elif self.kind == "cost":
            s = m.cost
        elif self.kind == "edap_cost":
            # §IV-I: cost = alpha * A replaces the raw area term
            s = e_mj * l_ms * m.cost
        elif self.kind == "edap_acc":
            # §IV-H: EDAP / prod(Acc_w); accuracy (P, W) in (0, 1]
            _need_accuracy(accuracy, "edap_acc")
            acc_prod = pointwise(torch.exp, torch.sum(pointwise(
                torch.log, torch.clamp(accuracy, min=1e-6)), dim=1))
            s = e_mj * l_ms * a / acc_prod
        elif self.kind == "acc_loss":
            # accuracy-loss axis for joint fronts: 1 - agg(Acc_w)
            _need_accuracy(accuracy, "acc_loss")
            s = 1.0 - aggregate_scores(accuracy, self.aggregation)
        else:
            raise ValueError(self.kind)
        bad = (~m.feasible) | (m.area > self.area_constraint)
        if self.min_accuracy > 0.0:
            _need_accuracy(accuracy, "the min_accuracy constraint")
            bad = bad | torch.any(accuracy < self.min_accuracy, dim=1)
        return torch.where(bad, torch.full_like(s, INFEASIBLE_PENALTY), s)


@dataclasses.dataclass(frozen=True)
class MultiObjective:
    """A tuple of Objectives evaluated into a (P, D) score matrix. Each
    column keeps its component's own feasibility/area penalty, so an
    infeasible design never dominates a feasible one."""
    components: Tuple[Objective, ...]

    def __post_init__(self):
        if len(self.components) < 2:
            raise ValueError("MultiObjective needs >= 2 components")

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(o.kind for o in self.components)

    @property
    def n_objectives(self) -> int:
        return len(self.components)

    def __call__(self, m: CostMetrics,
                 accuracy: Optional[torch.Tensor] = None) -> torch.Tensor:
        return torch.stack([o(m, accuracy=accuracy)
                            for o in self.components], dim=-1)


AnyObjective = Union[Objective, MultiObjective]


def is_multi_spec(spec: str) -> bool:
    """True for '+'-joined multi-objective specs ('edap:mean+cost')."""
    return "+" in spec


def make_multi_objective(spec: str,
                         area_constraint: float = AREA_CONSTRAINT_MM2,
                         min_accuracy: float = 0.0) -> MultiObjective:
    """Parse a '+'-joined spec into a MultiObjective
    (``"edap:mean+cost"`` -> columns edap:mean, cost)."""
    parts = [p.strip() for p in spec.split("+")]
    if len(parts) < 2 or not all(parts):
        raise ValueError(f"multi-objective spec {spec!r} needs >= 2 "
                         "'+'-separated components")
    return MultiObjective(tuple(make_objective(p, area_constraint,
                                               min_accuracy)
                                for p in parts))


def make_objective(spec: str,
                   area_constraint: float = AREA_CONSTRAINT_MM2,
                   min_accuracy: float = 0.0) -> AnyObjective:
    """Parse ``"kind[:aggregation]"`` (default aggregation ``max``), or a
    '+'-joined multi-objective spec into a ``MultiObjective``."""
    if is_multi_spec(spec):
        return make_multi_objective(spec, area_constraint, min_accuracy)
    kind, _, agg = spec.partition(":")
    agg = agg or "max"
    if kind not in OBJECTIVE_KINDS:
        raise ValueError(f"unknown objective kind {kind!r}; "
                         f"expected one of {OBJECTIVE_KINDS}")
    if agg not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {agg!r}; "
                         f"expected one of {AGGREGATIONS}")
    return Objective(kind, agg, area_constraint, min_accuracy)


def per_workload_scores(m: CostMetrics, kind: str = "edap",
                        accuracy: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(P, W) per-workload scores of each design. Restricting column
    ``w`` is arithmetically identical to evaluating the objective on a
    pack of workload ``w`` alone (the specific-baseline contract)."""
    e_mj = m.energy * 1e3
    l_ms = m.latency * 1e3
    a = m.area[:, None]
    if kind == "edap":
        return e_mj * l_ms * a
    if kind == "edp":
        return e_mj * l_ms
    if kind == "energy":
        return e_mj
    if kind == "delay":
        return l_ms
    if kind == "area":
        return torch.broadcast_to(a, e_mj.shape)
    if kind == "cost":
        return torch.broadcast_to(m.cost[:, None], e_mj.shape)
    if kind == "edap_cost":
        return e_mj * l_ms * m.cost[:, None]
    if kind == "edap_acc":
        _need_accuracy(accuracy, "edap_acc")
        return e_mj * l_ms * a / torch.clamp(accuracy, min=1e-6)
    if kind == "acc_loss":
        _need_accuracy(accuracy, "acc_loss")
        return 1.0 - accuracy
    raise ValueError(kind)
