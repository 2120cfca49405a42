"""Objective functions and aggregation schemes (paper Eq. 3, §IV-C);
counterpart of ``repro/core/objectives.py``.

A score function maps CostMetrics -> (P,) scores (lower is better),
with the area constraint A <= A_constr and capacity feasibility folded
in as ``INFEASIBLE_PENALTY``. Aggregations over the workload axis:
``max`` (Eq. 3), ``mean`` and ``all`` (product, in log space). Units:
energy mJ, latency ms, area mm².

Ported kinds: ``edap``, ``edp``, ``energy``, ``delay``, ``area``,
``cost``, ``edap_cost`` and ``edap_acc`` (§IV-H, Eq. 4). Multi-objective
specs (``"edap:mean+cost"``), ``acc_loss`` and the ``min_accuracy``
constraint are not ported yet (ROADMAP Queue 1 items 7 and 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cost_model import CostMetrics

AREA_CONSTRAINT_MM2 = 800.0
# Penalty score for infeasible / over-area designs.
INFEASIBLE_PENALTY = 1.0e30

OBJECTIVE_KINDS = ("edap", "edp", "energy", "delay", "area", "cost",
                   "edap_cost", "edap_acc")
AGGREGATIONS = ("max", "mean", "all")


def aggregate_scores(x: torch.Tensor, scheme: str) -> torch.Tensor:
    """Aggregate a (P, W) per-workload matrix over the workload axis."""
    if scheme == "max":
        return torch.amax(x, dim=1)
    if scheme == "mean":
        return torch.mean(x, dim=1)
    if scheme == "all":
        # product in log-space for numerical sanity
        return torch.exp(torch.sum(torch.log(torch.clamp(x, min=1e-30)),
                                   dim=1))
    raise ValueError(scheme)


def _penalize(m: CostMetrics, s: torch.Tensor, area_constraint: float
              ) -> torch.Tensor:
    bad = (~m.feasible) | (m.area > area_constraint)
    return torch.where(bad, torch.full_like(s, INFEASIBLE_PENALTY), s)


@dataclasses.dataclass(frozen=True)
class Objective:
    """kind: one of OBJECTIVE_KINDS; aggregation: max | mean | all."""
    kind: str = "edap"
    aggregation: str = "max"
    area_constraint: float = AREA_CONSTRAINT_MM2

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
            if accuracy is None:
                raise ValueError("edap_acc needs the accuracy model")
            acc_prod = torch.exp(torch.sum(torch.log(
                torch.clamp(accuracy, min=1e-6)), dim=1))
            s = e_mj * l_ms * a / acc_prod
        else:
            raise ValueError(self.kind)
        return _penalize(m, s, self.area_constraint)


def make_objective(spec: str,
                   area_constraint: float = AREA_CONSTRAINT_MM2,
                   min_accuracy: float = 0.0) -> Objective:
    """Parse ``"kind[:aggregation]"`` (default aggregation ``max``)."""
    if "+" in spec:
        raise NotImplementedError(
            f"multi-objective spec {spec!r}: the NSGA-II engine is not "
            "ported yet (ROADMAP Queue 1 item 8)")
    if min_accuracy > 0.0:
        raise NotImplementedError(
            "the min_accuracy constraint is not ported yet (ROADMAP "
            "Queue 1 item 7)")
    kind, _, agg = spec.partition(":")
    agg = agg or "max"
    if kind == "acc_loss":
        raise NotImplementedError(
            "the acc_loss objective is not ported yet (ROADMAP Queue 1 "
            "item 7)")
    if kind not in OBJECTIVE_KINDS:
        raise ValueError(f"unknown objective kind {kind!r}; "
                         f"expected one of {OBJECTIVE_KINDS}")
    if agg not in AGGREGATIONS:
        raise ValueError(f"unknown aggregation {agg!r}; "
                         f"expected one of {AGGREGATIONS}")
    return Objective(kind, agg, area_constraint)


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
        if accuracy is None:
            raise ValueError("edap_acc needs the accuracy model")
        return e_mj * l_ms * a / torch.clamp(accuracy, min=1e-6)
    raise ValueError(kind)
