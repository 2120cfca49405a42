"""Scorer construction: one entry point for every search path;
counterpart of ``repro/core/scoring.py``.

``build_scorer(space, ScorerSpec(objective, workloads=wa), calib=...,
backend=..., device=...)`` returns a ``Scorer``: the functions the
search engines call on genome tensors of the scorer's device —
``score``/``feasible`` over the whole workload set, ``score_w``/
``feasible_w`` restricted to one workload column per design (the
specific-baseline fan-out), ``metrics`` (CostMetrics), for
accuracy-aware objectives ``accuracy``, and for a ``MultiObjective``
``score_vec``, the (P, D) matrix the NSGA-II engine sorts (``score`` is
then its first column) — plus the resolved ``backend`` and ``device``.
A ``ScorerSpec`` with a ``builder`` (``workloads.WorkloadBuilder``)
scores the joint co-search genome. A Scorer's functions compute on its
own device; ``Scorer.on(device)`` is the same configuration built on
another device, and ``sharded_score_fn`` splits the population rows of
one scoring call over several devices (the reference shards them over
a device mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Union

import torch

from ..device import resolve_device
from . import nonideal
from .cost_model import (CostTables, HWConstants, evaluate_population,
                         evaluate_population_joint)
from .distributed import compile_batched_search
from .objectives import (INFEASIBLE_PENALTY, MultiObjective, Objective,
                         per_workload_scores)
from .search_space import SearchSpace
from .workloads import WorkloadArrays, WorkloadBuilder


@dataclasses.dataclass(frozen=True)
class Calib:
    """Calibration fidelity of the non-ideality accuracy model (§IV-H):
    rows and reduction depth of the calibration GEMMs."""
    n_calib: int = 32
    calib_k: int = 256


@dataclasses.dataclass(frozen=True)
class ScorerSpec:
    """What to score: the objective plus exactly one workload source —
    packed ``workloads``, or a ``builder`` for the joint co-search."""
    objective: Union[Objective, MultiObjective]
    workloads: Optional[WorkloadArrays] = None
    builder: Optional[WorkloadBuilder] = None
    constants: HWConstants = HWConstants()


@dataclasses.dataclass(frozen=True)
class Scorer:
    """Every scoring surface of one (space, spec, calib, backend,
    device) configuration. Genomes are (P, n) integer tensors; ``w`` in
    ``score_w``/``feasible_w`` is an int or a (P,) tensor of workload
    columns, one per design."""
    score: Callable                 # (P, n) -> (P,)
    feasible: Callable              # (P, n) -> (P,) bool
    score_w: Callable               # ((P, n), w) -> (P,)
    feasible_w: Callable            # ((P, n), w) -> (P,) bool
    metrics: Callable               # (P, n) -> CostMetrics
    backend: str                    # resolved accuracy-model route
    device: torch.device
    accuracy: Optional[Callable] = None   # (P, n) -> (P, W)
    score_vec: Optional[Callable] = None  # (P, n) -> (P, D), MO only
    rebuild: Optional[Callable] = dataclasses.field(
        default=None, compare=False, repr=False)
    _on: Dict = dataclasses.field(default_factory=dict, compare=False,
                                  repr=False)

    def on(self, device) -> "Scorer":
        """This configuration's Scorer on ``device`` (itself on its own
        device; built once per other device)."""
        dev = resolve_device(device)
        if dev == self.device:
            return self
        if dev not in self._on:
            self._on[dev] = self.rebuild(dev)
        return self._on[dev]


def needs_accuracy(objective: Union[Objective, MultiObjective]) -> bool:
    """Whether the objective consumes the accuracy model: an
    ``edap_acc`` or ``acc_loss`` component, or an accuracy floor."""
    components = (objective.components
                  if isinstance(objective, MultiObjective) else (objective,))
    return any(o.kind in ("edap_acc", "acc_loss") or o.min_accuracy > 0.0
               for o in components)


def _column(x: torch.Tensor, w) -> torch.Tensor:
    """Column ``w`` of a (P, W) tensor, ``w`` an int or one per row."""
    if isinstance(w, int):
        return x[:, w]
    idx = torch.as_tensor(w, device=x.device).long().reshape(-1, 1)
    return torch.gather(x, 1, idx.expand(x.shape[0], 1))[:, 0]


def sharded_score_fn(score: Union["Scorer", Callable],
                     devices: Sequence) -> Callable:
    """A population scorer whose rows split over ``devices``: P rows,
    P divisible by the device count, go ``P/D`` contiguous rows to each
    device and come back in row order on the first. ``score`` is a
    ``Scorer`` (each device scores with ``score.on(device).score``) or
    a function that computes where its input lies. On one device it is
    one call of ``score``."""
    devs = [resolve_device(d) for d in devices]
    if isinstance(score, Scorer):
        def one(dev, genomes):
            return score.on(dev).score(genomes)
    else:
        def one(dev, genomes):
            return score(genomes)
    return compile_batched_search(one, devs)


def build_scorer(space: SearchSpace, spec: ScorerSpec, *,
                 calib: Calib = Calib(), backend: str = "auto",
                 device="cuda") -> Scorer:
    """THE scorer constructor of the port (see module docstring)."""
    dev = resolve_device(device)
    objective = spec.objective
    backend = nonideal.resolve_backend(backend, dev)
    is_mo = isinstance(objective, MultiObjective)
    first = objective.components[0] if is_mo else objective

    acc_fn = None
    if needs_accuracy(objective):
        acc_fn = nonideal.make_accuracy_model(
            space, spec.workloads, builder=spec.builder,
            n_calib=calib.n_calib, calib_k=calib.calib_k, backend=backend,
            device=dev)

    if spec.builder is not None:
        tables = CostTables.joint(space, spec.builder, dev)

        def metrics(genomes):
            return evaluate_population_joint(space, spec.builder,
                                             genomes.to(dev), spec.constants,
                                             tables)
    else:
        tables = CostTables.of(space, spec.workloads, dev)

        def metrics(genomes):
            return evaluate_population(space, spec.workloads,
                                       genomes.to(dev), spec.constants,
                                       tables)

    def score_full(genomes):
        m = metrics(genomes)
        if acc_fn is None:
            return objective(m)
        return objective(m, accuracy=acc_fn(genomes))

    if is_mo:
        score_vec = score_full

        def score(genomes):
            return score_full(genomes)[:, 0]
    else:
        score_vec = None
        score = score_full

    def feasible(genomes):
        return metrics(genomes).feasible

    def feasible_w(genomes, w):
        return _column(metrics(genomes).feasible_w, w)

    def score_w(genomes, w):
        m = metrics(genomes)
        acc = acc_fn(genomes) if acc_fn is not None else None
        s = _column(per_workload_scores(m, first.kind, accuracy=acc), w)
        bad = (~_column(m.feasible_w, w)) | (m.area > first.area_constraint)
        if first.min_accuracy > 0.0:
            bad = bad | (_column(acc, w) < first.min_accuracy)
        return torch.where(bad, torch.full_like(s, INFEASIBLE_PENALTY), s)

    def rebuild(device):
        return build_scorer(space, spec, calib=calib, backend=backend,
                            device=device)

    return Scorer(score=score, feasible=feasible, score_w=score_w,
                  feasible_w=feasible_w, metrics=metrics, accuracy=acc_fn,
                  score_vec=score_vec, backend=backend, device=dev,
                  rebuild=rebuild)
