"""repro_torch.api — the supported public surface of the port's
co-design stack; counterpart of ``repro/api.py``.

Everything a downstream consumer needs is importable from here: the
Scorer constructor, the scenario registry and budgets, the sequential
runner, the campaign engine, the co-design service with its frozen
request/response schema, and the LM serving engine. The internal module
layout (``repro_torch.core``, ``repro_torch.experiments``,
``repro_torch.serve``) is not a stable interface.

The request schema of the co-design service is defined here, not in
``repro_torch.serve.codesign``: the service depends on the schema, never
the other way around, so the wire types import without the service or
the LM model stack. The schema carries no device: the device belongs to
the service (``CodesignService(device=...)``, default ``"cuda"``).

  from repro_torch.api import CodesignService, SearchRequest

  with CodesignService(out_dir="results") as svc:   # device="cpu" on a CPU
      rid = svc.submit(SearchRequest("rram_small_set", smoke=True))
      for ev in svc.stream(rid):
          print(ev.generation, ev.best_score)
      print(svc.result(rid).status)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

from .core import (PAPER_4, PAPER_9, Calib, MultiObjective, Objective,
                   Scorer, ScorerSpec, build_scorer, get_space,
                   get_workload_set, joint_search, joint_space,
                   make_evaluator, make_objective, pack, sharded_score_fn)
from .experiments import (DEFAULT_OUT_DIR, REGISTRY, RESULT_SCHEMA_VERSION,
                          SMOKE_BUDGET, Budget, Scenario,
                          enable_persistent_cache, get_scenario,
                          plan_campaign, run_campaign, run_scenario,
                          scenario_names)

#: Version of the SearchRequest/SearchResponse/ProgressEvent schema
#: below (the result payload is versioned separately by
#: experiments.runner.RESULT_SCHEMA_VERSION, carried inside
#: ``SearchResponse.result["schema_version"]``).
API_SCHEMA_VERSION = 1

#: Terminal states a SearchResponse can report.
RESPONSE_STATUSES = ("completed", "cancelled", "expired", "failed")


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One co-design query: a scenario (registry name or an ad-hoc
    ``Scenario``) plus per-request overrides. Frozen — a request is a
    value, safe to hash, log, and resubmit."""
    scenario: Union[str, Scenario]
    seed: Optional[int] = None        # overrides Scenario.seed
    n_seeds: Optional[int] = None     # overrides Budget.n_seeds
    smoke: bool = False               # run at the scenario's smoke budget
    backend: Optional[str] = None     # overrides Scenario.backend
    deadline_s: Optional[float] = None  # expire if not dispatched in time


@dataclasses.dataclass(frozen=True)
class ProgressEvent:
    """One generation of one request's search, streamed to subscribers
    from the result's best-so-far history. Generation indices are
    strictly increasing per request; ``final`` marks the last one."""
    request_id: str
    scenario: str
    generation: int
    best_score: float
    final: bool = False


@dataclasses.dataclass(frozen=True)
class SearchResponse:
    """Terminal answer for one request. ``result`` is the runner's
    result.json payload (schema-versioned via its own
    ``schema_version`` field) on ``status == "completed"``, else
    None with ``error`` explaining why."""
    request_id: str
    scenario: str
    status: str                       # one of RESPONSE_STATUSES
    result: Optional[Dict[str, Any]] = None
    error: Optional[str] = None
    cached: bool = False              # served from the result cache
    latency_s: float = 0.0            # submit -> terminal
    api_version: int = API_SCHEMA_VERSION


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Point-in-time observability surface of a CodesignService."""
    uptime_s: float
    submitted: int
    completed: int
    cancelled: int
    expired: int
    failed: int
    result_cache_hits: int
    queue_depth: int
    inflight: int
    batches: int
    buckets: int
    degraded_buckets: int
    lanes_total: int
    lanes_padded: int
    bucket_occupancy: float           # real lanes / padded lane slots
    requests_per_sec: float           # completed / active span
    kernel_cache_hits: int
    kernel_cache_misses: int
    kernel_cache_hit_rate: float
    latency_p50_s: float
    latency_p90_s: float
    latency_p99_s: float

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def resolve_request(request: SearchRequest) -> Scenario:
    """A request's concrete Scenario: registry lookup + the request's
    overrides folded into the frozen dataclass. Pure — no device work,
    no service dependency; the service and tests share it."""
    sc = request.scenario
    if isinstance(sc, str):
        sc = get_scenario(sc)
    if not isinstance(sc, Scenario):
        raise TypeError("SearchRequest.scenario must be a registry name "
                        f"or a Scenario, got {type(sc).__name__}")
    if request.smoke:
        sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    if request.backend is not None:
        sc = dataclasses.replace(sc, backend=request.backend)
    if request.seed is not None:
        sc = dataclasses.replace(sc, seed=request.seed)
    if request.n_seeds is not None:
        sc = dataclasses.replace(
            sc, budget=dataclasses.replace(sc.budget,
                                           n_seeds=request.n_seeds))
    return sc


# The serve layer loads lazily (PEP 562): the schema above stays
# importable without the LM model stack or the service, and
# repro_torch.serve.codesign itself imports this module for the schema.
_LAZY = {
    "CodesignService": ("repro_torch.serve.codesign", "CodesignService"),
    "ServeEngine": ("repro_torch.serve.engine", "ServeEngine"),
    "LMRequest": ("repro_torch.serve.engine", "LMRequest"),
}


def __getattr__(name: str):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.api' has no attribute {name!r}") from None
    import importlib
    obj = getattr(importlib.import_module(mod_name), attr)
    globals()[name] = obj
    return obj


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = [
    # request/response schema + service
    "API_SCHEMA_VERSION", "RESPONSE_STATUSES", "SearchRequest",
    "SearchResponse", "ProgressEvent", "ServiceStats",
    "resolve_request", "CodesignService",
    # scorer construction (core.scoring)
    "build_scorer", "Scorer", "ScorerSpec", "Calib", "sharded_score_fn",
    # objectives / spaces / workloads
    "Objective", "MultiObjective", "make_objective", "get_space",
    "joint_space", "get_workload_set", "pack", "make_evaluator",
    "joint_search", "PAPER_4", "PAPER_9",
    # scenario registry + runners
    "Scenario", "Budget", "SMOKE_BUDGET", "REGISTRY", "get_scenario",
    "scenario_names", "run_scenario", "run_campaign", "plan_campaign",
    "enable_persistent_cache", "DEFAULT_OUT_DIR",
    "RESULT_SCHEMA_VERSION",
    # LM serving
    "ServeEngine", "LMRequest",
]
