"""Layer 2: the launch audit — host syncs, signature splits and launch
bloat of every search call; counterpart of
``repro/analysis/jaxpr_audit.py``.

The reference lowers each scenario's scorer and search kernel to a
jaxpr and audits the lowering. The port compiles nothing: a search is
an eager Python loop that dispatches one ATen op at a time. So this
audit does not lower, it runs. For every registered scenario at its
``smoke_budget`` it builds the calls ``jaxpr_audit.lower_scenario``
lowers — under the same kernel ids as ``analysis/baseline.json``
(``<scenario>::scorer``, ``::kernel`` for the GA and NSGA-II engines,
``::kernel:<alg>`` for the Table 3 engines) — calls each once with key 0
under a ``TorchDispatchMode`` that records every dispatched ATen op, and
checks:

J001  host syncs: ops that make the host wait for the device —
      ``aten._local_scalar_dense`` (``.item()``, ``float(t)``,
      ``int(t)``, ``bool(t)``), ``aten.equal`` and ``aten.is_nonzero``
      (a host bool), and ops whose output shape depends on the data
      (``aten.nonzero``, ``aten.masked_select``, ``aten.unique*``, an
      ``aten.index`` with a boolean mask). On a CUDA device the call
      also runs under ``torch.cuda.set_sync_debug_mode("warn")``, which
      names the copies between host and device that dispatch nothing
      on the CPU. Each finding names the Python frame (file:line,
      function) in ``src/repro_torch`` that caused it, once per site,
      with the kernel ids that reach it. Every sync stalls the eager
      launch queue and stops a CUDA graph of the step, so the
      suppressed ones (``analysis/torch_suppressions.txt``) are the
      to-do list of the eager-launch cut.
J002  signature split: calls whose campaign signature is equal
      (``campaign.scorer_key`` + engine + population/schedule shape)
      must dispatch one op sequence (op, argument shapes and dtypes):
      the port's form of "one compiled kernel per bucket".
J003  bloat: per-id dispatched-op counts are held to the committed
      ``analysis/torch_baseline.json`` — one block per device type,
      because the counts differ by design (the cost model's float64
      pointwise ops on the CPU, the Hopper kernels on the card) —
      allowing 25% + 16 ops of growth, as the reference does. Ids not
      in the block are warnings until ``--update-baseline`` commits
      them.

A call that raises is itself a finding (J000): the audit covers every
registered scenario by construction.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import sys
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from .findings import Finding

BASELINE_FILE = os.path.join("analysis", "torch_baseline.json")

# J003: allowed growth of an id's dispatched-op count over the committed
# baseline (the reference's bound).
BLOAT_RATIO = 1.25
BLOAT_SLACK = 16

_SCENARIOS_PATH = "src/repro_torch/experiments/scenarios.py"

# J001: ops that read a device value on the host, and why.
SYNC_OPS = {
    "aten._local_scalar_dense": "a host read of a device scalar "
                                "(.item(), float(t), int(t), bool(t))",
    "aten.equal": "a host bool from a device comparison (torch.equal)",
    "aten.is_nonzero": "a host bool from a device tensor (bool(t))",
}
# J001: ops whose output shape depends on the data (the host waits for
# the size).
DATA_DEPENDENT_OPS = ("aten.nonzero", "aten.masked_select",
                      "aten._unique", "aten._unique2", "aten.unique_dim",
                      "aten.unique_consecutive")
# The message torch.cuda.set_sync_debug_mode("warn") warns with.
_SYNC_WARNING = "synchronizing CUDA operation"

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(_PKG_DIR)
_SELF_DIR = os.path.dirname(os.path.abspath(__file__))


def _op_name(func) -> str:
    return f"{func.namespace}.{func.overloadpacket.__name__}"


def _site() -> Tuple[str, int, str]:
    """(repo-relative path, line, qualname) of the innermost frame of the
    port outside this package: the line that caused the op."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn.startswith(_PKG_DIR + os.sep) and \
                not fn.startswith(_SELF_DIR + os.sep):
            rel = os.path.relpath(fn, os.path.dirname(_SRC_DIR))
            # qualnames as the AST rules write them: no "<locals>"
            qual = getattr(f.f_code, "co_qualname", f.f_code.co_name)
            return (rel.replace(os.sep, "/"), f.f_lineno,
                    qual.replace(".<locals>", ""))
        f = f.f_back
    return ("<outside src/repro_torch>", 0, "")


def _bool_mask(index_args) -> bool:
    """Whether an ``aten.index`` call indexes with a boolean mask."""
    return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
               for i in index_args[1] if i is not None)


class OpRecorder(TorchDispatchMode):
    """Counts every dispatched ATen op by name, hashes the op sequence
    (overload, argument shapes and dtypes) and records the sites of the
    J001 ops."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = collections.Counter()
        self._hash = hashlib.sha256()
        self.syncs: List[Tuple[str, int, str, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _op_name(func)
        self.counts[name] += 1
        flat, _ = tree_flatten((args, kwargs))
        sig = [str(func)] + [f"{tuple(a.shape)}:{a.dtype}" for a in flat
                             if isinstance(a, torch.Tensor)]
        self._hash.update("|".join(sig).encode())
        why = SYNC_OPS.get(name)
        if why is None and (name in DATA_DEPENDENT_OPS or (
                name == "aten.index" and _bool_mask(args))):
            why = f"{name}: an output shape that depends on the data"
        if why is not None:
            self.syncs.append(_site() + (why,))
        return func(*args, **kwargs)

    @property
    def hash(self) -> str:
        return self._hash.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One audited call of one scenario."""
    kernel_id: str      # "<scenario>::<label>"
    scenario: str
    label: str          # "scorer" | "kernel" | "kernel:<alg>"
    group: str          # J002 signature-group key
    hash: str
    n_ops: int
    ops: Dict[str, int]
    syncs: Tuple[Tuple[str, int, str, str], ...]  # (path, line, fn, why)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


def _smoke(scenario):
    return dataclasses.replace(scenario, budget=scenario.smoke_budget)


def _group_key(scenario, engine: str, shape: Tuple, device) -> str:
    """J002 signature: calls sharing this string must dispatch one op
    sequence (the campaign engine's bucketing contract)."""
    from ..experiments.campaign import scorer_key
    return repr((scorer_key(scenario, device), engine, shape))


@dataclasses.dataclass(frozen=True)
class AuditCall:
    """One call the audit runs: ``fn()`` queues the scorer or the whole
    search on the device and returns its output tensors."""
    label: str
    fn: Callable[[], object]
    group: str


def scenario_calls(scenario, device) -> List[AuditCall]:
    """The (smoke-budget) scenario's scorer and search-kernel calls on
    ``device``, as ``jaxpr_audit.lower_scenario`` lowers them: the
    scorer on P_GA zero genomes, and each engine with key 0 as one lane
    through the runner's own lane functions."""
    from .. import random as jr
    from ..core.baselines import _lane_penalty, baseline_kernel
    from ..core.genetic import (PLAIN_PHASE, cards_of, lanes_of,
                                phase_schedule, search_kernel)
    from ..experiments import runner

    sc = _smoke(scenario)
    st = runner.setup_scenario(sc)
    b = sc.budget
    space = st.space
    dev = torch.device(device)
    genomes = torch.zeros((b.p_ga, space.n_params), dtype=torch.int64,
                          device=dev)
    cards = cards_of(space, dev)
    keys = jr.PRNGKey(0, dev)[None]
    calls: List[AuditCall] = []

    def add(label: str, fn: Callable, engine: str, shape: Tuple) -> None:
        calls.append(AuditCall(label, fn, _group_key(sc, engine, shape,
                                                      dev)))

    if sc.algorithm == "alg_compare":
        if sc.reduced_space:
            score = runner.make_landscape_scorer(space, st.wa, st.objective,
                                                 device=dev)
            penalty = None
        else:
            traced = runner.build_scenario_scorer(sc, st, dev)
            score = traced.score
            penalty = runner.make_infeasibility_penalty(traced,
                                                        st.objective)
        pop, iters = b.p_ga, b.total_generations
        add("scorer", lambda: score(genomes), "score", (b.p_ga,))
        sched = torch.as_tensor(phase_schedule((PLAIN_PHASE,), iters),
                                device=dev)
        add("kernel:ga",
            lambda: search_kernel(keys, cards, sched, lanes_of(score), None,
                                  p_h=pop, p_e=pop, p_ga=pop,
                                  hamming_sampling=False),
            "ga", (pop, pop, pop, iters))
        for _, alg in runner.TABLE3_ALGORITHMS:
            if alg == "ga":
                continue
            pen = _lane_penalty(penalty) if alg == "sres" else None
            add(f"kernel:{alg}",
                lambda a=alg, p=pen: baseline_kernel(
                    keys, cards, lanes_of(score), algorithm=a, pop=pop,
                    iters=iters, penalty_fn=p),
                alg, (pop, iters))
        return calls

    traced = runner.build_scenario_scorer(sc, st, dev)
    if st.is_mo:
        add("scorer", lambda: traced.score_vec(genomes), "score_vec",
            (b.p_ga,))
    else:
        add("scorer", lambda: traced.score(genomes), "score", (b.p_ga,))
    if sc.algorithm == "random":
        # a host-driven engine: the scorer above is its whole device
        # surface
        return calls
    sched, p_h, p_e, hamming = runner.search_budget(sc)
    engine = "nsga" if st.is_mo else "ga"
    one = runner.lane_search(space, traced, engine=engine, part="main",
                             p_h=p_h, p_e=p_e, p_ga=b.p_ga, hamming=hamming,
                             rram=sc.mem == "rram")
    schedule = torch.as_tensor(sched, device=dev)[None]
    add("kernel", lambda: one(dev, keys, schedule, None), engine,
        (p_h, p_e, b.p_ga, sched.shape[0]))
    return calls


def record_call(call: Callable[[], object], device
                ) -> Tuple[OpRecorder, object]:
    """Run ``call()`` once under an ``OpRecorder``; on a CUDA device
    also under ``torch.cuda.set_sync_debug_mode("warn")``, whose
    warnings add their sites to the recorder's syncs. Returns the
    recorder and the call's output (the device work finished)."""
    dev = torch.device(device)
    rec = OpRecorder()
    if dev.type != "cuda":
        with rec:
            out = call()
        return rec, out

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if _SYNC_WARNING in str(message):
            rec.syncs.append(_site() + ("a synchronizing CUDA operation "
                                        "(set_sync_debug_mode)",))

    torch.cuda.synchronize(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with rec:
                out = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize(dev)
    return rec, out


def audit_scenario(scenario, device) -> List[KernelEntry]:
    """Run and record every audited call of one (smoke-budget)
    scenario."""
    entries = []
    for c in scenario_calls(scenario, device):
        rec, _ = record_call(c.fn, device)
        entries.append(KernelEntry(
            kernel_id=f"{scenario.name}::{c.label}", scenario=scenario.name,
            label=c.label, group=c.group, hash=rec.hash,
            n_ops=sum(rec.counts.values()), ops=dict(rec.counts),
            syncs=tuple(sorted(set(rec.syncs)))))
    return entries


def load_baseline(repo_root: str, device_type: str
                  ) -> Optional[Dict[str, int]]:
    """The ``device_type`` block of the committed baseline (None when
    the file or the block is missing)."""
    path = os.path.join(repo_root, BASELINE_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        block = json.load(f).get(device_type)
    return None if block is None else block.get("kernels", {})


def write_baseline(repo_root: str, entries: List[KernelEntry],
                   device_type: str, device_name: str) -> str:
    """Rewrite the ``device_type`` block of the baseline from
    ``entries``, keeping the other device's block."""
    path = os.path.join(repo_root, BASELINE_FILE)
    payload = {}
    if os.path.exists(path):
        with open(path) as f:
            payload = json.load(f)
    payload["comment"] = (
        "per-kernel dispatched ATen op counts at smoke-budget shapes, one "
        "block per device type; refreshed via `python -m "
        "repro_torch.analysis --launch --update-baseline --device "
        "cpu|cuda`")
    payload[device_type] = {
        "device": device_name,
        "kernels": {e.kernel_id: e.n_ops for e in entries},
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def audit_entries(entries: List[KernelEntry],
                  baseline: Optional[Dict[str, int]],
                  device_type: str = "cpu") -> List[Finding]:
    """J001-J003 over the recorded calls."""
    findings: List[Finding] = []
    sites: Dict[Tuple[str, int, str], Dict[str, List[str]]] = {}
    for e in entries:
        for path, line, fn, why in e.syncs:
            site = sites.setdefault((path, line, fn), {})
            site.setdefault(why, [])
            ids = site.setdefault("", [])
            if e.kernel_id not in ids:
                ids.append(e.kernel_id)
    for (path, line, fn), site in sorted(sites.items()):
        ids = site.pop("")
        shown = ", ".join(ids[:3]) + (f" and {len(ids) - 3} more"
                                      if len(ids) > 3 else "")
        findings.append(Finding(
            rule="J001", path=path, line=line, symbol=fn,
            message=f"host sync inside a search call on {device_type}: "
                    f"{'; '.join(sorted(site))}; reached from "
                    f"{len(ids)} id(s): {shown}"))

    groups: Dict[str, Dict[str, List[str]]] = {}
    for e in entries:
        groups.setdefault(e.group, {}).setdefault(e.hash, []) \
            .append(e.kernel_id)
    for group, by_hash in groups.items():
        if len(by_hash) > 1:
            shown = "; ".join(
                f"{h}: {', '.join(ids)}" for h, ids in
                sorted(by_hash.items()))
            findings.append(Finding(
                rule="J002", path=_SCENARIOS_PATH, line=1,
                symbol="signature",
                message=f"calls with one campaign signature dispatch "
                        f"{len(by_hash)} distinct op sequences ({shown}) "
                        "— one bucket would not run one program"))

    bfile = BASELINE_FILE.replace(os.sep, "/")
    if baseline is not None:
        for e in entries:
            old = baseline.get(e.kernel_id)
            if old is None:
                findings.append(Finding(
                    rule="J003", path=bfile, line=1, symbol=e.kernel_id,
                    message=f"id not in the {device_type} block of "
                            f"torch_baseline.json (now {e.n_ops} ops) — "
                            "run --launch --update-baseline and commit",
                    severity="warning"))
                continue
            limit = int(old * BLOAT_RATIO + BLOAT_SLACK)
            if e.n_ops > limit:
                findings.append(Finding(
                    rule="J003", path=bfile, line=1, symbol=e.kernel_id,
                    message=f"launch bloat on {device_type}: {old} -> "
                            f"{e.n_ops} dispatched ops (limit {limit}) — "
                            "an unrolled loop or a split op grew the "
                            "call; fix it or deliberately refresh the "
                            "baseline"))
        current = {e.kernel_id for e in entries}
        for kid in sorted(set(baseline) - current):
            findings.append(Finding(
                rule="J003", path=bfile, line=1, symbol=kid,
                message=f"{device_type} baseline entry matches no current "
                        "call — refresh the baseline", severity="warning"))
    return findings


def run_launch_audit(repo_root: str, device, update_baseline: bool = False,
                     names: Optional[List[str]] = None,
                     ) -> Tuple[List[Finding], Dict]:
    """Run every registered scenario's (or ``names``') audited calls on
    ``device``; returns (findings, report)."""
    from ..device import resolve_device
    from ..experiments.scenarios import get_scenario, scenario_names

    dev = resolve_device(device)
    dtype = dev.type
    dname = "cpu"
    if dtype == "cuda":
        from ..kernels import build
        dname = torch.cuda.get_device_name(dev)
        # the accuracy model's kernel library, built and loaded before any
        # call is recorded
        build.load("imc_fused")
    entries: List[KernelEntry] = []
    findings: List[Finding] = []
    for name in (names if names is not None else scenario_names()):
        try:
            entries += audit_scenario(get_scenario(name), dev)
        except Exception as exc:  # any crash of a call -> a J000 finding
            findings.append(Finding(
                rule="J000", path=_SCENARIOS_PATH, line=1, symbol=name,
                message=f"audited call failed: {type(exc).__name__}: "
                        f"{exc}"))

    if update_baseline:
        write_baseline(repo_root, entries, dtype, dname)
        baseline = {e.kernel_id: e.n_ops for e in entries}
    else:
        baseline = load_baseline(repo_root, dtype)
    findings += audit_entries(entries, baseline, dtype)

    report = {
        "schema": 1,
        "device": {"type": dtype, "name": dname},
        "n_scenarios": len(set(e.scenario for e in entries)),
        "n_kernels": len(entries),
        "kernels": {e.kernel_id: e.asdict() for e in entries},
        "findings": [f.asdict() for f in findings],
    }
    return findings, report
