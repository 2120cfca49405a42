"""Co-design-as-a-service: concurrent scenario searches over the
campaign engine; counterpart of ``repro/serve/codesign.py``.

``CodesignService`` is the long-lived counterpart of the one-shot
``run --all`` CLI: callers submit ``repro_torch.api.SearchRequest``s
from any thread and get a request id back at once; one worker thread
does all device work. It gathers pending requests in a micro-batching
window, plans the batch into campaign buckets
(``experiments.campaign.plan_campaign``), runs the lane batches
(``execute_buckets``, ``pipeline_window`` deep), and as each bucket
drains completes its requests: per-generation ``ProgressEvent``s
replayed from the result's best-so-far history into the request's
stream, then the terminal ``SearchResponse``.

Request lifecycle::

    submit -> [queued] -> window -> [dispatched] -> bucket -> device
           -> drain -> progress stream -> SearchResponse

* **cancellation** — ``cancel(rid)`` succeeds only while the request is
  queued (a lane cannot be taken back out of a batch). Returns False
  once dispatch started.
* **deadlines** — ``SearchRequest.deadline_s`` is an admission deadline,
  enforced when the window closes: a request still queued past it
  completes with status ``"expired"`` instead of taking a lane.
* **degradation** — a bucket whose call (or drain) fails falls back to
  per-scenario sequential runs; the batch's other buckets are untouched
  and the stats count the degradation.

The service runs on ``device`` (default ``"cuda"``; it raises without a
GPU unless given ``device="cpu"``). torch's current CUDA device is per
thread, so the worker sets it to the service's device before any work
and the kernel wrappers launch on that thread's current stream.

Results equal the sequential runner's ``result.json`` (modulo timing
fields): planning, bucket calls and result finalization are the
campaign engine's, and the same schema-versioned result cache serves
repeat submissions (``SearchResponse.cached``).
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
import traceback
from collections import deque
from typing import Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from ..api import (ProgressEvent, SearchRequest, SearchResponse,
                   ServiceStats, resolve_request)
from ..core.distributed import kernel_cache_stats
from ..device import resolve_device
from ..experiments import campaign, runner
from ..experiments.scenarios import Scenario

_QUEUED, _DISPATCHED = "queued", "dispatched"


class _Record:
    """Mutable service-side state of one request (the public types
    stay frozen)."""
    __slots__ = ("rid", "request", "scenario", "status", "submitted_t",
                 "deadline_t", "dispatch_t", "events", "done",
                 "response")

    def __init__(self, rid: str, request: SearchRequest,
                 scenario: Scenario, now: float):
        self.rid = rid
        self.request = request
        self.scenario = scenario
        self.status = _QUEUED
        self.submitted_t = now
        self.deadline_t = (now + request.deadline_s
                           if request.deadline_s is not None else None)
        self.dispatch_t: Optional[float] = None
        self.events: "queue.Queue" = queue.Queue()
        self.done = threading.Event()
        self.response: Optional[SearchResponse] = None


class CodesignService:
    """Concurrent co-design search service (see module docstring).

    Thread-safe: ``submit``/``cancel``/``result``/``stream``/``stats``
    may be called from any thread; all planning and device work runs
    on the service's single worker thread. Use as a context manager
    (``close()`` drains outstanding requests by default).

    ``window_s`` is the micro-batching window: how long the worker
    waits after the first pending request before closing the batch, so
    a burst of submissions lands in one campaign plan (and shared
    buckets). ``pipeline_window`` is the campaign engine's dispatch
    depth. ``autostart=False`` defers the worker until ``start()`` —
    deterministic single-batch behavior for tests and benches.
    """

    def __init__(self, out_dir: str = runner.DEFAULT_OUT_DIR, *,
                 write: bool = True, force: bool = False,
                 window_s: float = 0.05, max_batch: int = 64,
                 pipeline_window: int = 2,
                 specific_fanout: bool = True,
                 compile_cache: Optional[str] = None,
                 autostart: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.out_dir = out_dir
        self.write = write
        self.force = force
        self.window_s = window_s
        self.max_batch = max_batch
        self.pipeline_window = pipeline_window
        self.specific_fanout = specific_fanout
        self._autostart = autostart
        if compile_cache:
            campaign.enable_persistent_cache(compile_cache)

        self._cond = threading.Condition(threading.RLock())
        self._queue: "deque[_Record]" = deque()
        self._records: Dict[str, _Record] = {}
        self._ids = itertools.count()
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._closed = False
        self._t_start = time.monotonic()
        self._last_done_t = self._t_start
        self._latencies: List[float] = []
        self._kstats0 = kernel_cache_stats()
        self._counts = {k: 0 for k in (
            "submitted", "completed", "cancelled", "expired", "failed",
            "result_cache_hits", "batches", "buckets",
            "degraded_buckets", "lanes_total", "lanes_padded")}

    # -- public API ---------------------------------------------------------

    def __enter__(self) -> "CodesignService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def start(self) -> "CodesignService":
        """Start the worker thread (idempotent)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="codesign-service",
                    daemon=True)
                self._thread.start()
        return self

    def submit(self, request: Union[SearchRequest, str, Scenario]
               ) -> str:
        """Enqueue a request; returns its id immediately. A bare
        registry name or Scenario wraps into a default SearchRequest."""
        if isinstance(request, (str, Scenario)):
            request = SearchRequest(scenario=request)
        scenario = resolve_request(request)
        with self._cond:
            if self._closed:
                raise RuntimeError("service is closed")
            rid = f"req-{next(self._ids):04d}"
            rec = _Record(rid, request, scenario, time.monotonic())
            self._records[rid] = rec
            self._queue.append(rec)
            self._counts["submitted"] += 1
            self._cond.notify_all()
        if self._autostart:
            self.start()
        return rid

    def cancel(self, rid: str) -> bool:
        """Cancel a still-queued request. True iff it was cancelled
        (False once it reached a device batch or finished)."""
        with self._cond:
            rec = self._records[rid]
            if rec.status != _QUEUED or rec.done.is_set():
                return False
            try:
                self._queue.remove(rec)
            except ValueError:
                pass
            self._finish(rec, "cancelled",
                         error="cancelled while queued")
            return True

    def result(self, rid: str,
               timeout: Optional[float] = None) -> SearchResponse:
        """Block until the request is terminal; returns its response."""
        rec = self._records[rid]
        if not rec.done.wait(timeout):
            raise TimeoutError(
                f"request {rid} still {rec.status!r} after {timeout}s")
        return rec.response

    def stream(self, rid: str) -> Iterator[ProgressEvent]:
        """Per-generation progress events for one request (single
        consumer), ending when the request is terminal."""
        rec = self._records[rid]
        while True:
            ev = rec.events.get()
            if ev is None:
                rec.events.put(None)  # terminal marker stays for re-streams
                return
            yield ev

    def stats(self) -> ServiceStats:
        """Snapshot of the observability surface."""
        with self._cond:
            c = dict(self._counts)
            lat = np.asarray(self._latencies, float)
            queue_depth = sum(1 for r in self._queue
                              if r.status == _QUEUED)
            inflight = sum(1 for r in self._records.values()
                           if r.status == _DISPATCHED)
            span = self._last_done_t - self._t_start
            uptime = time.monotonic() - self._t_start
        k = kernel_cache_stats()
        kh = k["hits"] - self._kstats0["hits"]
        km = k["misses"] - self._kstats0["misses"]

        def pct(q: float) -> float:
            return float(np.percentile(lat, q)) if lat.size else 0.0

        lanes = c["lanes_total"] + c["lanes_padded"]
        return ServiceStats(
            uptime_s=uptime,
            submitted=c["submitted"], completed=c["completed"],
            cancelled=c["cancelled"], expired=c["expired"],
            failed=c["failed"],
            result_cache_hits=c["result_cache_hits"],
            queue_depth=queue_depth, inflight=inflight,
            batches=c["batches"], buckets=c["buckets"],
            degraded_buckets=c["degraded_buckets"],
            lanes_total=c["lanes_total"],
            lanes_padded=c["lanes_padded"],
            bucket_occupancy=(c["lanes_total"] / lanes if lanes
                              else 1.0),
            requests_per_sec=(c["completed"] / span if span > 0
                              and c["completed"] else 0.0),
            kernel_cache_hits=kh, kernel_cache_misses=km,
            kernel_cache_hit_rate=(kh / (kh + km) if kh + km else 0.0),
            latency_p50_s=pct(50), latency_p90_s=pct(90),
            latency_p99_s=pct(99))

    def close(self, drain: bool = True) -> None:
        """Stop the service. ``drain=True`` (default) finishes every
        queued request first; ``drain=False`` cancels them."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._queue:
                    rec = self._queue.popleft()
                    if rec.status == _QUEUED:
                        self._finish(rec, "cancelled",
                                     error="service closed")
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()

    # -- worker -------------------------------------------------------------

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.1)
                if self._stop and not self._queue:
                    return
            if self.window_s > 0:
                time.sleep(self.window_s)  # micro-batch accumulation
            batch = self._collect()
            if batch:
                with self._cond:
                    self._counts["batches"] += 1
                self._execute(batch)

    def _collect(self) -> List[_Record]:
        """Close the window: pop up to max_batch queued records,
        expiring the ones whose admission deadline passed."""
        batch: List[_Record] = []
        now = time.monotonic()
        with self._cond:
            while self._queue and len(batch) < self.max_batch:
                rec = self._queue.popleft()
                if rec.status != _QUEUED:
                    continue
                if rec.deadline_t is not None and now > rec.deadline_t:
                    self._finish(
                        rec, "expired",
                        error=f"deadline of {rec.request.deadline_s}s "
                              "expired before dispatch")
                    continue
                rec.status = _DISPATCHED
                rec.dispatch_t = now
                batch.append(rec)
        return batch

    def _execute(self, records: List[_Record]) -> None:
        """One batch end to end: plan -> cached -> buckets (pipelined,
        degradable) -> fallbacks. Every record terminates."""
        try:
            jobs = campaign.plan_campaign(
                [r.scenario for r in records], out_dir=self.out_dir,
                force=self.force, write=self.write, device=self.device)
        except Exception:
            err = traceback.format_exc(limit=8)
            for rec in records:
                self._finish(rec, "failed", error=err)
            return
        rec_of = {id(job): rec for job, rec in zip(jobs, records)}
        for job in jobs:
            if job.kind == "cached":
                self._finish_job(rec_of[id(job)], job)

        buckets = campaign.bucket_jobs(jobs)
        with self._cond:
            self._counts["buckets"] += len(buckets)
            self._counts["lanes_total"] += sum(
                b.n_lanes for b in buckets.values())
            self._counts["lanes_padded"] += sum(
                b.lanes_padded_to - b.n_lanes for b in buckets.values())

        def on_drained(bucket) -> None:
            for job in bucket.jobs:
                self._finish_job(rec_of[id(job)], job)

        try:
            degraded = campaign.execute_buckets(
                buckets.values(), self.out_dir, write=self.write,
                specific_fanout=self.specific_fanout,
                window=self.pipeline_window, on_drained=on_drained,
                degrade_sequential=True)
        except Exception:
            # degrade_sequential keeps bucket failures inside; anything
            # escaping is unexpected: fail the batch's open requests
            err = traceback.format_exc(limit=8)
            degraded = 0
            for rec in records:
                if not rec.done.is_set():
                    self._finish(rec, "failed", error=err)
        with self._cond:
            self._counts["degraded_buckets"] += degraded

        for job in jobs:
            if job.kind != "fallback":
                continue
            try:
                job.result = runner.run_scenario(
                    job.scenario, out_dir=self.out_dir,
                    force=self.force, write=self.write,
                    specific_fanout=self.specific_fanout,
                    device=self.device)
            except Exception:
                job.error = traceback.format_exc(limit=8)
            self._finish_job(rec_of[id(job)], job)

    # -- completion ---------------------------------------------------------

    def _finish_job(self, rec: _Record, job) -> None:
        """Job result -> progress replay + terminal response."""
        if job.result is None:
            self._finish(rec, "failed", error=job.error
                         or "campaign job produced no result")
            return
        history = job.result.get("history") or []
        for gen, best in enumerate(history):
            rec.events.put(ProgressEvent(
                request_id=rec.rid, scenario=rec.scenario.name,
                generation=gen, best_score=float(best),
                final=gen == len(history) - 1))
        self._finish(rec, "completed", result=job.result,
                     cached=bool(job.result.get("cached")))

    def _finish(self, rec: _Record, status: str, *,
                result: Optional[Dict] = None,
                error: Optional[str] = None,
                cached: bool = False) -> None:
        with self._cond:
            if rec.done.is_set():
                return
            rec.status = status
            latency = time.monotonic() - rec.submitted_t
            rec.response = SearchResponse(
                request_id=rec.rid, scenario=rec.scenario.name,
                status=status, result=result, error=error,
                cached=cached, latency_s=latency)
            self._counts[status] += 1
            if status == "completed":
                self._latencies.append(latency)
                if cached:
                    self._counts["result_cache_hits"] += 1
            self._last_done_t = time.monotonic()
            rec.events.put(None)
            rec.done.set()
