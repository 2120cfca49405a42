"""The port's CodesignService (repro_torch/serve/codesign.py) and the
request schema of repro_torch.api, on the CPU: the reference's cases
(tests/test_codesign_service.py) against the port.

  * concurrent submissions write result.json files byte-identical to
    the port's sequential runner's (modulo timing fields and the cache
    flag) — the service is the campaign engine behind a request loop;
  * progress streams replay the per-generation history with strictly
    increasing generation indices and a final marker;
  * deadlines expire still-queued requests, cancellation wins only
    before dispatch, and any interleaving of submit/cancel leaves the
    accounting consistent (hypothesis property);
  * a bucket whose call fails degrades to sequential runs instead of
    failing its requests;
  * a burst of seeds of one scenario lands in one bucket, each answer
    the sequential run of its seed;
  * the service runs on the GPU by default and raises without one.
"""
import dataclasses
import json
import os
import threading
import time

import pytest
import torch

from repro_torch.api import (CodesignService, ProgressEvent, SearchRequest,
                             SearchResponse, resolve_request)
from repro_torch.experiments import campaign, runner
from repro_torch.experiments.scenarios import Budget, Scenario

torch.set_num_threads(1)

TINY_BUDGET = Budget(p_h=16, p_e=8, p_ga=6, generations=1)

TINY = Scenario(name="tiny_service", mem="sram",
                workloads=("alexnet", "resnet18"),
                algorithm="fourphase", budget=TINY_BUDGET)
TINY_PLAIN = dataclasses.replace(TINY, name="tiny_service_plain",
                                 algorithm="plain")
TINY_MO = dataclasses.replace(TINY, name="tiny_service_mo",
                              objective="edap:mean+cost",
                              specific_baselines=False)

# "cached" differs legitimately between a fresh run and its replay
TIMING_FIELDS = {"wall_time_s", "search_wall_time_s",
                 "sampling_time_s", "cached"}


def _strip(d):
    return {k: v for k, v in d.items() if k not in TIMING_FIELDS}


def _load(out, name):
    with open(os.path.join(out, name, "result.json")) as f:
        return json.load(f)


def _svc(**kw):
    return CodesignService(device="cpu", **kw)


# ---------------------------------------------------------------------------
# request schema
# ---------------------------------------------------------------------------


def test_schema_types_frozen():
    req = SearchRequest("rram_smoke", smoke=True)
    with pytest.raises(dataclasses.FrozenInstanceError):
        req.seed = 7
    ev = ProgressEvent("r", "s", 0, 1.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        ev.generation = 1
    resp = SearchResponse("r", "s", "completed")
    with pytest.raises(dataclasses.FrozenInstanceError):
        resp.status = "failed"


def test_resolve_request_overrides():
    sc = resolve_request(SearchRequest("rram_small_set", smoke=True,
                                       seed=3, n_seeds=2,
                                       backend="jnp"))
    assert sc.budget.p_h == sc.smoke_budget.p_h
    assert sc.seed == 3 and sc.budget.n_seeds == 2
    assert sc.backend == "jnp"
    # a Scenario passes through with its own fields untouched
    assert resolve_request(SearchRequest(TINY)) == TINY
    with pytest.raises(TypeError, match="Scenario"):
        resolve_request(SearchRequest(42))


# ---------------------------------------------------------------------------
# concurrent submission == sequential runner, byte-identical
# ---------------------------------------------------------------------------


def test_service_matches_sequential_runner(tmp_path):
    """Requests submitted concurrently from several threads write
    result.json files byte-identical (modulo timing) to one-at-a-time
    run_scenario, through the same result cache schema."""
    seq_out, svc_out = str(tmp_path / "seq"), str(tmp_path / "svc")
    scenarios = [TINY, TINY_PLAIN, TINY_MO]
    for sc in scenarios:
        runner.run_scenario(sc, out_dir=seq_out, device="cpu")

    with _svc(out_dir=svc_out, window_s=0.2) as svc:
        rids = {}

        def _submit(sc):
            rids[sc.name] = svc.submit(SearchRequest(sc))

        threads = [threading.Thread(target=_submit, args=(sc,))
                   for sc in scenarios]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        responses = {n: svc.result(rid, timeout=600)
                     for n, rid in rids.items()}

    for sc in scenarios:
        r = responses[sc.name]
        assert r.status == "completed" and not r.cached
        assert _strip(_load(svc_out, sc.name)) == \
            _strip(_load(seq_out, sc.name))
        assert _strip(r.result) == _strip(_load(svc_out, sc.name))

    # resubmitting hits the shared result cache
    with _svc(out_dir=svc_out, window_s=0.0) as svc:
        rid = svc.submit(SearchRequest(TINY))
        r = svc.result(rid, timeout=600)
    assert r.cached and r.status == "completed"
    assert _strip(r.result) == _strip(_load(seq_out, TINY.name))
    assert svc.stats().result_cache_hits == 1


def test_seed_burst_is_one_bucket(tmp_path):
    """Four seeds of one scenario inside one window: one batch, one
    bucket of 4 main + 8 specific lanes, each response the sequential
    run of its seed (modulo timing)."""
    svc = _svc(out_dir=str(tmp_path), write=False, window_s=0.0,
               autostart=False)
    try:
        # all submitted before the worker starts: one window
        rids = [svc.submit(SearchRequest(TINY, seed=s)) for s in range(4)]
        svc.start()
        got = [svc.result(rid, timeout=600) for rid in rids]
    finally:
        svc.close()
    st = svc.stats()
    assert (st.batches, st.buckets, st.lanes_total, st.lanes_padded) == \
        (1, 1, 12, 0)
    for s, r in enumerate(got):
        want = runner.run_scenario(dataclasses.replace(TINY, seed=s),
                                   write=False, device="cpu")
        assert r.status == "completed"
        assert _strip(r.result) == _strip(want)


# ---------------------------------------------------------------------------
# progress streaming
# ---------------------------------------------------------------------------


def test_progress_stream_monotone(tmp_path):
    with _svc(out_dir=str(tmp_path), write=False, window_s=0.1,
              autostart=False) as svc:
        rid_a = svc.submit(SearchRequest(TINY))
        rid_b = svc.submit(SearchRequest(TINY_MO))
        svc.start()
        for rid in (rid_a, rid_b):
            events = list(svc.stream(rid))
            assert events, "no progress events streamed"
            gens = [e.generation for e in events]
            assert gens == sorted(set(gens)), \
                "generation indices not strictly increasing"
            assert gens[0] == 0
            assert [e.final for e in events] == \
                [False] * (len(events) - 1) + [True]
            assert all(e.request_id == rid for e in events)
            # the stream replays the result's history exactly
            hist = svc.result(rid).result["history"]
            assert [e.best_score for e in events] == \
                [pytest.approx(h) for h in hist]
        # a drained stream re-streams as empty, not hanging
        assert list(svc.stream(rid_a)) == []


# ---------------------------------------------------------------------------
# deadlines, cancellation, degradation (stubbed executor where the
# device path is irrelevant)
# ---------------------------------------------------------------------------


def _stub_execute(svc, done_names=None):
    """Replace the batch executor with an instant completer."""
    def fake(records):
        for rec in records:
            if done_names is not None:
                done_names.append(rec.scenario.name)
            svc._finish(rec, "completed",
                        result={"scenario": rec.scenario.name,
                                "history": [2.0, 1.0]})
    svc._execute = fake
    return svc


def test_cancel_before_dispatch():
    svc = _stub_execute(_svc(write=False, autostart=False, window_s=0.0))
    rid_keep = svc.submit(SearchRequest(TINY))
    rid_gone = svc.submit(SearchRequest(TINY_PLAIN))
    assert svc.cancel(rid_gone)
    assert not svc.cancel(rid_gone)  # already terminal
    svc.start()
    keep, gone = svc.result(rid_keep, 60), svc.result(rid_gone, 60)
    svc.close()
    assert keep.status == "completed"
    assert gone.status == "cancelled" and gone.result is None
    st = svc.stats()
    assert (st.submitted, st.completed, st.cancelled) == (2, 1, 1)
    assert st.queue_depth == 0 and st.inflight == 0


def test_cancel_after_completion_fails():
    svc = _stub_execute(_svc(write=False, window_s=0.0))
    rid = svc.submit(SearchRequest(TINY))
    assert svc.result(rid, 60).status == "completed"
    assert not svc.cancel(rid)
    svc.close()


def test_deadline_expires_queued_request():
    svc = _stub_execute(_svc(write=False, autostart=False, window_s=0.0))
    rid_live = svc.submit(SearchRequest(TINY, deadline_s=600.0))
    rid_dead = svc.submit(SearchRequest(TINY_PLAIN, deadline_s=0.0))
    time.sleep(0.01)  # let the zero deadline lapse while queued
    svc.start()
    live, dead = svc.result(rid_live, 60), svc.result(rid_dead, 60)
    svc.close()
    assert live.status == "completed"
    assert dead.status == "expired" and "deadline" in dead.error
    assert list(svc.stream(rid_dead)) == []  # stream terminates too
    assert svc.stats().expired == 1


def test_close_without_drain_cancels_queued():
    svc = _stub_execute(_svc(write=False, autostart=False, window_s=0.0))
    rid = svc.submit(SearchRequest(TINY))
    svc.close(drain=False)
    assert svc.result(rid, 1).status == "cancelled"
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(SearchRequest(TINY))


def test_bucket_failure_degrades_to_sequential(tmp_path, monkeypatch):
    """A bucket whose call fails must not fail its requests: the service
    retries each scenario sequentially and the stats record the
    degradation."""
    monkeypatch.setattr(
        campaign._Bucket, "dispatch",
        lambda self: (_ for _ in ()).throw(RuntimeError("launch failed")))
    out = str(tmp_path)
    with _svc(out_dir=out, window_s=0.0) as svc:
        rid = svc.submit(SearchRequest(TINY))
        r = svc.result(rid, timeout=600)
    assert r.status == "completed"
    assert svc.stats().degraded_buckets == 1
    # the degraded result is still the runner's result, byte-identical
    seq = runner.run_scenario(TINY, out_dir=str(tmp_path / "seq"),
                              device="cpu")
    assert _strip(_load(out, TINY.name)) == _strip(seq)


# ---------------------------------------------------------------------------
# interleaving property: accounting stays consistent
# ---------------------------------------------------------------------------


def test_submit_cancel_interleaving_accounting():
    """Any interleaving of submit/cancel leaves the queue empty, every
    request terminal, and the counters summing to submissions."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    actions = st.lists(
        st.one_of(st.just("submit"),
                  st.tuples(st.just("cancel"), st.integers(0, 19))),
        min_size=1, max_size=20)

    @settings(max_examples=25, deadline=None)
    @given(ops=actions)
    def run(ops):
        svc = _stub_execute(_svc(write=False, window_s=0.0))
        rids, cancelled_ok = [], []
        try:
            for op in ops:
                if op == "submit":
                    rids.append(svc.submit(SearchRequest(TINY)))
                elif rids:
                    rid = rids[op[1] % len(rids)]
                    if svc.cancel(rid):
                        cancelled_ok.append(rid)
            responses = [svc.result(rid, timeout=60) for rid in rids]
        finally:
            svc.close()
        st_ = svc.stats()
        assert st_.submitted == len(rids)
        assert (st_.completed + st_.cancelled + st_.expired
                + st_.failed) == len(rids)
        assert st_.cancelled == len(cancelled_ok)
        assert st_.queue_depth == 0 and st_.inflight == 0
        by_rid = {r.request_id: r for r in responses}
        for rid in rids:
            expect = ("cancelled" if rid in cancelled_ok
                      else "completed")
            assert by_rid[rid].status == expect, rid

    run()


def test_service_defaults_to_the_gpu():
    """``device`` defaults to cuda: without a GPU the constructor raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        svc = CodesignService(write=False, autostart=False)
        assert svc.device.type == "cuda"
        svc.close()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CodesignService(write=False)
