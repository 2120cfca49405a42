"""Co-design service launcher: concurrent scenario searches through
``repro_torch.api.CodesignService``, with the service stats surface
rendered at the end; counterpart of ``repro/launch/codesign_serve.py``,
with the same flags plus ``--device``.

  python -m repro_torch.launch.codesign_serve --requests 4 --smoke
  python -m repro_torch.launch.codesign_serve --scenario rram_small_set \\
      --requests 8 --smoke --out /tmp/serve --compile-cache DIR \\
      [--device cuda|cpu]

Each request is a distinct clone of the base scenario (its own name
and seed), so every request owns a result-cache entry. With
``--verify-cached`` (default on) the same requests are resubmitted
after the first round completes and the launcher checks that every
response is served from the result cache with an identical payload.
``--compile-cache`` points the kernel-build directory (and the
campaign's bucket-signature index) at DIR. The service runs on the GPU
unless ``--device cpu`` is given; the launcher exits 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from ..api import (DEFAULT_OUT_DIR, CodesignService, SearchRequest,
                   get_scenario)
from ..device import resolve_device

# result fields that legitimately differ between a fresh run and its
# cached replay (runner timing + the cache marker itself)
_TIMING_FIELDS = ("wall_time_s", "search_wall_time_s",
                  "sampling_time_s", "cached")


def _strip(result: dict) -> dict:
    return {k: v for k, v in result.items() if k not in _TIMING_FIELDS}


def render_stats(stats) -> str:
    """The service observability surface as a printable block."""
    return "\n".join([
        "-- codesign service stats " + "-" * 28,
        f"  uptime            {stats.uptime_s:8.2f} s"
        f"    requests/sec {stats.requests_per_sec:6.2f}",
        f"  requests          {stats.submitted:4d} submitted "
        f"/ {stats.completed} completed / {stats.cancelled} cancelled "
        f"/ {stats.expired} expired / {stats.failed} failed",
        f"  queue depth       {stats.queue_depth:4d}"
        f"    inflight {stats.inflight}    batches {stats.batches}",
        f"  buckets           {stats.buckets:4d} "
        f"({stats.degraded_buckets} degraded), occupancy "
        f"{stats.bucket_occupancy:.2f} "
        f"({stats.lanes_total} lanes + {stats.lanes_padded} pad)",
        f"  result cache      {stats.result_cache_hits:4d} hits",
        f"  kernel cache      {stats.kernel_cache_hits:4d} hits / "
        f"{stats.kernel_cache_misses} misses "
        f"(hit rate {stats.kernel_cache_hit_rate:.2f})",
        f"  latency           p50 {stats.latency_p50_s:.2f}s   "
        f"p90 {stats.latency_p90_s:.2f}s   p99 {stats.latency_p99_s:.2f}s",
    ])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="rram_smoke",
                    help="base registry scenario to clone per request")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="run every request at the smoke budget")
    ap.add_argument("--out", default=DEFAULT_OUT_DIR)
    ap.add_argument("--window", type=float, default=0.25,
                    help="micro-batching window (s)")
    ap.add_argument("--compile-cache", default=None,
                    help="kernel-build cache directory")
    ap.add_argument("--no-verify-cached", dest="verify_cached",
                    action="store_false",
                    help="skip the cached-replay verification round")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"codesign_serve: {e}", file=sys.stderr)
        return 2

    base = get_scenario(args.scenario)
    clones = [dataclasses.replace(base, name=f"{base.name}@r{i}",
                                  seed=base.seed + i)
              for i in range(args.requests)]

    with CodesignService(out_dir=args.out, window_s=args.window,
                         compile_cache=args.compile_cache,
                         device=dev) as svc:
        rids = [svc.submit(SearchRequest(sc, smoke=args.smoke))
                for sc in clones]
        first = [svc.result(rid, timeout=1800) for rid in rids]
        for r in first:
            print(f"  {r.request_id}  {r.scenario:28s} {r.status:10s}"
                  f" cached={r.cached!s:5s} {r.latency_s:6.2f}s")
        bad = [r for r in first if r.status != "completed"]
        if bad:
            print(f"FAIL: {len(bad)} request(s) did not complete: "
                  f"{[(r.request_id, r.status, r.error) for r in bad]}")
            print(render_stats(svc.stats()))
            return 1

        if args.verify_cached:
            replay_rids = [svc.submit(SearchRequest(sc, smoke=args.smoke))
                           for sc in clones]
            replay = [svc.result(rid, timeout=300) for rid in replay_rids]
            for a, b in zip(first, replay):
                if b.status != "completed" or not b.cached:
                    print(f"FAIL: replay {b.request_id} ({b.scenario}) "
                          f"not served from cache: status={b.status} "
                          f"cached={b.cached} err={b.error}")
                    return 1
                if _strip(a.result) != _strip(b.result):
                    print(f"FAIL: replay {b.request_id} ({b.scenario}) "
                          "cached result differs from the first run")
                    return 1
            print(f"  replay: {len(replay)} requests served from the "
                  "result cache, payloads equal")

        print(render_stats(svc.stats()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
