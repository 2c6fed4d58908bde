"""Open-loop (Poisson-arrival) load driver for the request scheduler.

Closed-loop measurements (time N back-to-back batches) hide queueing: the
benchmark only ever offers the next request once the last one finished.
An **open-loop** driver offers requests on a Poisson arrival process at a
fixed rate regardless of completion — so queue wait, deadline misses, and
load shedding become visible.  This is the shared measurement core behind
``benchmarks/bench_service.py --open-loop`` and
``launch/discover.py --open-loop``.

Every completion is retained individually (``completions``: per-request
finish timestamp + latency + trace spans), so a run's client-side latency
histogram can be cross-checked against the server-side metrics registry
(``ServiceMetrics``) — the two measure the same requests through
different instruments and must agree.  ``trace_phases`` aggregates the
per-request phase spans into per-phase p50/p99, and
``max_trace_sum_err_ms`` is the worst |sum(spans) - latency_ms| over the
run — the traces' exactness guarantee, measured.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.service.metrics import DEFAULT_LATENCY_BUCKETS_MS
from repro_torch.service.scheduler import (DeadlineExpired, RequestScheduler,
                                     SchedulerConfig, SchedulerOverloadError)


def latency_histogram(lats_ms, buckets=DEFAULT_LATENCY_BUCKETS_MS) -> dict:
    """Cumulative bucket counts over ``lats_ms``, same boundaries (and
    same cumulative ``le`` semantics) as the server-side histogram — so
    client-observed latencies are directly comparable to a scrape."""
    lats = np.asarray(sorted(lats_ms), dtype=np.float64)
    out = {f"{float(b):g}": int(np.searchsorted(lats, float(b), "right"))
           for b in buckets}
    out["+Inf"] = int(lats.size)
    return out


def _trace_phase_stats(traces: list[list[dict]]) -> dict:
    by_phase: dict[str, list[float]] = {}
    for tr in traces:
        for span in tr:
            by_phase.setdefault(span["phase"], []).append(span["ms"])
    return {
        phase: {"n": len(ms),
                "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)),
                "total_ms": float(np.sum(ms))}
        for phase, ms in by_phase.items()
    }


def run_open_loop(engine, pool, offered_qps: float, duration_s: float,
                  deadline_ms: float, *,
                  scheduler_config: SchedulerConfig | None = None,
                  seed: int = 0, max_arrivals: int | None = None) -> dict:
    """Offer a Poisson request stream to a fresh scheduler over ``engine``.

    ``pool`` is a list of :class:`DiscoveryRequest`\\ s cycled round-robin
    (reused objects are safe: requests are read-only on the serve path).
    Returns achieved QPS, goodput under the deadline, latency-incl-queue
    percentiles, shed and expiration rates, the scheduler's formed-batch
    statistics, plus the per-request ``completions`` record and trace
    aggregates described in the module docstring.  ``max_arrivals``
    bounds the submit loop (the run shortens rather than the rate
    dropping).
    """
    rng = np.random.default_rng(seed)
    n = max(int(offered_qps * duration_s), 16)
    if max_arrivals is not None:
        n = min(n, int(max_arrivals))
    arrivals = np.cumsum(rng.exponential(1.0 / offered_qps, size=n))
    scheduler = RequestScheduler(engine, scheduler_config)
    try:
        futures, shed = [], 0
        t0 = time.perf_counter()
        for i in range(n):
            gap = arrivals[i] - (time.perf_counter() - t0)
            if gap > 0:
                time.sleep(gap)
            try:
                futures.append(scheduler.submit(pool[i % len(pool)],
                                                deadline_ms=deadline_ms))
            except SchedulerOverloadError:
                shed += 1
        completions, expired = [], 0
        for f in futures:
            try:
                r = f.result(timeout=300)
            except DeadlineExpired:
                expired += 1
                continue
            # completion timestamp is taken as results are drained — for
            # already-resolved futures it trails the true finish slightly,
            # but it is monotone in finish order, which is what throughput-
            # over-time plots need
            completions.append({
                "t_done_s": time.perf_counter() - t0,
                "latency_ms": r.latency_ms,
                "queue_ms": r.queue_ms,
                "compute_ms": r.compute_ms,
                "cached": r.cached,
                "trace_id": r.trace_id,
                "trace": r.trace,
            })
        wall = time.perf_counter() - t0      # submit + drain
        stats = scheduler.stats()
    finally:
        scheduler.close()
    lats = [c["latency_ms"] for c in completions]
    completed = len(lats)
    good = sum(1 for l in lats if l <= deadline_ms)
    trace_err = [abs(sum(s["ms"] for s in c["trace"]) - c["latency_ms"])
                 for c in completions if c["trace"]]
    return {
        "offered_qps": n / max(float(arrivals[-1]), 1e-9),
        "n_offered": n,
        "duration_s": wall,
        "qps": completed / max(wall, 1e-9),
        "goodput_qps": good / max(wall, 1e-9),
        "p50_ms": float(np.percentile(lats, 50)) if lats else None,
        "p99_ms": float(np.percentile(lats, 99)) if lats else None,
        "shed": shed, "shed_rate": shed / n,
        "expired": expired, "expired_rate": expired / n,
        "batches": stats["batches"],
        "batch_size_hist": stats["batch_size_hist"],
        "bucket_hits": stats["bucket_hits"],
        "buckets": stats["buckets"],
        "max_queue_depth": stats["max_queue_depth"],
        "completions": completions,
        "latency_hist": latency_histogram(lats),
        "trace_phases": _trace_phase_stats(
            [c["trace"] for c in completions if c["trace"]]),
        "max_trace_sum_err_ms": max(trace_err) if trace_err else None,
    }
