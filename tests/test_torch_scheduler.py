"""The port's continuous-batching request runtime, restating
tests/test_scheduler.py: future-based submission, priority batch formation,
bucket snapping, deadline expiry, overload shedding, the queue/compute
latency split, and the ``serve_discovery`` adapter's request-order parity
with synchronous chunking, over host engines (``device="cpu"``)."""
import threading
import time

import numpy as np
import pytest

from repro_torch.exec.plan import DEFAULT_BATCH_BUCKETS, Planner, PlannerConfig
from repro_torch.service import (ColumnCatalog, DeadlineExpired, DiscoveryRequest,
                                 EngineConfig, RequestScheduler,
                                 SchedulerConfig, SchedulerOverloadError,
                                 serve_discovery)
from repro_torch.service import engine as port_engine

from _torch_service import tiny_model as _tiny_model


def DiscoveryEngine(snapshot, model, config):
    return port_engine.DiscoveryEngine(snapshot, model, config, device="cpu")


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sched_catalog"))
    cat = ColumnCatalog(root, n_perm=64, device="cpu")
    for t in range(4):
        cat.add_table(f"t{t}",
                      [(f"c{t}a", [f"v{t}_{i}" for i in range(60)]),
                       (f"c{t}b", [f"w{i % 11}" for i in range(40)])])
    return cat.snapshot()


@pytest.fixture()
def engine(snapshot):
    return DiscoveryEngine(snapshot, _tiny_model(),
                           EngineConfig(k=3, mode="full", cache_entries=0))


class _Gate:
    """Stall the engine's batch path so tests control batch formation."""

    def __init__(self, engine):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls: list[list[str]] = []
        real = engine.query_batch

        def wrapped(reqs, **kw):
            self.calls.append([r.name for r in reqs])
            self.entered.set()
            assert self.release.wait(30)
            return real(reqs, **kw)

        engine.query_batch = wrapped


# ---------------------------------------------------------------------------
# submission / completion basics
# ---------------------------------------------------------------------------

def test_submit_completes_with_latency_split(engine):
    reqs = [DiscoveryRequest(name=f"q{i}", column_id=i % engine.n_columns)
            for i in range(6)]
    with RequestScheduler(engine, SchedulerConfig(max_wait_ms=1.0)) as sch:
        futs = [sch.submit(r) for r in reqs]
        outs = [f.result(timeout=30) for f in futs]
    assert [r.name for r in outs] == [r.name for r in reqs]
    for r in outs:
        assert r.queue_ms >= 0.0 and r.compute_ms > 0.0
        assert r.latency_ms == pytest.approx(r.queue_ms + r.compute_ms)
    s = engine.stats()["scheduler"]
    assert s["submitted"] == 6 and s["completed"] == 6
    assert s["batches"] >= 1 and sum(s["batch_size_hist"].values()) == \
        s["batches"]
    # direct engine calls report pure compute (no queue component)
    direct = engine.query(reqs[0])
    assert direct.queue_ms == 0.0
    assert direct.latency_ms == pytest.approx(direct.compute_ms)


def test_priority_orders_batches_out_of_order(engine):
    """Higher-priority submissions overtake earlier low-priority ones, and
    every future still resolves to its own request's response."""
    gate = _Gate(engine)
    with RequestScheduler(engine,
                          SchedulerConfig(max_wait_ms=0.0,
                                          max_batch=1)) as sch:
        f_decoy = sch.submit(DiscoveryRequest(name="decoy", column_id=0))
        assert gate.entered.wait(30)       # worker busy with the decoy
        f_low = sch.submit(DiscoveryRequest(name="low", column_id=1),
                           priority=0)
        f_high = sch.submit(DiscoveryRequest(name="high", column_id=2),
                            priority=5)
        gate.release.set()
        outs = {name: f.result(timeout=30)
                for name, f in [("decoy", f_decoy), ("low", f_low),
                                ("high", f_high)]}
    assert gate.calls == [["decoy"], ["high"], ["low"]]
    for name, r in outs.items():
        assert r.name == name              # out-of-order completion, yet
        assert r.matches is not None       # each future got ITS response


def test_deadline_expiry(engine, fake_clock):
    """Deadline lapse under an injected clock: no wall-clock sleep, no
    race between the 5 ms deadline and a hoped-for-slow scheduler."""
    gate = _Gate(engine)
    with RequestScheduler(engine,
                          SchedulerConfig(max_wait_ms=0.0,
                                          clock=fake_clock)) as sch:
        f_decoy = sch.submit(DiscoveryRequest(name="decoy", column_id=0))
        assert gate.entered.wait(30)
        f_dead = sch.submit(DiscoveryRequest(name="dead", column_id=1),
                            deadline_ms=5.0)
        f_live = sch.submit(DiscoveryRequest(name="live", column_id=2),
                            deadline_ms=60_000.0)
        fake_clock.advance(0.050)          # deadline lapses while queued
        gate.release.set()
        with pytest.raises(DeadlineExpired):
            f_dead.result(timeout=30)
        assert f_live.result(timeout=30).name == "live"
        assert f_decoy.result(timeout=30).name == "decoy"
        s = sch.stats()
    assert s["expired"] == 1 and s["completed"] == 2


def test_overload_shedding_and_backpressure(engine):
    gate = _Gate(engine)
    sch = RequestScheduler(engine, SchedulerConfig(max_wait_ms=0.0,
                                                   max_batch=1,
                                                   max_queue=2))
    try:
        futs = [sch.submit(DiscoveryRequest(name="q0", column_id=0))]
        assert gate.entered.wait(30)       # q0 popped: worker is busy
        futs += [sch.submit(DiscoveryRequest(name=f"q{i}", column_id=0))
                 for i in range(1, 3)]     # 2 queued = full
        with pytest.raises(SchedulerOverloadError):
            sch.submit(DiscoveryRequest(name="shed", column_id=1))
        assert sch.stats()["shed"] == 1
        # block=True is backpressure, not shedding
        blocked = []
        t = threading.Thread(target=lambda: blocked.append(
            sch.submit(DiscoveryRequest(name="patient", column_id=1),
                       block=True)))
        t.start()
        time.sleep(0.05)
        assert not blocked                 # still waiting for queue space
        gate.release.set()
        t.join(30)
        assert not t.is_alive()
        assert blocked[0].result(timeout=30).name == "patient"
        for f in futs:
            f.result(timeout=30)
        assert sch.stats()["shed"] == 1    # backpressure never sheds
    finally:
        gate.release.set()
        sch.close()


def test_close_drain_false_fails_queued(engine):
    gate = _Gate(engine)
    sch = RequestScheduler(engine, SchedulerConfig(max_wait_ms=0.0,
                                                   max_batch=1))
    f_running = sch.submit(DiscoveryRequest(name="running", column_id=0))
    assert gate.entered.wait(30)
    f_queued = sch.submit(DiscoveryRequest(name="queued", column_id=1))
    closer = threading.Thread(target=lambda: sch.close(drain=False))
    closer.start()
    with pytest.raises(RuntimeError, match="closed"):
        f_queued.result(timeout=30)
    gate.release.set()
    closer.join(30)
    assert not closer.is_alive()
    assert f_running.result(timeout=30).name == "running"  # in-flight lands
    with pytest.raises(RuntimeError, match="closed"):
        sch.submit(DiscoveryRequest(name="late", column_id=0))


# ---------------------------------------------------------------------------
# bucket ladder
# ---------------------------------------------------------------------------

def test_planner_snap_batch():
    p = Planner(PlannerConfig(batch_buckets=(4, 8, 32)))
    assert [p.snap_batch(n) for n in (1, 3, 4, 5, 8, 9, 32)] == \
        [4, 4, 4, 8, 8, 32, 32]
    assert p.snap_batch(33) == 64          # beyond the ladder: top multiple
    assert p.snap_batch(65) == 96
    # no ladder: identity (callers pad by their own multiple)
    assert Planner(PlannerConfig()).snap_batch(13) == 13


def test_scheduler_installs_ladder_and_engine_pads_to_bucket(engine):
    assert engine.config.batch_buckets is None
    gate = _Gate(engine)
    with RequestScheduler(engine,
                          SchedulerConfig(max_wait_ms=50.0,
                                          batch_buckets=(4, 8))) as sch:
        assert engine.planner.config.batch_buckets == (4, 8)
        assert engine._pad_target(3) == 4 and engine._pad_target(5) == 8
        futs = [sch.submit(DiscoveryRequest(name=f"q{i}",
                                            column_id=i % engine.n_columns))
                for i in range(5)]
        gate.release.set()
        for f in futs:
            f.result(timeout=30)
        s = sch.stats()
    # the 5 arrivals coalesced (50ms window) into batches the engine
    # padded up the ladder; the planner only ever saw bucket shapes
    assert s["buckets"] == [4, 8]
    assert engine.last_plan.cost["n_queries"] in (4, 8)
    assert sum(s["batch_size_hist"].values()) == s["batches"]
    assert s["bucket_hits"] + s["bucket_misses"] == s["batches"]


def test_derive_batch_buckets(tmp_path):
    from repro_torch.launch.costmodel import derive_batch_buckets
    rec = {"batch_sweep": {"batches": [{"batch": 32}, {"batch": 8},
                                       {"batch": 64}]}}
    assert derive_batch_buckets(rec) == (8, 32, 64)
    assert derive_batch_buckets({}) == DEFAULT_BATCH_BUCKETS
    assert derive_batch_buckets(str(tmp_path / "missing.json")) == \
        DEFAULT_BATCH_BUCKETS


# ---------------------------------------------------------------------------
# external (uploaded) columns
# ---------------------------------------------------------------------------

def test_external_request_profiled_at_submit(engine):
    gate = _Gate(engine)
    vals = [f"v0_{i}" for i in range(40)]
    with RequestScheduler(engine, SchedulerConfig(max_wait_ms=0.0)) as sch:
        req = DiscoveryRequest(name="up", values=vals)
        fut = sch.submit(req)
        assert req._profile is not None    # profiled in the submitter
        gate.release.set()
        got = fut.result(timeout=30)
    direct = engine.query(DiscoveryRequest(name="up2", values=vals))
    assert [m.column_id for m in got.matches] == \
        [m.column_id for m in direct.matches]


# ---------------------------------------------------------------------------
# serve_discovery compat adapter
# ---------------------------------------------------------------------------

def test_serve_discovery_order_parity_with_pr4_chunking(snapshot):
    """The adapter must look exactly like the old synchronous loop to its
    caller: same responses, same request order, regardless of how the
    scheduler formed batches underneath."""
    model = _tiny_model()
    eng_sync = DiscoveryEngine(snapshot, model,
                               EngineConfig(k=3, mode="full",
                                            cache_entries=0))
    eng_async = DiscoveryEngine(snapshot, model,
                                EngineConfig(k=3, mode="full",
                                             cache_entries=0))
    reqs = [DiscoveryRequest(name=f"q{i}", column_id=(i * 3) % 8)
            for i in range(11)]
    # PR-4 semantics: drain in fixed max_batch chunks, in order
    baseline = []
    for i in range(0, len(reqs), 4):
        baseline.extend(eng_sync.query_batch(reqs[i:i + 4]))
    got = list(serve_discovery(eng_async, reqs, max_batch=4))
    assert [r.name for r in got] == [r.name for r in reqs]
    for b, g in zip(baseline, got):
        assert b.name == g.name
        assert [m.column_id for m in b.matches] == \
            [m.column_id for m in g.matches]
        np.testing.assert_allclose([m.score for m in b.matches],
                                   [m.score for m in g.matches],
                                   rtol=1e-5)


def test_serve_discovery_backpressures_instead_of_shedding(engine):
    """A tiny bounded queue under the adapter must slow the producer, not
    drop requests — every response arrives, in order."""
    reqs = [DiscoveryRequest(name=f"q{i}", column_id=i % engine.n_columns)
            for i in range(12)]
    sch = RequestScheduler(engine, SchedulerConfig(max_queue=2, max_batch=2,
                                                   max_wait_ms=0.0))
    try:
        got = list(serve_discovery(engine, reqs, scheduler=sch))
    finally:
        stats = sch.stats()
        sch.close()
    assert [r.name for r in got] == [r.name for r in reqs]
    assert stats["shed"] == 0 and stats["completed"] == 12
