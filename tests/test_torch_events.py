"""The port's observability layer, restating tests/test_events.py: the
bounded multi-consumer event bus, the metrics registry and exposition
endpoint, and the per-request phase traces threaded scheduler -> engine ->
executor, on host stores and engines (``device="cpu"``)."""
import threading
import time
import urllib.request

import pytest

from repro_torch.service import (BackgroundCompactor, CatalogReader,
                                 ColumnCatalog, DiscoveryEngine, DiscoveryRequest,
                                 EngineConfig, EventBus, MetricsServer,
                                 RequestScheduler, SchedulerConfig, ServiceMetrics,
                                 mint_trace_id, parse_exposition)
from repro_torch.service import events as EV
from repro_torch.service.metrics import BATCH_SIZE_BUCKETS, MetricsRegistry

from _torch_service import tiny_model as _tiny_model


def CatalogStore(root, **kw):
    return ColumnCatalog(root, device="cpu", **kw)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("events_catalog"))
    cat = CatalogStore(root, n_perm=64)
    for t in range(4):
        cat.add_table(f"t{t}",
                      [(f"c{t}a", [f"v{t}_{i}" for i in range(60)]),
                       (f"c{t}b", [f"w{i % 11}" for i in range(40)])])
    return cat.snapshot()


def _engine(snapshot, **kw):
    kw.setdefault("metrics", True)
    return DiscoveryEngine(snapshot, _tiny_model(),
                           EngineConfig(k=3, mode="full", cache_entries=0,
                                        **kw), device="cpu")


# -- event bus ---------------------------------------------------------------

class TestEventBus:
    def test_cursors_advance_independently(self):
        bus = EventBus(capacity=64)
        a, b = bus.subscribe("a"), bus.subscribe("b")
        for i in range(5):
            bus.publish("x", i=i)
        got_a = a.poll()
        assert [e.payload["i"] for e in got_a] == [0, 1, 2, 3, 4]
        for i in range(5, 8):
            bus.publish("x", i=i)
        # b sees the whole stream even though a already consumed a prefix
        assert [e.payload["i"] for e in b.poll()] == list(range(8))
        assert [e.payload["i"] for e in a.poll()] == [5, 6, 7]
        assert a.dropped == b.dropped == 0
        # seqs are dense and shared across consumers
        assert [e.seq for e in got_a] == [0, 1, 2, 3, 4]

    def test_subscribe_positions_at_tail(self):
        bus = EventBus(capacity=8)
        bus.publish("early")
        cur = bus.subscribe("late")
        assert cur.poll() == []
        bus.publish("after")
        assert [e.type for e in cur.poll()] == ["after"]

    def test_overflow_drop_accounting_slow_consumer(self):
        bus = EventBus(capacity=8)
        slow = bus.subscribe("slow")
        for i in range(20):
            bus.publish("x", i=i)
        got = slow.poll()
        # the ring holds the newest 8; the 12 overwritten are counted
        assert [e.payload["i"] for e in got] == list(range(12, 20))
        assert slow.dropped == 12
        assert slow.delivered == 8
        st = bus.stats()
        assert st["published"] == 20
        assert st["consumers"]["slow"] == {"delivered": 8, "dropped": 12,
                                           "lag": 0}

    def test_publish_nonblocking_without_consumers(self):
        # 10k publishes with no consumer must complete quickly (drop-oldest,
        # never wait); generous wall bound so CI noise can't flake it
        bus = EventBus(capacity=16)
        err = []

        def worker():
            try:
                for i in range(10_000):
                    bus.publish("spin", i=i)
            except BaseException as e:      # pragma: no cover
                err.append(e)

        th = threading.Thread(target=worker)
        t0 = time.perf_counter()
        th.start()
        th.join(timeout=10)
        assert not th.is_alive() and not err
        assert time.perf_counter() - t0 < 10
        assert bus.stats()["published"] == 10_000

    def test_max_events_poll_chunking(self):
        bus = EventBus(capacity=64)
        cur = bus.subscribe()
        for i in range(10):
            bus.publish("x", i=i)
        assert len(cur.poll(max_events=4)) == 4
        assert len(cur.poll(max_events=4)) == 4
        assert len(cur.poll()) == 2

    def test_mint_trace_id_unique(self):
        ids = {mint_trace_id() for _ in range(1000)}
        assert len(ids) == 1000


# -- metrics registry --------------------------------------------------------

class TestMetrics:
    def test_histogram_bucket_boundaries(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat_ms", buckets=(1.0, 10.0, 100.0))
        for v in (0.5, 1.0, 1.5, 10.0, 99.9, 100.0, 1e6):
            h.observe(v)
        got = h._collect()["buckets"]
        # le is INCLUSIVE (Prometheus contract): 1.0 lands in le="1"
        assert got == {"1": 2, "10": 4, "100": 6, "+Inf": 7}
        assert h._collect()["count"] == 7

    def test_exposition_golden(self):
        reg = MetricsRegistry()
        c = reg.counter("reqs_total", "requests")
        g = reg.gauge("depth")
        h = reg.histogram("ms", buckets=(1.0, 5.0))
        c.inc(3)
        c.inc(2, consumer="metrics")
        g.set(7)
        h.observe(0.5)
        h.observe(4.0)
        h.observe(9.0)
        assert reg.render() == (
            "# TYPE depth gauge\n"
            "depth 7\n"
            "# TYPE ms histogram\n"
            'ms_bucket{le="1"} 1\n'
            'ms_bucket{le="5"} 2\n'
            'ms_bucket{le="+Inf"} 3\n'
            "ms_sum 13.5\n"
            "ms_count 3\n"
            "# HELP reqs_total requests\n"
            "# TYPE reqs_total counter\n"
            "reqs_total 3\n"
            'reqs_total{consumer="metrics"} 2\n')

    def test_parse_exposition_roundtrip(self):
        reg = MetricsRegistry()
        reg.counter("a_total").inc(5)
        reg.gauge("b").set(2.5, shard="x")
        reg.histogram("h_ms", buckets=(10.0,)).observe(3)
        parsed = parse_exposition(reg.render())
        assert parsed["a_total"][""] == 5
        assert parsed["b"]['{shard="x"}'] == 2.5
        assert parsed["h_ms_bucket"]['{le="10"}'] == 1
        assert parsed["h_ms_bucket"]['{le="+Inf"}'] == 1
        assert parsed["h_ms_count"][""] == 1

    def test_registration_idempotent_and_type_checked(self):
        reg = MetricsRegistry()
        assert reg.counter("x") is reg.counter("x")
        with pytest.raises(ValueError):
            reg.gauge("x")

    def test_service_metrics_event_folding(self):
        bus = EventBus(capacity=256)
        m = ServiceMetrics(bus)
        bus.publish(EV.REQUEST_ADMITTED, trace_id="t1")
        bus.publish(EV.REQUEST_SHED, name="q")
        bus.publish(EV.BATCH_FORMED, n=4, trace_ids=list("abcd"))
        bus.publish(EV.CACHE_HIT, n=3)
        bus.publish(EV.CACHE_MISS, n=1)
        bus.publish(EV.COMPILE_END, ms=12.5)
        bus.publish(EV.MANIFEST_ADVANCED, version=9)
        assert m.drain() == 7
        assert m.requests_admitted.value() == 1
        assert m.requests_shed.value() == 1
        assert m.batches_formed.value() == 1
        assert m.cache_hits.value() == 3
        assert m.cache_misses.value() == 1
        assert m.compiles.value() == 1
        assert m.manifest_version.value() == 9
        # batch_size histogram saw n=4 (bucket le=4)
        assert m.batch_size._collect()["buckets"][
            str(BATCH_SIZE_BUCKETS[2])] == 1

    def test_http_endpoint(self):
        reg = MetricsRegistry()
        reg.counter("up_total").inc()
        with MetricsServer(reg) as srv:
            assert srv.port > 0
            body = urllib.request.urlopen(srv.url, timeout=10).read()
            assert parse_exposition(body.decode())["up_total"][""] == 1
            # non-metrics paths 404 instead of leaking anything
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/other", timeout=10)


# -- end-to-end tracing ------------------------------------------------------

class TestTracing:
    def test_direct_query_trace_spans_sum_to_compute(self, snapshot):
        eng = _engine(snapshot, metrics=False)   # traces need no bus
        r = eng.query(DiscoveryRequest(name="q", column_id=0))
        assert r.trace_id is not None
        phases = [s["phase"] for s in r.trace]
        assert phases == ["pin", "resolve", "plan", "candidates",
                          "execute", "finalize"]
        assert abs(sum(s["ms"] for s in r.trace)
                   - r.latency_ms) < 1e-6
        assert r.latency_ms == r.compute_ms      # no scheduler: queue 0

    def test_caller_seeded_trace_id(self, snapshot):
        eng = _engine(snapshot, metrics=False)
        r = eng.query(DiscoveryRequest(name="q", column_id=0,
                                       trace_id="mine-001"))
        assert r.trace_id == "mine-001"

    def test_scheduler_roundtrip_admitted_to_batch_chain(self, snapshot):
        eng = _engine(snapshot)
        tail = eng.events.subscribe("test-tail")
        with RequestScheduler(eng, SchedulerConfig(max_wait_ms=1.0)) as s:
            futs = [s.submit(DiscoveryRequest(name=f"q{i}",
                                              column_id=i % 8))
                    for i in range(6)]
            rs = [f.result(timeout=60) for f in futs]
        evs = tail.poll()
        admitted = [e for e in evs if e.type == EV.REQUEST_ADMITTED]
        formed = [e for e in evs if e.type == EV.BATCH_FORMED]
        assert len(admitted) == 6
        # every admitted trace id appears in exactly one formed batch
        batched = [tid for e in formed for tid in e.payload["trace_ids"]]
        assert sorted(batched) == sorted(e.payload["trace_id"]
                                         for e in admitted)
        assert len(batched) == len(set(batched)) == 6
        # ... and on exactly one response, whose spans partition latency
        assert sorted(r.trace_id for r in rs) == sorted(batched)
        for r in rs:
            assert [s_["phase"] for s_ in r.trace[:2]] == ["profile",
                                                           "queue"]
            assert abs(sum(s_["ms"] for s_ in r.trace)
                       - r.latency_ms) < 1e-6
            assert r.trace[1]["ms"] >= 0      # queue = queue_ms - profile

    def test_scheduler_feeds_metrics_registry(self, snapshot):
        eng = _engine(snapshot)
        with RequestScheduler(eng, SchedulerConfig(max_wait_ms=0.5)) as s:
            futs = [s.submit(DiscoveryRequest(name=f"q{i}", column_id=i))
                    for i in range(4)]
            [f.result(timeout=60) for f in futs]
            text = eng.metrics.render()
        parsed = parse_exposition(text)
        assert parsed["requests_admitted_total"][""] == 4
        assert parsed["requests_completed_total"][""] == 4
        assert parsed["request_latency_ms_count"][""] == 4
        assert parsed["batches_formed_total"][""] >= 1
        # the dedicated metrics consumer kept up: zero drops
        assert all(v == 0 for v in
                   parsed["event_bus_dropped_total"].values())

    def test_compile_events_first_contact_only(self, snapshot):
        eng = _engine(snapshot)
        tail = eng.events.subscribe("compiles")
        reqs = [DiscoveryRequest(name="a", column_id=0)]
        r0 = eng.query_batch(reqs)[0]
        first = [e.type for e in tail.poll()]
        assert first.count(EV.COMPILE_BEGIN) == 1
        assert first.count(EV.COMPILE_END) == 1
        # first contact annotates the execute span with the compile wall
        ex = [s for s in r0.trace if s["phase"] == "execute"]
        assert ex and ex[0]["compile_ms"] > 0
        eng.query_batch(reqs)                    # same shape: silent
        again = [e.type for e in tail.poll()]
        assert EV.COMPILE_BEGIN not in again
        assert EV.COMPILE_END not in again
        # the first response's execute span carried the compile wall
        r = eng.query_batch(reqs)[0]
        assert all("compile_ms" not in s for s in r.trace)

    def test_snapshot_lifecycle_events(self, snapshot):
        eng = _engine(snapshot)
        tail = eng.events.subscribe("mvcc")
        eng.query(DiscoveryRequest(name="q", column_id=0))
        types = [e.type for e in tail.poll()]
        assert EV.SNAPSHOT_PINNED in types
        eng.refresh(snapshot)                    # retires the old version
        types = [e.type for e in tail.poll()]
        assert EV.SNAPSHOT_RETIRED in types


# -- catalog / compactor events ---------------------------------------------

class TestCatalogEvents:
    def test_store_publish_and_follower_poll_events(self, tmp_path):
        bus = EventBus(capacity=256)
        store = CatalogStore(str(tmp_path), n_perm=32, events=bus)
        cur = bus.subscribe("chain")
        store.add_table("t0", [("c", [f"v{i}" for i in range(40)])])
        advanced = [e for e in cur.poll()
                    if e.type == EV.MANIFEST_ADVANCED]
        assert advanced and not advanced[-1].payload["follower"]
        assert advanced[-1].payload["version"] == store.version

        rbus = EventBus(capacity=64)
        reader = CatalogReader(str(tmp_path), events=rbus)
        rcur = rbus.subscribe("follower")
        store.add_table("t1", [("d", [f"w{i}" for i in range(40)])])
        assert reader.poll() == [store.version]
        seen = [e for e in rcur.poll() if e.type == EV.MANIFEST_ADVANCED]
        assert [e.payload["version"] for e in seen] == [store.version]
        assert all(e.payload["follower"] for e in seen)

    def test_compactor_lifecycle_events(self, tmp_path):
        bus = EventBus(capacity=256)
        store = CatalogStore(str(tmp_path), n_perm=32, events=bus)
        for t in range(3):
            store.add_table(f"t{t}", [("c", [f"v{t}_{i}"
                                             for i in range(30)])])
        cur = bus.subscribe("compaction")
        with BackgroundCompactor(store) as comp:  # inherits store.events
            comp.submit().result(timeout=60)
        types = [e.type for e in cur.poll()]
        assert types.index(EV.COMPACTION_STARTED) < \
            types.index(EV.COMPACTION_PUBLISHED)


# -- loadgen / stats consistency --------------------------------------------

class TestLoadgenAndStats:
    def test_open_loop_retains_completions(self, snapshot):
        from repro_torch.service.loadgen import run_open_loop
        eng = _engine(snapshot)
        pool = [DiscoveryRequest(name=f"p{i}", column_id=i % 8)
                for i in range(8)]
        r = run_open_loop(eng, pool, offered_qps=200.0, duration_s=0.1,
                          deadline_ms=10_000.0, max_arrivals=24)
        assert len(r["completions"]) == r["n_offered"] - r["expired"]
        done_ts = [c["t_done_s"] for c in r["completions"]]
        assert done_ts == sorted(done_ts)        # drained in finish order
        assert r["latency_hist"]["+Inf"] == len(r["completions"])
        assert r["max_trace_sum_err_ms"] is not None
        assert r["max_trace_sum_err_ms"] <= 1.0
        assert {"profile", "queue", "execute"} <= set(r["trace_phases"])

    def test_stats_snapshot_consistent_under_load(self, snapshot):
        # hits+misses must always equal queries — the torn-snapshot bug
        # stats() had before it took the counter locks
        eng = _engine(snapshot, metrics=False)
        stop = threading.Event()
        errs = []

        def serve():
            i = 0
            while not stop.is_set():
                eng.query(DiscoveryRequest(name=f"s{i}", column_id=i % 8))
                i += 1

        def watch():
            while not stop.is_set():
                s = eng.stats()
                if s["cache"]["hits"] + s["cache"]["misses"] \
                        != s["queries"]:
                    errs.append(s)
                    return

        ths = [threading.Thread(target=serve) for _ in range(2)] + \
              [threading.Thread(target=watch)]
        for t in ths:
            t.start()
        time.sleep(0.8)
        stop.set()
        for t in ths:
            t.join(timeout=30)
        assert not errs, f"torn stats snapshot: {errs[0]}"
