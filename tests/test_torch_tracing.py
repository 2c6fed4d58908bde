"""The port's span tree (``repro_torch.exec.tracing``) on the host: one
record per formed batch from the scheduler through the engine to the
executor's stages; the engine's phases against ``DiscoveryResponse.trace``;
``stats()["trace"]`` against ``trace_records()``; the counters on a small
tiered lake; device intervals through timing events and their anchor; idle
time put down to host spans; tracing off (no event, no profiler range) and
on under a running ``torch.profiler``, whose all-thread trace holds the
scheduler thread's ``freyja::`` ranges on the tracer's clock."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.lakegen import ScaledLakeSpec, generate_scaled_lake
from repro_torch.core.predictor import JoinQualityModel
from repro_torch.core.profiles import lake_profiles
from repro_torch.exec import tracing
from repro_torch.service import catalog
from repro_torch.service.api import DiscoveryRequest
from repro_torch.service.catalog import CatalogSnapshot
from repro_torch.service.engine import DiscoveryEngine, EngineConfig
from repro_torch.service.lsh import LSHConfig
from repro_torch.service.scheduler import RequestScheduler, SchedulerConfig

N_COLUMNS = 1200            # survivors max(5%, 512) = 512 < N: the coarse pass prunes
ENGINE_PHASES = ("pin", "resolve", "plan", "candidates", "execute", "finalize")
SCHEDULER_SPANS = ("wait", "form", "batch", "deliver")


@pytest.fixture(scope="module")
def snapshot():
    lake = generate_scaled_lake(ScaledLakeSpec(n_columns=N_COLUMNS, seed=3))
    num, words, sigs = catalog.profile_and_sign(lake.batch, n_perm=128, seed=0, device="cpu")
    return CatalogSnapshot(profiles=lake_profiles(num, words, lake.batch.n_rows),
                           signatures=sigs, table_ids=lake.table,
                           names=[f"c{i}" for i in range(N_COLUMNS)], table_names={},
                           version=1, minhash_seed=0)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    t, d = 6, 3
    return JoinQualityModel(gbdt=GBDTParams(
        feats=rng.integers(0, 23, (t, d)).astype(np.int32),
        thrs=rng.normal(0, 1, (t, d)).astype(np.float32),
        leaves=rng.normal(0, 1, (t, 1 << d)).astype(np.float32), base=0.0))


def _engine(snapshot, model, **kw):
    cfg = dict(k=10, lsh=LSHConfig(n_bands=64, n_coarse_bands=16))
    cfg.update(kw)
    return DiscoveryEngine(snapshot, model, EngineConfig(**cfg), device="cpu")


def _requests(ids, prefix="q"):
    return [DiscoveryRequest(name=f"{prefix}{i}", column_id=int(c)) for i, c in enumerate(ids)]


def _serve(engine, ids, rounds=1):
    """Submit ``ids`` (shifted by the round, so no round hits the result
    cache) through a scheduler ``rounds`` times, a round at a time; returns
    the responses and the scheduler's stats."""
    out = []
    with RequestScheduler(engine, SchedulerConfig(max_wait_ms=20.0)) as sch:
        for r in range(rounds):
            shifted = (np.asarray(ids) + r) % N_COLUMNS
            futs = [sch.submit(q) for q in _requests(shifted, f"r{r}q")]
            out.append([f.result(timeout=60) for f in futs])
    return out, sch.stats()           # closed: the last batch's deliver is folded


def _spans(rec: dict) -> list[dict]:
    return rec["spans"]


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode, dtype", [("full", "fp32"), ("tiered", "int8"), ("lsh", "fp32")])
def test_children_lie_inside_their_parents(snapshot, model, mode, dtype):
    eng = _engine(snapshot, model, mode=mode, profile_dtype=dtype, metrics=True)
    _serve(eng, np.arange(0, N_COLUMNS, 97), rounds=2)
    recs = eng.trace_records()
    assert len(recs) >= 2                    # a round may form more than one batch
    for rec in recs:
        spans = _spans(rec)
        names = [s["name"] for s in spans]
        assert [s["name"] for s in spans if s["parent"] < 0] == list(SCHEDULER_SPANS)
        batch = names.index("batch")
        assert [s["name"] for s in spans if s["parent"] == batch] == list(ENGINE_PHASES)
        execute = names.index("execute")
        stages = [s["name"] for s in spans if s["parent"] == execute]
        want = {"full": ["upload", "score", "mask", "merge", "download"],
                "tiered": ["upload", "coarse", "fine", "score", "merge", "rerank", "download"],
                "lsh": ["upload", "prune", "score", "merge", "download"]}[mode]
        assert stages == want
        if mode == "tiered":
            coarse = names.index("coarse")
            assert [s["name"] for s in spans if s["parent"] == coarse] == \
                ["fill", "probe", "priority", "select"]
            assert [s["name"] for s in spans if s["parent"] == names.index("rerank")] == \
                ["roundtrip"]
        finalize = names.index("finalize")
        assert [s["name"] for s in spans if s["parent"] == finalize] == \
            ["matches", "cache", "respond"]
        for s in spans:
            assert s["t1_ns"] >= s["t0_ns"] > 0
            if s["parent"] >= 0:
                p = spans[s["parent"]]
                assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"], (s, p)
            for d0, d1 in s.get("device_ns", []):
                # on the host a stage's device interval is its host interval
                assert s["t0_ns"] <= d0 <= d1 <= s["t1_ns"]
    for row in eng.stats()["trace"]["spans"].values():
        assert row["self_ms"] >= 0 and row["total_ms"] >= row["self_ms"]
        assert row["max_ms"] <= row["total_ms"] and row["count"] >= 1


def test_engine_phases_are_the_response_trace(snapshot, model):
    eng = _engine(snapshot, model, mode="full", metrics=True)
    ids = np.arange(3, N_COLUMNS, 113)
    responses = eng.query_batch(_requests(ids))
    (rec,) = eng.trace_records()
    spans = _spans(rec)
    batch = [s["name"] for s in spans].index("batch")
    phases = [s for s in spans if s["parent"] == batch]
    assert [s["name"] for s in phases] == list(ENGINE_PHASES)
    for a, b in zip(phases, phases[1:]):
        assert a["t1_ns"] == b["t0_ns"]                  # contiguous
    n = len(ids)
    for r in responses:
        got = [s for s in r.trace if s["phase"] not in ("profile", "queue")]
        assert [s["phase"] for s in got] == list(ENGINE_PHASES)
        for s, p in zip(got, phases):
            assert s["ms"] * n == pytest.approx((p["t1_ns"] - p["t0_ns"]) / 1e6, rel=1e-9)
        assert sum(s["ms"] for s in got) == pytest.approx(r.compute_ms, rel=1e-9)
        assert r.compute_ms * n == pytest.approx(
            (phases[-1]["t1_ns"] - phases[0]["t0_ns"]) / 1e6, rel=1e-9)


def test_totals_are_the_sum_of_the_records(snapshot, model):
    eng = _engine(snapshot, model, mode="tiered", profile_dtype="int8", metrics=True)
    _, sched = _serve(eng, np.arange(0, N_COLUMNS, 61), rounds=3)
    eng.query_batch(_requests([5, 6, 7], "direct"))      # a record the engine owns
    recs = eng.trace_records()
    assert len(recs) >= 4 and [r["id"] for r in recs] == sorted(r["id"] for r in recs)
    totals = eng.stats()["trace"]
    assert totals["batches"] == totals["device_batches"] == len(recs)

    def summed(names, records):
        out = {}
        for rec in records:
            for s in _spans(rec):
                if s["name"] in names:
                    out[s["name"]] = out.get(s["name"], 0.0) + (s["t1_ns"] - s["t0_ns"]) / 1e6
        return out

    sched_recs = recs[:-1]
    want = summed(SCHEDULER_SPANS, sched_recs)
    got = sched["trace"]["spans"]
    assert set(got) == set(SCHEDULER_SPANS)
    for name in SCHEDULER_SPANS:
        assert got[name]["count"] == len(sched_recs)
        assert got[name]["total_ms"] == pytest.approx(want[name], rel=1e-9)
    engine_names = set(totals["spans"]) - {"batch"}
    want = summed(engine_names, recs)
    for name in engine_names:
        assert totals["spans"][name]["total_ms"] == pytest.approx(want[name], rel=1e-9)
    # only the direct call's root is the engine's
    assert totals["spans"]["batch"]["count"] == 1
    dev = {}
    for rec in recs:
        for s in _spans(rec):
            for d0, d1 in s.get("device_ns", []):
                dev[s["name"]] = dev.get(s["name"], 0.0) + (d1 - d0) / 1e6
    assert set(dev) == set(totals["device_ms"])
    for name, ms in dev.items():
        assert totals["device_ms"][name]["ms"] == pytest.approx(ms, rel=1e-9)
    counters = {}
    for rec in recs:
        for k, v in rec["counters"].items():
            counters[k] = counters.get(k, 0) + v
    assert counters == totals["counters"]


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def test_counters_on_a_tiered_lake(snapshot, model):
    cap = 8
    eng = _engine(snapshot, model, mode="tiered", profile_dtype="int8", cache_entries=cap,
                  batch_pad=8)
    ex = eng._head.executor
    tiers = []                               # each batch's tier counts
    execute = ex.execute

    def recording_execute(*args, **kw):
        res = execute(*args, **kw)
        tiers.append(res.tier)
        return res

    ex.execute = recording_execute
    hits = surv = rerank = walked = 0
    occupancy = 0
    for b in range(3):                       # 3 batches of 6 distinct misses
        ids = np.arange(b * 6, b * 6 + 6) * 37 % N_COLUMNS
        eng.query_batch(_requests(ids, f"b{b}q"))
        n_hits, n_surv = tiers[-1]
        hits += int(n_hits.sum())
        surv += int(n_surv.sum())
        plan = eng.last_plan
        rerank += 8 * min(4 * plan.k, plan.budget)    # padded batch x over-fetch R
        for _ in ids:                        # each miss into a full cache
            walked += 1 if occupancy >= cap else 0   # inspects one victim
            occupancy = min(occupancy + 1, cap)
    c = eng.stats()["trace"]["counters"]
    assert c["digest_hits"] == hits > 0 and c["survivors"] == surv > 0
    assert c["rerank_rows"] == rerank == 3 * 8 * 40
    assert c["cache_walked"] == walked == 10
    assert c["scored_columns"] == eng.stats()["scored_columns"]
    # the batch's uploads (queries, fine and coarse keys, re-rank rows) and
    # downloads (top-k, counts, tier stats, re-rank ids), in bytes
    q, f = 8, 21
    up = q * (f * 4 + 11 * 8 + 8 + 8 + 64 * 8 + 16 * 8) + q * 40 * (f * 4 + 8)
    down = q * (10 * 4 + 10 * 4 + 4 + 4 + 4) + q * 40 * 8
    assert c["h2d_bytes"] == 3 * up and c["d2h_bytes"] == 3 * down
    assert "scan_columns" not in eng.stats()


def test_cache_walk_counts_only_full_admissions(snapshot, model):
    eng = _engine(snapshot, model, mode="full", cache_entries=4, batch_pad=8)
    eng.query_batch(_requests([1, 2, 3]))
    assert eng.stats()["trace"]["counters"]["cache_walked"] == 0
    eng.query_batch(_requests([4, 5, 6]))        # 1 fills the cache, 2 inspect a victim each
    assert eng.stats()["trace"]["counters"]["cache_walked"] == 2
    eng.query_batch(_requests([4, 5, 6]))        # hits: nothing admitted
    assert eng.stats()["trace"]["counters"]["cache_walked"] == 2


def test_full_cache_admission_inspects_one_victim(snapshot, model):
    """A full 1,024-entry cache at one cost: each of a batch's 256 misses
    inspects one victim, and one cost level is resident; mixed costs keep
    one level a resident cost."""
    eng = _engine(snapshot, model, mode="full", cache_entries=1024)
    eng.query_batch(_requests(range(256)))
    cost = {c for _, c in eng._cache.values()}
    assert len(cost) == 1
    fill = [b"fill%d" % i for i in range(768)]   # the rest of the cache, at the plan's cost
    assert eng._cache_admit(fill, [[]] * 768, *cost) == 0
    assert eng.stats()["cache"]["size"] == 1024
    eng.query_batch(_requests(range(256, 512)))  # 256 misses into the full cache
    s = eng.stats()
    assert s["trace"]["counters"]["cache_walked"] == 256
    assert s["cache"]["evicted"] == 256 and s["cache"]["rejected"] == 0
    assert s["cache"]["size"] == 1024 and s["cache"]["cost_levels"] == 1
    # the victims were the oldest: the first batch's entries, not the fill
    assert all(key in eng._cache for key in fill)

    mixed = _engine(snapshot, model, mode="full", cache_entries=4)
    levels = []
    for key, c in ((b"a", 1.0), (b"b", 2.0), (b"c", 2.0), (b"d", 3.0),
                   (b"e", 2.0), (b"f", 0.5), (b"g", 3.0), (b"c", 5.0),
                   (b"h", 2.0), (b"i", 3.0)):
        mixed._cache_admit([key], [[]], c)
        levels.append(mixed.stats()["cache"]["cost_levels"])
    # e evicts a, f is refused, g evicts b, c moves to 5.0, h evicts e, i evicts h
    assert levels == [1, 2, 2, 3, 2, 2, 2, 3, 3, 2]
    assert list(mixed._cache) == [b"d", b"g", b"c", b"i"]


# ---------------------------------------------------------------------------
# device intervals, the anchor, idle time
# ---------------------------------------------------------------------------

class FakeEvent:
    """A timing event on a device clock ``SKEW`` ns ahead of the host's,
    completing ``LAG`` ns after it is recorded."""

    SKEW, LAG = 5_000_000_000, 3_000
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns() + self.SKEW + self.LAG
        self.records = getattr(self, "records", 0) + 1

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) / 1e6


@pytest.fixture()
def fake_cuda(monkeypatch):
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    entered = []
    real = torch.autograd.profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(torch.autograd.profiler.record_function, "__enter__", counting)
    return entered


def _staged_record(traced: bool):
    rec = tracing.Record(1)
    rec.arm(traced, "cuda:0")
    with rec.span("execute"):
        with rec.stage("upload", defer=True) as up:
            time.sleep(0.002)
            up.begin()
            time.sleep(0.001)
        with rec.stage("score"):
            time.sleep(0.002)
        with rec.stage("rerank") as st:
            time.sleep(0.001)
            with st.host("gather"):
                time.sleep(0.002)
            time.sleep(0.001)
        with rec.stage("download", anchor=True):
            time.sleep(0.001)
    rec.read_device()
    return rec


def test_tracing_off_makes_no_event_and_enters_no_range(fake_cuda):
    rec = _staged_record(traced=False)
    assert FakeEvent.made == 0 and fake_cuda == [] and rec.dev is None
    assert rec.names == ["execute", "upload", "score", "rerank", "gather", "download"]
    rec = _staged_record(traced=True)
    assert FakeEvent.made == 10 and len(fake_cuda) == 6
    assert all(n.startswith(tracing.PREFIX) for n in fake_cuda)


def test_engine_with_tracing_off_enters_no_range(snapshot, model, fake_cuda):
    eng = _engine(snapshot, model, mode="tiered", profile_dtype="int8")
    _serve(eng, [1, 2, 3])
    assert fake_cuda == [] and FakeEvent.made == 0
    assert eng.stats()["trace"]["device_batches"] == 0 and eng.stats()["trace"]["batches"] >= 1
    on = _engine(snapshot, model, mode="tiered", profile_dtype="int8", metrics=True)
    _serve(on, [1, 2, 3])
    assert {f"{tracing.PREFIX}{n}" for n in ("wait", "batch", "coarse", "download")} <= \
        set(fake_cuda)
    t = on.stats()["trace"]
    assert t["device_batches"] == t["batches"] >= 1


def test_device_intervals_come_back_on_the_host_clock(fake_cuda):
    rec = _staged_record(traced=True)
    lag = FakeEvent.LAG
    names = rec.names
    # a start event's device time is its record time (plus the lag), an end
    # event's too; the anchor (download's end) maps every one back
    up = rec.dev[names.index("upload")]
    assert len(up) == 2 and rec.t0[names.index("upload")] + 2_000_000 <= up[0]
    rr = rec.dev[names.index("rerank")]
    g = names.index("gather")
    assert len(rr) == 4 and rr[1] <= rec.t0[g] and rec.t1[g] <= rr[2]
    for i, d in rec.dev.items():
        assert rec.t0[i] - 50_000 <= d[0] and d[-1] <= rec.t1[i] + 50_000, (names[i], d)
    dl = rec.dev[names.index("download")]
    assert abs(dl[1] - rec.t1[names.index("download")]) <= 50_000 + lag


def test_a_late_anchor_stamp_is_recorded_again(fake_cuda, monkeypatch):
    """A host stamp that lags the anchor's record call (the thread was
    preempted there) would shift the whole batch: the record is repeated
    until host clock reads bracket it tightly."""
    rec = tracing.Record(1)
    rec.arm(True, "cuda:0")
    with rec.stage("download", anchor=True):
        real, calls = time.perf_counter_ns, [0]

        def late():                          # the read after the first record lags 1 ms
            calls[0] += 1
            return real() + (1_000_000 if calls[0] == 2 else 0)

        monkeypatch.setattr(tracing, "now", late)
    monkeypatch.setattr(tracing, "now", real)
    ev, t = rec._anchor
    assert ev.records == 2 and calls[0] == 4
    rec.read_device()
    d0, d1 = rec.dev[0]
    assert abs(d1 - t) < 50_000 and d0 <= d1


def test_idle_time_goes_to_the_spans_that_cover_it():
    """Two hand-built batches: device busy [10, 20] and [40, 52] with a gap
    [44, 46] between stages; the host's deliver, wait, form and pin cover
    [20, 40]."""
    def record(rid, spans, dev):
        rec = tracing.Record(rid)
        for name, parent, t0, t1 in spans:
            i = len(rec.names)
            rec.names.append(name)
            rec.parents.append(parent)
            rec.t0.append(t0)
            rec.t1.append(t1)
        rec.dev = dev
        return rec

    a = record(1, [("wait", -1, 0, 2), ("form", -1, 2, 3), ("batch", -1, 3, 26),
                   ("execute", 2, 8, 21), ("upload", 3, 8, 11), ("score", 3, 11, 20),
                   ("download", 3, 20, 20), ("finalize", 2, 21, 26),
                   ("cache", 7, 22, 25), ("deliver", -1, 26, 31)],
               {4: [10, 11], 5: [11, 20], 6: [20, 20]})
    b = record(2, [("wait", -1, 31, 33), ("form", -1, 33, 34), ("batch", -1, 34, 60),
                   ("pin", 2, 34, 36), ("resolve", 2, 36, 38), ("execute", 2, 38, 55),
                   ("upload", 5, 38, 42), ("score", 5, 42, 44), ("rerank", 5, 44, 50),
                   ("gather", 8, 44, 46), ("download", 5, 50, 52)],
               {6: [40, 42], 7: [42, 44], 8: [44, 44, 46, 50], 10: [50, 52]})
    tr = tracing.Tracer()
    tr.fold(a, 0)
    tr.fold(b, 0)
    idle = tr.totals()["idle_ms"]
    # gap [20, 40]: execute 20-21, finalize 21-22 and 25-26, cache 22-25,
    # deliver 26-31, wait 31-33, form 33-34, pin 34-36, resolve 36-38,
    # upload 38-40 (before its first copy)
    ns = {k: round(v * 1e6) for k, v in idle.items()}
    assert ns == {"execute": 1, "finalize": 2, "cache": 3, "deliver": 5, "wait": 2,
                  "form": 1, "pin": 2, "resolve": 2, "upload": 2,
                  tracing.EXEC_IDLE: 2}
    dev = tr.totals()["device_ms"]
    assert round(dev["rerank"]["ms"] * 1e6) == 4 and dev["rerank"]["count"] == 1


# ---------------------------------------------------------------------------
# under torch.profiler
# ---------------------------------------------------------------------------

def test_tracer_reads_on_inside_a_running_profiler(snapshot, model):
    assert not tracing.profiling()
    seen = {}

    def probe():
        seen["on"] = tracing.profiling()

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert tracing.profiling()
        th = threading.Thread(target=probe)
        th.start()
        th.join()
    assert seen["on"] and not tracing.profiling()
    eng = _engine(snapshot, model, mode="full")          # metrics off
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _serve(eng, [1, 2, 3])
    n_on = eng.stats()["trace"]["batches"]
    _serve(eng, [4, 5, 6])
    t = eng.stats()["trace"]
    assert t["batches"] > n_on >= 1 and t["device_batches"] == n_on
    assert [r["traced"] for r in eng.trace_records()] == \
        [True] * n_on + [False] * (t["batches"] - n_on)


def test_scheduler_ranges_land_in_an_all_threads_profile(snapshot, model):
    from torch._C._profiler import _ExperimentalConfig
    eng = _engine(snapshot, model, mode="full")
    cfg = _ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                experimental_config=cfg) as prof:
        _serve(eng, [1, 2, 3], rounds=2)
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(tracing.PREFIX)]
    rec = eng.trace_records()[-1]                        # the second, warm batch
    by_name = {}
    for e in events:
        by_name.setdefault(e.name()[len(tracing.PREFIX):], []).append(int(e.start_ns()))
    checked = 0
    for s in rec["spans"]:
        starts = by_name.get(s["name"], [])
        assert starts, f"no range for {s['name']}"
        assert min(abs(t - s["t0_ns"]) for t in starts) < 1_000_000, s["name"]
        checked += 1
    assert checked >= len(SCHEDULER_SPANS) + len(ENGINE_PHASES)
