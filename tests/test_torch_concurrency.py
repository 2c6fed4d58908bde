"""The port's MVCC catalog runtime, restating tests/test_concurrency.py:
CAS multi-writer manifest, writer lease, follower replication, background
compaction, snapshot-pinned serving and the scheduler racing refreshes.
Every store profiles and signs on the host (``device="cpu"``)."""
import os
import threading

import numpy as np
import pytest

from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake
from repro_torch.core.predictor import train_quality_model
from repro_torch.service import (BackgroundCompactor, CatalogReader,
                                 DiscoveryEngine, DiscoveryRequest, EngineConfig,
                                 LeaseHeldError, WriterLease)
from repro_torch.service import catalog as port_catalog
from repro_torch.service.catalog import read_latest_manifest, read_manifest_version

from _torch_service import cols as _cols
from _torch_service import tiny_model as _tiny_model


class CatalogStore(port_catalog.CatalogStore):
    """The port's store, profiling and signing on the host."""

    def __init__(self, root, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(root, **kw)


def _from_catalog(store, model, config):
    return DiscoveryEngine.from_catalog(store, model, config, device="cpu")


@pytest.fixture(scope="module")
def model():
    lake = generate_lake(LakeSpec(n_domains=8, n_tables=12, row_budget=512,
                                  rows_log_mean=5.5, seed=3))
    return train_quality_model([lake], GBDTConfig(n_trees=20, depth=4),
                               n_query=48, device="cpu")


# ---------------------------------------------------------------------------
# CAS primitive + deterministic race
# ---------------------------------------------------------------------------

def test_cas_publish_rejects_taken_version(tmp_path):
    """The low-level CAS: version v+1 can be created exactly once."""
    a = CatalogStore(str(tmp_path), n_perm=64)
    b = CatalogStore(str(tmp_path))
    m = dict(a.manifest, version=a.version + 1)
    assert b._publish(dict(b.manifest, version=b.version + 1))
    assert not a._publish(m)               # same version: a lost the race
    assert read_latest_manifest(str(tmp_path))["version"] == 1


def test_add_table_retries_lost_cas(tmp_path, monkeypatch):
    """Deterministic writer race: B publishes between A's manifest read and
    A's publish; A must retry against the new head — both tables land,
    neither segment is lost, and the version advances by exactly two."""
    a = CatalogStore(str(tmp_path), n_perm=64)
    b = CatalogStore(str(tmp_path))

    real_publish = port_catalog.CatalogStore._publish
    fired = []

    def racing_publish(self, m):
        if self is a and not fired:
            fired.append(True)
            b.add_table("from_b", _cols("b"))      # sneaks in ahead of A
        return real_publish(self, m)

    monkeypatch.setattr(port_catalog.CatalogStore, "_publish", racing_publish)
    tid_a = a.add_table("from_a", _cols("a"))

    assert a.stats["cas_retries"] >= 1
    head = read_latest_manifest(str(tmp_path))
    assert head["version"] == 2
    assert set(head["tables"]) == {"from_a", "from_b"}
    assert len(head["segments"]) == 2
    # tids are unique even though both writers started from tid 0
    assert sorted(head["tables"].values()) == [0, 1]
    assert tid_a == head["tables"]["from_a"]
    snap = a.snapshot()
    assert snap.n_columns == 2


def test_two_writers_race_stress(tmp_path):
    """ISSUE acceptance: two concurrent writers both land every segment and
    the manifest version advances monotonically (strictly +1 per publish,
    no gaps, no lost updates)."""
    root = str(tmp_path)
    CatalogStore(root, n_perm=64)          # create v0
    n_each = 6
    barrier = threading.Barrier(2)
    errors = []

    def writer(tag):
        try:
            store = CatalogStore(root)     # its own handle, like a worker
            barrier.wait()
            for i in range(n_each):
                store.add_table(f"{tag}{i}", _cols(f"{tag}{i}"))
        except Exception as e:             # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors

    head = read_latest_manifest(root)
    assert head["version"] == 2 * n_each   # one CAS advance per add
    assert len(head["tables"]) == 2 * n_each
    assert len(head["segments"]) == 2 * n_each
    assert sorted(head["tables"].values()) == list(range(2 * n_each))
    # every intermediate version is present on disk, in order
    versions = [read_manifest_version(root, v)["version"]
                for v in range(2 * n_each + 1)]
    assert versions == list(range(2 * n_each + 1))
    # no orphaned segment directories
    segs = {d for d in os.listdir(root) if d.startswith("seg-")}
    assert segs == set(head["segments"])
    assert CatalogStore(root).snapshot().n_columns == 2 * n_each


def test_duplicate_name_race_cleans_orphan(tmp_path, monkeypatch):
    """A writer that loses the race to the same table name raises and
    removes its orphaned segment directory."""
    a = CatalogStore(str(tmp_path), n_perm=64)
    b = CatalogStore(str(tmp_path))

    real_publish = port_catalog.CatalogStore._publish
    fired = []

    def racing_publish(self, m):
        if self is a and not fired:
            fired.append(True)
            b.add_table("dup", _cols("b"))
        return real_publish(self, m)

    monkeypatch.setattr(port_catalog.CatalogStore, "_publish", racing_publish)
    with pytest.raises(ValueError, match="already in catalog"):
        a.add_table("dup", _cols("a"))
    head = read_latest_manifest(str(tmp_path))
    segs = {d for d in os.listdir(str(tmp_path)) if d.startswith("seg-")}
    assert segs == set(head["segments"])   # A's orphan was removed


# ---------------------------------------------------------------------------
# writer lease
# ---------------------------------------------------------------------------

def test_writer_lease_mutual_exclusion_and_expiry(tmp_path, fake_clock):
    """Expiry under an injected clock: the old version faked expiry with
    ``ttl_s=-1`` (a lease born dead); here a *valid* lease genuinely ages
    past its TTL when the clock advances — no wall-clock wait, and the
    pre-expiry exclusion check exercises the real code path."""
    root = str(tmp_path)
    os.makedirs(root, exist_ok=True)
    a = WriterLease(root, owner="a", ttl_s=60, clock=fake_clock).acquire()
    with pytest.raises(LeaseHeldError):
        WriterLease(root, owner="b", ttl_s=60, clock=fake_clock).acquire()
    fake_clock.advance(59)                 # aged but still live: still held
    with pytest.raises(LeaseHeldError):
        WriterLease(root, owner="b", ttl_s=60, clock=fake_clock).acquire()
    fake_clock.advance(2)                  # now past a's 60 s TTL
    c = WriterLease(root, owner="c", ttl_s=60,
                    clock=fake_clock).acquire()    # steals expired
    a.release()                            # stale token: must not unlink c's
    with pytest.raises(LeaseHeldError):
        WriterLease(root, owner="b", ttl_s=60, clock=fake_clock).acquire()
    c.release()
    d = WriterLease(root, owner="d", ttl_s=60, clock=fake_clock)
    with d:
        assert d._held
    assert not os.path.exists(d.path)


def test_compact_requires_free_lease(tmp_path):
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    held = WriterLease(str(tmp_path), owner="other", ttl_s=60).acquire()
    try:
        with pytest.raises(LeaseHeldError):
            store.compact()
    finally:
        held.release()
    store.compact()                        # released lease: proceeds
    assert len(store.manifest["segments"]) == 1


# ---------------------------------------------------------------------------
# follower replication
# ---------------------------------------------------------------------------

def test_follower_observes_versions_in_order(tmp_path):
    root = str(tmp_path)
    store = CatalogStore(root, n_perm=64)
    reader = CatalogReader(root)
    assert reader.version == 0 and reader.poll() == []

    store.add_table("t0", _cols("t0"))
    store.add_table("t1", _cols("t1"))
    assert reader.poll() == [1, 2]         # both versions, in order
    store.drop_table("t0")
    assert reader.poll() == [3]
    assert reader.version == 3

    snap2 = reader.snapshot(2)             # pinned historical version
    snap3 = reader.snapshot()
    assert snap2.version == 2 and snap2.n_columns == 2
    assert snap3.version == 3 and snap3.n_columns == 1
    # snapshots are immutable: compaction deletes old segments, but the
    # materialized pinned snapshot keeps serving
    store.compact()
    assert snap2.n_columns == 2
    assert reader.poll() == [4]
    assert reader.snapshot(4).n_columns == 1


def test_follower_sees_both_racing_writers(tmp_path):
    root = str(tmp_path)
    CatalogStore(root, n_perm=64)
    reader = CatalogReader(root)
    barrier = threading.Barrier(2)

    def writer(tag):
        store = CatalogStore(root)
        barrier.wait()
        for i in range(4):
            store.add_table(f"{tag}{i}", _cols(f"{tag}{i}"))

    threads = [threading.Thread(target=writer, args=(t,)) for t in "ab"]
    observed = []
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        observed.extend(reader.poll())
    for t in threads:
        t.join()
    observed.extend(reader.poll())
    assert observed == list(range(1, 9))   # every version, strictly in order


# ---------------------------------------------------------------------------
# compaction: replay, background scheduling, pinned serving
# ---------------------------------------------------------------------------

def test_compaction_replays_concurrent_writes(tmp_path):
    """Adds and drops landing between the compactor's pin and its publish
    survive the swap via manifest replay."""
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("old0", _cols("old0"))
    store.add_table("old1", _cols("old1"))
    store.drop_table("old1")

    other = CatalogStore(str(tmp_path))

    def concurrent_writes():               # runs after build, before publish
        other.add_table("during", _cols("during"))
        other.drop_table("old0")           # tombstone laid after the pin

    store.compact(on_built=concurrent_writes)

    head = read_latest_manifest(str(tmp_path))
    assert set(head["tables"]) == {"during"}
    assert len(head["segments"]) == 2      # compacted + the concurrent delta
    # old0's columns live inside the compacted segment but stay tombstoned
    snap = store.snapshot()
    assert snap.n_columns == 1
    assert snap.names == ["during_x"]
    # the next compaction clears the replayed tombstone too
    store.compact()
    assert read_latest_manifest(str(tmp_path))["dropped_ids"] == []
    assert store.snapshot().names == ["during_x"]


def test_resign_compaction_restarts_over_concurrent_add(tmp_path):
    """A geometry change cannot replay segments signed with the old
    geometry — it rebuilds from the new head instead (and converges)."""
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    other = CatalogStore(str(tmp_path))
    fired = []

    def add_once():
        if not fired:
            fired.append(True)
            other.add_table("mid", _cols("mid"))

    store.compact(n_perm=128, on_built=add_once)
    snap = store.snapshot()
    assert store.n_perm == 128
    assert snap.signatures.shape == (2, 128)     # BOTH tables re-signed
    assert set(store.tables()) == {"t0", "mid"}
    assert len(store.manifest["segments"]) == 1  # second pass absorbed mid


def test_background_compactor_serves_during_compaction(tmp_path, model):
    """ISSUE acceptance: queries during an in-flight compact() are
    identical to the pinned pre-compaction snapshot — no torn reads."""
    store = CatalogStore(str(tmp_path), n_perm=64)
    for i in range(6):
        store.add_table(f"t{i}", [(f"c{i}", [f"v{j}" for j in range(30 + i)]),
                                  (f"d{i}", [f"w{j % 7}" for j in range(25)])])
    engine = _from_catalog(store, model,
                                          EngineConfig(k=5, mode="full"))
    reqs = [DiscoveryRequest(name=f"q{i}", column_id=i) for i in range(8)]
    baseline = [[(m.column_id, m.score) for m in r.matches]
                for r in engine.query_batch(reqs)]
    v0 = engine.version

    built = threading.Event()
    release = threading.Event()

    def hold():
        built.set()
        assert release.wait(timeout=30)

    with BackgroundCompactor(store) as compactor:
        fut = compactor.submit(on_built=hold)
        assert built.wait(timeout=30)      # compaction is now in flight
        assert compactor.busy
        during = [[(m.column_id, m.score) for m in r.matches]
                  for r in engine.query_batch(reqs)]
        assert during == baseline          # pinned snapshot: bit-identical
        assert engine.version == v0
        release.set()
        fut.result(timeout=30)

    assert len(store.manifest["segments"]) == 1
    # the engine still serves its pinned pre-compaction snapshot (the old
    # segments are deleted, but the materialized snapshot is immutable)...
    after = [[(m.column_id, m.score) for m in r.matches]
             for r in engine.query_batch(reqs)]
    assert after == baseline and engine.version == v0
    # ...and refreshing onto the post-compaction version keeps the results
    # (compaction must not change what is served, only the layout)
    engine.refresh(store.snapshot())
    assert engine.version > v0
    refreshed = [[(m.column_id, m.score) for m in r.matches]
                 for r in engine.query_batch(reqs)]
    assert refreshed == baseline


def test_racing_compactors_never_duplicate_columns(tmp_path, monkeypatch):
    """Two compactors racing over the same pinned segments (possible when
    the advisory lease fails) must not publish overlapping merges — the
    loser detects its inputs were swapped out and rebuilds from the head."""
    root = str(tmp_path)
    a = CatalogStore(root, n_perm=64)
    a.add_table("t0", _cols("t0"))
    a.add_table("t1", _cols("t1"))
    b = CatalogStore(root)
    # disable lease exclusion so both compactors run "concurrently"
    def fake_acquire(self):
        self._held = True
        return self

    monkeypatch.setattr(WriterLease, "acquire", fake_acquire)
    monkeypatch.setattr(WriterLease, "renew", lambda self: None)
    monkeypatch.setattr(WriterLease, "release", lambda self: None)

    fired = []

    def a_compacts_first():                # fires after B built, pre-publish
        if not fired:
            fired.append(True)
            a.compact()                    # A swaps the same two segments

    b.compact(on_built=a_compacts_first)
    snap = CatalogStore(root).snapshot()
    assert snap.n_columns == 2             # NOT 4: no duplicated columns
    assert sorted(snap.names) == ["t0_x", "t1_x"]
    assert len(read_latest_manifest(root)["segments"]) == 1


def test_reader_snapshot_survives_compaction_race(tmp_path, monkeypatch):
    """A compaction that publishes and deletes segments between the
    reader's poll and its materialize must not crash the latest-snapshot
    path (the follower retries at the new head)."""
    cat = port_catalog
    root = str(tmp_path)
    store = CatalogStore(root, n_perm=64)
    store.add_table("t0", _cols("t0"))
    store.add_table("t1", _cols("t1"))
    reader = CatalogReader(root)

    real = cat.materialize_snapshot
    fired = []

    def racing(root_, manifest, **kw):
        if not fired:                      # compaction lands mid-materialize
            fired.append(True)
            store.compact()
        return real(root_, manifest, **kw)

    monkeypatch.setattr(cat, "materialize_snapshot", racing)
    snap = reader.snapshot()               # must retry at the head, not die
    assert snap.version == store.version
    assert snap.n_columns == 2
    # an EXPLICITLY pinned version whose segments are gone raises clearly
    with pytest.raises(KeyError, match="compacted away"):
        reader.snapshot(1)


def test_compact_renews_lease_during_build(tmp_path, monkeypatch):
    """Long builds renew the lease (per merged segment / re-sign chunk) so
    mutual exclusion outlives ttl_s."""
    renews = []
    real_renew = WriterLease.renew
    monkeypatch.setattr(WriterLease, "renew",
                        lambda self: (renews.append(1), real_renew(self))[1])
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    store.add_table("t1", _cols("t1"))
    store.compact(n_perm=128, resign_chunk=1)
    assert len(renews) >= 4                # 2 segments + 2 chunks + final


def test_maybe_compact_counts_other_handles_segments(tmp_path):
    """The threshold must see deltas appended through OTHER store handles
    (each ingest worker has its own), not this handle's stale view."""
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    other = CatalogStore(str(tmp_path))
    for i in range(3):
        other.add_table(f"o{i}", _cols(f"o{i}"))
    with BackgroundCompactor(store, min_segments=4) as compactor:
        fut = compactor.maybe_compact()
        assert fut is not None             # 4 segments live at the head
        fut.result(timeout=30)
    assert len(read_latest_manifest(str(tmp_path))["segments"]) == 1


def test_background_compactor_coalesces_and_thresholds(tmp_path):
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    with BackgroundCompactor(store, min_segments=3) as compactor:
        assert compactor.maybe_compact() is None       # below threshold
        store.add_table("t1", _cols("t1"))
        store.add_table("t2", _cols("t2"))
        gate = threading.Event()
        f1 = compactor.submit(on_built=lambda: gate.wait(timeout=30))
        f2 = compactor.submit()                        # coalesces onto f1
        assert f1 is f2
        gate.set()
        f1.result(timeout=30)
    assert len(store.manifest["segments"]) == 1


# ---------------------------------------------------------------------------
# engine MVCC: version pinning, follow mode, cache namespacing
# ---------------------------------------------------------------------------

def test_engine_follow_picks_up_new_versions(tmp_path, model):
    """Follower engine: a post-add_table query must see the new version —
    the version-namespaced cache makes a stale hit impossible even though
    the request hashes identically."""
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("base", [("ids", [f"v{i}" for i in range(200)])])
    engine = _from_catalog(store, model,
                                          EngineConfig(k=5, mode="full"))
    engine.follow(CatalogReader(str(tmp_path)))

    req = DiscoveryRequest(name="q", column_id=0)
    r1 = engine.query(req)                 # miss; admitted under version v1
    assert engine.query(req).cached        # hit within the same version
    assert r1.matches == []                # nothing else in the lake yet

    store.add_table("joinable", [("ids2", [f"v{i}" for i in range(100, 300)])])
    r2 = engine.query(req)                 # follower refreshes -> new cache
    assert not r2.cached                   # namespace: stale hit impossible
    assert engine.version == store.version
    assert [m.column for m in r2.matches] == ["ids2"]
    s = engine.stats()["snapshot"]
    assert s["version"] == store.version and s["refreshes"] >= 2


def test_engine_retires_old_versions_by_refcount(tmp_path, model):
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    engine = _from_catalog(store, model,
                                          EngineConfig(k=3, mode="full"))
    st0 = engine._pin()                    # an in-flight batch's pin
    store.add_table("t1", _cols("t1"))
    engine.refresh(store.snapshot())
    assert not st0.executor.closed         # still pinned: must stay usable
    assert engine.stats()["snapshot"]["live_states"] == 2
    engine._release(st0)                   # last unpin retires the version
    assert st0.executor.closed
    assert engine.stats()["snapshot"]["live_states"] == 1
    with pytest.raises(RuntimeError, match="closed"):
        st0.executor.execute(engine.planner.plan(n_columns=1, mode="full"),
                             np.zeros((1, engine._z_np.shape[1]), np.float32),
                             np.zeros((1, engine._w_np.shape[1]), np.uint32),
                             np.full((1,), -1, np.int32),
                             np.full((1,), -1, np.int32))


def test_engine_empty_catalog_still_answers(tmp_path):
    store = CatalogStore(str(tmp_path), n_perm=64)
    engine = DiscoveryEngine(store.snapshot(), _tiny_model(), device="cpu")
    r = engine.query(DiscoveryRequest(values=["a", "b"]))
    assert r.matches == []


def test_scheduler_submitters_race_catalog_refresh(tmp_path, model):
    """Concurrent submitters drive the continuous-batching scheduler while
    a writer publishes new versions and the engine refreshes onto them:
    every future resolves to its own request's response, no batch is torn
    by a swap, and the engine retires old versions cleanly."""
    from repro_torch.service import RequestScheduler, SchedulerConfig

    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("base0", _cols("base0"))
    store.add_table("base1", _cols("base1"))
    engine = _from_catalog(
        store, model, EngineConfig(k=3, mode="full", cache_entries=0))
    n0 = engine.n_columns
    errors: list[Exception] = []
    results: list[tuple[str, object]] = []
    start = threading.Barrier(3)

    def submitter(tag, scheduler):
        try:
            start.wait()
            futs = []
            for i in range(24):
                name = f"{tag}{i}"
                futs.append((name, scheduler.submit(
                    DiscoveryRequest(name=name, column_id=i % n0))))
            results.extend(futs)
        except Exception as e:              # pragma: no cover
            errors.append(e)

    def refresher():
        try:
            start.wait()
            for i in range(4):
                store.add_table(f"extra{i}", _cols(f"extra{i}"))
                engine.refresh(store.snapshot())
        except Exception as e:              # pragma: no cover
            errors.append(e)

    with RequestScheduler(engine,
                          SchedulerConfig(max_wait_ms=0.5)) as scheduler:
        threads = [threading.Thread(target=submitter,
                                    args=(t, scheduler)) for t in "ab"]
        threads.append(threading.Thread(target=refresher))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for name, fut in results:
            r = fut.result(timeout=60)
            assert r.name == name           # futures never cross wires
    s = engine.stats()
    assert s["queries"] >= 48
    assert s["snapshot"]["refreshes"] >= 5  # initial + 4 concurrent swaps
    assert s["snapshot"]["live_states"] == 1    # retired states released
    assert s["scheduler"]["completed"] == 48


def test_reader_poll_stat_cache_fast_path(tmp_path):
    """Idle polls are a single pointer stat (no JSON read); a publish
    moves the pointer and the next poll goes deep and observes it."""
    root = str(tmp_path)
    store = CatalogStore(root, n_perm=64)
    reader = CatalogReader(root)
    for _ in range(6):
        assert reader.poll() == []
    assert reader.stats["fast_polls"] >= 5
    assert reader.stats["deep_polls"] <= 1

    store.add_table("t0", _cols("t0"))
    assert reader.poll() == [1]            # pointer moved -> deep probe
    deep_after_add = reader.stats["deep_polls"]
    assert deep_after_add >= 1
    assert reader.poll() == []             # idle again: back on the stat
    assert reader.stats["fast_polls"] >= 6

    # the hint is best-effort: even with the pointer frozen (crashed
    # writer), the periodic deep probe still observes the new version
    lazy = CatalogReader(root, deep_poll_every=3)
    real_stat = lazy._stat_pointer()
    lazy._stat_pointer = lambda: real_stat
    store.add_table("t1", _cols("t1"))
    observed = []
    for _ in range(3):
        observed.extend(lazy.poll())
    assert observed == [2]


def test_compact_retention_window_keeps_recent_versions(tmp_path):
    """compact(retain_versions=N) defers deletion of replaced segments so
    the last N manifest versions stay materializable; a later compaction
    GCs segments past the window."""
    root = str(tmp_path)
    store = CatalogStore(root, n_perm=64)
    store.add_table("t0", _cols("t0"))     # v1
    store.add_table("t1", _cols("t1"))     # v2
    segs_v2 = set(store.manifest["segments"])

    store.compact(retain_versions=2)       # v3: replaced segments retained
    for s in segs_v2:
        assert os.path.isdir(os.path.join(root, s))
    assert store.manifest["retired"] == [[3, s] for s in sorted(segs_v2)] \
        or {s for _, s in store.manifest["retired"]} == segs_v2
    # a FRESH follower can still materialize the pre-compaction version
    assert CatalogReader(root).snapshot(2).n_columns == 2

    store.add_table("t2", _cols("t2"))     # v4
    store.add_table("t3", _cols("t3"))     # v5
    store.compact(retain_versions=2)       # v6: v3's retirees are past the
    for s in segs_v2:                      # window -> deleted
        assert not os.path.exists(os.path.join(root, s))
    with pytest.raises(KeyError, match="compacted away"):
        CatalogReader(root).snapshot(2)
    # versions inside the window stay readable
    assert CatalogReader(root).snapshot(5).n_columns == 4
    assert CatalogReader(root).snapshot(6).n_columns == 4

    # retain_versions=0 (default) purges any remaining window
    store.compact()
    assert store.manifest["retired"] == []
    segs = [d for d in os.listdir(root) if d.startswith("seg-")]
    assert len(segs) == 1


def test_legacy_single_manifest_catalog_upgrades(tmp_path):
    """A pre-CAS catalog (pointer file only, no chain) opens, serves, and
    joins the chain on the first write."""
    import json
    store = CatalogStore(str(tmp_path), n_perm=64)
    store.add_table("t0", _cols("t0"))
    # strip the chain + lease: what a PR-1-era catalog directory held
    for f in os.listdir(str(tmp_path)):
        if f.startswith("MANIFEST-") or f == "LEASE.json":
            os.unlink(os.path.join(str(tmp_path), f))
    with open(os.path.join(str(tmp_path), "MANIFEST.json")) as f:
        assert json.load(f)["version"] == 1

    reopened = CatalogStore(str(tmp_path))
    assert reopened.version == 1
    assert reopened.snapshot().n_columns == 1
    reader = CatalogReader(str(tmp_path))
    reopened.add_table("t1", _cols("t1"))
    assert reader.poll() == [2]
    assert reader.snapshot(2).n_columns == 2
