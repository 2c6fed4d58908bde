"""The port's engine-replica fleet: tests/test_fleet.py restated on the
port (lifecycle, fault injection, routing invariants) over host engines
(``device="cpu"``), then held against the JAX package: the router's choices
on the same replica states, both fleets' answers over one catalog directory,
``make_replica_devices`` against ``make_replica_meshes``, and ``discover
--replicas 2`` against the JAX entry point. A two-replica fleet on the card
is ``gpu``-marked."""
import re
import sys
import threading
import time
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.launch import discover as jax_discover
from repro.launch.mesh import make_replica_meshes
from repro.service import CatalogStore as JCatalogStore
from repro.service import DiscoveryRequest as JDiscoveryRequest
from repro.service import EngineConfig as JEngineConfig
from repro.service import EngineFleet as JEngineFleet
from repro.service import FleetConfig as JFleetConfig
from repro.service import FleetRouter as JFleetRouter
from repro.service import ReplicaSnapshot as JReplicaSnapshot
from repro.service import RequestScheduler as JRequestScheduler
from repro.service import SchedulerConfig as JSchedulerConfig
from repro.service import add_lake as jadd_lake
from repro_torch.core import lakegen
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.predictor import train_quality_model
from repro_torch.kernels import _build
from repro_torch.launch import discover as port_discover
from repro_torch.launch.mesh import make_replica_devices
from repro_torch.launch.mesh import make_replica_meshes as port_replica_meshes
from repro_torch.service import (ColumnCatalog, DiscoveryRequest, EngineConfig,
                                 EngineFleet, EventBus, FaultInjector,
                                 FleetConfig, FleetRouter, ReplicaSnapshot,
                                 RequestScheduler, SchedulerConfig,
                                 SchedulerOverloadError)
from repro_torch.service import engine as port_engine
from repro_torch.service.fleet import DRAINING, EVICTED, SERVING, WARMING, _FleetBatch
from repro_torch.service.scheduler import _Item

from _torch_service import assert_same_responses, model_pair
from _torch_service import tiny_model as _tiny_model

CPU = torch.device("cpu")


def DiscoveryEngine(snapshot, model, config, **kw):
    return port_engine.DiscoveryEngine(snapshot, model, config, device="cpu", **kw)


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("fleet_catalog"))
    cat = ColumnCatalog(root, n_perm=64, device="cpu")
    for t in range(4):
        cat.add_table(f"t{t}",
                      [(f"c{t}a", [f"v{t}_{i}" for i in range(60)]),
                       (f"c{t}b", [f"w{i % 11}" for i in range(40)])])
    return cat.snapshot()


MODEL = _tiny_model()


def _make_fleet(snapshot, n=2, injector=None, bus=None, **cfg):
    engines = [DiscoveryEngine(snapshot, MODEL,
                               EngineConfig(k=3, mode="full",
                                            cache_entries=0), events=bus)
               for _ in range(n)]
    cfg.setdefault("health_interval_s", 0.05)
    return EngineFleet(engines, FleetConfig(**cfg), events=bus,
                       injector=injector)


def _reqs(prefix, n):
    return [DiscoveryRequest(name=f"{prefix}{i}", column_id=i % 8)
            for i in range(n)]


def _wait_until(pred, timeout=20.0):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.01)


def _assert_pins_released(replica):
    """The eviction contract: engine closed, head refcount zero, its
    executor closed, and no other live version remains."""
    eng = replica.engine
    assert eng.closed
    _wait_until(lambda: eng._head.refs == 0)
    assert eng._head.executor.closed
    assert not eng._live


class _Gate:
    """Stall one replica engine's batch path under test control."""

    def __init__(self, engine):
        self.release = threading.Event()
        self.entered = threading.Event()
        real = engine.query_batch

        def wrapped(reqs, **kw):
            self.entered.set()
            assert self.release.wait(30)
            return real(reqs, **kw)

        engine.query_batch = wrapped


# ---------------------------------------------------------------------------
# lifecycle + serving
# ---------------------------------------------------------------------------

def test_fleet_serves_through_scheduler_with_parity(snapshot):
    direct = DiscoveryEngine(snapshot, MODEL,
                             EngineConfig(k=3, mode="full", cache_entries=0))
    baseline = {r.name: r for r in direct.query_batch(_reqs("q", 12))}
    fleet = _make_fleet(snapshot, n=2)
    try:
        with RequestScheduler(fleet, SchedulerConfig(max_wait_ms=1.0)) as sch:
            futs = [sch.submit(r) for r in _reqs("q", 12)]
            outs = [f.result(timeout=60) for f in futs]
        for r in outs:
            want = baseline[r.name]
            assert [m.column_id for m in r.matches] == \
                [m.column_id for m in want.matches]
            assert r.queue_ms >= 0.0 and r.compute_ms > 0.0
            assert r.latency_ms == pytest.approx(r.queue_ms + r.compute_ms)
        st_ = fleet.stats()
        assert st_["completed"] == 12
        assert st_["scheduler"]["completed"] == 12
        assert st_["scheduler"]["failed"] == 0
        assert all(v["state"] == SERVING for v in st_["replicas"].values())
    finally:
        fleet.close()
    # close() retires every replica and releases every pinned snapshot
    for r in fleet.replicas:
        assert r.state == EVICTED
        _assert_pins_released(r)


def test_fleet_query_batch_direct_no_scheduler(snapshot):
    fleet = _make_fleet(snapshot, n=2)
    try:
        outs = fleet.query_batch(_reqs("d", 5), timeout=60)
        assert [r.name for r in outs] == [f"d{i}" for i in range(5)]
    finally:
        fleet.close()


def test_replica_state_events_on_shared_bus(snapshot):
    bus = EventBus(capacity=512)
    cur = bus.subscribe("test")
    fleet = _make_fleet(snapshot, n=2, bus=bus)
    try:
        _wait_until(lambda: all(r.state == SERVING for r in fleet.replicas))
        fleet.query_batch(_reqs("e", 3), timeout=60)
    finally:
        fleet.close()
    evs = cur.poll()
    flips = [e.payload for e in evs if e.type == "replica_state"]
    assert sum(1 for p in flips if p["state"] == SERVING) == 2
    assert sum(1 for p in flips if p["state"] == EVICTED) == 2
    routed = [e for e in evs if e.type == "batch_routed"]
    assert routed and all("replica" in e.payload for e in routed)


def test_drain_lifecycle_releases_engine_and_traffic_moves(snapshot):
    fleet = _make_fleet(snapshot, n=2)
    try:
        fleet.query_batch(_reqs("w", 2), timeout=60)
        fleet.drain_replica(0)
        _wait_until(lambda: fleet.replicas[0].state == EVICTED)
        _assert_pins_released(fleet.replicas[0])
        served_before = fleet.replicas[1].batches_served
        outs = fleet.query_batch(_reqs("x", 3), timeout=60)
        assert len(outs) == 3
        assert fleet.replicas[1].batches_served == served_before + 1
        assert fleet.replicas[0].batches_served <= 1  # nothing post-drain
    finally:
        fleet.close()


def test_install_buckets_propagates_to_every_replica(snapshot):
    fleet = _make_fleet(snapshot, n=3)
    try:
        with RequestScheduler(fleet,
                              SchedulerConfig(max_wait_ms=0.0,
                                              batch_buckets=(4, 8))):
            assert fleet.batch_buckets == (4, 8)
            for r in fleet.replicas:
                assert r.engine.batch_buckets == (4, 8)
                assert r.engine.planner.config.batch_buckets == (4, 8)
    finally:
        fleet.close()


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

def test_kill_mid_batch_redispatches_everything(snapshot):
    inj = FaultInjector()
    inj.arm("mid_batch", mode="kill")
    fleet = _make_fleet(snapshot, n=2, injector=inj)
    try:
        with RequestScheduler(fleet, SchedulerConfig(max_wait_ms=1.0)) as sch:
            futs = [sch.submit(r) for r in _reqs("k", 10)]
            outs = [f.result(timeout=60) for f in futs]   # ALL resolve
        assert [r.name for r in outs] == [f"k{i}" for i in range(10)]
        st_ = fleet.stats()
        assert st_["evictions"] == 1 and st_["redispatches"] >= 1
        # no batch silently dropped: every submission is accounted for
        assert st_["scheduler"]["completed"] == 10
        assert st_["scheduler"]["failed"] == 0
        killed = [r for r in fleet.replicas if r.state == EVICTED]
        assert len(killed) == 1
        _assert_pins_released(killed[0])
        assert inj.fired and inj.fired[0][2] == "kill"
    finally:
        fleet.close()


def test_kill_mid_warmup_survivor_serves(snapshot):
    inj = FaultInjector()
    inj.arm("mid_warmup", replica=0, mode="kill")
    fleet = _make_fleet(snapshot, n=2, injector=inj)
    try:
        _wait_until(lambda: fleet.replicas[0].state == EVICTED)
        _assert_pins_released(fleet.replicas[0])
        outs = fleet.query_batch(_reqs("s", 4), timeout=60)
        assert len(outs) == 4
        assert fleet.replicas[1].state == SERVING
        assert fleet.warm_event.is_set()
    finally:
        fleet.close()


def test_hang_mid_batch_health_evicts_and_redispatches(snapshot):
    inj = FaultInjector()
    inj.arm("mid_batch", mode="hang")
    fleet = _make_fleet(snapshot, n=2, injector=inj,
                        health_interval_s=0.05, hang_timeout_s=0.25)
    try:
        with RequestScheduler(fleet, SchedulerConfig(max_wait_ms=1.0)) as sch:
            futs = [sch.submit(r) for r in _reqs("h", 8)]
            outs = [f.result(timeout=60) for f in futs]   # ALL resolve
        assert len(outs) == 8
        st_ = fleet.stats()
        assert st_["evictions"] == 1 and st_["redispatches"] >= 1
        hung = [r for r in fleet.replicas if r.state == EVICTED][0]
        assert hung.engine.closed
    finally:
        inj.release_hangs()               # let the hung worker exit
        fleet.close()
    # the un-hung worker finds its engine closed and exits without
    # corrupting anything; its pin count still returns to zero
    _assert_pins_released([r for r in fleet.replicas
                           if r.batches_served == 0][0])


def test_hang_mid_warmup_evicted_by_health_check(snapshot):
    inj = FaultInjector()
    inj.arm("mid_warmup", replica=0, mode="hang")
    fleet = _make_fleet(snapshot, n=2, injector=inj,
                        health_interval_s=0.05, hang_timeout_s=10.0,
                        warmup_timeout_s=0.25)
    try:
        _wait_until(lambda: fleet.replicas[0].state == EVICTED)
        outs = fleet.query_batch(_reqs("wh", 3), timeout=60)
        assert len(outs) == 3
    finally:
        inj.release_hangs()
        fleet.close()


def test_kill_mid_drain_redispatches_queued_batch(snapshot):
    inj = FaultInjector()
    inj.arm("mid_drain", replica=0, mode="kill")
    fleet = _make_fleet(snapshot, n=2, injector=inj)
    try:
        _wait_until(lambda: all(r.state == SERVING for r in fleet.replicas))
        gate = _Gate(fleet.replicas[0].engine)

        def item(name):
            return _Item(request=DiscoveryRequest(name=name, column_id=0),
                         future=Future(), t_submit=time.perf_counter(),
                         deadline=None, trace_id=name)

        # stage directly on replica 0 (bypassing the router) so a batch
        # is QUEUED behind the gated in-flight one when the drain begins
        b1, b2 = _FleetBatch([item("b1")]), _FleetBatch([item("b2")])
        assert fleet.replicas[0].enqueue(b1)
        assert gate.entered.wait(30)
        assert fleet.replicas[0].enqueue(b2)
        fleet.drain_replica(0)
        gate.release.set()
        # b1 finishes on replica 0; b2 hits mid_drain -> kill -> the
        # fleet re-dispatches it to the surviving replica
        assert b1.items[0].future.result(timeout=60).name == "b1"
        assert b2.items[0].future.result(timeout=60).name == "b2"
        _wait_until(lambda: fleet.replicas[0].state == EVICTED)
        _assert_pins_released(fleet.replicas[0])
        assert fleet.stats()["redispatches"] == 1
        assert fleet.replicas[1].requests_served >= 1
    finally:
        fleet.close()


def test_every_replica_killed_fails_futures_cleanly(snapshot):
    """With every replica repeatedly killed, accepted futures must still
    ALL resolve — with a clean SchedulerOverloadError, never a hang."""
    inj = FaultInjector()
    inj.arm("mid_batch", mode="kill", times=99)
    fleet = _make_fleet(snapshot, n=2, injector=inj, max_redispatch=2)
    try:
        with RequestScheduler(fleet, SchedulerConfig(max_wait_ms=1.0)) as sch:
            futs = [sch.submit(r) for r in _reqs("x", 6)]
            outcomes = []
            for f in futs:
                try:
                    outcomes.append(("ok", f.result(timeout=60)))
                except SchedulerOverloadError:
                    outcomes.append(("overload", None))
        assert len(outcomes) == 6                      # nothing hung
        assert all(kind == "overload" for kind, _ in outcomes)
        st_ = fleet.stats()
        assert st_["evictions"] == 2
        assert st_["scheduler"]["failed"] == 6         # nothing dropped
        for r in fleet.replicas:
            _assert_pins_released(r)
        # late submissions fail fast instead of queueing forever
        with pytest.raises((SchedulerOverloadError, RuntimeError)):
            fleet.query_batch(_reqs("late", 1), timeout=10)
    finally:
        fleet.close()


def test_fault_injector_validates_points_and_modes():
    inj = FaultInjector()
    with pytest.raises(ValueError, match="point"):
        inj.arm("mid_nothing")
    with pytest.raises(ValueError, match="mode"):
        inj.arm("mid_batch", mode="explode")
    inj.arm("mid_batch", replica=3, times=2)
    inj.check("mid_batch", 1)             # wrong replica: no fire
    assert not inj.fired


# ---------------------------------------------------------------------------
# routing invariants (property tests)
# ---------------------------------------------------------------------------

def _random_snapshots(rnd, n_replicas):
    states = (WARMING, SERVING, DRAINING, EVICTED)
    return [ReplicaSnapshot(replica_id=i,
                            state=rnd.choice(states),
                            queue_depth=rnd.randrange(0, 500),
                            cost_per_item=rnd.uniform(1e-4, 10.0))
            for i in range(n_replicas)]


@settings(max_examples=60, deadline=None)
@given(st.randoms(), st.integers(1, 8), st.integers(0, 64))
def test_router_never_places_on_non_serving(rnd, n_replicas, spread):
    snaps = _random_snapshots(rnd, n_replicas)
    rid = FleetRouter(max_depth_spread=spread).choose(
        snaps, n_items=rnd.randrange(1, 65))
    if rid is None:
        assert all(s.state != SERVING for s in snaps)
    else:
        assert snaps[rid].state == SERVING


@settings(max_examples=60, deadline=None)
@given(st.randoms(), st.integers(1, 8), st.integers(0, 64))
def test_router_is_deterministic(rnd, n_replicas, spread):
    snaps = _random_snapshots(rnd, n_replicas)
    n = rnd.randrange(1, 65)
    router = FleetRouter(max_depth_spread=spread)
    first = router.choose(snaps, n_items=n)
    assert all(router.choose(list(snaps), n_items=n) == first
               for _ in range(5))


@settings(max_examples=40, deadline=None)
@given(st.randoms(), st.integers(2, 6), st.integers(0, 32))
def test_router_bounds_queue_depth_spread(rnd, n_replicas, spread):
    """Over any placement sequence (no consumption — worst case), the
    depth gap between the most- and least-loaded SERVING replicas never
    exceeds ``max_depth_spread + n_max`` — the no-starvation bound."""
    router = FleetRouter(max_depth_spread=spread)
    costs = [rnd.uniform(1e-3, 5.0) for _ in range(n_replicas)]
    depths = [0] * n_replicas
    n_max = 0
    for _ in range(100):
        n = rnd.randrange(1, 9)
        n_max = max(n_max, n)
        snaps = [ReplicaSnapshot(i, SERVING, depths[i], costs[i])
                 for i in range(n_replicas)]
        rid = router.choose(snaps, n_items=n)
        assert rid is not None
        # eligibility bound at choose time
        assert depths[rid] <= min(depths) + spread
        depths[rid] += n
        assert max(depths) - min(depths) <= spread + n_max


@settings(max_examples=40, deadline=None)
@given(st.randoms(), st.integers(2, 8))
def test_router_equal_cost_is_least_loaded_round_robin(rnd, n_replicas):
    """Equal costs + equal batch sizes: each of the first ``n_replicas``
    placements lands on a distinct replica (nobody starves while an
    idle peer exists)."""
    router = FleetRouter(max_depth_spread=64)
    cost = rnd.uniform(1e-3, 5.0)
    depths = [0] * n_replicas
    hit = []
    for _ in range(n_replicas):
        snaps = [ReplicaSnapshot(i, SERVING, depths[i], cost)
                 for i in range(n_replicas)]
        rid = router.choose(snaps, n_items=4)
        hit.append(rid)
        depths[rid] += 4
    assert sorted(hit) == list(range(n_replicas))


def test_router_empty_and_all_evicted():
    r = FleetRouter()
    assert r.choose([], n_items=1) is None
    assert r.choose([ReplicaSnapshot(0, EVICTED, 0, 1.0),
                     ReplicaSnapshot(1, DRAINING, 0, 1.0)]) is None


def test_router_prefers_cheap_replica_under_load():
    """A 2x-faster replica absorbs more work until depths rebalance."""
    r = FleetRouter(max_depth_spread=64)
    snaps = [ReplicaSnapshot(0, SERVING, 10, 1.0),
             ReplicaSnapshot(1, SERVING, 10, 0.25)]
    assert r.choose(snaps, n_items=8) == 1
    # but the spread cap still overrides raw cost
    snaps = [ReplicaSnapshot(0, SERVING, 0, 1.0),
             ReplicaSnapshot(1, SERVING, 100, 0.001)]
    assert r.choose(snaps, n_items=8) == 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.randoms(), st.integers(1, 8), st.integers(0, 64))
def test_router_chooses_as_the_jax_router(rnd, n_replicas, spread):
    snaps = _random_snapshots(rnd, n_replicas)
    jsnaps = [JReplicaSnapshot(replica_id=s.replica_id, state=s.state,
                               queue_depth=s.queue_depth, cost_per_item=s.cost_per_item)
              for s in snaps]
    n = rnd.randrange(1, 65)
    assert (FleetRouter(max_depth_spread=spread).choose(snaps, n_items=n)
            == JFleetRouter(max_depth_spread=spread).choose(jsnaps, n_items=n))


@pytest.fixture(scope="module")
def fleet_models():
    """(port model, JAX model) with the same trees, trained by the port."""
    lake = lakegen.generate_lake(lakegen.LakeSpec(n_domains=8, n_tables=16, row_budget=512,
                                                  rows_log_mean=5.5, seed=0))
    return model_pair(train_quality_model([lake], GBDTConfig(n_trees=20, depth=4),
                                          n_query=48, device="cpu"))


def _serve_fleet(fleet, requests):
    with fleet:
        fleet.warm_event.wait(timeout=120)
        scheduler, config = ((RequestScheduler, SchedulerConfig)
                             if isinstance(fleet, EngineFleet)
                             else (JRequestScheduler, JSchedulerConfig))
        with scheduler(fleet, config(max_wait_ms=2.0)) as sch:
            futures = [sch.submit(r) for r in requests]
            out = [f.result(timeout=120) for f in futures]
        assert fleet.stats()["completed"] == len(requests)
    return out


@pytest.mark.parametrize("mode", ["full", "lsh"])
def test_fleet_answers_match_the_jax_fleet(small_lake, fleet_models, tmp_path, mode):
    """One catalog directory, a JAX fleet and a port fleet of two replicas,
    the same requests through a scheduler: equal ids up to exact ties, the
    scorer tolerance on scores, equal n_candidates (placement depends on
    timing and is not compared)."""
    root = str(tmp_path)
    jadd_lake(JCatalogStore(root, n_perm=128), small_lake)
    model, jmodel = fleet_models
    qids = [int(q) for q in lakegen.select_queries(small_lake, 6)]
    upload = [f"tok{i % 37}" for i in range(150)]
    reqs = ([DiscoveryRequest(name=f"q{q}", column_id=q) for q in qids]
            + [DiscoveryRequest(name="up", values=upload)])
    jreqs = ([JDiscoveryRequest(name=f"q{q}", column_id=q) for q in qids]
             + [JDiscoveryRequest(name="up", values=upload)])
    k = 5
    got = _serve_fleet(EngineFleet.from_catalog(
        root, model, EngineConfig(k=k, mode=mode, cache_entries=0),
        n_replicas=2, devices=[CPU]), reqs)
    want = _serve_fleet(JEngineFleet.from_catalog(
        root, jmodel, JEngineConfig(k=k, mode=mode, cache_entries=0),
        n_replicas=2, config=JFleetConfig()), jreqs)
    assert_same_responses(want, got, k)


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_replica_devices_follow_the_jax_slices(monkeypatch, n_devices):
    """The slice rule over cards named without a card present, and JAX's
    slice starts wherever JAX gives every replica a mesh (>= 2 devices)."""
    cards = [torch.device("cuda", i) for i in range(n_devices)]
    monkeypatch.setattr(jax.sharding, "Mesh", lambda devs, axes: np.asarray(devs))
    for n_replicas in range(1, 9):
        got = make_replica_devices(n_replicas, devices=cards)
        per = n_devices // n_replicas
        assert len(got) == n_replicas
        if per == 0:
            assert got == [cards[0]] * n_replicas
        else:
            assert got == [cards[i * per] for i in range(n_replicas)]
        meshes = make_replica_meshes(n_replicas, devices=list(range(n_devices)))
        port_meshes = port_replica_meshes(n_replicas, devices=cards)
        for dev, mesh, port_mesh in zip(got, meshes, port_meshes):
            assert (mesh is None) == (port_mesh is None)
            if mesh is not None:
                assert dev == cards[int(mesh.flat[0])]
                assert port_mesh.devices.shape == mesh.shape
                assert list(port_mesh.devices.flat) == [cards[int(j)] for j in mesh.flat]
                assert port_mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="n_replicas"):
        make_replica_devices(0, devices=cards)
    assert make_replica_devices(3, devices=[CPU]) == [CPU] * 3


def test_fleet_replicas_shard_over_their_slices(small_lake, fleet_models, tmp_path):
    """Four host devices, two replicas: each replica serves sharded plans
    over its two-device slice, with the JAX engine's full-scan answers."""
    root = str(tmp_path)
    jadd_lake(JCatalogStore(root, n_perm=128), small_lake)
    model, jmodel = fleet_models
    qids = [int(q) for q in lakegen.select_queries(small_lake, 6)]
    fleet = EngineFleet.from_catalog(root, model, EngineConfig(k=5, mode="sharded",
                                                               cache_entries=0),
                                     n_replicas=2, devices=[CPU] * 4)
    meshes = [r.engine.mesh for r in fleet.replicas]
    assert [m.shape for m in meshes] == [{"data": 2, "model": 1}] * 2
    got = _serve_fleet(fleet, [DiscoveryRequest(name=f"q{q}", column_id=q) for q in qids])
    from repro.service import DiscoveryEngine as JDiscoveryEngine
    from repro.service import CatalogReader as JCatalogReader
    want = JDiscoveryEngine(JCatalogReader(root).snapshot(), jmodel,
                            JEngineConfig(k=5, mode="full", cache_entries=0)).query_batch(
        [JDiscoveryRequest(name=f"q{q}", column_id=q) for q in qids])
    assert_same_responses(want, got, 5)


def _served_lines(out: str):
    """The lines of a fleet run that do not depend on timing."""
    return [line for line in out.splitlines() if re.match(r"  q\d+ \(\d+ scored\) -> ", line)]


def test_discover_replicas_matches_jax_entry_point(monkeypatch, capsys, tmp_path,
                                                    fleet_models):
    _, jmodel = fleet_models
    jmodel.save(str(tmp_path / "m.npz"))
    args = ["--tables", "12", "--domains", "5", "--queries", "6", "--k", "5",
            "--model", str(tmp_path / "m.npz"), "--replicas", "2", "--serve"]
    runs = {}
    for name, main, extra in (("jax", jax_discover.main, []),
                              ("port", port_discover.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["discover", *args, "--catalog",
                                          str(tmp_path / name), *extra])
        main()
        runs[name] = capsys.readouterr().out
    lines = _served_lines(runs["port"])
    assert len(lines) == 3 and "fleet: 2 replicas over 1 devices" in runs["port"]
    assert lines == _served_lines(runs["jax"])
    assert len(re.findall(r"  replica \d: evicted|  replica \d: serving", runs["port"])) == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_replica_fleet_on_the_card_equals_one_engine(cuda, small_lake, fleet_models,
                                                         tmp_path):
    """Both replicas on the card (the default devices), served through a
    scheduler: every response equals a single engine's on the card, and
    the scorer and probe kernels launched."""
    root = str(tmp_path)
    jadd_lake(JCatalogStore(root, n_perm=128), small_lake)
    model, _ = fleet_models
    cfg = dict(k=5, mode="lsh", cache_entries=0)
    reqs = [DiscoveryRequest(name=f"q{q}.{r}", column_id=int(q))
            for r in range(3) for q in lakegen.select_queries(small_lake, 8)]
    reqs.append(DiscoveryRequest(name="up", values=[f"tok{i % 37}" for i in range(150)]))
    direct = port_engine.DiscoveryEngine.from_catalog(ColumnCatalog(root, device=cuda), model,
                                                      EngineConfig(**cfg), device=cuda)
    want = direct.query_batch(reqs)
    direct.close()
    _build.reset_launch_counts()
    fleet = EngineFleet.from_catalog(root, model, EngineConfig(**cfg), n_replicas=2)
    assert all(r.engine.device.type == "cuda" for r in fleet.replicas)
    got = _serve_fleet(fleet, reqs)
    assert _build.launch_counts["fused_score"] > 0 and _build.launch_counts["lsh_probe"] > 0
    for w, g in zip(want, got):
        assert g.name == w.name and g.n_candidates == w.n_candidates
        assert [(m.column_id, m.score) for m in g.matches] == \
            [(m.column_id, m.score) for m in w.matches]
