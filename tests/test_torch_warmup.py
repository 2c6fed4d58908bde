"""The port's warmup, restating tests/test_warmup.py: a warmed engine
serves every ladder bucket with no first-contact run on the request path,
the scheduler holds dispatch while a warmup runs, ``plan_set`` enumerates
what the JAX planner enumerates, the next column bucket warms ahead of a
crossing, and the lazy-snapshot int8 engine streams its sidecar without
materializing the lake-sized float32 z-score matrix. The JAX package's
persistent executable cache has no counterpart (the port has no
executables to serialize): its tests are not restated."""
import dataclasses
import time

import numpy as np
import pytest

import repro.exec as jexec
from repro.kernels.profile_distance import (
    quantize_profiles_streamed as jquantize_profiles_streamed)
from repro.service import CatalogReader as JCatalogReader
from repro.service import DiscoveryEngine as JDiscoveryEngine
from repro.service import DiscoveryRequest as JDiscoveryRequest
from repro.service import EngineConfig as JEngineConfig
from repro.service import LSHConfig as JLSHConfig
import repro_torch.core.profiles as core_profiles
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake
from repro_torch.core.predictor import train_quality_model
from repro_torch.exec.plan import (DEFAULT_BATCH_BUCKETS, CANDIDATE_KINDS, Planner,
                                   PlannerConfig)
from repro_torch.kernels.profile_distance import (quantize_profiles,
                                                  quantize_profiles_streamed)
from repro_torch.service import (CatalogReader, ColumnCatalog, DiscoveryEngine,
                                 DiscoveryRequest, EngineConfig, LSHConfig,
                                 RequestScheduler, SchedulerConfig, add_lake)
from repro_torch.service.metrics import parse_exposition

from _torch_service import assert_same_responses, match_rows, model_pair

BUCKETS = (4, 8)


@pytest.fixture(scope="module")
def warm_lake():
    return generate_lake(LakeSpec(n_domains=6, n_tables=10, row_budget=512, seed=5))


@pytest.fixture(scope="module")
def models(warm_lake):
    return model_pair(train_quality_model([warm_lake], GBDTConfig(n_trees=10, depth=3),
                                          n_query=32, device="cpu"))


@pytest.fixture(scope="module")
def catalog_dir(tmp_path_factory, warm_lake):
    root = str(tmp_path_factory.mktemp("warm_catalog"))
    cat = ColumnCatalog(root, device="cpu")
    add_lake(cat, warm_lake)
    cat.compact()          # single segment: the lazy fast path needs it
    return root


def _config(**kw):
    kw.setdefault("k", 4)
    kw.setdefault("mode", "lsh")
    kw.setdefault("lsh", LSHConfig(n_bands=16, n_coarse_bands=4))
    kw.setdefault("batch_buckets", BUCKETS)
    return EngineConfig(**kw)


def _engine(catalog_dir, model, **kw):
    return DiscoveryEngine.from_catalog(ColumnCatalog(catalog_dir, device="cpu"), model,
                                        _config(**kw), device="cpu")


def _reqs(n, R=DiscoveryRequest):
    return [R(name=f"q{i}", column_id=i) for i in range(n)]


@pytest.mark.parametrize("mode", ["lsh", "full", "tiered", "auto"])
def test_warmed_engine_serves_every_bucket_without_first_contact(catalog_dir, models,
                                                                 mode):
    eng = _engine(catalog_dir, models[0], metrics=True, warmup="serve", mode=mode)
    rep = eng.warmup_report
    assert rep is not None and eng.warm_event.is_set()
    assert rep["scope"] == "serve" and rep["buckets"] == list(BUCKETS)
    assert rep["n_executables"] > 0
    assert rep["cache_misses"] == rep["n_executables"] and rep["cache_hits"] == 0
    assert rep["wall_ms"] > 0
    cursor = eng.events.subscribe("test")
    for b in BUCKETS:
        for r in eng.query_batch(_reqs(b)):
            assert not any("compile_ms" in s for s in r.trace), r.trace
    types = [ev.type for ev in cursor.poll()]
    assert "compile_begin" not in types and "compile_end" not in types
    stats = eng._executor.dispatch_stats()
    assert stats["fallback"] == 0 and stats["aot"] == len(BUCKETS)
    # a second warmup finds every unit warm
    again = eng.warmup("serve")
    assert again["already_warm"] == again["n_executables"] and again["cache_misses"] == 0


def test_unwarmed_shape_counts_as_first_contact(catalog_dir, models):
    eng = _engine(catalog_dir, models[0], metrics=True)
    r = eng.query_batch(_reqs(3))[0]
    assert [s for s in r.trace if s["phase"] == "execute"][0]["compile_ms"] > 0
    assert eng._executor.dispatch_stats() == {"aot": 0, "fallback": 1}


def test_warmup_installs_default_ladder_when_none(catalog_dir, models):
    eng = _engine(catalog_dir, models[0], batch_buckets=None)
    assert not eng.planner.config.batch_buckets
    rep = eng.warmup("serve")
    assert tuple(eng.planner.config.batch_buckets) == DEFAULT_BATCH_BUCKETS
    assert rep["buckets"] == sorted(DEFAULT_BATCH_BUCKETS)
    with pytest.raises(ValueError):
        eng.warmup("everything")


def test_scheduler_holds_dispatch_until_warm(catalog_dir, models):
    eng = _engine(catalog_dir, models[0])
    with RequestScheduler(eng, SchedulerConfig(batch_buckets=BUCKETS,
                                               max_wait_ms=1.0)) as sch:
        eng.warm_event.clear()       # a warmup is "running"
        fut = sch.submit(DiscoveryRequest(name="held", column_id=0))
        time.sleep(0.25)
        assert not fut.done()
        eng.warm_event.set()
        assert fut.result(timeout=30).name == "held"
        assert sch.stats()["warm_held"] >= 1


def test_warmup_metrics_and_exposition(catalog_dir, models):
    eng = _engine(catalog_dir, models[0], metrics=True, warmup="serve")
    rep = eng.warmup_report
    snap = eng.metrics.collect()
    assert snap["warmups_total"]["values"][""] == 1.0
    assert snap["executable_cache_misses_total"]["values"][""] == rep["cache_misses"]
    assert snap["warmup_remaining"]["values"][""] == 0.0
    assert snap["compile_ms"]["values"]["count"] == rep["cache_misses"]
    parsed = parse_exposition(eng.metrics.render())
    assert "warmup_remaining" in parsed
    assert parsed["executable_cache_misses_total"][""] == rep["cache_misses"]


def test_refresh_rewarms_new_version(catalog_dir, models, tmp_path):
    eng = _engine(catalog_dir, models[0], metrics=True, warmup="serve", batch_buckets=(4,))
    writer = ColumnCatalog(catalog_dir, device="cpu")
    if "warm_refresh_demo" not in writer.tables():
        writer.add_table("warm_refresh_demo", [("ids", [f"wr_{i}" for i in range(50)])])
    eng.refresh(ColumnCatalog(catalog_dir, device="cpu").snapshot())
    assert eng.warm_event.is_set()
    assert eng.warmup_report["n_executables"] > 0
    cursor = eng.events.subscribe("test")
    for r in eng.query_batch(_reqs(4)):
        assert not any("compile_ms" in s for s in r.trace)
    assert "compile_begin" not in [ev.type for ev in cursor.poll()]


def test_next_column_bucket_warms_ahead_of_a_crossing(warm_lake, models, tmp_path):
    """``prewarm_bucket`` runs the serving plans on a stand-in of the next
    bucket's size; the incremental successor that crosses into it serves
    with no first-contact run."""
    root = str(tmp_path)
    add_lake(ColumnCatalog(root, device="cpu"), warm_lake)
    reader = CatalogReader(root)
    eng = DiscoveryEngine(reader.snapshot(), models[0],
                          _config(incremental=True, column_buckets=(64, 128, 256),
                                  prewarm_fraction=2.0, metrics=True),
                          device="cpu")
    eng.follow(reader, auto=False)
    cur = eng._executor.n_columns
    nxt = eng.planner.next_column_bucket(cur)
    assert nxt == 2 * cur
    rep = eng.prewarm_bucket(nxt)
    assert rep["n_executables"] > 0 and rep["cache_misses"] == rep["n_executables"]
    writer = ColumnCatalog(root, device="cpu")
    writer.add_table("grow", [(f"g{j}", [f"g{j}_{i}" for i in range(40)])
                              for j in range(cur - eng.n_columns + 1)])
    eng._maybe_follow(force=True)
    assert eng._executor.n_columns == nxt
    assert eng.stats()["refresh"]["incremental"] == 1
    cursor = eng.events.subscribe("test")
    eng.query_batch(_reqs(BUCKETS[0]))
    assert "compile_begin" not in [ev.type for ev in cursor.poll()]
    assert eng._executor.dispatch_stats() == {"aot": 1, "fallback": 0}


# ---------------------------------------------------------------------------
# plan_set enumeration
# ---------------------------------------------------------------------------

def test_plan_set_serve_scope_covers_served_and_baseline(catalog_dir, models):
    eng = _engine(catalog_dir, models[0])
    plans = eng.planner.plan_set(n_columns=eng.n_columns, n_queries=4, mode="lsh",
                                 scope="serve")
    kinds = {p.candidates for p in plans}
    assert "all" in kinds and len(kinds) == len(plans) == 2


def test_plan_set_full_scope_enumerates_admissible_kinds(catalog_dir, models):
    eng = _engine(catalog_dir, models[0])
    plans = eng.planner.plan_set(n_columns=eng.n_columns, n_queries=4, mode="lsh",
                                 scope="full")
    assert {p.candidates for p in plans} == set(CANDIDATE_KINDS)
    keys = [(p.candidates, p.sharded, p.budget, p.k, p.grid, p.survivor_budget)
            for p in plans]
    assert len(keys) == len(set(keys))
    with pytest.raises(ValueError):
        eng.planner.plan_set(n_columns=eng.n_columns, scope="everything")


@pytest.mark.parametrize("scope", ["serve", "full"])
@pytest.mark.parametrize("mode", ["lsh", "full", "tiered", "auto"])
def test_plan_set_matches_jax(mode, scope):
    for n, q in ((40, 4), (3000, 8), (100_000, 64)):
        want = jexec.Planner(jexec.PlannerConfig(batch_buckets=(4, 8))).plan_set(
            n_columns=n, n_queries=q, mode=mode, scope=scope)
        got = Planner(PlannerConfig(batch_buckets=(4, 8))).plan_set(
            n_columns=n, n_queries=q, mode=mode, scope=scope)
        ident = lambda p: (p.candidates, p.sharded, p.budget, p.k, p.grid,
                           p.survivor_budget)
        assert [ident(p) for p in got] == [ident(p) for p in want]


def test_planner_ladders_match_jax():
    cfg = dict(batch_buckets=(4, 8, 32), column_buckets=(1024, 4096))
    jp, tp = jexec.Planner(jexec.PlannerConfig(**cfg)), Planner(PlannerConfig(**cfg))
    for n in (1, 3, 4, 5, 8, 9, 32, 33, 65, 1000, 1025, 4097, 9000):
        assert tp.snap_batch(n) == jp.snap_batch(n)
        assert tp.snap_columns(n) == jp.snap_columns(n)
        assert tp.next_column_bucket(n) == jp.next_column_bucket(n)
    assert jexec.DEFAULT_BATCH_BUCKETS == DEFAULT_BATCH_BUCKETS
    from repro.exec.plan import DEFAULT_COLUMN_BUCKETS as JCOLS
    from repro_torch.exec.plan import DEFAULT_COLUMN_BUCKETS
    assert JCOLS == DEFAULT_COLUMN_BUCKETS
    assert Planner(PlannerConfig()).next_column_bucket(5) is None


class _FakeMesh:
    """The planner reads only ``mesh.shape``."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("kw", [dict(mode="sharded", mesh=_FakeMesh(data=2, model=1)),
                                dict(mesh=_FakeMesh(data=4, model=1)),
                                dict(mesh=_FakeMesh(data=2, model=1), grid=(2, 1))])
def test_sharded_plans_and_plan_sets_match_jax(kw):
    """``mode="sharded"``, ``lsh`` over a mesh and a pinned (2, 1) grid: the
    plan and both warmup plan sets, field by field, as the JAX planner's."""
    args = dict(n_columns=100, n_queries=4, mode="lsh")
    args.update(kw)
    ident = lambda p: (p.kind, p.candidates, p.sharded, p.budget, p.k, p.grid,
                       p.n_shards, p.shard_axes, p.survivor_budget, p.budget_per_shard)
    want, got = jexec.Planner().plan(**args), Planner().plan(**args)
    assert ident(got) == ident(want) and got.sharded
    for scope in ("serve", "full"):
        assert ([ident(p) for p in Planner().plan_set(scope=scope, **args)]
                == [ident(p) for p in jexec.Planner().plan_set(scope=scope, **args)])


# ---------------------------------------------------------------------------
# lazy snapshots: streamed quantized sidecar, no eager z-score pass
# ---------------------------------------------------------------------------

def test_streamed_quantizer_matches_eager_bytes(catalog_dir):
    prof = ColumnCatalog(catalog_dir, device="cpu").snapshot().profiles
    z = prof.zscored.astype(np.float32)
    for dt in ("int8", "fp16", "fp32"):
        a, sa = quantize_profiles(z, dt)
        b, sb = quantize_profiles_streamed(prof.numeric, prof.mean, prof.std, dt, block=17)
        jb, jsb = jquantize_profiles_streamed(prof.numeric, prof.mean, prof.std, dt,
                                              block=17)
        assert a.dtype == b.dtype == jb.dtype
        assert np.array_equal(a, b) and np.array_equal(sa, sb)
        assert np.array_equal(b, jb) and np.array_equal(sb, jsb)
    with pytest.raises(ValueError):
        quantize_profiles_streamed(prof.numeric, prof.mean, prof.std, "int4")


@pytest.mark.parametrize("dtype", ["int8", "fp16"])
def test_lazy_quantized_engine_never_materializes_zscores(catalog_dir, models,
                                                          monkeypatch, dtype):
    model, jmodel = models
    cat = ColumnCatalog(catalog_dir, device="cpu")
    cat.compact()
    snap = cat.snapshot(lazy=True)
    assert snap.lazy
    legacy = dataclasses.replace(snap, lazy=False)

    def boom(self):
        raise AssertionError("lazy path materialized the float32 z-score matrix")

    monkeypatch.setattr(core_profiles.LakeProfiles, "zscored", property(boom))
    e_lazy = DiscoveryEngine(snap, model, _config(profile_dtype=dtype), device="cpu")
    lazy_out = e_lazy.query_batch(_reqs(6))
    monkeypatch.undo()
    e_legacy = DiscoveryEngine(legacy, model, _config(profile_dtype=dtype), device="cpu")
    assert match_rows(lazy_out) == match_rows(e_legacy.query_batch(_reqs(6)))
    # and the JAX package's lazy engine over the same directory
    jsnap = JCatalogReader(catalog_dir).snapshot(lazy=True)
    jeng = JDiscoveryEngine(jsnap, jmodel, JEngineConfig(
        k=4, mode="lsh", lsh=JLSHConfig(n_bands=16, n_coarse_bands=4),
        batch_buckets=BUCKETS, profile_dtype=dtype))
    assert_same_responses(jeng.query_batch(_reqs(6, JDiscoveryRequest)), lazy_out, k=4)
