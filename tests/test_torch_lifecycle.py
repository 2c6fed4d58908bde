"""The port's executor lifecycle on the CPU: sentinel-padded corpora,
``Executor.extended`` against a fresh executor over the same rows, close
and the refcounted placements, and the engine's incremental refresh held
against the JAX engine's incremental refresh over the same catalog
versions (restating tests/test_ingest.py)."""
import numpy as np
import pytest
import torch

from repro.kernels.minhash import make_permutations as jax_make_permutations
from repro.kernels import ref as jref
from repro.service import CatalogReader as JCatalogReader
from repro.service import ColumnCatalog as JColumnCatalog
from repro.service import DiscoveryEngine as JDiscoveryEngine
from repro.service import DiscoveryRequest as JDiscoveryRequest
from repro.service import EngineConfig as JEngineConfig
from repro.service import LSHConfig as JLSHConfig
from repro.service import add_lake as jadd_lake
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake
from repro_torch.core.predictor import train_quality_model
from repro_torch.exec.executor import Executor, live_placement_bundles
from repro_torch.exec.plan import Planner, PlannerConfig, QueryPlan
from repro_torch.service import (CatalogReader, ColumnCatalog, DiscoveryEngine,
                                 DiscoveryRequest, EngineConfig, EventBus, LSHConfig,
                                 LSHIndex, ServiceMetrics, add_lake, measure_recall)

from _torch_service import assert_same_responses, model_pair, str_table

WARM_LAKE = dict(n_domains=6, n_tables=10, row_budget=512, seed=5)
BUCKETS = (128, 256, 512, 1024)
KINDS = ("all", "lsh", "hybrid", "tiered")


@pytest.fixture(scope="module")
def models():
    lake = generate_lake(LakeSpec(**WARM_LAKE))
    return model_pair(train_quality_model([lake], GBDTConfig(n_trees=20, depth=4),
                                          n_query=40, device="cpu"))


@pytest.fixture(scope="module")
def corpus(small_lake, small_profiles):
    """z-scored profiles, words, table ids and both key tiers of the small
    lake, from reference signatures."""
    a, b = jax_make_permutations(64, 0)
    sigs = np.asarray(jref.minhash_ref(small_lake.batch.values32, a, b))
    index = LSHIndex.build(sigs, LSHConfig(n_bands=16, n_coarse_bands=8))
    return dict(z=small_profiles.zscored.astype(np.float32), w=small_profiles.words,
                tids=np.asarray(small_lake.table, np.int32), keys=index.keys,
                coarse=index.coarse, index=index, sigs=sigs)


def _plan(kind: str, n: int) -> QueryPlan:
    planner = Planner(PlannerConfig(k=10, n_bands=16, n_coarse_bands=8,
                                    min_survivors=64))
    if kind == "lsh":
        return QueryPlan(candidates="lsh", budget=planner.candidate_budget(n), k=10)
    mode = {"all": "full", "hybrid": "lsh", "tiered": "tiered"}[kind]
    return planner.plan(n_columns=n, n_queries=8, mode=mode)


def _batch(c, rows, external=2):
    """Resident queries ``rows`` (table masks on) and ``external`` uploaded
    ones (a perturbed resident profile, no masks)."""
    r = np.random.default_rng(len(rows))
    ext = r.choice(c["z"].shape[0], external, replace=False)
    zq = np.concatenate([c["z"][rows], c["z"][ext] + r.normal(0, 0.1, (external, 21))])
    sel = np.concatenate([rows, ext])
    tq = np.concatenate([c["tids"][rows], np.full(external, -1, np.int32)])
    qid = np.concatenate([rows, np.full(external, -1)]).astype(np.int32)
    return (zq.astype(np.float32), c["w"][sel], tq, qid,
            c["index"].query_keys(c["sigs"][sel]),
            c["index"].coarse_query_keys(c["sigs"][sel]))


def _executor(c, n=None, **kw):
    n = c["z"].shape[0] if n is None else n
    return Executor(c["z"][:n], c["w"][:n], kw.pop("gbdt"), table_ids=c["tids"][:n],
                    band_keys=c["keys"][:n], coarse_keys=c["coarse"][:n],
                    device="cpu", **kw)


def _run(ex, plan, batch):
    res = ex.execute(plan, *batch)
    return (*res, res.tier)


def _assert_equal_runs(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert np.array_equal(x, y)
    assert (a[3] is None) == (b[3] is None)
    if a[3] is not None:
        for x, y in zip(a[3], b[3]):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("dtype", ["fp32", "int8", "fp16"])
@pytest.mark.parametrize("kind", KINDS)
def test_padded_executor_equals_unpadded(corpus, models, kind, dtype):
    """Sentinel pad rows never take a slot: ids, scores, ``n_scored`` and
    the tier counts equal the unpadded executor's exactly."""
    g = models[0].gbdt.astuple()
    n = corpus["z"].shape[0]
    plan = _plan(kind, n)
    batch = _batch(corpus, np.asarray([0, 3, 17, 40, 41, 90]))
    want = _run(_executor(corpus, gbdt=g, profile_dtype=dtype), plan, batch)
    padded = _executor(corpus, gbdt=g, profile_dtype=dtype, n_padded=n + 77)
    assert (padded.n_live, padded.n_columns) == (n, n + 77)
    _assert_equal_runs(_run(padded, plan, batch), want)
    assert (want[1] >= -1).all() and (want[1] < n).all()


@pytest.mark.parametrize("kind", KINDS)
def test_extended_equals_a_fresh_executor(corpus, models, kind):
    """A successor built from delta rows serves exactly what a fresh
    executor over the same rows and keys serves, inside its column bucket
    and across one; its predecessor keeps serving what it served."""
    g = models[0].gbdt.astuple()
    n = corpus["z"].shape[0]
    n0, n1 = n - 40, n - 9
    c = corpus
    base = _executor(c, n0, gbdt=g, n_padded=256)
    plan = _plan(kind, n0)
    batch = _batch(c, np.asarray([1, 5, 20, 33]))
    before = _run(base, plan, batch)

    def delta(ex, lo, hi, **kw):
        return ex.extended(c["z"][lo:hi], c["w"][lo:hi], table_ids=c["tids"][lo:hi],
                           band_keys=c["keys"][lo:hi], coarse_keys=c["coarse"][lo:hi], **kw)

    same = delta(base, n0, n1)                       # inside the 256 bucket
    crossed = delta(same, n1, n, n_padded=512)       # into the 512 bucket
    for ex, size in ((same, n1), (crossed, n)):
        fresh = _executor(c, size, gbdt=g, n_padded=ex.n_columns)
        assert (ex.n_live, ex.n_columns) == (fresh.n_live, fresh.n_columns)
        _assert_equal_runs(_run(ex, plan, batch), _run(fresh, plan, batch))
        assert 0 < ex.bytes_uploaded < fresh.bytes_uploaded / 4
    _assert_equal_runs(_run(base, plan, batch), before)
    for ex in (crossed, same, base):
        ex.close()


def test_close_releases_placements_by_refcount(corpus, models):
    g = models[0].gbdt.astuple()
    c, n = corpus, corpus["z"].shape[0]
    base0 = live_placement_bundles()
    ex = _executor(c, n - 5, gbdt=g, n_padded=256)
    assert live_placement_bundles() == base0 + 2          # rows + GBDT
    succ = ex.extended(c["z"][n - 5:], c["w"][n - 5:], table_ids=c["tids"][n - 5:],
                       band_keys=c["keys"][n - 5:], coarse_keys=c["coarse"][n - 5:])
    zero = succ.extended(c["z"][:0], c["w"][:0], table_ids=c["tids"][:0],
                         band_keys=c["keys"][:0], coarse_keys=c["coarse"][:0])
    assert zero.bytes_uploaded == 0 and zero.n_live == succ.n_live
    assert live_placement_bundles() == base0 + 3          # successor rows only
    plan = _plan("hybrid", n)
    batch = _batch(c, np.asarray([2, 9]))
    want = _run(succ, plan, batch)
    ex.close()
    succ.close()                                           # zero still holds rows
    assert ex.closed and succ.closed and not zero.closed
    assert live_placement_bundles() == base0 + 2
    _assert_equal_runs(_run(zero, plan, batch), want)
    for closed in (ex, succ):
        with pytest.raises(RuntimeError, match="closed"):
            closed.execute(plan, *batch)
        with pytest.raises(RuntimeError, match="closed"):
            closed.extended(c["z"][:0], c["w"][:0], table_ids=c["tids"][:0],
                            band_keys=c["keys"][:0], coarse_keys=c["coarse"][:0])
    zero.close()
    zero.close()                                           # idempotent
    assert live_placement_bundles() == base0


def test_quantized_executor_refuses_delta_placement(corpus, models):
    ex = _executor(corpus, gbdt=models[0].gbdt.astuple(), profile_dtype="int8")
    with pytest.raises(NotImplementedError, match="float32"):
        ex.extended(corpus["z"][:1], corpus["w"][:1], table_ids=corpus["tids"][:1],
                    band_keys=corpus["keys"][:1], coarse_keys=corpus["coarse"][:1])
    ex.close()


# ---------------------------------------------------------------------------
# incremental refresh (tests/test_ingest.py)
# ---------------------------------------------------------------------------

@pytest.fixture()
def catalog(tmp_path):
    root = str(tmp_path)
    jadd_lake(JColumnCatalog(root, n_perm=128), generate_lake(LakeSpec(**WARM_LAKE)))
    return root


def _follower(root, model, events=None, **kw):
    reader = CatalogReader(root)
    eng = DiscoveryEngine(reader.snapshot(), model,
                          EngineConfig(k=10, mode=kw.pop("mode", "lsh"),
                                       lsh=LSHConfig(n_bands=64), cache_entries=0,
                                       incremental=True, column_buckets=BUCKETS,
                                       prewarm_fraction=2.0, **kw),
                          events=events, device="cpu")
    eng.follow(reader, auto=False)
    return eng


def _jax_follower(root, model, mode):
    reader = JCatalogReader(root)
    eng = JDiscoveryEngine(reader.snapshot(), model,
                           JEngineConfig(k=10, mode=mode, lsh=JLSHConfig(n_bands=64),
                                         cache_entries=0, incremental=True,
                                         column_buckets=BUCKETS, prewarm_fraction=2.0))
    eng.follow(reader, auto=False)
    return eng


def _requests(R, n_columns):
    return ([R(name=f"q{i}", column_id=i) for i in range(0, n_columns, 7)]
            + [R(name="up", values=[f"tok{i % 70}" for i in range(200)])])


@pytest.mark.parametrize("mode", ["lsh", "full"])
def test_incremental_refresh_matches_jax_incremental_refresh(catalog, models, mode):
    """Both engines follow the same catalog through a coalesced append-only
    burst (the delta path, frozen statistics) and then a drop (a full
    rebuild): their answers agree after each, and the port's delta-built
    executor equals a fresh one over the same rows."""
    model, jmodel = models
    bus = EventBus()
    metrics = ServiceMetrics(bus)
    eng = _follower(catalog, model, events=bus, mode=mode)
    jeng = _jax_follower(catalog, jmodel, mode)
    c0 = eng.snapshot.n_columns
    writer = ColumnCatalog(catalog, device="cpu")
    for i in range(3):
        str_table(writer, f"burst{i}", seed=50 + i)
    for e in (eng, jeng):
        e._maybe_follow(force=True)
    rs, jrs = eng.stats()["refresh"], jeng.stats()["refresh"]
    assert (rs["incremental"], rs["full"], rs["coalesced"]) == (1, 1, 2)
    for key in ("incremental", "full", "coalesced", "last_delta_columns", "column_bucket"):
        assert rs[key] == jrs[key], key
    assert rs["last_delta_columns"] == eng.snapshot.n_columns - c0 == 9
    assert rs["recompiles_total"] == 0 and 0.0 <= rs["stats_drift"] < 10.0
    np.testing.assert_allclose(rs["stats_drift"], jrs["stats_drift"], rtol=1e-6)
    n = eng.n_columns
    assert_same_responses(jeng.query_batch(_requests(JDiscoveryRequest, n)),
                          eng.query_batch(_requests(DiscoveryRequest, n)), k=10)

    # the delta-built executor against a fresh one over the same rows
    st = eng._head
    fresh = Executor(st.z, st.w, model.gbdt.astuple(), table_ids=st.snapshot.table_ids,
                     band_keys=st.lsh.keys, coarse_keys=st.lsh.coarse,
                     n_padded=st.executor.n_columns, device="cpu")
    zq, wq, sigq, tq, qid = eng._resolve(_requests(DiscoveryRequest, n), st)
    plan = eng.planner.plan(n_columns=st.executor.n_columns, n_queries=8, mode=mode)
    args = (zq, wq, tq, qid, st.lsh.query_keys(sigq), st.lsh.coarse_query_keys(sigq))
    _assert_equal_runs(_run(st.executor, plan, args), _run(fresh, plan, args))
    assert st.executor.bytes_uploaded < fresh.bytes_uploaded / 4
    fresh.close()

    metrics.drain()
    assert metrics.refreshes_incremental.value() == 1
    assert metrics.refreshes_coalesced.value() == 2
    assert metrics.refresh_recompiles.value() == 0
    assert metrics.placement_bytes_uploaded.value() > 0
    assert "refresh_ms" in metrics.render()

    # a drop rewrites manifest history: both rebuild in full
    writer.drop_table("burst0")
    for e in (eng, jeng):
        e._maybe_follow(force=True)
    assert eng.stats()["refresh"]["full"] == jeng.stats()["refresh"]["full"] == 2
    n = eng.n_columns
    assert_same_responses(jeng.query_batch(_requests(JDiscoveryRequest, n)),
                          eng.query_batch(_requests(DiscoveryRequest, n)), k=10)
    if mode == "lsh":
        assert measure_recall(eng, np.arange(0, n, 5), k=10)["recall"] >= 0.7
    eng.close()
    jeng.close()


def _rss_mb() -> float:
    with open("/proc/self/statm") as fh:
        return int(fh.read().split()[1]) * 4096 / 2 ** 20


def test_refresh_cycles_do_not_leak_placements(catalog, models):
    base = live_placement_bundles()
    eng = _follower(catalog, models[0])
    writer = ColumnCatalog(catalog, device="cpu")
    rss0 = _rss_mb()
    high_water = live_placement_bundles()
    for i in range(6):
        str_table(writer, f"cycle{i}", seed=90 + i, n_cols=2, n_rows=120)
        eng._maybe_follow(force=True)
        eng.query(DiscoveryRequest(column_id=1))
        high_water = max(high_water, live_placement_bundles())
    assert eng.stats()["refresh"]["incremental"] == 6
    # one live head (its rows and the GBDT bundle); predecessors released
    assert high_water - base <= 2, (high_water, base)
    assert _rss_mb() - rss0 < 256.0
    eng.close()
    assert live_placement_bundles() == base


def test_engine_add_lake_then_follow_keeps_recall(models, tmp_path):
    """A catalog the port ingests, followed through an append-only add."""
    root = str(tmp_path)
    lake = generate_lake(LakeSpec(**WARM_LAKE))
    add_lake(ColumnCatalog(root, n_perm=128, device="cpu"), lake)
    eng = _follower(root, models[0])
    str_table(ColumnCatalog(root, device="cpu"), "late", seed=7)
    eng._maybe_follow(force=True)
    assert eng.stats()["refresh"]["incremental"] == 1
    r = eng.query(DiscoveryRequest(name="up", values=[f"tok{i % 70}" for i in range(200)]))
    assert any(m.column.startswith("late_") for m in r.matches)
    eng.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
def test_extended_on_the_card_equals_a_fresh_executor(cuda, corpus, models, kind):
    g = models[0].gbdt.astuple()
    c, n = corpus, corpus["z"].shape[0]
    n0 = n - 30
    base = Executor(c["z"][:n0], c["w"][:n0], g, table_ids=c["tids"][:n0],
                    band_keys=c["keys"][:n0], coarse_keys=c["coarse"][:n0],
                    n_padded=256, device=cuda)
    ext = base.extended(c["z"][n0:], c["w"][n0:], table_ids=c["tids"][n0:],
                        band_keys=c["keys"][n0:], coarse_keys=c["coarse"][n0:])
    fresh = Executor(c["z"], c["w"], g, table_ids=c["tids"], band_keys=c["keys"],
                     coarse_keys=c["coarse"], n_padded=256, device=cuda)
    plan = _plan(kind, n)
    batch = _batch(c, np.asarray([1, 5, 20, 33]))
    _assert_equal_runs(_run(ext, plan, batch), _run(fresh, plan, batch))
    before = torch.cuda.memory_allocated(cuda)
    base.close()
    assert torch.cuda.memory_allocated(cuda) < before       # the predecessor's rows freed
    for ex in (ext, fresh):
        ex.close()
