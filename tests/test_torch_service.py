"""The port's serving path against the JAX package on the CPU: one on-disk
catalog read and written by both packages, both engines serving the same
directory, the index deltas, and the reference service tests restated on
the port (tests/test_service.py, tests/test_ingest.py:89-116)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.sketches as jsketches
import repro.launch.costmodel as jcostmodel
from repro.core.ingest import ColumnSketch
from repro.kernels import ref as jref
from repro.service import CatalogReader as JCatalogReader
from repro.service import ColumnCatalog as JColumnCatalog
from repro.service import DiscoveryEngine as JDiscoveryEngine
from repro.service import DiscoveryRequest as JDiscoveryRequest
from repro.service import EngineConfig as JEngineConfig
from repro.service import LSHConfig as JLSHConfig
from repro.service import LSHIndex as JLSHIndex
from repro.service import add_lake as jadd_lake
from repro.service.lsh import measure_tradeoff as jmeasure_tradeoff
from repro_torch.convert import profiles_from_jax
from repro_torch.core import lakegen
from repro_torch.core import sketches
from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import select_queries
from repro_torch.core.predictor import train_quality_model
from repro_torch.core.profiles import profile_lake
from repro_torch.launch.mesh import DeviceMesh
from repro_torch.kernels import ref
from repro_torch.kernels.minhash import make_permutations
from repro_torch.launch import costmodel
from repro_torch.service import (CatalogReader, ColumnCatalog, DiscoveryEngine,
                                 DiscoveryRequest, EngineConfig, LSHConfig,
                                 LSHIndex, add_lake, band_keys, measure_recall,
                                 serve_discovery)
from repro_torch.service.catalog import manifest_delta
from repro_torch.service.lsh import measure_tradeoff

from _torch_service import assert_same_responses, model_pair, tiny_model

SMALL_LAKE = dict(n_domains=10, n_tables=24, row_budget=2048, rows_log_mean=6.8,
                  coverage_range=(0.5, 1.0), gran_ratio=(4, 8), seed=7)
BENCH = os.path.join(os.path.dirname(__file__), "..", "BENCH_service.json")


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model) with the same trees, trained by the port."""
    lake = lakegen.generate_lake(lakegen.LakeSpec(**SMALL_LAKE))
    return model_pair(train_quality_model([lake], GBDTConfig(n_trees=30, depth=4),
                                          n_query=64, device="cpu"))


@pytest.fixture(scope="module")
def catalog_dir(small_lake, tmp_path_factory):
    """The small lake written by the JAX package's catalog store."""
    root = str(tmp_path_factory.mktemp("jax_catalog"))
    jadd_lake(JColumnCatalog(root, n_perm=128), small_lake)
    return root


def _store(root, **kw):
    return ColumnCatalog(root, device="cpu", **kw)


def _engine(root, model, **cfg):
    return DiscoveryEngine.from_catalog(_store(root), model, EngineConfig(**cfg),
                                        device="cpu")


# ---------------------------------------------------------------------------
# one catalog, both packages
# ---------------------------------------------------------------------------

def _assert_same_snapshot(got, want, numeric_tol=0.0):
    assert got.version == want.version and got.n_columns == want.n_columns
    if numeric_tol:
        np.testing.assert_allclose(got.profiles.numeric, want.profiles.numeric,
                                   atol=numeric_tol, rtol=numeric_tol)
    else:
        assert np.array_equal(got.profiles.numeric, want.profiles.numeric)
        for f in ("mean", "std"):
            assert np.array_equal(getattr(got.profiles, f), getattr(want.profiles, f))
    for f in ("words", "n_rows"):
        assert np.array_equal(getattr(got.profiles, f), getattr(want.profiles, f)), f
    assert np.array_equal(got.signatures, want.signatures)
    assert np.array_equal(got.table_ids, want.table_ids)
    assert got.names == want.names and got.table_names == want.table_names
    assert got.minhash_seed == want.minhash_seed


def _history(store, add):
    """A lake (one segment a table, through the package's ``add_lake``),
    adds, a drop and a re-sign compaction that keeps the last versions
    materializable, then one more add."""
    add(store, lakegen.generate_lake(lakegen.LakeSpec(n_domains=3, n_tables=3,
                                                      row_budget=64, seed=1)))
    store.add_table("a", [("x", [f"v{i}" for i in range(50)]),
                          ("y", [f"w{i % 7}" for i in range(50)])])
    store.add_table("b", [("z", [f"v{i}" for i in range(30, 90)])])
    store.add_table("c", [("u", [f"city_{i % 60}" for i in range(600)])])
    store.drop_table("b")
    store.compact(n_perm=96, minhash_seed=3, retain_versions=2)
    store.add_table("d", [("t", [f"v{i}" for i in range(10, 40)])])


def test_port_reads_every_version_of_a_jax_catalog(tmp_path):
    root = str(tmp_path)
    _history(JColumnCatalog(root, n_perm=64), jadd_lake)
    jr, tr = JCatalogReader(root), CatalogReader(root)
    seen = 0
    for v in range(tr.version + 1):
        try:
            want = jr.snapshot(v)
        except KeyError:                    # compacted away in both
            with pytest.raises(KeyError, match="compacted away"):
                tr.snapshot(v)
            continue
        _assert_same_snapshot(tr.snapshot(v), want)
        assert tr.manifest(v) == jr.manifest(v)
        seen += 1
    assert seen >= 6
    _assert_same_snapshot(CatalogReader(root).snapshot(lazy=False),
                          JCatalogReader(root).snapshot(lazy=False))


def test_jax_reads_a_port_catalog(tmp_path):
    """A catalog the port writes opens in the JAX reader, equal to the one
    the JAX store writes with the same operations: words, signatures, ids
    and manifests exactly (up to the segments' random names), numeric
    profiles within 4.8e-7 absolute or relative (a few float32 ulp: the
    two packages sum the profile statistics in different orders)."""
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    _history(_store(port_root, n_perm=64), add_lake)
    _history(JColumnCatalog(jax_root, n_perm=64), jadd_lake)
    jp, jj = JCatalogReader(port_root), JCatalogReader(jax_root)
    assert jp.version == jj.version
    for v in (jp.version - 1, jp.version):
        _assert_same_snapshot(jp.snapshot(v), jj.snapshot(v), numeric_tol=4.8e-7)
        mp, mj = jp.manifest(v), jj.manifest(v)
        drop = lambda m: {k: x for k, x in m.items() if k not in ("segments", "retired")}
        assert drop(mp) == drop(mj)
        assert len(mp["segments"]) == len(mj["segments"])


_MODES = ("full", "lsh", "tiered", "auto")


@pytest.mark.parametrize("dtype", ["fp32", "int8"])
@pytest.mark.parametrize("mode", _MODES)
def test_both_engines_serve_one_catalog(catalog_dir, models, small_lake, mode, dtype):
    """The JAX and the port's engines over the same directory: equal ids up
    to exact ties, equal ``n_candidates``, scores within the scorer
    tolerance, for resident requests and uploaded raw columns."""
    model, jmodel = models
    lsh = dict(n_bands=64, n_coarse_bands=16)
    want_eng = JDiscoveryEngine(JCatalogReader(catalog_dir).snapshot(), jmodel,
                                JEngineConfig(k=10, mode=mode, profile_dtype=dtype,
                                              lsh=JLSHConfig(**lsh)))
    got_eng = DiscoveryEngine(CatalogReader(catalog_dir).snapshot(), model,
                              EngineConfig(k=10, mode=mode, profile_dtype=dtype,
                                           lsh=LSHConfig(**lsh)), device="cpu")
    qids = select_queries(small_lake, 10)
    uploads = [[f"city_{i % 60}" for i in range(300)],
               [f"tok{(7 * i) % 41}" for i in range(150)]]

    def requests(R):
        return ([R(name=f"q{int(q)}", column_id=int(q)) for q in qids]
                + [R(name=f"up{i}", values=v) for i, v in enumerate(uploads)])

    assert_same_responses(want_eng.query_batch(requests(JDiscoveryRequest)),
                          got_eng.query_batch(requests(DiscoveryRequest)), k=10)
    assert got_eng.stats()["last_plan"]["kind"] == want_eng.stats()["last_plan"]["kind"]


# ---------------------------------------------------------------------------
# index deltas (tests/test_ingest.py:89-116)
# ---------------------------------------------------------------------------

def _rand_sigs(n_cols, n_perm, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** 32, size=(n_cols, n_perm), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("n_perm,n_bands", [(128, 64), (96, 7)])
def test_lsh_extend_matches_fresh_build(n_perm, n_bands):
    cfg = LSHConfig(n_bands=n_bands, n_coarse_bands=4)
    a, b = _rand_sigs(37, n_perm, seed=1), _rand_sigs(11, n_perm, seed=2)
    fresh = LSHIndex.build(np.concatenate([a, b]), cfg)
    delta = LSHIndex.build(a, cfg).extend(b)
    jdelta = JLSHIndex.build(a, JLSHConfig(n_bands=n_bands, n_coarse_bands=4)).extend(b)
    for got in (delta.keys, jdelta.keys):
        np.testing.assert_array_equal(got, fresh.keys)
    for got in (delta.coarse, jdelta.coarse):
        np.testing.assert_array_equal(got, fresh.coarse)
    assert LSHIndex.build(a, cfg).extend(b[:0]).keys.shape == (37, n_bands)


def test_lsh_retract_then_extend_matches_fresh_build():
    cfg = LSHConfig(n_bands=16, n_coarse_bands=2)
    a, c = _rand_sigs(29, 64, seed=3), _rand_sigs(9, 64, seed=4)
    keep = np.ones(29, bool)
    keep[[2, 7, 21]] = False
    fresh = LSHIndex.build(np.concatenate([a[keep], c]), cfg)
    delta = LSHIndex.build(a, cfg).retract(keep).extend(c)
    jdelta = JLSHIndex.build(a, JLSHConfig(n_bands=16, n_coarse_bands=2)).retract(keep).extend(c)
    for got in (delta, jdelta):
        np.testing.assert_array_equal(got.keys, fresh.keys)
        np.testing.assert_array_equal(got.coarse, fresh.coarse)
    with pytest.raises(ValueError):
        LSHIndex.build(a, cfg).retract(keep[:5])


def test_manifest_delta_prefix_rule():
    old = {"n_perm": 64, "minhash_seed": 1, "dropped_ids": [], "segments": ["s0", "s1"]}
    new = dict(old, segments=["s0", "s1", "s2"])
    assert manifest_delta(old, new) == ["s2"]
    assert manifest_delta(old, old) == []
    assert manifest_delta(old, dict(new, dropped_ids=[3])) is None
    assert manifest_delta(old, dict(new, segments=["sX", "s1", "s2"])) is None
    assert manifest_delta(None, new) is None


def test_probe_fractions_and_tradeoff_match_jax(catalog_dir, small_lake, models):
    snap = CatalogReader(catalog_dir).snapshot()
    idx = LSHIndex.build(snap.signatures, LSHConfig(n_bands=32, n_coarse_bands=8))
    jidx = JLSHIndex.build(snap.signatures, JLSHConfig(n_bands=32, n_coarse_bands=8))
    rows = np.arange(0, 30, 3)
    assert idx.candidate_fraction(idx.keys[rows], device="cpu") == \
        jidx.candidate_fraction(jidx.keys[rows])
    assert idx.coarse_fraction(idx.coarse[rows], device="cpu") == \
        jidx.coarse_fraction(jidx.coarse[rows])
    index = DiscoveryIndex(profiles=profiles_from_jax(snap.profiles), model=models[0],
                           table_ids=snap.table_ids)
    _, top_ids = rank(index, rows, k=10, device="cpu")
    curve = measure_tradeoff(snap.signatures, top_ids, rows, band_choices=(16, 32, 64),
                             device="cpu")
    assert curve == jmeasure_tradeoff(snap.signatures, top_ids, rows,
                                      band_choices=(16, 32, 64))
    fracs = [p["candidate_fraction"] for p in curve]
    assert fracs == sorted(fracs)                  # more bands -> larger sets
    assert curve[-1]["recall"] >= curve[0]["recall"]


# ---------------------------------------------------------------------------
# the leftovers of the earlier slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("idx", [3, slice(2, 9), slice(0, 0), np.array([[0, 2], [5, 1]]),
                                 np.array([], np.int64), np.array([7, 7, 0])])
def test_zscore_view_matches_jax(small_profiles, idx):
    prof = profiles_from_jax(small_profiles)
    view, jview = prof.zscored_view(), small_profiles.zscored_view()
    assert view.shape == jview.shape and len(view) == len(jview)
    got, want = view[idx], jview[idx]
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(got, prof.zscored.astype(np.float32)[idx])


def test_sketch_metrics_match_jax(small_lake):
    sk = small_lake.sketches[:12]
    for a in sk[:4]:
        for b in sk:
            assert sketches.intersections_np(a, b) == jsketches.intersections_np(a, b)
            assert sketches.pair_metrics_np(a, b) == jsketches.pair_metrics_np(a, b)
    empty = ColumnSketch(values=np.zeros((0,), np.uint64), counts=np.zeros((0,), np.int64),
                         n_rows=0)
    assert sketches.pair_metrics_np(empty, sk[0]) == jsketches.pair_metrics_np(empty, sk[0])
    packed, jpacked = sketches.pack_sketches(sk), jsketches.pack_sketches(sk)
    assert packed.nbytes() == jpacked.nbytes() > 0


def test_minhash_jaccard_ref_matches_jax():
    import torch
    a, b = make_permutations(256, 0)
    n = 4000
    vals = np.stack([np.arange(n, dtype=np.uint32),
                     np.arange(n // 2, n + n // 2, dtype=np.uint32)])
    sig = ref.minhash_ref(torch.from_numpy(vals.astype(np.int64)),
                          torch.from_numpy(a.astype(np.int64)),
                          torch.from_numpy(b.astype(np.int64)))
    got = float(ref.minhash_jaccard_ref(sig[0], sig[1]))
    want = float(jref.minhash_jaccard_ref(jnp.asarray(sig[0].numpy().astype(np.uint32)),
                                          jnp.asarray(sig[1].numpy().astype(np.uint32))))
    assert got == want and abs(got - 1 / 3) < 0.08
    batch = ref.minhash_jaccard_ref(sig[None], sig[None])
    assert batch.shape == (1, 2) and bool((batch == 1.0).all())


def test_cost_model_calibration_matches_jax():
    constants, fn = costmodel.calibrate_stage_costs(BENCH)
    jconstants, jfn = jcostmodel.calibrate_stage_costs(BENCH)
    assert constants == jconstants
    for cand in ("all", "hybrid", "lsh", "tiered"):
        kw = dict(budget=2048, candidates=cand, survivor_budget=2048 if cand == "tiered" else 0)
        assert fn(64, 100_000, **kw) == jfn(64, 100_000, **kw)
    assert costmodel.derive_batch_buckets(BENCH) == jcostmodel.derive_batch_buckets(BENCH)
    assert costmodel.derive_column_buckets(BENCH) == jcostmodel.derive_column_buckets(BENCH)
    rec = {"scale_sweep": {"lakes": [{"n_columns": 900}, {"n_columns": 70_000}]}}
    assert costmodel.derive_column_buckets(rec) == jcostmodel.derive_column_buckets(rec)
    with pytest.raises(ValueError, match=">= 4 timed"):
        costmodel.calibrate_stage_costs({"lakes": []})


# ---------------------------------------------------------------------------
# catalog (tests/test_service.py)
# ---------------------------------------------------------------------------

def test_catalog_persists_and_restarts(small_lake, tmp_path):
    root = str(tmp_path)
    add_lake(_store(root, n_perm=128), small_lake)
    reopened = _store(root)
    snap = reopened.snapshot()
    assert snap.n_columns == small_lake.n_columns == len(snap.names)
    assert snap.signatures.shape == (small_lake.n_columns, 128)
    assert len(reopened.tables()) == len(np.unique(small_lake.batch.table_ids))
    prof = profile_lake(small_lake.batch, device="cpu")
    np.testing.assert_allclose(snap.profiles.numeric, prof.numeric, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(snap.profiles.words, prof.words)


def test_catalog_incremental_add_drop_compact(tmp_path):
    cat = _store(str(tmp_path), n_perm=64)
    cat.add_table("a", [("x", [f"v{i}" for i in range(50)]),
                        ("y", [f"w{i % 7}" for i in range(50)])])
    cat.add_table("b", [("z", [f"v{i}" for i in range(30)])])
    assert cat.snapshot().n_columns == 3
    with pytest.raises(ValueError):
        cat.add_table("a", [("dup", ["1"])])
    cat.drop_table("a")
    snap = cat.snapshot()
    assert snap.n_columns == 1 and snap.names == ["z"]
    n_seg_before = len(cat.manifest["segments"])
    cat.compact()
    assert len(cat.manifest["segments"]) == 1
    snap2 = cat.snapshot()
    assert snap2.n_columns == 1 and snap2.names == ["z"]
    np.testing.assert_array_equal(snap.signatures, snap2.signatures)
    segs = [d for d in os.listdir(str(tmp_path)) if d.startswith("seg-")]
    assert len(segs) == 1 and n_seg_before > 1
    with pytest.raises(KeyError):
        cat.drop_table("nope")


def test_catalog_empty_snapshot(tmp_path):
    snap = _store(str(tmp_path)).snapshot()
    assert snap.n_columns == 0
    eng = DiscoveryEngine(snap, tiny_model(), device="cpu")
    assert eng.query(DiscoveryRequest(values=["a", "b"])).matches == []


def test_band_keys_shape_determinism_and_bounds(catalog_dir):
    snap = CatalogReader(catalog_dir).snapshot()
    k1 = band_keys(snap.signatures, 64)
    assert k1.shape == (snap.n_columns, 64)
    np.testing.assert_array_equal(k1, band_keys(snap.signatures, 64))
    assert (band_keys(snap.signatures[:1], 64) == k1[:1]).all()
    assert (k1[0] != k1[1]).any()
    with pytest.raises(ValueError):
        band_keys(np.zeros((2, 16), np.uint32), 32)


def test_compact_resigns_signatures(tmp_path):
    cat = _store(str(tmp_path), n_perm=64, minhash_seed=0)
    cat.add_table("a", [("x", [f"v{i}" for i in range(100)]),
                        ("y", [f"w{i % 9}" for i in range(50)])])
    cat.add_table("b", [("z", [f"v{i}" for i in range(40, 140)])])
    cat.drop_table("b")
    assert cat.snapshot().signatures.shape == (2, 64)
    cat.compact(n_perm=128, minhash_seed=3)
    assert cat.n_perm == 128
    snap = cat.snapshot()
    assert snap.n_columns == 2 and snap.names == ["x", "y"]
    assert snap.signatures.shape == (2, 128) and snap.minhash_seed == 3
    # bit-exact vs the JAX package re-signing the surviving stored values
    from repro.kernels import ops as jops
    seg = cat.manifest["segments"][0]
    vals = np.load(os.path.join(str(tmp_path), seg, "values.npy"))
    np.testing.assert_array_equal(snap.signatures,
                                  np.asarray(jops.minhash(vals, n_perm=128, seed=3)))
    assert _store(str(tmp_path)).n_perm == 128
    cat.compact()
    np.testing.assert_array_equal(cat.snapshot().signatures, snap.signatures)


def test_compact_resign_requires_stored_values(tmp_path):
    cat = _store(str(tmp_path), n_perm=64)
    cat.add_table("a", [("x", [f"v{i}" for i in range(30)])])
    os.remove(os.path.join(str(tmp_path), cat.manifest["segments"][0], "values.npy"))
    with pytest.raises(ValueError, match="predate value storage"):
        cat.compact(n_perm=128)
    cat.compact()
    assert cat.snapshot().signatures.shape == (1, 64)


def test_compact_preserves_resign_source_across_legacy_merge(tmp_path):
    cat = _store(str(tmp_path), n_perm=64)
    cat.add_table("a", [("x", [f"v{i}" for i in range(30)])])
    cat.add_table("b", [("y", [f"w{i}" for i in range(20)])])
    os.remove(os.path.join(str(tmp_path), cat.manifest["segments"][1], "values.npy"))
    cat.compact()
    seg = cat.manifest["segments"][0]
    valid = np.load(os.path.join(str(tmp_path), seg, "values_valid.npy"))
    assert valid.tolist() == [True, False]
    with pytest.raises(ValueError, match="predate value storage"):
        cat.compact(n_perm=128)
    cat.drop_table("b")
    cat.compact(n_perm=128, minhash_seed=5)
    snap = cat.snapshot()
    assert snap.names == ["x"]
    assert snap.signatures.shape == (1, 128) and snap.minhash_seed == 5


# ---------------------------------------------------------------------------
# engine (tests/test_service.py)
# ---------------------------------------------------------------------------

def test_end_to_end_service(small_lake, models, tmp_path):
    """Persist → restart → incremental add → serve a batch with recall@10
    ≥ 0.9 against the full scan while scoring < 25% of the lake."""
    model = models[0]
    root = str(tmp_path)
    add_lake(_store(root, n_perm=128), small_lake)
    engine = _engine(root, model, k=10, mode="lsh", lsh=LSHConfig(n_bands=64),
                     candidate_frac=0.2)
    n0 = engine.n_columns
    assert n0 == small_lake.n_columns
    catalog = _store(root)
    catalog.add_table("incremental", [("inc_a", [f"v{i}" for i in range(400)]),
                                      ("inc_b", [f"u{i % 13}" for i in range(200)])])
    engine.refresh(catalog.snapshot())
    assert engine.n_columns == n0 + 2
    qids = select_queries(small_lake, 16)
    reqs = [DiscoveryRequest(name=f"q{int(q)}", column_id=int(q)) for q in qids]
    responses = list(serve_discovery(engine, reqs, max_batch=8))
    assert [r.name for r in responses] == [r.name for r in reqs]
    for r in responses:
        assert r.n_candidates < 0.25 * engine.n_columns
        assert all(np.isfinite(m.score) for m in r.matches)
    rec = measure_recall(engine, qids, k=10)
    assert rec["recall"] >= 0.9, rec
    assert rec["scored_fraction"] < 0.25, rec


def test_engine_lru_cache_and_eviction(catalog_dir, models):
    engine = _engine(catalog_dir, models[0], k=5)
    req = DiscoveryRequest(name="q", column_id=3)
    r1 = engine.query(req)
    r2 = engine.query(DiscoveryRequest(name="q2", column_id=3))
    assert not r1.cached and r2.cached
    assert [m.column_id for m in r1.matches] == [m.column_id for m in r2.matches]
    engine.refresh(engine.snapshot)                  # refresh invalidates
    assert engine.query(req).cached is False
    small = _engine(catalog_dir, models[0], k=3, cache_entries=4)
    for cid in range(8):
        small.query(DiscoveryRequest(column_id=cid))
    assert len(small._cache) == 4
    assert small.query(DiscoveryRequest(column_id=0)).cached is False
    assert small.query(DiscoveryRequest(column_id=7)).cached is True


def test_engine_external_query_matches_resident(small_lake, models, tmp_path):
    root = str(tmp_path)
    cat = _store(root, n_perm=128)
    add_lake(cat, small_lake)
    cat.add_table("strtab", [("cities", [f"city_{i % 60}" for i in range(600)])])
    engine = _engine(root, models[0], k=5)
    r = engine.query(DiscoveryRequest(name="upload",
                                      values=[f"city_{i % 60}" for i in range(300)]))
    assert any(m.column == "cities" for m in r.matches), r.matches


def test_engine_full_mode_matches_core_rank(catalog_dir, models, small_lake):
    snap = CatalogReader(catalog_dir).snapshot()
    engine = DiscoveryEngine(snap, models[0], EngineConfig(k=5, mode="full"), device="cpu")
    index = DiscoveryIndex(profiles=snap.profiles, model=models[0], table_ids=snap.table_ids)
    qids = select_queries(small_lake, 6)
    scores, ids = rank(index, qids, k=5, device="cpu")
    responses = engine.query_batch([DiscoveryRequest(column_id=int(q)) for q in qids])
    for row, resp in enumerate(responses):
        assert [m.column_id for m in resp.matches] == \
            [int(i) for i, s in zip(ids[row], scores[row]) if np.isfinite(s)]


def test_request_validation():
    with pytest.raises(ValueError):
        DiscoveryRequest()
    with pytest.raises(ValueError):
        DiscoveryRequest(column_id=1, values=["a"])


def test_engine_stats_expose_plan_and_cache(catalog_dir, models):
    engine = _engine(catalog_dir, models[0], k=5, mode="lsh")
    engine.query(DiscoveryRequest(column_id=1))
    engine.query(DiscoveryRequest(column_id=1))        # cache hit
    engine.query(DiscoveryRequest(column_id=2))
    s = engine.stats()
    assert s["queries"] == 3
    assert s["cache"]["hits"] == 1 and s["cache"]["misses"] == 2
    assert s["cache"]["admitted"] == 2
    assert s["plans"] == {"local-hybrid": 2}
    assert s["last_plan"]["kind"] == "local-hybrid"
    assert s["last_plan"]["grid"] == [1, 1] and s["last_plan"]["n_shards"] == 1
    assert s["last_plan"]["cost"]["total_flops"] > 0
    assert s["last_plan"]["budget"] == engine.candidate_budget


def test_engine_cache_cost_aware_admission(catalog_dir, models):
    engine = _engine(catalog_dir, models[0], cache_entries=2)
    engine._cache_admit([b"full-scan"], [["A"]], 100.0)
    engine._cache_admit([b"pruned"], [["B"]], 40.0)
    engine._cache_admit([b"cheap"], [["C"]], 10.0)
    assert b"cheap" not in engine._cache
    assert engine.stats()["cache"]["rejected"] == 1
    engine._cache_admit([b"mid"], [["D"]], 60.0)
    assert set(engine._cache) == {b"full-scan", b"mid"}
    assert engine.stats()["cache"]["evicted"] == 1
    off = _engine(catalog_dir, models[0], cache_entries=0)
    assert not off.query(DiscoveryRequest(column_id=3)).cached
    assert not off.query(DiscoveryRequest(column_id=3)).cached


_ADMISSION_COSTS = (0.0, 1.0, 1.0, 2.5, 4.0)      # drawn with ties, 0.0 among them


def _admission_trace(seed, cap, n_steps=300):
    """A seeded trace of cache calls: ("put", key, cost), ("admit", keys,
    cost) (a batch's admissions at one cost, in order) and ("get", key).
    Puts re-put keys at their cost and at a new one, and admit new
    keys; gets ask for keys put before and for keys never put."""
    rng = np.random.default_rng(seed)
    pool = [b"k%d" % i for i in range(2 * cap + 3)]
    seen: dict[bytes, float] = {}                 # the keys put so far, at their last cost
    trace = []
    for _ in range(n_steps):
        r = rng.random()
        if r < 0.15:
            keys = [pool[j] for j in rng.integers(len(pool), size=rng.integers(1, 7))]
            cost = float(_ADMISSION_COSTS[rng.integers(len(_ADMISSION_COSTS))])
            seen.update(dict.fromkeys(keys, cost))
            trace.append(("admit", keys, cost))
        elif r < 0.6 or not seen:
            key = pool[rng.integers(len(pool))]
            if key in seen and rng.random() < 0.5:
                cost = seen[key]               # the same cost again
            else:
                cost = float(_ADMISSION_COSTS[rng.integers(len(_ADMISSION_COSTS))])
            seen[key] = cost
            trace.append(("put", key, cost))
        elif r < 0.8:
            trace.append(("get", list(seen)[rng.integers(len(seen))]))
        else:
            trace.append(("get", pool[rng.integers(len(pool))] + b"?"))
    return trace


_ADMISSION_COUNTERS = ("cache_admitted", "cache_rejected", "cache_evicted")


@pytest.mark.parametrize("cap", [1, 2, 8, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_admission_matches_jax(catalog_dir, models, seed, cap):
    """The port's indexed admission against the JAX engine's walk
    (src/repro/service/engine.py:983-1015), one entry or a batch's entries
    at a time, on one seeded trace: the same entries in the same order, the
    same hits and the same counters after every step, one victim inspected
    an admission into a full cache, one cost level a resident cost; and
    after refresh, re-admitting a formerly resident key evicts nothing."""
    model, jmodel = models
    want = JDiscoveryEngine(JCatalogReader(catalog_dir).snapshot(), jmodel,
                            JEngineConfig(cache_entries=cap))
    got = _engine(catalog_dir, model, cache_entries=cap)
    for step, call in enumerate(_admission_trace(seed, cap)):
        if call[0] == "put":
            _, key, cost = call
            full = key not in got._cache and len(got._cache) >= cap
            want._cache_put(key, [step], cost)
            assert got._cache_admit([key], [[step]], cost) == int(full)
        elif call[0] == "admit":
            _, keys, cost = call
            full = 0
            for key in keys:
                full += key not in want._cache and len(want._cache) >= cap
                want._cache_put(key, [step, key], cost)
            assert got._cache_admit(keys, [[step, k] for k in keys], cost) == full
        else:
            assert got._cache_get(call[1]) == want._cache_get(call[1])
        assert list(got._cache.items()) == list(want._cache.items()), (step, call)
        for name in _ADMISSION_COUNTERS:
            assert got._counters[name] == want._counters[name], (step, name)
        assert got.stats()["cache"]["cost_levels"] == \
            len({c for _, c in got._cache.values()})
    assert got._counters["cache_evicted"] > 0
    before = list(got._cache)
    evicted = got._counters["cache_evicted"]
    got.refresh(got.snapshot)
    assert len(got._cache) == 0 and got.stats()["cache"]["cost_levels"] == 0
    for key in before:
        assert got._cache_admit([key], [["again"]], 1.0) == 0
    assert list(got._cache) == before
    assert got._counters["cache_evicted"] == evicted


def test_engine_auto_mode_plans_by_cost(catalog_dir, models, tmp_path):
    big = _engine(catalog_dir, models[0], k=10, mode="auto")
    big.query(DiscoveryRequest(column_id=0))
    assert big.stats()["last_plan"]["kind"] == "local-hybrid"
    tiny_cat = _store(str(tmp_path), n_perm=128)
    tiny_cat.add_table("t", [("x", [f"v{i}" for i in range(40)]),
                             ("y", [f"w{i}" for i in range(40)])])
    tiny = _engine(str(tmp_path), models[0], k=10, mode="auto")
    tiny.query(DiscoveryRequest(column_id=0))
    assert tiny.stats()["last_plan"]["kind"] == "local-all"


def test_resigned_catalog_still_serves(small_lake, models, tmp_path):
    root = str(tmp_path)
    cat = _store(root, n_perm=64, minhash_seed=0)
    add_lake(cat, small_lake)
    cat.compact(n_perm=128, minhash_seed=11)
    engine = _engine(root, models[0], k=10, mode="lsh", lsh=LSHConfig(n_bands=64))
    rec = measure_recall(engine, select_queries(small_lake, 8), k=10)
    assert rec["recall"] >= 0.9, rec
    assert rec["scored_fraction"] < 0.25, rec


# ---------------------------------------------------------------------------
# sharded serving (tests/test_service.py:247)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,shape", [
    (dict(mode="sharded"), dict(data=8, model=1)),
    (dict(mode="sharded", grid=(2, 4)), dict(data=8, model=1)),
    (dict(mode="sharded", shard_axes=("pod", "data")), dict(pod=2, data=4, model=1))])
def test_sharded_engine_matches_jax(catalog_dir, models, small_lake, cfg, shape):
    """The port's engine over eight host devices (a pinned (2, 4) grid, and a
    two-axis ("pod", "data") placement among them) against the JAX engine's
    sharded scan over its one host device: the full scan is the same on
    every geometry, so responses agree up to exact ties, with equal
    ``n_candidates``, for resident and uploaded columns."""
    import jax
    model, jmodel = models
    mesh = DeviceMesh(np.full(tuple(shape.values()), torch.device("cpu"), dtype=object),
                      tuple(shape))
    jmesh = jax.make_mesh((1,) * len(shape), tuple(shape))
    jcfg = {k: v for k, v in cfg.items() if k != "grid"}
    want_eng = JDiscoveryEngine(JCatalogReader(catalog_dir).snapshot(), jmodel,
                                JEngineConfig(k=10, **jcfg), mesh=jmesh)
    got_eng = DiscoveryEngine(CatalogReader(catalog_dir).snapshot(), model,
                              EngineConfig(k=10, **cfg), mesh=mesh)
    qids = select_queries(small_lake, 10)
    upload = [f"city_{i % 60}" for i in range(300)]

    def requests(R):
        return ([R(name=f"q{int(q)}", column_id=int(q)) for q in qids]
                + [R(name="up", values=upload)])

    assert_same_responses(want_eng.query_batch(requests(JDiscoveryRequest)),
                          got_eng.query_batch(requests(DiscoveryRequest)), k=10)
    last = got_eng.stats()["last_plan"]
    assert last["kind"] == want_eng.stats()["last_plan"]["kind"] == "sharded-all"
    assert last["grid"][0] * last["grid"][1] == 8
    if "grid" in cfg:
        assert tuple(last["grid"]) == cfg["grid"]
    got_eng.close()


def test_executable_cache_dir_is_refused(catalog_dir, models, tmp_path):
    with pytest.raises(NotImplementedError, match="no executables to serialize"):
        _engine(catalog_dir, models[0], executable_cache_dir=str(tmp_path))


# ---------------------------------------------------------------------------
# the service branches of launch/discover.py
# ---------------------------------------------------------------------------

_SMALL_CLI = ["--device", "cpu", "--tables", "6", "--domains", "3", "--queries", "4"]


def test_discover_serves_follows_and_reuses_a_catalog(tmp_path, capsys):
    from repro_torch.launch import discover
    root = str(tmp_path / "cat")
    args = _SMALL_CLI + ["--catalog", root, "--serve", "--warmup", "serve"]
    discover.main(args + ["--mode", "tiered"])
    out = capsys.readouterr().out
    assert "catalog: ingested 6 tables" in out and "warmup[serve]" in out
    assert "served 4 queries" in out and "plan: local-tiered" in out
    # the second run reuses the catalog and follows a concurrent append
    discover.main(args + ["--follow"])
    out = capsys.readouterr().out
    assert "catalog: reusing 6 tables" in out and "plan: local-hybrid" in out
    assert "follower: observed version 7 (was 6)" in out
    assert JCatalogReader(root).version == 7      # the JAX reader opens it


def _jax_discover(monkeypatch, argv):
    """The JAX CLI, which reads ``sys.argv``."""
    from repro.launch import discover as jdiscover
    monkeypatch.setattr(sys, "argv", ["discover", *argv])
    jdiscover.main()


def _discover_lines(main, argv, capsys, prefixes):
    main(argv)
    return [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(prefixes)]


def test_discover_mesh_grid_matches_jax(tmp_path, capsys, monkeypatch):
    """``--mesh --grid 1x1 --mode sharded`` on the host's one device: the
    mesh, the grid and the executed plan as the JAX CLI prints them."""
    from repro_torch.launch import discover
    flags = ["--serve", "--mesh", "--grid", "1x1", "--mode", "sharded"]
    keep = ("mesh:", "grid:", "plan:")
    want = _discover_lines(lambda a: _jax_discover(monkeypatch, a), _SMALL_CLI[2:] + flags + [
        "--catalog", str(tmp_path / "j")], capsys, keep)
    got = _discover_lines(discover.main, _SMALL_CLI + flags + [
        "--catalog", str(tmp_path / "t")], capsys, keep)
    assert want[:2] == got[:2] == ["mesh: {'data': 1, 'model': 1} (1 devices)",
                                   "grid: 1 query shards x 1 data shards"]
    plan = lambda ln: ln.split(" (~")[0]          # kind, budget, grid
    assert plan(got[2]) == plan(want[2])
    assert plan(got[2]).startswith("plan: sharded-all") and "grid=1x1" in got[2]


@pytest.mark.parametrize("flags", [["--grid", "2x4"], ["--grid", "2by4", "--mesh"],
                                   ["--mode", "sharded"]])
def test_discover_sharded_errors_match_jax(tmp_path, flags, monkeypatch):
    """``--grid`` without ``--mesh``, a malformed grid, and ``--mode
    sharded`` without a mesh fail as the JAX CLI fails, with its message."""
    from repro_torch.launch import discover
    argv = ["--serve", "--catalog", str(tmp_path / "c")] + flags
    with pytest.raises((SystemExit, ValueError)) as want:
        _jax_discover(monkeypatch, _SMALL_CLI[2:] + argv)
    with pytest.raises(want.type) as got:
        discover.main(_SMALL_CLI + argv)
    assert str(got.value) == str(want.value)
