"""The port's query path against the JAX package on the CPU: training data
and trees, the planner, the executor's all/lsh/hybrid pipelines and
``rank``, and the precision of a model the port trains itself."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
from repro.core import GBDTConfig as JGBDTConfig
from repro.core import DiscoveryIndex as JDiscoveryIndex
from repro.core import rank as jax_rank
from repro.core import train_quality_model as jax_train
from repro.core.gbdt import fit_gbdt as jax_fit_gbdt
from repro.core.predictor import JoinQualityModel as JJoinQualityModel
from repro.core.predictor import build_training_set as jax_build_training_set
from repro.core.predictor import gbdt_predict_ref as jax_gbdt_predict_ref
from repro.kernels import ref as jref
from repro.kernels.minhash import make_permutations as jax_make_permutations
from repro.service import lsh as jlsh
from repro_torch.convert import gbdt_from_jax, profiles_from_jax
from repro_torch.core import lakegen
from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTConfig, fit_gbdt
from repro_torch.core.predictor import (JoinQualityModel, build_training_set,
                                        gbdt_predict_ref, gbdt_to_torch,
                                        train_quality_model)
from repro_torch.core.profiles import profile_lake
from repro_torch.exec.executor import Executor, pad_rows, pad_topk
from repro_torch.exec.plan import Planner, PlannerConfig, QueryPlan

SMALL_LAKE = dict(n_domains=10, n_tables=24, row_budget=2048, rows_log_mean=6.8,
                  coverage_range=(0.5, 1.0), gran_ratio=(4, 8), seed=7)


def _assert_same_ranking(s_ref, i_ref, s, i, tol=1e-4):
    """Ranked output equal up to the order of exact score ties (the
    comparator of tests/test_grid.py)."""
    s_ref, i_ref = np.asarray(s_ref), np.asarray(i_ref)
    s, i = np.asarray(s), np.asarray(i)
    assert s.shape == s_ref.shape and i.shape == i_ref.shape
    both = np.isfinite(s) & np.isfinite(s_ref)
    assert (np.isfinite(s) == np.isfinite(s_ref)).all()
    np.testing.assert_allclose(s[both], s_ref[both], rtol=tol, atol=tol)
    for row in range(s.shape[0]):
        a = {int(x) for x in i_ref[row] if x >= 0}
        b = {int(x) for x in i[row] if x >= 0}
        for side, (ids, sc, other_sc) in enumerate(
                ((i_ref[row], s_ref[row], s[row]),
                 (i[row], s[row], s_ref[row]))):
            diff = (a - b) if side == 0 else (b - a)
            for d in diff:
                sd = sc[list(ids).index(d)]
                near = np.min(np.abs(other_sc[np.isfinite(other_sc)] - sd))
                assert near <= tol * max(1.0, abs(sd)), (
                    f"row {row}: id {d} (score {sd}) in one ranking has no "
                    f"tied score in the other (closest {near})")


@pytest.fixture(scope="module")
def jax_model(small_lake):
    return jax_train([small_lake], JGBDTConfig(n_trees=20, depth=4), n_query=48)


@pytest.fixture(scope="module")
def port_lake():
    return lakegen.generate_lake(lakegen.LakeSpec(**SMALL_LAKE))


@pytest.fixture(scope="module")
def corpus(small_lake, small_profiles, jax_model):
    """Shared inputs of both executors: z-scored profiles, words, table ids,
    band keys from reference signatures, and a query batch."""
    a, b = jax_make_permutations(64, 0)
    sigs = np.asarray(jref.minhash_ref(small_lake.batch.values32, a, b))
    keys = jlsh.band_keys(sigs, 64)       # single-row bands: many hits
    qids = np.asarray([0, 3, 17, 40, 41, 90, 120, 150], np.int32)
    z = small_profiles.zscored.astype(np.float32)
    w = small_profiles.words
    tids = small_lake.table
    return dict(z=z, w=w, tids=tids, keys=keys, qids=qids,
                gbdt=jax_model.gbdt.astuple(),
                query=(z[qids], w[qids], tids[qids], qids, keys[qids]))


def test_build_training_set_matches(small_lake, small_profiles, port_lake):
    jx, jy = jax_build_training_set(small_lake, profiles=small_profiles,
                                    n_query=40, seed=2)
    tx, ty = build_training_set(port_lake, profiles=profiles_from_jax(small_profiles),
                                n_query=40, seed=2, device="cpu")
    assert tx.shape == jx.shape and ty.shape == jy.shape
    np.testing.assert_allclose(tx, jx, atol=1e-6, rtol=0)
    np.testing.assert_allclose(ty, jy, atol=1e-6, rtol=0)


def test_fit_gbdt_gives_identical_trees(small_lake, small_profiles):
    x, y = jax_build_training_set(small_lake, profiles=small_profiles, n_query=24)
    want = jax_fit_gbdt(x, y, JGBDTConfig(n_trees=8, depth=4))
    got = fit_gbdt(x, y, GBDTConfig(n_trees=8, depth=4))
    for f in ("feats", "thrs", "leaves"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.base == want.base


def test_model_file_loads_across_packages(tmp_path, jax_model):
    path = str(tmp_path / "model.npz")
    jax_model.save(path)
    got = JoinQualityModel.load(path)
    assert np.array_equal(got.gbdt.thrs, jax_model.gbdt.thrs)
    got.save(path)
    back = JJoinQualityModel.load(path)
    assert np.array_equal(back.gbdt.leaves, jax_model.gbdt.leaves)
    assert back.strictness == jax_model.strictness


@pytest.mark.parametrize("n_columns", [1, 9, 50, 1000, 20_480, 100_000])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_planner_matches(n_columns, k):
    jp = jexec.Planner(jexec.PlannerConfig(k=k))
    tp = Planner(PlannerConfig(k=k))
    assert tp.candidate_budget(n_columns) == jp.candidate_budget(n_columns)
    for mode in ("full", "lsh"):
        want = jp.plan(n_columns=n_columns, n_queries=8, mode=mode)
        got = tp.plan(n_columns=n_columns, mode=mode)
        assert not want.sharded
        assert (got.candidates, got.budget, got.k) == (want.candidates, want.budget, want.k)


@pytest.mark.parametrize("exclude_same_table", [True, False])
def test_rank_matches_jax(small_lake, small_profiles, jax_model, exclude_same_table):
    qids = np.asarray([1, 5, 8, 33, 64, 77], np.int32)
    want = jax_rank(JDiscoveryIndex(small_profiles, jax_model, table_ids=small_lake.table),
                    qids, k=7, exclude_same_table=exclude_same_table)
    index = DiscoveryIndex(profiles_from_jax(small_profiles),
                           JoinQualityModel(gbdt=gbdt_from_jax(jax_model.gbdt)),
                           table_ids=small_lake.table)
    got = rank(index, qids, k=7, exclude_same_table=exclude_same_table, device="cpu")
    _assert_same_ranking(*want, *got)


def test_rank_k_exceeds_lake_size(small_lake, small_profiles, jax_model):
    index = DiscoveryIndex(profiles_from_jax(small_profiles),
                           JoinQualityModel(gbdt=gbdt_from_jax(jax_model.gbdt)),
                           table_ids=small_lake.table)
    n = index.n_columns
    scores, ids = rank(index, np.asarray([0, 1]), k=n + 7, device="cpu")
    assert scores.shape == (2, n + 7) and ids.dtype == np.int32
    assert not np.isfinite(scores[:, n:]).any() and (ids[:, n:] == -1).all()


@pytest.mark.parametrize("plan_args", [
    dict(mode="full"), dict(mode="lsh"),
    dict(candidates="lsh", budget=5), dict(candidates="lsh", budget=20),
    dict(candidates="hybrid", budget=7)])
def test_executor_matches_jax(corpus, plan_args):
    c = corpus
    n = c["z"].shape[0]
    if "mode" in plan_args:
        jplan = jexec.Planner(jexec.PlannerConfig(k=10)).plan(
            n_columns=n, n_queries=len(c["qids"]), mode=plan_args["mode"])
        tplan = Planner(PlannerConfig(k=10)).plan(n_columns=n, mode=plan_args["mode"])
    else:
        jplan = jexec.QueryPlan(sharded=False, k=10, **plan_args)
        tplan = QueryPlan(k=10, **plan_args)
    assert (tplan.candidates, tplan.budget) == (jplan.candidates, jplan.budget)
    jx = jexec.Executor(c["z"], c["w"], c["gbdt"], table_ids=c["tids"],
                        band_keys=c["keys"])
    tx = Executor(c["z"], c["w"], c["gbdt"], table_ids=c["tids"],
                  band_keys=c["keys"], device="cpu")
    js, ji, jn = jx.execute(jplan, *c["query"])
    ts, ti, tn = tx.execute(tplan, *c["query"])
    assert ti.dtype == np.int32 and tn.dtype == np.int32
    assert np.array_equal(tn, jn)
    _assert_same_ranking(js, ji, ts, ti)


def test_port_trained_model_ranks_semantic_joins(port_lake):
    model = train_quality_model([port_lake], GBDTConfig(n_trees=30, depth=4),
                                n_query=64, device="cpu")
    assert model.train_r2 > 0.5
    prof = profile_lake(port_lake.batch, device="cpu")
    qids = lakegen.select_queries(port_lake, 12, min_semantic=3)
    scores, ids = rank(DiscoveryIndex(prof, model, table_ids=port_lake.table),
                       qids, k=3, device="cpu")
    valid = np.isfinite(scores)
    sem = port_lake.is_semantic(np.repeat(qids, 3), ids.reshape(-1)).reshape(-1)
    p_at_3 = (sem & valid.reshape(-1)).sum() / max(valid.sum(), 1)
    assert p_at_3 > 0.6, p_at_3


@pytest.mark.parametrize("t,d", [(1, 1), (50, 5), (13, 6)])
def test_gbdt_predict_matches_jax(t, d):
    r = np.random.default_rng(t * d)
    g = (r.integers(0, 23, (t, d)).astype(np.int32), r.normal(size=(t, d)).astype(np.float32),
         r.normal(size=(t, 2 ** d)).astype(np.float32), np.float32(r.normal()))
    x = r.normal(size=(3, 40, 23)).astype(np.float32)
    x[0, :, 5] = g[1][0, 0]                   # features exactly at a threshold
    want = jax_gbdt_predict_ref(tuple(map(jnp.asarray, g)), jnp.asarray(x))
    got = gbdt_predict_ref(gbdt_to_torch(g, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_pad_helpers_match_jax():
    arrays = [np.arange(10).reshape(5, 2), np.arange(5)]
    (got, q), (want, jq) = pad_rows(arrays, 4), jexec.pad_rows(arrays, 4)
    assert q == jq and all(np.array_equal(a, b) for a, b in zip(got, want))
    s = np.arange(6, dtype=np.float32).reshape(2, 3)
    i = np.arange(6, dtype=np.int32).reshape(2, 3)
    for k in (2, 3, 5):
        for a, b in zip(pad_topk(s, i, k), jexec.pad_topk(s, i, k)):
            assert np.array_equal(a, b)
