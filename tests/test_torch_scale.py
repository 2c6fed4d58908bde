"""The port's large-lake scale path against the JAX package on the CPU:
quantized profile sidecars, the coarse super-band digest, the tiered
candidate stages, the planner's tiered and auto modes, the analytic cost
model, and the executor's all/hybrid/tiered pipelines over fp32, int8 and
fp16 profiles (with the exact fp32 re-rank)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.exec as jexec
from repro.core import GBDTConfig as JGBDTConfig
from repro.core import select_queries as jax_select_queries
from repro.core import train_quality_model as jax_train
from repro.exec import stages as jstages
from repro.kernels import profile_distance as jpd
from repro.launch import costmodel as jcost
from repro.service import lsh as jlsh
from repro_torch.core.lakegen import (ScaledLakeSpec, generate_scaled_lake,
                                      select_scaled_queries)
from repro_torch.core.predictor import gbdt_to_torch
from repro_torch.core.profiles import lake_profiles
from repro_torch.device import hashes_to_torch
from repro_torch.exec import stages
from repro_torch.exec.executor import Executor, _rescore_exact
from repro_torch.exec.plan import Planner, PlannerConfig
from repro_torch.kernels import profile_distance as tpd
from repro_torch.kernels.lsh_probe import PAD_CORPUS
from repro_torch.launch import costmodel as tcost
from repro_torch.service import catalog
from repro_torch.service.lsh import LSHConfig, LSHIndex, coarse_band_keys
from test_torch_discovery import _assert_same_ranking

DTYPES = ("fp32", "int8", "fp16")


@pytest.fixture(scope="module")
def jax_model(small_lake):
    return jax_train([small_lake], JGBDTConfig(n_trees=20, depth=4), n_query=48)


@pytest.fixture(scope="module")
def scaled():
    """A 3000-column scaled lake (survivor budget 512 < C, so the tiered
    pass prunes), profiled and signed once; the same numpy arrays feed both
    packages."""
    lake = generate_scaled_lake(ScaledLakeSpec(n_columns=3000, seed=5))
    numeric, words, sigs = catalog.profile_and_sign(lake.batch, n_perm=128, seed=0,
                                                    device="cpu")
    z = lake_profiles(numeric, words, lake.batch.n_rows).zscored.astype(np.float32)
    index = LSHIndex.build(sigs, LSHConfig(n_bands=64, n_coarse_bands=16))
    qids = select_scaled_queries(lake, 8).astype(np.int32)
    return dict(z=z, w=words, tids=lake.table, keys=index.keys, coarse=index.coarse,
                qids=qids, query=(z[qids], words[qids], lake.table[qids].astype(np.int32),
                                  qids, index.keys[qids], index.coarse[qids]))


def _same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# quantized sidecars
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [0, 1, 257])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_profiles_byte_identical(dtype, c):
    z = np.random.default_rng(c).normal(0, 2.0, (c, 21)).astype(np.float32)
    got, want = tpd.quantize_profiles(z, dtype), jpd.quantize_profiles(z, dtype)
    assert _same_bytes(got[0], want[0]) and _same_bytes(got[1], want[1])
    deq = np.asarray(jpd.dequantize(*want))
    assert _same_bytes(tpd.dequantize(*got), deq)
    on_torch = tpd.dequantize(torch.from_numpy(got[0]), torch.from_numpy(got[1]))
    assert _same_bytes(on_torch.numpy(), deq)


@pytest.mark.parametrize("c,block", [(0, 64), (257, 64), (257, 8192), (300, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_profiles_streamed_byte_identical(dtype, c, block):
    r = np.random.default_rng(c + block)
    numeric = r.normal(3.0, 5.0, (c, 21)).astype(np.float32)
    mean = r.normal(size=21).astype(np.float32)
    std = r.uniform(0.5, 2.0, 21).astype(np.float32)
    got = tpd.quantize_profiles_streamed(numeric, mean, std, dtype, block=block)
    want = jpd.quantize_profiles_streamed(numeric, mean, std, dtype, block=block)
    assert _same_bytes(got[0], want[0]) and _same_bytes(got[1], want[1])
    # and the stream gives the eager quantizer's bytes
    eager = tpd.quantize_profiles((numeric - mean) / std, dtype)
    assert _same_bytes(got[0], eager[0]) and _same_bytes(got[1], eager[1])


def test_quantize_rejects_an_unknown_dtype():
    with pytest.raises(ValueError, match="unknown profile dtype"):
        tpd.quantize_profiles(np.zeros((2, 21), np.float32), "int4")


# ---------------------------------------------------------------------------
# coarse super-band digest
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,p,s", [(50, 128, 16), (7, 100, 5), (9, 64, 64), (3, 16, 1)])
def test_coarse_band_keys_byte_identical(c, p, s):
    sigs = np.random.default_rng(p).integers(0, 2 ** 32, (c, p), dtype=np.uint32)
    sigs[0, :] = np.uint32(0xFFFFFFFF)             # keys must clear the sentinels
    assert _same_bytes(coarse_band_keys(sigs, s), jlsh.coarse_band_keys(sigs, s))
    with pytest.raises(ValueError):
        coarse_band_keys(sigs, p + 1)


@pytest.mark.parametrize("n_coarse", [0, 16, 200])
def test_index_coarse_digest_matches(n_coarse):
    r = np.random.default_rng(n_coarse)
    sigs = r.integers(0, 40, (60, 128), dtype=np.uint32)     # small space: hits
    got = LSHIndex.build(sigs, LSHConfig(n_bands=32, n_coarse_bands=n_coarse))
    want = jlsh.LSHIndex.build(sigs, jlsh.LSHConfig(n_bands=32, n_coarse_bands=n_coarse))
    assert got.n_columns == want.n_columns == 60
    assert _same_bytes(got.keys, want.keys)
    if want.coarse is None:
        assert got.coarse is None
        with pytest.raises(ValueError, match="coarse digest"):
            got.coarse_query_keys(sigs[:2])
        return
    assert _same_bytes(got.coarse, want.coarse)
    qc = got.coarse_query_keys(sigs[:5])
    assert _same_bytes(qc, want.coarse_query_keys(sigs[:5]))
    mask = got.coarse_hit_mask(qc, device="cpu")
    assert np.array_equal(mask.numpy(), np.asarray(want.coarse_hit_mask(qc)))


# ---------------------------------------------------------------------------
# tiered stages: the same proxy into both packages, positions exactly equal
# ---------------------------------------------------------------------------

def _survivor_inputs(q, c, s, seed):
    r = np.random.default_rng(seed)
    qc = r.integers(0, 60, (q, s)).astype(np.uint32)
    cc = r.integers(0, 60, (c, s)).astype(np.uint32)
    qc[-1] = np.arange(1000, 1000 + s)               # a query that hits nothing
    cc[-1] = PAD_CORPUS
    tids = r.integers(0, 7, c).astype(np.int32)
    qid = r.choice(c, q, replace=False).astype(np.int32)
    qid[0] = -1                                      # an external query
    tq = tids[np.maximum(qid, 0)]
    tq[1] = -1                                       # table mask off
    proxy = (r.normal(size=(q, c)) * 4).astype(np.float32)
    return qc, cc, np.arange(c, dtype=np.int32), tids, tq, qid, proxy


@pytest.mark.parametrize("c,block_c,budget", [(256, 32, 40), (97, 32, 40),
                                              (130, 7, 16), (50, 32, 50)])
@pytest.mark.parametrize("with_proxy", [True, False])
def test_tiered_survivors_match(c, block_c, budget, with_proxy):
    qc, cc, cids, tids, tq, qid, proxy = _survivor_inputs(5, c, 6, seed=c + block_c)
    jout = jstages.tiered_survivors(
        *map(jnp.asarray, (qc, cc, cids, tids, tq, qid)), survivor_budget=budget,
        block_c=block_c, proxy=jnp.asarray(proxy) if with_proxy else None)
    tout = stages.tiered_survivors(
        hashes_to_torch(qc, "cpu"), hashes_to_torch(cc, "cpu"),
        *(torch.from_numpy(a.astype(np.int64)) for a in (cids, tids, tq, qid)),
        survivor_budget=budget, block_c=block_c,
        proxy=torch.from_numpy(proxy) if with_proxy else None)
    for name, j, t in zip(("pos", "valid", "n_hits", "n_survivors"), jout, tout):
        assert np.array_equal(t.numpy(), np.asarray(j)), name
    assert int(tout[2][-1]) == 0                     # the no-hit query
    assert not with_proxy or bool(tout[1][-1].any())  # ... filled by the proxy


@pytest.mark.parametrize("q,m,b", [(4, 37, 16), (3, 300, 64), (1, 1, 8)])
def test_tiered_priorities_match(q, m, b):
    # XLA and ATen sum the proxy's 21 products in different orders; the
    # float32 error of 2·zq·z - |z|² grows with |z|², so profiles of modest
    # magnitude keep the two within 1e-6 (at unit scale they differ by ~2e-6
    # where the proxy is near 0, each within float32 error of the exact value)
    r = np.random.default_rng(q * m + b)
    zq = r.normal(0, 0.3, (q, 21)).astype(np.float32)
    zg = r.normal(0, 0.3, (q, m, 21)).astype(np.float32)
    qk = r.integers(0, 30, (q, b)).astype(np.uint32)
    kg = r.integers(0, 30, (q, m, b)).astype(np.uint32)
    kg[:, ::5] = PAD_CORPUS
    valid = r.random((q, m)) < 0.8
    want = np.asarray(jstages.tiered_priorities(*map(jnp.asarray, (zq, qk, zg, kg, valid))))
    got = stages.tiered_priorities(torch.from_numpy(zq), hashes_to_torch(qk, "cpu"),
                                   torch.from_numpy(zg), hashes_to_torch(kg, "cpu"),
                                   torch.from_numpy(valid)).numpy()
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    both = np.isfinite(want)
    np.testing.assert_allclose(got[both], want[both], rtol=0, atol=1e-6)


@pytest.mark.parametrize("q,m,b,n", [(4, 37, 16, 90), (3, 300, 64, 120), (1, 1, 8, 5)])
def test_tiered_priorities_take_positions(q, m, b, n):
    """``pos=``: the fine probe reads the survivors' keys in place from the
    resident table; the priorities equal the reference's over the gathered
    keys ``table[pos]``, and the port's own pre-gathered call exactly."""
    r = np.random.default_rng(q * m + b + n)
    zq = r.normal(0, 0.3, (q, 21)).astype(np.float32)
    zg = r.normal(0, 0.3, (q, m, 21)).astype(np.float32)
    qk = r.integers(0, 30, (q, b)).astype(np.uint32)
    table = r.integers(0, 30, (n, b)).astype(np.uint32)
    table[::5] = PAD_CORPUS
    pos = r.integers(0, n, (q, m)).astype(np.int64)
    pos[:, 1::2] = pos[:, :1]                        # repeated survivors
    valid = r.random((q, m)) < 0.8
    want = np.asarray(jstages.tiered_priorities(
        *map(jnp.asarray, (zq, qk, zg, table[pos], valid))))
    args = (torch.from_numpy(zq), hashes_to_torch(qk, "cpu"), torch.from_numpy(zg))
    got = stages.tiered_priorities(*args, hashes_to_torch(table, "cpu"),
                                   torch.from_numpy(valid), pos=torch.from_numpy(pos))
    assert np.array_equal(np.isfinite(got.numpy()), np.isfinite(want))
    both = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[both], want[both], rtol=0, atol=1e-6)
    gathered = stages.tiered_priorities(*args, hashes_to_torch(table[pos], "cpu"),
                                        torch.from_numpy(valid))
    assert torch.equal(got, gathered)


# ---------------------------------------------------------------------------
# planner and cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_columns", [1, 50, 1000, 20_480, 100_000, 1_000_000])
@pytest.mark.parametrize("n_queries", [1, 64])
def test_planner_tiered_and_auto_match(n_columns, n_queries):
    jp, tp = jexec.Planner(jexec.PlannerConfig()), Planner(PlannerConfig())
    budget = tp.candidate_budget(n_columns)
    assert tp.survivor_budget(n_columns, budget) == jp.survivor_budget(n_columns, budget)
    for mode in ("tiered", "auto", "full", "lsh"):
        want = jp.plan(n_columns=n_columns, n_queries=n_queries, mode=mode)
        got = tp.plan(n_columns=n_columns, n_queries=n_queries, mode=mode)
        assert not want.sharded
        assert (got.candidates, got.budget, got.survivor_budget, got.k) == \
            (want.candidates, want.budget, want.survivor_budget, want.k), mode
        assert got.cost == want.cost, mode


def _assert_costs_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for key in want:
            _assert_costs_equal(got[key], want[key])
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    else:
        assert got == want


@pytest.mark.parametrize("candidates", ["all", "lsh", "hybrid", "tiered"])
@pytest.mark.parametrize("geometry", [
    dict(n_queries=64, n_columns=100_000, budget=2048, survivor_budget=2048),
    dict(n_queries=3, n_columns=999, budget=200, n_shards=4, q_shards=2),
    dict(n_queries=1, n_columns=1, budget=1, n_trees=50, tree_depth=5)])
def test_discovery_stage_costs_match(candidates, geometry):
    got = tcost.discovery_stage_costs(candidates=candidates, **geometry)
    want = jcost.discovery_stage_costs(candidates=candidates, **geometry)
    _assert_costs_equal(got, want)
    assert tcost.plan_cost_per_query(got) == jcost.plan_cost_per_query(want)


def test_plan_cost_per_query_edge_cases():
    for cost in (None, {}, {"n_queries": 4}, {"n_queries": 4, "total_cost": 2.0}):
        assert tcost.plan_cost_per_query(cost) == jcost.plan_cost_per_query(cost)


# ---------------------------------------------------------------------------
# executor: fp32 / int8 / fp16 x all / hybrid / tiered against the JAX one
# ---------------------------------------------------------------------------

_MODES = {"all": "full", "hybrid": "lsh", "tiered": "tiered"}


@pytest.mark.parametrize("kind", sorted(_MODES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_executor_scale_path_matches_jax(scaled, jax_model, dtype, kind):
    s = scaled
    n, q = s["z"].shape[0], len(s["qids"])
    jplan = jexec.Planner(jexec.PlannerConfig(k=10)).plan(
        n_columns=n, n_queries=q, mode=_MODES[kind])
    tplan = Planner(PlannerConfig(k=10)).plan(n_columns=n, n_queries=q, mode=_MODES[kind])
    assert (tplan.candidates, tplan.budget, tplan.survivor_budget) == \
        (jplan.candidates, jplan.budget, jplan.survivor_budget) == \
        (kind, jplan.budget, 512 if kind == "tiered" else 0)
    common = dict(table_ids=s["tids"], band_keys=s["keys"], coarse_keys=s["coarse"],
                  profile_dtype=dtype)
    jx = jexec.Executor(s["z"], s["w"], jax_model.gbdt.astuple(), **common)
    tx = Executor(s["z"], s["w"], jax_model.gbdt.astuple(), device="cpu", **common)
    js, ji, jn = jx.execute(jplan, *s["query"])
    res = tx.execute(tplan, *s["query"])
    (ts, ti, tn), tier = res, res.tier
    assert ti.dtype == np.int32 and tn.dtype == np.int32
    assert np.array_equal(tn, jn)
    if kind == "tiered":
        for got, want in zip(tier, jx._tls.tier_stats):
            assert np.array_equal(got, np.asarray(want))
        assert (tn < n).all()                        # the tier really pruned
    else:
        assert tier is None
    _assert_same_ranking(js, ji, ts, ti)


@pytest.mark.parametrize("r_slots,k", [(40, 10), (7, 10), (1, 1)])
def test_rescore_exact_matches_jax(jax_model, r_slots, k):
    """The exact re-rank of an over-fetched set, invalid slots included."""
    from repro.exec.executor import _rescore_exact as jax_rescore_exact
    r = np.random.default_rng(r_slots)
    q = 5
    zq, zg = (r.normal(size=s).astype(np.float32) for s in ((q, 21), (q, r_slots, 21)))
    wq = r.integers(0, 9, (q, 11)).astype(np.uint32)
    wg = r.integers(0, 9, (q, r_slots, 11)).astype(np.uint32)
    sc = r.normal(size=(q, r_slots)).astype(np.float32)
    ids = r.integers(0, 1000, (q, r_slots)).astype(np.int32)
    sc[0, r_slots // 2:] = -np.inf                   # slots the scan left invalid
    ids[0, r_slots // 2:] = -1
    g = jax_model.gbdt.astuple()
    want = jax_rescore_exact(*map(jnp.asarray, (zq, wq, zg, wg)), tuple(map(jnp.asarray, g)),
                             jnp.asarray(sc), jnp.asarray(ids), k=k)
    got = _rescore_exact(torch.from_numpy(zq), hashes_to_torch(wq, "cpu"),
                         torch.from_numpy(zg), hashes_to_torch(wg, "cpu"),
                         gbdt_to_torch(g, "cpu"),
                         torch.from_numpy(sc), torch.from_numpy(ids.astype(np.int64)), k)
    assert got[0].shape == (q, min(k, r_slots))
    _assert_same_ranking(*want, got[0].numpy(), got[1].numpy())


def test_prequantized_sidecar_with_row_source_matches(scaled, jax_model):
    """A caller that quantized itself (sidecar + scale + float32 row source)
    gets the profile_dtype executor's answer."""
    s = scaled
    plan = Planner(PlannerConfig(k=10)).plan(n_columns=s["z"].shape[0], mode="tiered")
    side, scale = tpd.quantize_profiles(s["z"], "int8")
    common = dict(table_ids=s["tids"], band_keys=s["keys"], coarse_keys=s["coarse"],
                  device="cpu")
    a = Executor(s["z"], s["w"], jax_model.gbdt.astuple(), profile_dtype="int8",
                 **common).execute(plan, *s["query"])
    b = Executor(side, s["w"], jax_model.gbdt.astuple(), z_scale=scale,
                 fp32_rows=s["z"].__getitem__, **common).execute(plan, *s["query"])
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


def test_tiered_plan_needs_the_coarse_digest(scaled, jax_model):
    s = scaled
    plan = Planner(PlannerConfig(k=10)).plan(n_columns=s["z"].shape[0], mode="tiered")
    ex = Executor(s["z"], s["w"], jax_model.gbdt.astuple(), band_keys=s["keys"],
                  device="cpu")
    with pytest.raises(ValueError, match="coarse super-band digest"):
        ex.execute(plan, *s["query"])
    ex = Executor(s["z"], s["w"], jax_model.gbdt.astuple(), band_keys=s["keys"],
                  coarse_keys=s["coarse"], device="cpu")
    with pytest.raises(ValueError, match="coarse query keys"):
        ex.execute(plan, *s["query"][:5])


@pytest.mark.parametrize("dtype", ["int8", "fp16"])
def test_quantized_topk_overlaps_fp32(small_lake, small_profiles, jax_model, dtype):
    """int8/fp16 sidecars + the exact fp32 re-rank reproduce the fp32
    top-10 (the JAX package's gate: overlap >= 0.99)."""
    qids = np.asarray(jax_select_queries(small_lake, 16), np.int32)
    z = small_profiles.zscored.astype(np.float32)
    w, tids = small_profiles.words, small_lake.table
    plan = Planner(PlannerConfig(k=10)).plan(n_columns=z.shape[0], mode="full")
    query = (z[qids], w[qids], tids[qids].astype(np.int32), qids)
    tops = {dt: Executor(z, w, jax_model.gbdt.astuple(), table_ids=tids, profile_dtype=dt,
                         device="cpu").execute(plan, *query)[1]
            for dt in ("fp32", dtype)}
    overlap = np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max((a >= 0).sum(), 1)
                       for a, b in zip(tops["fp32"], tops[dtype])])
    assert overlap >= 0.99, f"{dtype} top-k overlap {overlap} vs fp32"
