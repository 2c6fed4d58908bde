"""The port's multi-device plans against the JAX package on 8 devices.

The JAX side runs once per module, in a subprocess with 8 forced host
devices (``tests/test_grid.py``'s lake and model), and writes its inputs and
its sharded results to an ``.npz``. The port runs in this process on
``make_grid_mesh(q, d, devices=[cpu] * 8)``, one host device standing in for
eight as the forced device count does for JAX, over the same inputs: the
port builds the lake, its word features, band keys and queries from the same
seeds and must reproduce the oracle's exactly; the float32 profile numerics
and the trained trees agree only to rounding between the packages, so the
port takes those from the oracle and the comparison isolates the sharded
path. Also here: the grid planner against the JAX planner on the same
hypothesis inputs, and the 8-device ``lsh`` acceptance of
``tests/test_exec.py``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.exec as jexec
from repro_torch.core import lakegen
from repro_torch.core.discovery import DiscoveryIndex, rank_sharded
from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.predictor import JoinQualityModel
from repro_torch.core.profiles import LakeProfiles, profile_lake
from repro_torch.device import hashes_to_numpy, hashes_to_torch
from repro_torch.exec.executor import Executor
from repro_torch.exec.plan import Planner, PlannerConfig, QueryPlan
from repro_torch.kernels import ref
from repro_torch.kernels.lsh_probe import PAD_QUERY
from repro_torch.kernels.minhash import make_permutations
from repro_torch.launch.mesh import make_grid_mesh, make_local_mesh
from repro_torch.service.lsh import band_keys
from test_torch_discovery import SMALL_LAKE, _assert_same_ranking

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
GRIDS = [(1, 8), (2, 4), (4, 2), (8, 1)]

_ORACLE = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, jax
    from repro.core import (GBDTConfig, LakeSpec, generate_lake, profile_lake,
                            select_queries, train_quality_model)
    from repro.core.discovery import DiscoveryIndex, rank_sharded
    from repro.exec import Executor, QueryPlan
    from repro.kernels import ref
    from repro.kernels.lsh_probe import PAD_QUERY
    from repro.kernels.minhash import make_permutations
    from repro.service.lsh import band_keys

    assert len(jax.devices()) == 8, jax.devices()
    lake = generate_lake(LakeSpec(n_domains=10, n_tables=24, row_budget=2048,
                                  rows_log_mean=6.8, coverage_range=(0.5, 1.0),
                                  gran_ratio=(4, 8), seed=7))
    prof = profile_lake(lake.batch)
    model = train_quality_model([lake], GBDTConfig(n_trees=30, depth=4), n_query=64)
    a, b = make_permutations(128, 0)          # minhash_ref is ops.minhash bit for bit
    keys = band_keys(np.asarray(ref.minhash_ref(lake.batch.values32, a, b)), 64)
    gb = model.gbdt.astuple()
    mesh = jax.make_mesh((8, 1), ("data", "model"))
    ex = Executor(prof.zscored, prof.words, gb, table_ids=lake.table,
                  band_keys=keys, mesh=mesh)
    ex8 = Executor(prof.zscored, prof.words, gb, table_ids=lake.table,
                   band_keys=keys, mesh=mesh, profile_dtype="int8")
    qids = select_queries(lake, 16)
    zq, wq = prof.zscored[qids].astype(np.float32), prof.words[qids]
    tq, qk = lake.table[qids].astype(np.int32), keys[qids]
    none = np.full_like(tq, -1)
    n = lake.n_columns
    out = dict(numeric=prof.numeric, words=prof.words, n_rows=prof.n_rows,
               mean=prof.mean, std=prof.std, table=lake.table, keys=keys,
               qids=qids, feats=gb[0], thrs=gb[1], leaves=gb[2],
               base=np.float32(gb[3]))

    def put(name, res):
        for part, arr in zip("sin", res):
            out[name + "/" + part] = np.asarray(arr)

    def plan(kind, budget, k, g):
        return QueryPlan(candidates=kind, sharded=True, budget=budget, k=k, grid=g)

    for g in ((1, 8), (2, 4), (4, 2), (8, 1)):
        tag = "%dx%d" % g
        for kind, budget in (("all", n), ("lsh", n), ("hybrid", 128)):
            put(kind + "/" + tag, ex.execute(plan(kind, budget, 10, g), zq, wq, tq, qids,
                                             qkeys=qk))
        put("k_over/" + tag, ex.execute(plan("all", n, n + 7, g), zq, wq, tq, qids))
        put("empty/" + tag, ex.execute(plan("lsh", n, 10, g), zq, wq, tq, qids,
                                       qkeys=np.full_like(qk, PAD_QUERY)))
        put("external/" + tag, ex.execute(plan("hybrid", 64, 10, g), zq, wq, none, none,
                                          qkeys=qk))
    put("int8/local", ex8.execute(QueryPlan(candidates="all", sharded=False, budget=n, k=10),
                                  zq, wq, tq, qids))
    idx = DiscoveryIndex(profiles=prof, model=model, table_ids=lake.table)
    out["rank_q"] = select_queries(lake, 6, min_semantic=3)
    out["rank/s"], out["rank/i"] = rank_sharded(idx, out["rank_q"], mesh, k=5)
    sub = np.arange(6)
    small = DiscoveryIndex(profiles=dataclasses.replace(
        prof, numeric=prof.numeric[sub], words=prof.words[sub], n_rows=prof.n_rows[sub]),
        model=model, table_ids=lake.table[sub])
    out["rank_small/s"], out["rank_small/i"] = rank_sharded(small, np.asarray([0, 1]),
                                                            mesh, k=10)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The JAX package's sharded results on 8 forced host devices."""
    path = str(tmp_path_factory.mktemp("grid") / "oracle.npz")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _ORACLE, path], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port(oracle):
    """The port's side of the same inputs: its own lake, words, band keys
    and queries, the oracle's profile numerics and trees."""
    lake = lakegen.generate_lake(lakegen.LakeSpec(**SMALL_LAKE))
    a, b = make_permutations(128, 0)
    sigs = hashes_to_numpy(ref.minhash_ref(*(hashes_to_torch(x, CPU)
                                             for x in (lake.batch.values32, a, b))))
    prof = LakeProfiles(numeric=oracle["numeric"], words=oracle["words"],
                        n_rows=oracle["n_rows"], mean=oracle["mean"], std=oracle["std"])
    gbdt = GBDTParams(feats=oracle["feats"], thrs=oracle["thrs"],
                      leaves=oracle["leaves"], base=float(oracle["base"]))
    qids = lakegen.select_queries(lake, 16)
    z = prof.zscored.astype(np.float32)
    return dict(lake=lake, keys=band_keys(sigs, 64), prof=prof,
                model=JoinQualityModel(gbdt=gbdt), qids=qids, z=z,
                query=(z[qids], prof.words[qids], lake.table[qids].astype(np.int32),
                       qids.astype(np.int32)))


def _executor(port, grid, **kw) -> Executor:
    return Executor(port["z"], port["prof"].words, port["model"].gbdt.astuple(),
                    table_ids=port["lake"].table, band_keys=port["keys"],
                    mesh=make_grid_mesh(*grid, devices=[CPU] * 8), **kw)


def _run(port, grid, kind, budget, k=10, query=None, qkeys=None, **kw):
    plan = QueryPlan(candidates=kind, sharded=True, budget=budget, k=k, grid=grid)
    qkeys = port["keys"][port["qids"]] if qkeys is None else qkeys
    return _executor(port, grid, **kw).execute(plan, *(query or port["query"]),
                                               qkeys=qkeys)


def _want(oracle, name):
    return tuple(oracle[f"{name}/{p}"] for p in "sin")


def test_port_builds_the_oracles_lake(oracle, port):
    lake = port["lake"]
    prof = profile_lake(lake.batch, device="cpu")
    assert np.array_equal(prof.words, oracle["words"])
    np.testing.assert_allclose(prof.numeric, oracle["numeric"], rtol=1e-5, atol=1e-5)
    assert np.array_equal(lake.table, oracle["table"])
    assert np.array_equal(port["keys"], oracle["keys"])
    assert np.array_equal(port["qids"], oracle["qids"])


@pytest.mark.parametrize("kind", ["all", "lsh", "hybrid"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_matches_jax(oracle, port, grid, kind):
    """Every geometry × kind: ids equal up to exact ties, scores within
    1e-4, ``n_scored`` exactly equal."""
    n = port["lake"].n_columns
    s, i, nn = _run(port, grid, kind, n if kind != "hybrid" else 128)
    js, ji, jn = _want(oracle, f"{kind}/{grid[0]}x{grid[1]}")
    _assert_same_ranking(js, ji, s, i)
    assert np.array_equal(nn, jn)


@pytest.mark.parametrize("grid", [(1, 8), (4, 2)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_int8_sharded_scan_matches_jax_local_scan(oracle, port, grid):
    """A quantized executor dequantizes at placement and its sharded scan
    over-fetches RESCORE_MULT x k for the exact re-rank, as the local scan
    does: the merged over-fetch is the lake's, so the answer is the JAX
    package's local int8 answer. (The JAX package's sharded scan re-ranks
    only the k it returns and keeps fewer of the float32 top-k.)"""
    s, i, nn = _run(port, grid, "all", port["lake"].n_columns, profile_dtype="int8")
    js, ji, jn = _want(oracle, "int8/local")
    _assert_same_ranking(js, ji, s, i)
    assert np.array_equal(nn, jn)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_k_exceeds_lake(oracle, port, grid):
    n = port["lake"].n_columns
    s, i, _ = _run(port, grid, "all", n, k=n + 7)
    assert s.shape == (len(port["qids"]), n + 7)
    assert (i[~np.isfinite(s)] == -1).all()
    js, ji, _ = _want(oracle, f"k_over/{grid[0]}x{grid[1]}")
    _assert_same_ranking(js, ji, s, i)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_empty_candidates(oracle, port, grid):
    """Query keys that hit no bucket: every tile contributes nothing."""
    dead = np.full_like(port["keys"][port["qids"]], PAD_QUERY)
    s, i, nn = _run(port, grid, "lsh", port["lake"].n_columns, qkeys=dead)
    assert not np.isfinite(s).any() and (i == -1).all() and (nn == 0).all()
    assert np.array_equal(nn, _want(oracle, f"empty/{grid[0]}x{grid[1]}")[2])


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_grid_accounting_no_double_count(oracle, port, grid):
    """``n_scored`` sums over the data shards only: external queries with a
    budget every shard count divides score exactly the budget."""
    zq, wq, tq, _ = port["query"]
    none = np.full_like(tq, -1)
    s, i, nn = _run(port, grid, "hybrid", 64, query=(zq, wq, none, none))
    assert np.array_equal(nn, np.full_like(nn, 64))
    js, ji, jn = _want(oracle, f"external/{grid[0]}x{grid[1]}")
    _assert_same_ranking(js, ji, s, i)
    assert np.array_equal(nn, jn)


def test_rank_sharded_matches_jax(oracle, port):
    index = DiscoveryIndex(port["prof"], port["model"], table_ids=port["lake"].table)
    mesh = make_local_mesh(devices=[CPU] * 8)
    s, i = rank_sharded(index, oracle["rank_q"], mesh, k=5)
    _assert_same_ranking(oracle["rank/s"], oracle["rank/i"], s, i)


def test_rank_sharded_k_exceeds_shard_size(oracle, port):
    """Six columns over eight shards, k = 10: padded with -inf / -1."""
    prof, sub = port["prof"], np.arange(6)
    small = DiscoveryIndex(dataclasses.replace(prof, numeric=prof.numeric[sub],
                                               words=prof.words[sub],
                                               n_rows=prof.n_rows[sub]),
                           port["model"], table_ids=port["lake"].table[sub])
    s, i = rank_sharded(small, np.asarray([0, 1]), make_local_mesh(devices=[CPU] * 8), k=10)
    assert s.shape == (2, 10)
    _assert_same_ranking(oracle["rank_small/s"], oracle["rank_small/i"], s, i)


# ---------------------------------------------------------------------------
# the grid planner against the JAX planner
# ---------------------------------------------------------------------------

class _FakeMesh:
    """The planner reads only ``mesh.shape``."""

    def __init__(self, **shape):
        self.shape = shape


def _same_plan(want, got):
    for f in ("candidates", "sharded", "budget", "k", "n_shards", "grid", "shard_axes",
              "survivor_budget", "kind", "q_shards", "n_grid_devices", "budget_per_shard"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.cost.keys() == want.cost.keys()
    for key, v in want.cost.items():
        if isinstance(v, float):
            assert got.cost[key] == pytest.approx(v, rel=1e-12), key


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 64), st.integers(1, 512), st.integers(1, 100_000))
def test_grid_options_match_jax(n_dev, n_queries, n_columns):
    cfg = dict(k=10, min_columns_per_shard=64)
    got = Planner(PlannerConfig(**cfg)).grid_options(n_dev, n_queries, n_columns)
    assert got == jexec.Planner(jexec.PlannerConfig(**cfg)).grid_options(
        n_dev, n_queries, n_columns)
    for q, d in got:
        assert q * d == n_dev and 1 <= q <= max(n_queries, 1)
        assert d == 1 or -(-n_columns // d) >= 64


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 16), st.integers(1, 256), st.integers(1, 50_000),
       st.sampled_from(["auto", "lsh", "sharded", "full", "tiered"]))
def test_plans_match_jax(n_dev, n_queries, n_columns, mode):
    """Equal plans, field by field, for every mode over a mesh; sharded
    plans use exactly the mesh's devices and keep q within the batch."""
    mesh = _FakeMesh(data=n_dev, model=1)
    want = jexec.Planner(jexec.PlannerConfig(k=5)).plan(
        n_columns=n_columns, n_queries=n_queries, mode=mode, mesh=mesh)
    got = Planner(PlannerConfig(k=5)).plan(n_columns=n_columns, n_queries=n_queries,
                                           mode=mode, mesh=mesh)
    _same_plan(want, got)
    if got.sharded:
        assert got.n_grid_devices == n_dev and got.q_shards <= n_queries
    else:
        assert got.grid == (1, 1)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 16), st.integers(1, 256), st.integers(1, 50_000),
       st.sampled_from(["serve", "full"]))
def test_plan_sets_match_jax(n_dev, n_queries, n_columns, scope):
    mesh = _FakeMesh(data=n_dev, model=1)
    want = jexec.Planner(jexec.PlannerConfig(k=10)).plan_set(
        n_columns=n_columns, n_queries=n_queries, mode="lsh", mesh=mesh, scope=scope)
    got = Planner(PlannerConfig(k=10)).plan_set(
        n_columns=n_columns, n_queries=n_queries, mode="lsh", mesh=mesh, scope=scope)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        _same_plan(w, g)


@pytest.mark.parametrize("kw", [
    dict(grid=(2, 4)), dict(grid=(3, 2)), dict(grid=(8, 1), n_queries=4),
    dict(grid=(2, 1), mesh=_FakeMesh(data=2, model=1)), dict(mesh=None)])
def test_sharded_grid_validation_matches_jax(kw):
    """A pinned grid that factorizes the mesh is taken; one that does not,
    one that idles query shards, and sharded mode without a mesh raise the
    JAX planner's ValueError."""
    args = dict(n_columns=10_000, n_queries=16, mode="sharded",
                mesh=_FakeMesh(data=8, model=1))
    args.update(kw)
    try:
        want = jexec.Planner(jexec.PlannerConfig(k=10)).plan(**args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Planner(PlannerConfig(k=10)).plan(**args)
        assert str(got.value) == str(e)
        return
    _same_plan(want, Planner(PlannerConfig(k=10)).plan(**args))


def test_plan_grid_dimension():
    """The JAX planner's fixed cases: mode mapping over a mesh, the auto
    gate on an admissible d > 1 factorization, the budget split over the
    data axis only, and the 1-D construction."""
    p = Planner(PlannerConfig(k=10, min_columns_per_shard=64))
    mesh = _FakeMesh(data=8, model=1)
    assert p.plan(n_columns=1000, mode="lsh", mesh=mesh).kind == "sharded-hybrid"
    assert p.plan(n_columns=1000, mode="sharded", mesh=mesh).kind == "sharded-all"
    assert p.plan(n_columns=1000, mode="tiered", mesh=mesh).kind == "local-tiered"
    tiny = p.plan(n_columns=32, n_queries=64, mode="auto", mesh=mesh)
    assert not tiny.sharded and tiny.grid == (1, 1)
    big = p.plan(n_columns=10_000, n_queries=64, mode="auto", mesh=mesh)
    assert big.sharded and big.n_grid_devices == 8
    plan = QueryPlan(candidates="hybrid", sharded=True, budget=128, k=10, grid=(4, 2))
    assert plan.budget_per_shard == 64
    legacy = QueryPlan(candidates="hybrid", sharded=True, budget=128, k=10, n_shards=8)
    assert legacy.grid == (1, 8) and legacy.budget_per_shard == 16
    with pytest.raises(ValueError):
        QueryPlan(candidates="all", sharded=True, budget=10, k=5, grid=(0, 8))


# ---------------------------------------------------------------------------
# the two-phase merge's concatenation order, and the executor's guards
# ---------------------------------------------------------------------------

def test_gather_order_follows_jax_all_gathers():
    """Over ("pod", "data") the first axis gathers innermost: tiles
    concatenate data-major, not in flat shard order."""
    from repro_torch.exec.stages import gather_order
    assert gather_order((8,)) == list(range(8))
    assert gather_order((2, 4)) == [0, 4, 1, 5, 2, 6, 3, 7]
    assert gather_order(()) == [0]


def test_two_phase_merge_breaks_ties_in_gather_order():
    """Equal scores on every tile: the merged ranking lists them in the
    order of JAX's all_gathers over ("pod", "data"), then reassembles the
    query shards in batch order with their counts."""
    from repro_torch.exec.stages import assemble_query_shards, merge_topk_sharded
    tiles = [(torch.ones(2, 1), torch.full((2, 1), i), torch.full((2,), 10)) for i in range(8)]
    sc, ids, n = merge_topk_sharded(tiles, 8, (2, 4), CPU)
    assert ids.tolist() == [[0, 4, 1, 5, 2, 6, 3, 7]] * 2 and (n == 80).all()
    rows = [(sc, ids + 100 * q, n + q) for q in range(2)]
    sc2, ids2, n2 = assemble_query_shards(rows, (2,), CPU)
    assert ids2[2:].tolist() == (ids + 100).tolist() and n2.tolist() == [80, 80, 81, 81]


def test_sharded_executor_guards(port):
    ex = Executor(port["z"], port["prof"].words, port["model"].gbdt.astuple(),
                  table_ids=port["lake"].table, band_keys=port["keys"], device="cpu")
    zq, wq, tq, qid = port["query"]
    with pytest.raises(ValueError, match="needs a mesh"):
        ex.execute(QueryPlan(candidates="all", sharded=True, budget=8, k=5, grid=(1, 8)),
                   zq, wq, tq, qid)
    ex = _executor(port, (1, 8))
    with pytest.raises(ValueError, match="local-only"):
        ex.execute(QueryPlan(candidates="tiered", sharded=True, budget=8, k=5, grid=(1, 8),
                             survivor_budget=32), zq, wq, tq, qid,
                   qkeys=port["keys"][port["qids"]])
    ex.execute(QueryPlan(candidates="all", sharded=True, budget=8, k=5, grid=(1, 8)),
               zq, wq, tq, qid)
    assert ex._placed
    ex.close()
    assert not ex._placed


# ---------------------------------------------------------------------------
# acceptance: distributed LSH on 8 host devices (tests/test_exec.py:381)
# ---------------------------------------------------------------------------

def test_sharded_lsh_acceptance_8dev(port, tmp_path):
    """mode="lsh" end to end over an 8-device mesh: recall@10 >= 0.9 against
    the sharded full scan while scoring <= 30% of the lake, and the sharded
    and local pruned plans agree on the neighbourhoods."""
    from repro_torch.service import (CatalogStore, DiscoveryEngine, DiscoveryRequest,
                                     EngineConfig, LSHConfig, add_lake, measure_recall)
    lake = port["lake"]
    add_lake(CatalogStore(str(tmp_path), n_perm=128, device="cpu"), lake)
    snap = CatalogStore(str(tmp_path), device="cpu").snapshot()
    cfg = dict(k=10, lsh=LSHConfig(n_bands=64), candidate_frac=0.2)
    eng_sh = DiscoveryEngine(snap, port["model"], EngineConfig(mode="lsh", **cfg),
                             mesh=make_local_mesh(devices=[CPU] * 8))
    eng_lo = DiscoveryEngine(snap, port["model"], EngineConfig(mode="lsh", **cfg),
                             device="cpu")
    reqs = [DiscoveryRequest(name=f"q{int(q)}", column_id=int(q)) for q in port["qids"]]
    r_sh, r_lo = eng_sh.query_batch(reqs), eng_lo.query_batch(list(reqs))
    assert eng_sh.stats()["last_plan"]["kind"] == "sharded-hybrid"
    assert eng_sh.stats()["last_plan"]["grid"][0] * eng_sh.stats()["last_plan"]["grid"][1] == 8
    overlap = np.mean([len({m.column_id for m in a.matches} & {m.column_id for m in b.matches})
                       / max(len(b.matches), 1) for a, b in zip(r_sh, r_lo)])
    assert overlap >= 0.8, overlap
    rec = measure_recall(eng_sh, port["qids"], k=10)
    assert (rec["plan"], rec["baseline_plan"]) == ("sharded-hybrid", "sharded-all"), rec
    assert rec["recall"] >= 0.9 and rec["scored_fraction"] <= 0.30, rec
    eng_sh.close()
    eng_lo.close()


# ---------------------------------------------------------------------------
# the executor lifecycle on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all", "hybrid"])
def test_extended_on_a_mesh_equals_a_fresh_executor(port, kind):
    """A successor built from delta rows drops its predecessor's sharded
    placements and places its own on its first sharded batch, in a padded
    column bucket: it serves exactly what a fresh executor over the same
    rows serves, and its predecessor keeps serving what it served."""
    n = port["lake"].n_columns
    n0 = n - 30
    z, w, t, keys = port["z"], port["prof"].words, port["lake"].table, port["keys"]
    mesh = make_grid_mesh(2, 4, devices=[CPU] * 8)

    def fresh(size):
        return Executor(z[:size], w[:size], port["model"].gbdt.astuple(), table_ids=t[:size],
                        band_keys=keys[:size], mesh=mesh, n_padded=256)

    plan = QueryPlan(candidates=kind, sharded=True, budget=n0 if kind == "all" else 64, k=10,
                     grid=(2, 4))
    args = tuple(a[:6] for a in port["query"])
    qk = keys[port["qids"][:6]]
    base = fresh(n0)
    before = base.execute(plan, *args, qkeys=qk)
    assert base._placed
    succ = base.extended(z[n0:], w[n0:], table_ids=t[n0:], band_keys=keys[n0:])
    assert not succ._placed and succ.mesh is mesh
    got, want = succ.execute(plan, *args, qkeys=qk), fresh(n).execute(plan, *args, qkeys=qk)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for a, b in zip(base.execute(plan, *args, qkeys=qk), before):
        assert np.array_equal(a, b)


def test_sharded_engine_warms_its_grid(port, tmp_path):
    """Warmup runs the sharded plan and its baseline on every bucket, so a
    warmed engine serves every ladder shape with no first contact."""
    from repro_torch.service import (CatalogStore, DiscoveryEngine, DiscoveryRequest,
                                     EngineConfig, LSHConfig, add_lake)
    add_lake(CatalogStore(str(tmp_path), n_perm=128, device="cpu"), port["lake"])
    buckets = (4, 8)
    eng = DiscoveryEngine(CatalogStore(str(tmp_path), device="cpu").snapshot(), port["model"],
                          EngineConfig(k=5, mode="lsh", lsh=LSHConfig(n_bands=64),
                                       batch_buckets=buckets, warmup="serve"),
                          mesh=make_grid_mesh(2, 2, devices=[CPU] * 4))
    rep = eng.warmup_report
    assert rep["n_executables"] == 2 * len(buckets) and rep["skipped_plans"] == 0
    for b in buckets:
        eng.query_batch([DiscoveryRequest(name=f"q{i}", column_id=i) for i in range(b)])
        assert eng.stats()["last_plan"]["kind"] == "sharded-hybrid"
    assert eng._executor.dispatch_stats() == {"aot": len(buckets), "fallback": 0}
    eng.close()
