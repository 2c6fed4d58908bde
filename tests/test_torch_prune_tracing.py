"""The hybrid (``lsh`` mode) candidate stage's spans and counter on the
host: ``probe``, ``priority`` and ``select`` under ``prune``; ``prune_hits``
against a count worked from plain priorities; answers with tracing on equal
to those with it off."""
import numpy as np
import pytest
import torch

from repro_torch.core.gbdt import GBDTParams
from repro_torch.core.lakegen import ScaledLakeSpec, generate_scaled_lake
from repro_torch.core.predictor import JoinQualityModel
from repro_torch.core.profiles import lake_profiles
from repro_torch.service import catalog
from repro_torch.service.api import DiscoveryRequest
from repro_torch.service.catalog import CatalogSnapshot
from repro_torch.service.engine import DiscoveryEngine, EngineConfig
from repro_torch.service.lsh import LSHConfig

N_COLUMNS = 1200            # the planner's budget: 20% of the lake, 240 columns
BOOST = 4.0                 # kernels.ref.LSH_PRIORITY_BOOST


@pytest.fixture(scope="module")
def snapshot():
    lake = generate_scaled_lake(ScaledLakeSpec(n_columns=N_COLUMNS, seed=5))
    num, words, sigs = catalog.profile_and_sign(lake.batch, n_perm=128, seed=0, device="cpu")
    return CatalogSnapshot(profiles=lake_profiles(num, words, lake.batch.n_rows),
                           signatures=sigs, table_ids=lake.table,
                           names=[f"c{i}" for i in range(N_COLUMNS)], table_names={},
                           version=1, minhash_seed=0)


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(1)
    t, d = 6, 3
    return JoinQualityModel(gbdt=GBDTParams(
        feats=rng.integers(0, 23, (t, d)).astype(np.int32),
        thrs=rng.normal(0, 1, (t, d)).astype(np.float32),
        leaves=rng.normal(0, 1, (t, 1 << d)).astype(np.float32), base=0.0))


def _engine(snapshot, model, **kw):
    return DiscoveryEngine(snapshot, model, EngineConfig(
        k=10, mode="lsh", lsh=LSHConfig(n_bands=64, n_coarse_bands=16), batch_pad=8,
        cache_entries=0, **kw), device="cpu")


def _requests(ids):
    return [DiscoveryRequest(name=f"q{i}", column_id=int(c)) for i, c in enumerate(ids)]


QUERIES = np.arange(3, N_COLUMNS, 75)[:16]          # two padded batches' worth, no padding


def test_prune_nests_probe_priority_select(snapshot, model):
    eng = _engine(snapshot, model, metrics=True)
    eng.query_batch(_requests(QUERIES))
    (rec,) = eng.trace_records()
    spans = rec["spans"]
    names = [s["name"] for s in spans]
    execute = names.index("execute")
    assert [s["name"] for s in spans if s["parent"] == execute] == \
        ["upload", "prune", "score", "merge", "download"]
    prune = names.index("prune")
    kids = [s for s in spans if s["parent"] == prune]
    assert [s["name"] for s in kids] == ["probe", "priority", "select"]
    for s in kids:
        assert spans[prune]["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= spans[prune]["t1_ns"]
        assert s["device_ns"]                     # timed while tracing is on
    dev = eng.stats()["trace"]["device_ms"]
    assert {"prune", "probe", "priority", "select"} <= set(dev)


def _plain_hits(eng, qids, budget):
    """Budget slots an LSH hit fills over the batch, from priorities worked
    out in plain torch on the executor's resident arrays."""
    ex = eng._head.executor
    z, ck, tids = ex._z, ex._ckeys, ex._tids
    q = torch.as_tensor(qids)
    hit = (ck[q][:, None, :] == ck[None]).any(-1)
    zq = z[q]
    proxy = 2.0 * zq @ z.T - (z * z).sum(1)[None]
    prio = hit.to(torch.float32) * BOOST + proxy / (1.0 + torch.abs(proxy))
    cols = torch.arange(z.shape[0])
    excl = (cols[None] == q[:, None]) | (tids[None] == tids[q][:, None])
    prio = torch.where(excl, float("-inf"), prio)
    top = torch.sort(prio, dim=1, descending=True, stable=True).values[:, :budget]
    return int((top > 1.0).sum()), int((hit & ~excl).sum(1).clamp(max=budget).sum())


def test_prune_hits_is_the_budget_filled_by_hits(snapshot, model):
    eng = _engine(snapshot, model)
    eng.query_batch(_requests(QUERIES[:8]))
    eng.query_batch(_requests(QUERIES[8:]))
    assert eng.last_plan.candidates == "hybrid" and eng.last_plan.budget == 240
    want, by_hits = _plain_hits(eng, QUERIES, 240)
    assert want == by_hits > 0                 # every eligible hit outranks every proxy fill
    assert eng.stats()["trace"]["counters"]["prune_hits"] == want


def _answers(responses):
    return [[(m.column_id, m.score) for m in r.matches] for r in responses]


def test_answers_with_tracing_on_equal_those_with_it_off(snapshot, model):
    on = _answers(_engine(snapshot, model, metrics=True).query_batch(_requests(QUERIES)))
    off = _answers(_engine(snapshot, model).query_batch(_requests(QUERIES)))
    assert on == off and all(len(a) == 10 for a in on)
