"""The hybrid plan (``hybrid4m``) and the ``tiered4m.poisson`` mix on the
host: the plain hybrid by hand, the port's ``lsh`` engine against it on a
seeded lake, its control failing the check, harness runs of the cell sound
and broken, the mix's requests from a seed, the plan's bound and the
``prune_roofline_pct.batch`` reader."""
import json

import numpy as np
import pytest
import torch

from perfbench import bounds as B
from perfbench import control, harness, stagebounds, traffic
from perfbench.reference import hybrid, plain
from perfbench.tests.test_pb_harness import _Answered, _run, _small_root
from perfbench.tests.test_pb_stagebounds import _run as _synthetic
from perfbench.tests.test_pb_stagebounds import _trace

S = plain.SENTINEL
SEED = 2 ** 31 + 41


def _config(n_columns=None):
    with open(harness.PB / "configs" / "hybrid4m.json") as f:
        cfg = json.load(f)
    if n_columns:
        cfg["lake"]["n_columns"] = n_columns
    return cfg


def _words(first):
    w = torch.full((plain.F_WORDS,), S, dtype=torch.int64)
    w[plain.FIRST_WORD] = first
    return w


def test_hybrid_plan_by_hand():
    # 16 columns of 16 values, two a table. Column 9 holds exactly column 0's
    # values (every band a hit for query 0, and the same first word); every
    # other column's values are its own. z slot 0 sets the proxy: columns 5
    # and 6 tie.
    c, r = 16, 16
    values = torch.arange(c)[:, None] * 100 + torch.arange(r)[None, :] + 5000
    values[9] = values[0]
    z = torch.zeros((c, plain.F_NUM))
    z[:, 0] = torch.tensor([0.0, 0.05, 0.3, 0.1, 0.5, 0.2, 0.2, 0.9,
                            1.0, 2.0, 1.5, 1.6, 1.7, 1.8, 1.9, 2.1])
    cols = torch.arange(c)
    lake = plain.Lake(z=z, words=torch.stack([_words(int(v)) for v in values.amin(1)]),
                      tables=cols // 2, cols=cols, coarse=None, values=[(0, c, values)])
    bands = hybrid.lake_bands(lake, 128, 0, 64, block=5)       # signed in uneven blocks
    assert bands.shape == (c, 64) and torch.equal(bands[9], bands[0])
    assert plain.probe(bands[:1], bands)[0].nonzero().flatten().tolist() == [0, 9]
    q = torch.tensor([0])
    prio = hybrid.priorities(lake, bands, q, z)[0]
    # the query and its table-mate excluded; the hit above every proxy
    assert prio[:2].tolist() == [float("-inf")] * 2
    assert prio[9] == pytest.approx(4.0 - 4.0 / 5.0) and (prio[2:9] < 0).all()
    assert prio[5] == prio[6]
    # tree 0: first-word equality adds 1; tree 1: |dz0| < 0.25 adds 0.5
    model = plain.Ensemble(feats=torch.tensor([[plain.F_NUM + 1], [0]]),
                           thrs=torch.tensor([[0.5], [0.25]]),
                           leaves=torch.tensor([[0.0, 1.0], [0.5, 0.0]]), base=0.0)
    # budget 3: the hit, then column 3, then the tie at the edge to the
    # lower index, 5; column 6 is not a candidate
    sc, ids = hybrid.answer_hybrid(lake, model, q, 4, bands=bands, budget=3)
    assert ids.tolist() == [[9, 3, 5]] and sc.tolist() == [[1.0, 0.5, 0.5]]
    sc, ids = hybrid.answer_hybrid(lake, model, q, 5, bands=bands, budget=4)
    assert ids.tolist() == [[9, 3, 5, 6]] and sc.tolist() == [[1.0, 0.5, 0.5, 0.5]]
    # the budget is the planner's
    assert hybrid.budget(1 << 22, 10, 0.2, 4096) == 4096
    assert hybrid.budget(1024, 10, 0.2, 4096) == 204 and hybrid.budget(20, 10, 0.2, 4096) == 10


def test_the_lsh_engine_matches_the_reference():
    """The port's served path in ``lsh`` mode against the plain hybrid on a
    seeded 2,048-column lake, 32 queries in one padded batch: the reference
    keeps the program's float32 order, so both numbers read exactly 0."""
    from repro_torch.service.api import DiscoveryRequest
    cfg = _config(2048)
    prog = harness.setup(cfg, SEED, torch.device("cpu"), lambda s: None)
    eng = prog["engine"]
    try:
        qids = np.random.default_rng(3).choice(2048, 32, replace=False)
        res = eng.query_batch([DiscoveryRequest(name=f"q{i}", column_id=int(c))
                               for i, c in enumerate(qids)])
        assert eng.last_plan.candidates == "hybrid" and eng.last_plan.budget == 409
    finally:
        prog["scheduler"].close()
        eng.close()
    k = cfg["engine"]["k"]
    ids = np.full((len(qids), k), -1, np.int64)
    sc = np.full((len(qids), k), -np.inf, np.float32)
    for i, r in enumerate(res):
        ids[i, :len(r.matches)] = [m.column_id for m in r.matches]
        sc[i, :len(r.matches)] = [m.score for m in r.matches]
    out = harness.reference_numbers(cfg, SEED, qids, sc, ids, "cpu", lambda s: None,
                                    pad=len(qids))
    limits = cfg["check"]["limits"]
    assert out == {"rank_gap": 0.0, "score_err": 0.0}
    assert all(out[n] <= limits[n] for n in out)


def test_the_bfloat16_control_fails_the_check():
    cfg = _config(2048)
    cfg["check"].update(sample=16)
    out = control.control_numbers(cfg, 2 ** 32 + 3, "cpu", log=lambda s: None)
    limits = cfg["check"]["limits"]
    assert any(out[n] > limits[n] for n in ("rank_gap", "score_err")), out


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return _small_root(tmp_path_factory.mktemp("pbh"))


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_hybrid_run_prints_the_contract_line(small_root, traced):
    res, _ = _run(small_root, "hybrid4m.batch", traced)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["wrong_plan"]["value"] == 0
    assert res["checks"]["rank_gap"]["value"] == 0 and res["checks"]["score_err"]["value"] == 0
    want = {m["name"] for m in harness.metrics_for(harness.load_manifest(), "hybrid4m.batch",
                                                   traced)}
    if traced:
        assert set(res["metrics"]) <= want
        assert {"prune_roofline_pct.batch", "execute_ms.batch"} <= set(res["metrics"])
    else:
        assert set(res["metrics"]) == want == {"qps", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_a_broken_hybrid_path_is_not_correct(small_root, fault):
    res, _ = _run(small_root, "hybrid4m.batch", fault=fault)
    assert res["correct"] is False, res["checks"]


def test_the_poisson_mix_draws_the_same_requests_from_a_seed():
    mix = harness.load_traffic("poisson_tiered4m")
    assert mix.params["arrivals"] == "poisson" and mix.params["rate_qps"] > 0
    a, b = _Answered(), _Answered()
    for s in (a, b):
        traffic.run(mix, s, 1 << 22, 2 ** 31 + 5, 0.05, 10)
    assert a.asked == b.asked and len(a.asked) > 0


def test_the_prune_bound_at_the_cell_shape():
    cfg = _config()
    st = harness.load_plan(cfg).stage_bounds(256, 1 << 22, cfg, 50, 5)
    assert list(st) == ["prune", "score", "merge"]
    assert 4.5e-3 < st["prune"] < 5.1e-3      # the probe's 2·Q·C·B int32 compares set it
    assert st["prune"] == pytest.approx(
        256 * (1 << 22) * 44 / B.F32_OPS + 2.0 * 256 * (1 << 22) * 64 / B.I32_OPS)
    plan = harness.load_plan(cfg)
    for q, n in ((256, 1 << 22), (8, 1024)):
        assert sum(plan.stage_bounds(q, n, cfg, 50, 5).values()) == \
            pytest.approx(plan.bound_s(q, n, cfg, 50, 5), rel=1e-12)


def test_the_prune_reader():
    read = harness.load_reader("prune_roofline_pct.batch")
    assert read(_synthetic("hybrid4m", 10)) is None                 # no trace section
    assert read(_synthetic("hybrid4m", 10, before=_trace(batches=0),
                           after=_trace({"prune": 90.0}, batches=10))) is None   # no device
    # 8 of 10 batches timed, 40 ms of prune each
    run = _synthetic("hybrid4m", 10, before=_trace(batches=0),
                     after=_trace(device={"prune": (8, 8 * 40.0), "probe": (8, 8 * 10.0)},
                                  batches=10, device_batches=8))
    need = harness.load_plan(_config()).stage_bounds(256, 1 << 22, _config(), 50, 5)["prune"]
    assert read(run) == pytest.approx(100.0 * need * 1e3 / 40.0)
    tiered = _synthetic("tiered4m", 4, before=_trace(batches=0),
                        after=_trace(device={"prune": (4, 40.0)}, batches=4, device_batches=4))
    assert read(tiered) is None                # only the hybrid plan has a prune bound
    assert stagebounds.stage_bounds("hybrid", 256, 1 << 22, _config(), 50, 5) == {}
