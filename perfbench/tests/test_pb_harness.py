"""The harness itself, on the host at a small size: it finds every piece by
name, refuses what it cannot find, prints the result line the contract asks
for, fails without a card, loads no JAX, and sees ``correct`` come out false
when the timed path is broken underneath."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from perfbench import devtrace, harness, traffic

ROOT = harness.ROOT
RUN = [sys.executable, str(ROOT / "perfbench" / "run.py")]
# the planner's budgets at 1024 columns: survivors max(5%, 512) -> 512,
# fine budget min(20% of the lake, survivors) -> 204
SMALL = {"n_columns": 1024, "plan": {"survivors": 512, "budget": 204}}


def test_every_piece_is_found_by_its_name():
    m = harness.load_manifest()
    for w in m["workloads"]:
        cell, entry = harness.find_cell(m, w["name"])
        config = harness.load_config(entry)
        assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
        mix = harness.load_traffic(cell["traffic"])
        assert callable(mix.arrivals.drive) and callable(mix.queries.columns)
        plan = harness.load_plan(config)
        assert plan.LABEL.startswith("local-")
        assert 0 < plan.bound_s(harness.top_bucket(config), 1 << 20, config, 50, 5) < 1
        e2e = harness.metrics_for(m, w["name"], False)
        per_layer = harness.metrics_for(m, w["name"], True)
        assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2 and per_layer
        for x in e2e + per_layer:
            assert callable(harness.load_reader(x["name"]))
    for x in m["per_layer"]:
        assert x["moves"] in {e["name"] for e in m["end_to_end"]}


@pytest.mark.parametrize("name, want", [
    ("void freyja_fused::fused_score_kernel<float, 5, 4>(freyja_fused::Scorer, float const*)",
     "freyja_fused::fused_score_kernel<float, 5, 4>"),
    ("(anonymous namespace)::warp_topk<1, true>(float const*, long long, int)",
     "(anonymous namespace)::warp_topk<1, true>"),
    ("Memcpy HtoD (Pageable -> Device) ", "Memcpy HtoD"),
    ("Memcpy DtoH ", "Memcpy DtoH"),
])
def test_device_operations_lose_their_argument_lists(name, want):
    assert devtrace.short(name) == want


def test_unknown_names_fail_clearly(tmp_path):
    m = harness.load_manifest()
    with pytest.raises(harness.BenchError, match="unknown workload 'nope'"):
        harness.find_cell(m, "nope")
    bad = json.loads(json.dumps(m))
    bad["workloads"][0]["config"] = "ghost"
    with pytest.raises(harness.BenchError, match="configuration 'ghost'"):
        harness.find_cell(bad, bad["workloads"][0]["name"])
    with pytest.raises(harness.BenchError, match="missing file"):
        harness.load_traffic("no_such_mix")
    with pytest.raises(harness.BenchError, match="metrics 'no_such_metric' has no module"):
        harness.load_reader("no_such_metric")
    with pytest.raises(harness.BenchError, match="plans 'lsh' has no module"):
        harness.load_plan({"plan": {"kind": "lsh"}})
    mix_dir = tmp_path / "perfbench" / "traffic"
    mix_dir.mkdir(parents=True)
    (mix_dir / "odd.json").write_text(json.dumps({"arrivals": "bursty",
                                                  "queries": "resident_uniform"}))
    with pytest.raises(harness.BenchError, match="arrivals 'bursty' has no module"):
        harness.load_traffic("odd", tmp_path)
    (mix_dir / "bad.json").write_text(json.dumps({"arrivals": "closed", "in_flight": 0,
                                                  "queries": "resident_uniform"}))
    for folder in ("arrivals", "queries"):
        (tmp_path / "perfbench" / folder).symlink_to(harness.PB / folder)
    with pytest.raises(harness.BenchError, match="in_flight"):
        harness.load_traffic("bad", tmp_path)
    p = subprocess.run(RUN + ["--workload", "nope", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and "unknown workload 'nope'" in p.stderr
    assert not p.stdout.strip()


def test_without_a_card_it_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(RUN + ["--workload", "full1m.batch", "--seed", str(2 ** 31 + 9),
                              "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode not in (0, None)
    assert "CUDA" in p.stderr and not p.stdout.strip()


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
            "import perfbench.harness, perfbench.control, perfbench.knee, perfbench.devtrace\n"
            "from perfbench.reference import plain\n"
            "import repro_torch.service.engine, repro_torch.service.scheduler\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    tops = set(json.loads(p.stdout.strip().replace("'", '"')))
    assert "perfbench" in tops and "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def _small_root(tmp_path):
    """A checkout-shaped directory whose cells run 1024-column lakes."""
    m = harness.load_manifest()
    for c in m["configs"]:
        cfg = harness.load_config(c)
        cfg["lake"]["n_columns"] = SMALL["n_columns"]
        cfg["check"].update(sample=16)
        if "survivors" in cfg["plan"]:
            cfg["plan"].update(SMALL["plan"])
        c["file"] = f"{c['name']}.json"
        (tmp_path / c["file"]).write_text(json.dumps(cfg))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp_path / "perfbench").symlink_to(harness.PB)
    return tmp_path


# one run in a fresh interpreter: the run refuses to print a result in a
# process that holds JAX, which a test process that imported the JAX
# package's tests does; the faults are planted there
_DRIVER = """
import json, sys, time
from pathlib import Path
import numpy as np
root, cell, traced, fault = sys.argv[1], sys.argv[2], sys.argv[3] == "1", sys.argv[4]
sys.path[:0] = [%r, %r]
from perfbench import harness, traffic
from repro_torch.exec.executor import Executor
from repro_torch.service.engine import DiscoveryEngine
run = Executor.execute
if fault == "altered":      # every answer names the next column
    def execute(self, plan, *a, **kw):
        sc, ids, n = run(self, plan, *a, **kw)
        return sc, np.where(ids >= 0, (ids + 1) %% self.n_live, ids), n
    Executor.execute = execute
elif fault == "half":       # half the batch computed, its answers copied to the rest
    def execute(self, plan, zq, wq, tq, qid, qkeys=None, qcoarse=None):
        h = max(1, len(zq) // 2)
        cut = lambda a: None if a is None else np.asarray(a)[:h]
        sc, ids, n = run(self, plan, cut(zq), cut(wq), cut(tq), cut(qid), cut(qkeys), cut(qcoarse))
        idx = np.arange(len(zq)) %% h
        return sc[idx], ids[idx], n[idx]
    Executor.execute = execute
elif fault == "dropped":    # half of each batch's responses never delivered
    qb = DiscoveryEngine.query_batch
    DiscoveryEngine.query_batch = lambda self, r, **kw: qb(self, r, **kw)[:max(1, len(r) // 2)]
    traffic.GRACE_S = 0.5
lines, errs = [], []
rc = harness.execute(cell, 2 ** 31 + 77, 0.4, traced, time.perf_counter(), device="cpu",
                     root=Path(root), out=lines.append, err=errs.append)
print(json.dumps({"rc": rc, "last": lines[-1] if lines else None, "errs": errs}))
""" % (str(ROOT), str(ROOT / "src"))


def _run(root, cell, traced=False, fault="none"):
    p = subprocess.run([sys.executable, "-c", _DRIVER, str(root), cell,
                        "1" if traced else "0", fault],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0, out["errs"]
    return json.loads(out["last"]), out["errs"]


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    return _small_root(tmp_path_factory.mktemp("pb"))


@pytest.mark.parametrize("traced", [False, True])
def test_a_sound_run_prints_the_contract_line(small_root, traced):
    cell = harness.load_manifest()["workloads"][0]["name"]
    res, errs = _run(small_root, cell, traced)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == keys + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["checks"]) == {"unanswered", "wrong_plan", "rank_gap", "score_err"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    assert errs[-4:] == [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
                         for n, c in res["checks"].items()]
    want = {m["name"] for m in harness.metrics_for(harness.load_manifest(), cell, traced)}
    assert set(res["metrics"]) <= want
    if not traced:
        assert set(res["metrics"]) == want       # every end-to-end metric of the cell
    if traced:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("cell", ["full1m.batch", "tiered4m.batch"])
def test_a_broken_timed_path_is_not_correct(small_root, cell, fault):
    res, _ = _run(small_root, cell, fault=fault)
    assert res["correct"] is False, res["checks"]


def test_answers_that_never_come_are_not_correct(small_root):
    res, _ = _run(small_root, "full1m.batch", fault="dropped")
    assert res["correct"] is False and res["checks"]["unanswered"]["value"] > 0


class _Answered:
    """A scheduler whose every request is answered at once, naming the
    column it asked for."""

    def __init__(self):
        self.asked = []

    def submit(self, request):
        from concurrent.futures import Future
        from types import SimpleNamespace as NS
        self.asked.append((request.name, request.column_id))
        fut = Future()
        fut.set_result(NS(name=request.name, queue_ms=0.0, trace=[{"phase": "execute", "ms": 1.0}],
                          matches=[NS(column_id=request.column_id, score=1.0)]))
        return fut


def test_a_new_kind_is_a_new_file(tmp_path):
    """A plan, an arrival kind and a query kind that the benchmark does not
    have yet are found by their names once their modules are there, and a mix
    naming them drives the scheduler."""
    pb = tmp_path / "perfbench"
    for folder in ("plans", "arrivals", "queries", "traffic"):
        (pb / folder).mkdir(parents=True)
    (pb / "plans" / "lsh.py").write_text('LABEL = "local-lsh"\n')
    (pb / "arrivals" / "steady.py").write_text(
        "import numpy as np\n"
        "from perfbench import traffic\n"
        "def validate(mix): pass\n"
        "def drive(mix, client):\n"
        "    due = np.arange(0, client.seconds, 1 / mix['rate_qps'])\n"
        "    return traffic.open_loop(due, client)\n")
    (pb / "queries" / "hot.py").write_text(
        "import numpy as np\n"
        "from types import SimpleNamespace\n"
        "def validate(mix): pass\n"
        "def columns(mix, seed, n_columns, n): return np.full(n, mix['hot'])\n"
        "def request(name, column_id): return SimpleNamespace(name=name, column_id=column_id)\n")
    (pb / "traffic" / "steady_hot.json").write_text(json.dumps(
        {"arrivals": "steady", "rate_qps": 200.0, "queries": "hot", "hot": 7}))
    assert harness.load_plan({"plan": {"kind": "lsh"}}, tmp_path).LABEL == "local-lsh"
    mix = harness.load_traffic("steady_hot", tmp_path)
    sched = _Answered()
    w = traffic.run(mix, sched, 100, 5, 0.1, 3)
    assert w.log.n == 20 and w.log.answered.all()
    assert sched.asked == [(f"r{i}", 7) for i in range(20)]
    assert (w.log.ids[:, 0] == 7).all() and (w.log.ids[:, 1:] == -1).all()
    assert np.isfinite(w.log.latency_ms()).all() and w.log.span_ms["execute"] == 20.0


@pytest.mark.parametrize("name", ["closed256"])
def test_the_mixes_draw_the_same_requests_from_a_seed(name):
    mix = harness.load_traffic(name)
    seed = 2 ** 31 + 5
    a, b = _Answered(), _Answered()
    for s in (a, b):
        traffic.run(mix, s, 1 << 20, seed, 0.05, 10)
    da, db = dict(a.asked), dict(b.asked)       # request name -> column asked
    common = da.keys() & db.keys()
    assert len(common) >= mix.params.get("in_flight", 1)
    assert all(da[r] == db[r] for r in common)
