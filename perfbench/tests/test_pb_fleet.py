"""The fleet placement, on the host at a small size: a configuration with
``"placement": {"replicas": N}`` and a cell with ``chips: N``, added as new
files only, is served by an ``EngineFleet`` of N engines behind the one
scheduler and checked as any cell is; a broken timed path under the fleet
is not correct; a placement that differs from the cell's chips is refused
before set-up. In process: the device trace's per-card reduction, and the
merge of the replicas' ``stats()``."""
import json
import subprocess
import sys
import time
from types import SimpleNamespace as NS

import numpy as np
import pytest
from torch.autograd import DeviceType

from perfbench import devtrace, harness
from perfbench.tests.test_pb_harness import _small_root

ROOT = harness.ROOT
FLEET = "hybrid4m_r2.batch"


def _fleet_root(tmp_path):
    """``_small_root`` with new files only: a two-replica configuration
    shaped as ``hybrid4m``, its cell on two chips over a closed loop of 512
    in flight (two full batches, so both replicas serve), and a cell whose
    configuration places three replicas on two chips."""
    root = _small_root(tmp_path)
    (root / "perfbench").unlink()
    pb = root / "perfbench"
    pb.mkdir()
    for child in harness.PB.iterdir():
        if child.name != "traffic":
            (pb / child.name).symlink_to(child)
    (pb / "traffic").mkdir()
    for f in (harness.PB / "traffic").iterdir():
        (pb / "traffic" / f.name).symlink_to(f)
    (pb / "traffic" / "closed512.json").write_text(json.dumps(
        {"arrivals": "closed", "in_flight": 512, "queries": "resident_uniform"}))
    m = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(c for c in m["configs"] if c["name"] == "hybrid4m")
    for n, chips in ((2, 2), (3, 2)):
        name = f"hybrid4m_r{n}"
        cfg = json.loads((root / entry["file"]).read_text())
        cfg.update(name=name, placement={"replicas": n})
        (root / f"{name}.json").write_text(json.dumps(cfg))
        m["configs"].append(dict(entry, name=name, file=f"{name}.json"))
        m["workloads"].append({"name": f"{name}.batch", "config": name, "traffic": "closed512",
                               "chips": chips, "why": "a fleet of replicas, one a card"})
    for metric in m["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append(FLEET)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory):
    return _fleet_root(tmp_path_factory.mktemp("pbfleet"))


# one run in a fresh interpreter (a test process may hold JAX, and a run
# refuses to print a result then), on two CPU "cards"; it also prints what
# each replica served in the window
_DRIVER = """
import json, sys, time
from pathlib import Path
import numpy as np
root, cell, fault = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [%r, %r]
from perfbench import harness
from repro_torch.exec.executor import Executor
run = Executor.execute
if fault == "altered":      # every answer names the next column
    def execute(self, plan, *a, **kw):
        sc, ids, n = run(self, plan, *a, **kw)
        return sc, np.where(ids >= 0, (ids + 1) %% self.n_live, ids), n
    Executor.execute = execute
runs, run_cell = [], harness.run_cell
harness.run_cell = lambda *a, **kw: runs.append(run_cell(*a, **kw)) or runs[-1]
lines, errs = [], []
rc = harness.execute(cell, 2 ** 31 + 78, 0.6, False, time.perf_counter(), device=["cpu", "cpu"],
                     root=Path(root), out=lines.append, err=errs.append)
r = runs[0]
served = {k: v["batches_served"] - r.fleet_before["replicas"][k]["batches_served"]
          for k, v in r.fleet_after["replicas"].items()}
print(json.dumps({"rc": rc, "last": lines[-1] if lines else None, "errs": errs,
                  "served": served, "batches": r.n_batches(),
                  "engine_batches": r.engine_after["batches"] - r.engine_before["batches"]}))
""" % (str(ROOT), str(ROOT / "src"))


def _run(root, cell, fault="none"):
    p = subprocess.run([sys.executable, "-c", _DRIVER, str(root), cell, fault],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0, out["errs"]
    return json.loads(out["last"]), out


def test_a_fleet_cell_runs_from_new_files_only(fleet_root):
    res, out = _run(fleet_root, FLEET)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0, res["checks"]
    assert res["checks"]["wrong_plan"]["value"] == 0
    dev = res["device"]
    assert dev["count"] == 2 and dev["platform"] == "cpu"
    assert [c["device"] for c in dev["per_card"]] == ["cpu", "cpu"]
    want = {m["name"] for m in harness.metrics_for(
        json.loads((fleet_root / "BENCHMARK.json").read_text()), FLEET, False)}
    assert set(res["metrics"]) == want and "qps" in want
    # both replicas served, and the replicas' merged counters hold every batch
    assert sorted(out["served"]) == ["0", "1"] and min(out["served"].values()) > 0, out
    assert sum(out["served"].values()) == out["engine_batches"] == out["batches"]


def test_a_broken_timed_path_under_the_fleet_is_not_correct(fleet_root):
    res, out = _run(fleet_root, FLEET, fault="altered")
    assert res["correct"] is False, res["checks"]
    assert min(out["served"].values()) > 0, out


def test_a_placement_that_differs_from_the_chips_is_refused_before_set_up(
        fleet_root, monkeypatch):
    def no_set_up(*a, **kw):
        raise AssertionError("set up despite the placement")
    monkeypatch.setattr(harness, "setup", no_set_up)
    with pytest.raises(harness.BenchError, match="places 3 replica.*2 chip"):
        harness.execute("hybrid4m_r3.batch", 1, 0.1, False, time.perf_counter(),
                        device=["cpu", "cpu"], root=fleet_root, out=lambda s: None)


@pytest.mark.parametrize("place", [{"replicas": 0}, {"replicas": "2"}, {"replicas": True},
                                   {"replicas": 2, "spread": 1}, [2]])
def test_a_malformed_placement_is_refused(place):
    with pytest.raises(harness.BenchError, match="placement"):
        harness.placement_replicas({"placement": place})


def test_without_a_placement_there_is_no_fleet():
    assert harness.placement_replicas({"engine": {}}) is None
    assert harness.placement_replicas({"placement": {"replicas": 4}}) == 4


class _Event:
    def __init__(self, card, start, end, name, kind=DeviceType.CUDA):
        self.card, self.start, self.end, self.op, self.kind = card, start, end, name, kind

    def device_type(self):
        return self.kind

    def device_index(self):
        return self.card

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start

    def name(self):
        return self.op


def _prof(events):
    return NS(__exit__=lambda *a: None,
              profiler=NS(kineto_results=NS(events=lambda: list(events))))


def _one_card(events, window_s, top=10):
    """The reduction as it was before cards were told apart: one union over
    every device event."""
    dev = sorted((e.start, e.end, devtrace.short(e.op)) for e in events
                 if e.kind == DeviceType.CUDA)
    by_op, gaps = {}, {}
    busy = 0.0
    cur_s = cur_t = None
    for s, t, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (t - s) * 1e-9
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += (cur_t - cur_s) * 1e-9
            gaps["before " + name] = gaps.get("before " + name, 0.0) + (s - cur_t) * 1e-9
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += (cur_t - cur_s) * 1e-9
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy, "window_s": window_s, "device_ops": rank(by_op),
            "idle_gaps": rank(gaps), "n_device_events": len(dev)}


def _events(card, seed):
    """A card's activities at random times, some overlapping, some apart,
    and host events beside them that the reduction skips."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(400):
        s = int(rng.integers(0, 10 ** 9))
        out.append(_Event(card, s, s + int(rng.integers(1, 3 * 10 ** 6)),
                          f"void k{i % 7}<float, 5>(float const*, int)"))
        if i % 9 == 0:
            out.append(_Event(-1, s, s + 5, "aten::add", DeviceType.CPU))
    return out


def test_one_card_reads_as_before():
    events = _events(0, 1)
    got = devtrace.summarize(_prof(events), 12.5)
    want = _one_card(events, 12.5)
    assert got.pop("per_card") == {0: want["busy_s"]}
    assert got == want            # bit for bit: the same floats in the same order
    assert 0 < got["busy_s"] < got["window_s"] and got["idle_gaps"]


def test_two_cards_sum_their_unions_over_a_doubled_window():
    a, b = _events(0, 2), _events(1, 3)
    got = devtrace.summarize(_prof(a + b), 12.5, n_cards=2)
    one, two = _one_card(a, 12.5), _one_card(b, 12.5)
    both = _one_card(a + b, 12.5)
    assert got["per_card"] == {0: one["busy_s"], 1: two["busy_s"]}
    assert got["busy_s"] == one["busy_s"] + two["busy_s"] > both["busy_s"]
    assert got["window_s"] == 25.0
    assert got["n_device_events"] == one["n_device_events"] + two["n_device_events"]
    ops = dict(got["device_ops"])
    for name, v in dict(both["device_ops"]).items():
        assert ops[name] == pytest.approx(v, rel=1e-12)
    gaps = dict(got["idle_gaps"])
    sums = {k: dict(one["idle_gaps"]).get(k, 0.0) + dict(two["idle_gaps"]).get(k, 0.0)
            for k in gaps}
    assert gaps == pytest.approx(sums, rel=1e-12)


def test_a_card_with_no_activity_still_counts_in_the_window():
    got = devtrace.summarize(_prof(_events(0, 4)), 2.0, n_cards=4)
    assert got["window_s"] == 8.0 and list(got["per_card"]) == [0]


@pytest.fixture(scope="module")
def fleet_program(fleet_root):
    """The two-replica program set up on the host, with a few batches
    served through its scheduler."""
    from repro_torch.service.api import DiscoveryRequest
    cfg = json.loads((fleet_root / "hybrid4m_r2.json").read_text())
    prog = harness.setup(cfg, 2 ** 31 + 5, ["cpu", "cpu"], lambda s: None)
    try:
        futs = [prog["scheduler"].submit(DiscoveryRequest(name=f"q{i}", column_id=i * 7 % 1024))
                for i in range(600)]
        for f in futs:
            f.result(timeout=120)
        yield prog
    finally:
        prog["scheduler"].close()
        prog["fleet"].close()


def test_the_merge_of_one_replica_is_its_own_stats(fleet_program):
    s = fleet_program["engines"][0].stats()
    assert s["batches"] > 0 and s["trace"]["spans"]
    assert harness.merged_stats([s]) is s


def test_the_merge_of_two_replicas_sums_their_counters(fleet_program):
    a, b = (e.stats() for e in fleet_program["engines"])
    m = harness.merged_stats([a, b])
    assert m["queries"] == a["queries"] + b["queries"] == 600
    assert m["batches"] == a["batches"] + b["batches"]
    assert m["plans"] == {p: a["plans"].get(p, 0) + b["plans"].get(p, 0)
                          for p in {**a["plans"], **b["plans"]}}
    assert m["cache"]["misses"] == a["cache"]["misses"] + b["cache"]["misses"]
    assert m["n_columns"] == a["n_columns"] and m["snapshot"] == a["snapshot"]
    for name, span in m["trace"]["spans"].items():
        sa, sb = a["trace"]["spans"].get(name), b["trace"]["spans"].get(name)
        parts = [x for x in (sa, sb) if x]
        assert span["count"] == sum(x["count"] for x in parts)
        assert span["total_ms"] == pytest.approx(sum(x["total_ms"] for x in parts))
        assert span["max_ms"] == max(x["max_ms"] for x in parts)
    assert m["trace"]["batches"] == a["trace"]["batches"] + b["trace"]["batches"]
    served = fleet_program["fleet"].stats()["replicas"]
    assert m["batches"] == sum(r["batches_served"] for r in served.values())
