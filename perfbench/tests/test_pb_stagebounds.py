"""The stages' bounds and the readers of the program's span totals: each
plan kind's stages sum to its plan's bound at both configurations' shapes,
and each metric that reads ``stats()["trace"]`` reads None where a run holds
no such section (a program without the tracer) and the value worked out by
hand on a synthetic run."""
import pytest

from perfbench import bounds as B
from perfbench import harness, stagebounds

TRACE_METRICS = ("sched_host_ms.batch", "cache_admit_ms.batch", "score_roofline_pct.batch",
                 "coarse_roofline_pct.batch", "exec_idle_ms.batch")


def _configs():
    return {c["name"]: harness.load_config(c) for c in harness.load_manifest()["configs"]}


@pytest.mark.parametrize("q", [8, 256])
@pytest.mark.parametrize("name", ["full1m", "tiered4m"])
def test_stage_bounds_sum_to_the_plan_bound(name, q):
    config = _configs()[name]
    n = int(config["lake"]["n_columns"])
    kind = config["plan"]["kind"]
    stages = stagebounds.stage_bounds(kind, q, n, config, 50, 5)
    want = {"all": ["score", "mask", "merge"],
            "tiered": ["coarse", "fine", "score", "merge", "rerank"]}[kind]
    assert list(stages) == want and all(v > 0 for v in stages.values())
    plan = harness.load_plan(config).bound_s(q, n, config, 50, 5)
    assert sum(stages.values()) == pytest.approx(plan, rel=1e-12)


def test_stage_bounds_at_the_cells_shapes():
    c = _configs()
    full = stagebounds.stage_bounds("all", 256, 1 << 20, c["full1m"], 50, 5)
    assert full["score"] == pytest.approx(B.fused_score(256, 1 << 20, 256 << 20, 50, 5))
    assert 7.0e-3 < full["score"] < 7.3e-3    # 7.16 ms: 256 x 1M pairs of float32 and int32 work
    tiered = stagebounds.stage_bounds("tiered", 256, 4 << 20, c["tiered4m"], 50, 5)
    assert tiered["coarse"] / sum(tiered.values()) > 0.95
    assert stagebounds.stage_bounds("lsh", 256, 1 << 20, c["full1m"], 50, 5) == {}


def _trace(spans=None, device=None, idle=None, batches=0, device_batches=0):
    return {"batches": batches, "device_batches": device_batches,
            "spans": {k: {"count": 1, "total_ms": v, "self_ms": v, "max_ms": v}
                      for k, v in (spans or {}).items()},
            "device_ms": {k: {"count": c, "ms": v} for k, (c, v) in (device or {}).items()},
            "idle_ms": dict(idle or {}), "counters": {}}


def _run(config_name, n_batches, *, before=None, after=None, sched_before=None,
         sched_after=None):
    config = _configs()[config_name]
    hist0, hist1 = {256: 5}, {256: 5 + n_batches}
    eb, ea = {"plans": {}}, {"plans": {}}
    sb, sa = {"batch_size_hist": hist0}, {"batch_size_hist": hist1}
    for d, t in ((eb, before), (ea, after), (sb, sched_before), (sa, sched_after)):
        if t is not None:
            d["trace"] = t
    return harness.Run(config=config, engine_before=eb, engine_after=ea, sched_before=sb,
                       sched_after=sa, snap_batch=lambda n: 256)


@pytest.mark.parametrize("metric", TRACE_METRICS)
def test_a_run_without_the_tracer_reads_none(metric):
    read = harness.load_reader(metric)
    cell = "tiered4m" if metric.startswith("coarse") else "full1m"
    assert read(_run(cell, 10)) is None


@pytest.mark.parametrize("metric", ["score_roofline_pct.batch", "coarse_roofline_pct.batch",
                                    "exec_idle_ms.batch"])
def test_device_readers_read_none_without_device_times(metric):
    """Host spans are always on; device times only while tracing is on."""
    before = _trace({"cache": 1.0}, batches=5)
    after = _trace({"cache": 31.0}, batches=15)
    assert harness.load_reader(metric)(_run("tiered4m", 10, before=before, after=after)) is None


def test_the_readers_on_a_synthetic_run():
    c = _configs()
    sched_before = _trace({"wait": 1.0, "form": 2.0, "batch": 50.0, "deliver": 3.0})
    sched_after = _trace({"wait": 4.0, "form": 12.0, "batch": 750.0, "deliver": 63.0})
    # ten batches of 256: form 10 ms and deliver 60 ms in all
    run = _run("full1m", 10, sched_before=sched_before, sched_after=sched_after,
               before=_trace({"cache": 5.0}, {"score": (5, 90.0)}, {"execute.idle": 4.0},
                             batches=5, device_batches=5),
               after=_trace({"cache": 205.0}, {"score": (13, 90.0 + 8 * 18.0)},
                            {"execute.idle": 4.0 + 20.0, "deliver": 99.0},
                            batches=15, device_batches=15))
    read = lambda m: harness.load_reader(m)(run)
    assert read("sched_host_ms.batch") == pytest.approx(7.0)
    assert read("cache_admit_ms.batch") == pytest.approx(20.0)
    assert read("exec_idle_ms.batch") == pytest.approx(2.0)
    # 8 of the 10 batches timed, 18 ms of score each
    score = stagebounds.stage_bounds("all", 256, 1 << 20, c["full1m"], 50, 5)["score"]
    assert read("score_roofline_pct.batch") == pytest.approx(100.0 * score * 1e3 / 18.0)
    assert read("coarse_roofline_pct.batch") is None      # the exact plan has no coarse stage
    tiered = _run("tiered4m", 4, before=_trace(batches=0),
                  after=_trace(device={"coarse": (4, 4 * 80.0), "score": (4, 4 * 0.5)},
                               batches=4, device_batches=4))
    tb = stagebounds.stage_bounds("tiered", 256, 4 << 20, c["tiered4m"], 50, 5)
    assert harness.load_reader("coarse_roofline_pct.batch")(tiered) == \
        pytest.approx(100.0 * tb["coarse"] * 1e3 / 80.0)
    assert harness.load_reader("score_roofline_pct.batch")(tiered) == \
        pytest.approx(100.0 * tb["score"] * 1e3 / 0.5)
