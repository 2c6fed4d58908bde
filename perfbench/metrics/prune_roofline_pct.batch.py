"""prune_roofline_pct.batch: the least time an H100 needs for the window's
hybrid ``prune`` stages (the band probe, the proxy and the budget's
positions: ``plans/hybrid.py``'s ``stage_bounds``, which counts no (Q, C)
intermediate) over the device time the program timed for them, in percent;
the need is scaled to the batches whose stage was timed."""
import numpy as np

from perfbench import harness, stagebounds


def read(run):
    config = run.config
    if config["plan"]["kind"] != "hybrid":
        return None
    d = stagebounds.trace_delta(run.engine_before, run.engine_after)
    n = run.n_batches()
    if d is None or not n:
        return None
    dev_ms = d.get("device_ms", {}).get("prune", 0.0)
    timed = d.get("device_count", {}).get("prune", 0)
    if dev_ms <= 0 or not timed:
        return None
    plan = harness.load_plan(config)
    trees, depth = np.load(harness.PB / config["model"])["feats"].shape
    cols = int(config["lake"]["n_columns"])
    need = sum(c * plan.stage_bounds(run.snap_batch(size), cols, config, int(trees),
                                     int(depth))["prune"]
               for size, c in run.batch_sizes().items())
    return 100.0 * need * 1e3 * (timed / n) / dev_ms
