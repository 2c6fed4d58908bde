"""sched_host_ms.batch: ms a formed batch spends in the scheduler's own host
work on its thread, ``form`` (pop, stage, expire) plus ``deliver`` (the
futures resolved, their done-callbacks run, the metrics drained): the
program's span totals, after the window less before, over its batches."""
from perfbench import stagebounds


def read(run):
    d = stagebounds.trace_delta(run.sched_before, run.sched_after)
    n = run.n_batches()
    if d is None or not n or "form" not in d.get("spans", {}):
        return None
    return (d["spans"]["form"] + d["spans"].get("deliver", 0.0)) / n
