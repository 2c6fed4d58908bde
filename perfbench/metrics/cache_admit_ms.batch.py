"""cache_admit_ms.batch: ms a formed batch spends admitting its misses into
the engine's result cache (``finalize``'s ``cache`` span): the program's
span totals, after the window less before, over its batches."""
from perfbench import stagebounds


def read(run):
    d = stagebounds.trace_delta(run.engine_before, run.engine_after)
    n = run.n_batches()
    if d is None or not n or "cache" not in d.get("spans", {}):
        return None
    return d["spans"]["cache"] / n
