"""exec_idle_ms.batch: ms a batch's device idles between its stages inside
``execute`` (``execute.idle``: the batch's device window less the union of
its stages' device intervals, as the program timed them), over the batches
whose device times were read."""
from perfbench import stagebounds


def read(run):
    d = stagebounds.trace_delta(run.engine_before, run.engine_after)
    if d is None or not d.get("device_batches") or "execute.idle" not in d.get("idle_ms", {}):
        return None
    return d["idle_ms"]["execute.idle"] / d["device_batches"]
