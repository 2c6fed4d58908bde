"""roofline_pct.batch: the least time an H100 needs for the traced window's
batches (each padded batch's plan stages, from their shapes), over the
device's busy time in the same window, in percent."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0:
        return None
    need = sum(c * run.plan_bound_s(run.snap_batch(n)) for n, c in run.batch_sizes().items())
    return 100.0 * need / run.trace["busy_s"] if need else None
