"""batch_fill.batch: requests in the window's formed batches over the padded
buckets they ran at, in percent (the scheduler's batch-size histogram)."""


def read(run):
    sizes = run.batch_sizes()
    padded = sum(run.snap_batch(n) * c for n, c in sizes.items())
    return 100.0 * sum(n * c for n, c in sizes.items()) / padded if padded else None
