"""score_roofline_pct.batch: the least time an H100 needs for the window's
``score`` stages (``stagebounds``, from the batches' shapes) over the
device time the program timed for them (CUDA events at the stage's
boundaries, read while tracing is on), in percent."""
from perfbench import stagebounds


def read(run):
    return stagebounds.roofline_pct(run, "score")
