"""coarse_roofline_pct.batch: the least time an H100 needs for the window's
tiered ``coarse`` stages (digest probe, proxy fill, priority pass, survivor
select; ``stagebounds``) over the device time the program timed for them,
in percent."""
from perfbench import stagebounds


def read(run):
    return stagebounds.roofline_pct(run, "coarse")
