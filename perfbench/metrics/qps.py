"""qps: queries answered in the window over the window's seconds."""


def read(run):
    w = run.window
    done = w.log.t_done[w.log.answered]
    return float(((done >= w.t_start) & (done <= w.t_stop)).sum()) / w.seconds
