"""The CPU seconds each thread of this process used during a window, from
``/proc/self/task``: the program's scheduler thread runs the engine's host
phases and waits on the device, so its share of the window says how far
the host sets the pace. On a host without ``/proc`` it reads nothing."""
from __future__ import annotations

import os
import threading
from pathlib import Path

_TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def sample() -> dict[int, float]:
    """CPU seconds (user + system) of each thread, by its native id."""
    out = {}
    for task in Path("/proc/self/task").glob("*"):
        try:
            stat = (task / "stat").read_text()
        except OSError:
            continue
        f = stat[stat.rindex(")") + 2:].split()
        out[int(task.name)] = (int(f[11]) + int(f[12])) / _TICK
    return out


def delta(before: dict[int, float], after: dict[int, float], top: int = 4) -> list:
    """The ``top`` threads by CPU seconds between the samples, each as
    [name, seconds], by its Python name where it has one."""
    names = {t.native_id: t.name for t in threading.enumerate()}
    rows = [[names.get(tid, str(tid)), round(s - before.get(tid, 0.0), 3)]
            for tid, s in after.items()]
    return sorted(rows, key=lambda r: -r[1])[:top]
