"""What the devices did in a traced window, from ``torch.profiler``.

``busy_s`` is the union of each card's activity intervals (kernels, copies,
sets), summed over the cards, in device-seconds, and ``window_s`` the window
times the number of cards, so ``1 - busy_s / window_s`` is the idle share on
one card or on four; ``per_card`` holds each card's union by its device
index. ``device_ops`` are the operations that took most device time, summed
over the cards; and ``idle_gaps`` each card's idle time between activities,
summed by the device operation that ended each gap: the host was preparing
that launch (the profiler records host operations only on the thread that
started it, and the program's work runs on the scheduler's thread, or with a
fleet on the replicas' threads).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.autograd import DeviceType


def start(device) -> torch.profiler.profile | None:
    """A running profiler over the host and, on a card, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _span_ns(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        s = int(e.start_ns())
        return s, s + int(e.duration_ns())
    s = int(e.start_us()) * 1000
    return s, s + int(e.duration_us()) * 1000


def short(name: str) -> str:
    """A device operation's name without its return type and argument list."""
    n = name.strip().removeprefix("void ")
    if n.endswith(")"):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i]
                break
    return n.strip()[:160]


def summarize(prof, window_s: float, top: int = 10, n_cards: int = 1) -> dict:
    """Stop ``prof`` and read it over ``n_cards`` cards: ``busy_s``,
    ``window_s``, ``per_card`` and the two lists of the breakdown."""
    prof.__exit__(None, None, None)
    by_card: dict[int, list] = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_card[int(e.device_index())].append(_span_ns(e) + (short(e.name()),))
    by_op: dict[str, float] = defaultdict(float)
    gaps: dict[str, float] = defaultdict(float)
    per_card = {card: _card_busy(sorted(evs), by_op, gaps)
                for card, evs in sorted(by_card.items())}
    rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"busy_s": sum(per_card.values(), 0.0), "window_s": window_s * n_cards,
            "per_card": per_card, "device_ops": rank(by_op), "idle_gaps": rank(gaps),
            "n_device_events": sum(len(evs) for evs in by_card.values())}


def _card_busy(dev: list, by_op: dict, gaps: dict) -> float:
    """The union of one card's sorted ``(start_ns, end_ns, name)``
    activities in seconds; adds each activity's seconds to ``by_op`` and
    each idle gap to ``gaps`` under the operation that ended it."""
    busy = 0.0
    cur_s = cur_t = None
    for s, t, name in dev:
        by_op[name] += (t - s) * 1e-9
        if cur_t is None:
            cur_s, cur_t = s, t
        elif s > cur_t:
            busy += (cur_t - cur_s) * 1e-9
            gaps["before " + name] += (s - cur_t) * 1e-9
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += (cur_t - cur_s) * 1e-9
    return busy
