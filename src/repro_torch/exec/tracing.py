"""One span tree per formed batch: host spans, device time per stage, and
counters at the same boundaries.

A :class:`Record` is one formed batch. The scheduler opens it and stamps
its own spans (``wait``, ``form``, ``batch``, ``deliver``); the engine adds
its phases under ``batch`` (``pin``, ``resolve``, ``plan``, ``candidates``,
``execute``, ``finalize``) and the executor its stages under ``execute``
(``upload``, the plan's stages, ``download``). A span is its name, its
parent and its start and end on ``time.perf_counter_ns()``;
:data:`EPOCH_OFFSET_NS`, taken once, moves any of them onto the Unix-epoch
nanosecond clock that ``torch.profiler`` (Kineto) stamps host ranges and
device activities with.

Host spans, their totals and the counters are always on: a batch costs
about thirty clock reads and one fold. While tracing is on (the engine's
``EngineConfig(metrics=True)``, or while a ``torch.profiler`` session
records, read once a batch), a record also

* enters a ``record_function("freyja::<span>")`` range around each span, so
  a profiler that records all threads shows the program's phases;
* records one timing CUDA event at each stage boundary on the current
  stream. The events are read after the batch's download has synchronized:
  the download's end event, recorded on the idle stream, is the anchor
  whose host time is known, and every other event is placed on the host
  clock by its elapsed time to it. On the CPU a stage's device interval is
  its host interval. Nothing here synchronizes or allocates device memory.

:class:`Tracer` folds finished records into totals (per span name: count,
total, self and max ms; device ms per stage; device idle put down to the
host spans that cover it; counters) and keeps the last :data:`RING` records.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import torch

# perf_counter_ns + EPOCH_OFFSET_NS = the profiler's host clock (ns since the epoch)
EPOCH_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
RING = 4096                      # batch records kept for trace_records()
PREFIX = "freyja::"              # record_function name prefix
EXEC_IDLE = "execute.idle"       # device idle between stages inside a batch
ANCHOR_SLACK_NS = 50_000         # the anchor's record call, bracketed by host clock reads
ANCHOR_TRIES = 3
UNTRACED = "untraced"            # device idle that no host span covers
now = time.perf_counter_ns


def profiling() -> bool:
    """True while a ``torch.profiler`` session records (process-wide, so
    visible from the scheduler's thread)."""
    return bool(torch.autograd.profiler._is_profiler_enabled)


class _Events(threading.local):
    """Each thread's timing events, per device, reused batch after batch: a
    record's events are read before its thread records the next batch's."""

    def __init__(self):
        self.by_device: dict[int, list] = {}


class _Active(threading.local):
    """The record each thread's executor calls write into. A context, as
    :class:`active` sets and restores it, so that ``Executor.execute`` keeps
    its signature for every caller that wraps or replaces it."""

    rec = None


_active = _Active()


def current():
    """The calling thread's active record, or :data:`NULL`."""
    rec = _active.rec
    return NULL if rec is None else rec


class active:
    """``with active(record):`` makes ``record`` (None: none) the calling
    thread's record for the block, so the executor's stages go into it
    without a parameter of their own."""

    __slots__ = ("rec", "prev")

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.prev, _active.rec = _active.rec, self.rec
        return self.rec

    def __exit__(self, *exc):
        _active.rec = self.prev
        return False


class _NoSpan:
    """The context a span of the null record gives."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def begin(self) -> None:
        pass

    def host(self, name: str) -> "_NoSpan":
        return self


_NO_SPAN = _NoSpan()


class NullRecord:
    """Stands in for a record where nothing is traced (warm-up runs, direct
    executor calls)."""

    def span(self, name: str) -> _NoSpan:
        return _NO_SPAN

    def stage(self, name: str, defer: bool = False, anchor: bool = False) -> _NoSpan:
        return _NO_SPAN

    def count(self, key: str, n) -> None:
        pass


NULL = NullRecord()


class _Span:
    """``with record.span(name)``: a host span."""

    __slots__ = ("rec", "name", "i")

    def __init__(self, rec: "Record", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.i = self.rec.open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)
        return False


class _Stage(_Span):
    """``with record.stage(name)``: a host span that is also a device stage.

    ``defer`` starts the device interval at :meth:`begin` instead of at
    entry (the upload's host preparation is no device time); ``host(name)``
    is a child span of host work inside the stage, during which the stage's
    device interval pauses; ``anchor`` makes the stage's end event the
    record's anchor (the download's, recorded on the synchronized stream)."""

    __slots__ = ("defer", "anchor")

    def __init__(self, rec, name, defer, anchor):
        super().__init__(rec, name)
        self.defer, self.anchor = defer, anchor

    def __enter__(self):
        self.i = self.rec.open(self.name)
        if self.rec.timed and not self.defer:
            self.rec.seg_start(self.i)
        return self

    def begin(self) -> None:
        if self.rec.timed:
            self.rec.seg_start(self.i)

    def host(self, name: str) -> "_Pause":
        return _Pause(self, name)

    def __exit__(self, *exc):
        rec = self.rec
        if rec.timed:
            t = rec.seg_end(self.i, self.anchor)
            rec.close(self.i, t)
        else:
            rec.close(self.i)
        return False


class _Pause(_Span):
    """Host work inside a stage: a child span; the stage's device interval
    ends at its start and a new one starts at its end."""

    __slots__ = ("stage",)

    def __init__(self, stage: _Stage, name: str):
        super().__init__(stage.rec, name)
        self.stage = stage

    def __enter__(self):
        if self.rec.timed:
            self.rec.seg_end(self.stage.i)
        self.i = self.rec.open(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.i)
        if self.rec.timed:
            self.rec.seg_start(self.stage.i)
        return False


class Record:
    """One formed batch's span tree: parallel lists, one entry a span (few
    objects, so a ring of them gives the collector little to walk)."""

    __slots__ = ("id", "trace_ids", "names", "parents", "t0", "t1", "counters",
                 "traced", "timed", "device", "dev", "_stack", "_rf", "_segs",
                 "_events", "_n_ev", "_stream", "_anchor")

    def __init__(self, rid: int, traced: bool = False, events: _Events | None = None):
        self.id = rid
        self._events = events if events is not None else _Events()
        self.trace_ids = None            # the batch's list of trace ids (a reference)
        self.names: list[str] = []
        self.parents: list[int] = []
        self.t0: list[int] = []
        self.t1: list[int] = []
        self.counters: dict[str, int] = {}
        self.traced = traced             # record_function ranges on
        self.timed = False               # device intervals on
        self.device = None
        self.dev: dict[int, list] | None = None   # span -> [start, end, ...] (host ns)
        self._stack: list[int] = []
        self._rf: dict[int, object] = {}
        self._segs: dict[int, list] = {}
        self._n_ev = 0
        self._stream = None
        self._anchor = None

    # -- spans ---------------------------------------------------------------

    def arm(self, traced: bool, device) -> None:
        """Once a batch, before its device work: whether tracing is on, and
        the device its stages run on."""
        self.traced = traced
        self.timed = traced and device is not None
        self.device = torch.device(device) if device is not None else None

    def open(self, name: str, t: int | None = None) -> int:
        i = len(self.names)
        # ``names`` last: a reader on another thread (``as_dict``) sees a
        # span only once its other fields are there
        self.parents.append(self._stack[-1] if self._stack else -1)
        self.t0.append(now() if t is None else t)
        self.t1.append(-1)
        self.names.append(name)
        self._stack.append(i)
        if self.traced:
            rf = torch.autograd.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._rf[i] = rf
        return i

    def close(self, i: int, t: int | None = None) -> int:
        rf = self._rf.pop(i, None) if self._rf else None
        if rf is not None:
            rf.__exit__(None, None, None)
        t = now() if t is None else t
        self.t1[i] = t
        if self._stack and self._stack[-1] == i:
            self._stack.pop()
        elif i in self._stack:
            self._stack.remove(i)
        return t

    def top(self) -> int:
        """The innermost open span."""
        return self._stack[-1]

    def next(self, i: int, name: str) -> int:
        """Close span ``i`` and open its sibling ``name`` at the same instant."""
        return self.open(name, self.close(i))

    def unwind(self, first: int) -> None:
        """After a failure: close the spans from index ``first`` on that are
        still open, and drop the batch's device marks."""
        for i in reversed(list(self._stack)):
            if i >= first:
                self.close(i)
        self._segs, self._n_ev, self._stream, self._anchor = {}, 0, None, None

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def stage(self, name: str, defer: bool = False, anchor: bool = False) -> _Stage:
        return _Stage(self, name, defer, anchor)

    def count(self, key: str, n) -> None:
        self.counters[key] = self.counters.get(key, 0) + int(n)

    # -- device intervals ----------------------------------------------------

    def _mark(self):
        """A point on the device timeline: a recorded timing event, or on
        the host the clock."""
        if self.device.type != "cuda":
            return now()
        pool = self._events.by_device.setdefault(self.device.index or 0, [])
        if self._n_ev == len(pool):
            pool.append(torch.cuda.Event(enable_timing=True))
        ev = pool[self._n_ev]
        self._n_ev += 1
        if self._stream is None:
            self._stream = torch.cuda.current_stream(self.device)
        ev.record(self._stream)
        return ev

    def seg_start(self, i: int) -> None:
        self._segs.setdefault(i, []).append(self._mark())

    def seg_end(self, i: int, anchor: bool = False) -> int:
        """End span ``i``'s open device interval; the host time just after.
        An anchor's record call must be bracketed within
        :data:`ANCHOR_SLACK_NS` by host clock reads (a thread preempted
        there would shift the whole batch), else it is recorded again."""
        segs = self._segs.get(i)
        t0 = now()
        if segs is None or len(segs) % 2 == 0:
            return t0
        segs.append(self._mark())
        t = now()
        if anchor and self.device.type == "cuda":
            for _ in range(ANCHOR_TRIES - 1):
                if t - t0 <= ANCHOR_SLACK_NS:
                    break
                t0 = now()
                segs[-1].record(self._stream)
                t = now()
            self._anchor = (segs[-1], t)
        return t

    def read_device(self) -> None:
        """Place the stages' device intervals on the host clock (``dev``).
        Called once the batch's results are on the host."""
        segs, self._segs = self._segs, {}
        self._n_ev, self._stream = 0, None
        if not segs:
            return
        if self.device.type != "cuda":
            self.dev = {i: s[:len(s) // 2 * 2] for i, s in segs.items()}
            return
        anchor, self._anchor = self._anchor, None
        if anchor is None:
            return
        ev_a, t_a = anchor
        if not ev_a.query():           # recorded on an idle stream: done at once
            ev_a.synchronize()
        self.dev = {i: [t_a - int(ev.elapsed_time(ev_a) * 1e6) for ev in s[:len(s) // 2 * 2]]
                    for i, s in segs.items()}

    # -- reading -------------------------------------------------------------

    def depth(self, i: int) -> int:
        d = 0
        while self.parents[i] >= 0:
            i = self.parents[i]
            d += 1
        return d

    def device_window(self) -> tuple[int, int] | None:
        """(first device start, last device end) of the batch's stages."""
        if not self.dev:
            return None
        starts = [s[0] for s in self.dev.values() if s]
        ends = [s[-1] for s in self.dev.values() if s]
        return (min(starts), max(ends)) if starts else None

    def as_dict(self) -> dict:
        """The record ready for a JSON dump; times in ns on the profiler's
        clock (``perf_counter_ns + EPOCH_OFFSET_NS``), -1 for a span still
        open."""
        off = EPOCH_OFFSET_NS
        spans = []
        for i, name in enumerate(list(self.names)):
            s = {"name": name, "parent": self.parents[i], "t0_ns": self.t0[i] + off,
                 "t1_ns": self.t1[i] + off if self.t1[i] >= 0 else -1}
            if self.dev and i in self.dev:
                d = self.dev[i]
                s["device_ns"] = [[d[j] + off, d[j + 1] + off] for j in range(0, len(d), 2)]
            spans.append(s)
        return {"id": self.id, "trace_ids": self.trace_ids, "traced": self.traced,
                "spans": spans, "counters": dict(self.counters)}


def _union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0)


def _top_stage_intervals(rec: Record) -> list[tuple[int, int]]:
    """The device intervals of the stages that no other stage contains."""
    out = []
    for i, d in rec.dev.items():
        p = rec.parents[i]
        while p >= 0 and p not in rec.dev:
            p = rec.parents[p]
        if p < 0:
            out.extend((d[j], d[j + 1]) for j in range(0, len(d), 2))
    return out


def _cover(gaps: list[tuple[int, int]], spans, out: dict) -> None:
    """Add to ``out`` each gap's length, by the innermost span that covers
    each part of it (``UNTRACED`` where none does). ``spans``: (t0, t1,
    depth, name), properly nested on one thread's timeline."""
    marks = []
    for t0, t1, depth, name in spans:
        marks.append((t0, 1, depth, name))
        marks.append((t1, 0, -depth, name))
    marks.sort()
    for g0, g1 in gaps:
        stack: list[str] = []
        t_prev = None
        for t, kind, _, name in marks:
            if t_prev is not None and t > g0 and t_prev < g1:
                lo, hi = max(t_prev, g0), min(t, g1)
                if hi > lo:
                    key = stack[-1] if stack else UNTRACED
                    out[key] = out.get(key, 0) + (hi - lo)
            if kind:
                stack.append(name)
            elif name in stack:
                del stack[len(stack) - 1 - stack[::-1].index(name)]
            t_prev = t
        lo = max(t_prev if t_prev is not None else g0, g0)
        if g1 > lo:
            out[UNTRACED] = out.get(UNTRACED, 0) + (g1 - lo)


class SpanTotals:
    """Per span name: count, total, self and max ns."""

    def __init__(self):
        self.by_name: dict[str, list[int]] = {}

    def add(self, rec: Record, indices) -> None:
        """Fold the closed spans of ``rec`` at ``indices``; a span's self
        time leaves out all its closed children's."""
        child: dict[int, int] = {}
        for i in range(len(rec.names)):
            p = rec.parents[i]
            if p >= 0 and rec.t1[i] >= 0:
                child[p] = child.get(p, 0) + rec.t1[i] - rec.t0[i]
        for i in indices:
            if rec.t1[i] < 0:
                continue
            dur = rec.t1[i] - rec.t0[i]
            row = self.by_name.get(rec.names[i])
            if row is None:
                row = self.by_name[rec.names[i]] = [0, 0, 0, 0]
            row[0] += 1
            row[1] += dur
            row[2] += dur - child.get(i, 0)
            row[3] = max(row[3], dur)

    def as_dict(self) -> dict:
        return {name: {"count": c, "total_ms": tot / 1e6, "self_ms": slf / 1e6,
                       "max_ms": mx / 1e6}
                for name, (c, tot, slf, mx) in sorted(self.by_name.items())}


class Tracer:
    """One engine's totals and its ring of the last :data:`RING` records.
    The caller folds under its own lock."""

    def __init__(self):
        self._ids = itertools.count(1)
        self.ring: deque[Record] = deque(maxlen=RING)
        self.spans = SpanTotals()
        self.device: dict[str, list[int]] = {}     # stage -> [count, ns]
        self.idle: dict[str, int] = {}             # host span -> ns
        self.counters: dict[str, int] = {}
        self.batches = 0
        self.device_batches = 0
        self._prev: Record | None = None
        self._events = _Events()

    def begin(self, traced: bool = False) -> Record:
        return Record(next(self._ids), traced, self._events)

    def fold(self, rec: Record, first: int) -> None:
        """Fold ``rec``'s spans from index ``first`` on, its device intervals
        and its counters, and keep it in the ring."""
        self.spans.add(rec, range(first, len(rec.names)))
        for k, v in rec.counters.items():
            self.counters[k] = self.counters.get(k, 0) + v
        self.batches += 1
        self.ring.append(rec)
        window = rec.device_window()
        if window is None:
            self._prev = None
            return
        self.device_batches += 1
        for i, d in rec.dev.items():
            row = self.device.setdefault(rec.names[i], [0, 0])
            row[0] += 1
            row[1] += sum(d[j + 1] - d[j] for j in range(0, len(d), 2))
        busy = _union_ns(_top_stage_intervals(rec))
        self.idle[EXEC_IDLE] = self.idle.get(EXEC_IDLE, 0) + window[1] - window[0] - busy
        prev, self._prev = self._prev, rec
        pw = prev.device_window() if prev is not None else None
        if pw is None or pw[1] >= window[0]:
            return
        # the device idled from the previous batch's last device end to
        # this one's first start: put it down to the host spans covering it
        spans = [(p.t0[i], p.t1[i], p.depth(i), p.names[i])
                 for p, keep in ((prev, lambda i: prev.t1[i] > pw[1]),
                                 (rec, lambda i: rec.t0[i] < window[0]))
                 for i in range(len(p.names)) if p.t1[i] >= 0 and keep(i)]
        _cover([(pw[1], window[0])], spans, self.idle)

    def totals(self) -> dict:
        return {"batches": self.batches, "device_batches": self.device_batches,
                "spans": self.spans.as_dict(),
                "device_ms": {k: {"count": c, "ms": ns / 1e6}
                              for k, (c, ns) in sorted(self.device.items())},
                "idle_ms": {k: ns / 1e6 for k, ns in sorted(self.idle.items())},
                "counters": dict(sorted(self.counters.items()))}

    def records(self) -> list[dict]:
        return [r.as_dict() for r in list(self.ring)]
