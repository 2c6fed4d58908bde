"""Structured event bus for the serving plane.

Every serving component publishes typed events into one
:class:`EventBus` — a **bounded, multi-consumer ring buffer**:

* ``publish`` is **non-blocking**: it appends under a short lock and
  returns; a slow (or absent) consumer can never stall the scheduler
  worker, the compactor thread, or a submitter.  When the ring wraps,
  the **oldest** events are overwritten (drop-oldest) — the publisher
  never waits and never fails;
* each consumer holds its own :class:`EventCursor`: cursors advance
  independently, so the metrics aggregator, a debug tail, and a test
  assertion can all read the same stream at their own pace;
* overflow is **accounted per consumer**: a cursor that fell behind the
  ring reports exactly how many events it missed (``cursor.dropped``),
  so "the operator's counters are complete" is a checkable claim, not
  an assumption.

Event taxonomy (the ``type`` strings components publish):

==========================  =================================================
``request_admitted``        scheduler accepted a submission (trace_id, name)
``request_shed``            bounded-queue admission dropped it (queue full)
``request_expired``         deadline passed while queued (waited_ms)
``batch_formed``            worker staged a micro-batch (n, trace_ids)
``cache_hit`` / ``cache_miss``  engine result-cache outcome per batch
``compile_begin`` / ``compile_end``  engine: the executor's first contact
                            with a (plan kind, grid, batch shape), or a
                            warmup unit it ran
``snapshot_pinned``         a query batch pinned an MVCC version
``snapshot_retired``        last reference released; executor closed
``compaction_started`` / ``compaction_published``  background compactor
``manifest_advanced``       catalog manifest chain grew a version
``coarse_pass``             engine, from a tiered run's counts: the
                            super-band digest swept the lake (survivor
                            counts + fraction)
``fine_probe``              engine, from a tiered run: banded probe +
                            scoring ran on the gathered survivors
``warmup_begin``            engine AOT warmup started (scope, buckets,
                            n_plans)
``warmup_end``              warmup finished (executables, hits/misses,
                            wall_ms)
``executable_cache_miss``   warmup compiled one executable fresh (a
                            ``compile_begin``/``end`` pair brackets it)
``replica_state``           a fleet replica changed lifecycle state
                            (replica, state ∈ warming/serving/draining/
                            evicted, reason)
``batch_routed``            the fleet router placed a formed batch on a
                            replica (replica, n, queue_depth)
``batch_redispatched``      a batch was re-dispatched off a failed/evicted
                            replica (replica, n, attempts)
``refresh_begin``           engine snapshot refresh started
                            (version_from, version_to)
``refresh_end``             refresh swapped (version_from, version_to,
                            incremental, delta_columns, bytes_uploaded,
                            recompiles, coalesced, ms)
==========================  =================================================

Payloads are free-form keyword dicts; the constants below are the
canonical type names (components may publish additional types — the bus
does not validate, it transports).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
import typing

REQUEST_ADMITTED = "request_admitted"
REQUEST_SHED = "request_shed"
REQUEST_EXPIRED = "request_expired"
BATCH_FORMED = "batch_formed"
CACHE_HIT = "cache_hit"
CACHE_MISS = "cache_miss"
COMPILE_BEGIN = "compile_begin"
COMPILE_END = "compile_end"
SNAPSHOT_PINNED = "snapshot_pinned"
SNAPSHOT_RETIRED = "snapshot_retired"
COMPACTION_STARTED = "compaction_started"
COMPACTION_PUBLISHED = "compaction_published"
MANIFEST_ADVANCED = "manifest_advanced"
COARSE_PASS = "coarse_pass"
FINE_PROBE = "fine_probe"
WARMUP_BEGIN = "warmup_begin"
WARMUP_END = "warmup_end"
EXECUTABLE_CACHE_MISS = "executable_cache_miss"
REPLICA_STATE = "replica_state"
BATCH_ROUTED = "batch_routed"
BATCH_REDISPATCHED = "batch_redispatched"
REFRESH_BEGIN = "refresh_begin"
REFRESH_END = "refresh_end"

EVENT_TYPES = (
    REQUEST_ADMITTED, REQUEST_SHED, REQUEST_EXPIRED, BATCH_FORMED,
    CACHE_HIT, CACHE_MISS, COMPILE_BEGIN, COMPILE_END,
    SNAPSHOT_PINNED, SNAPSHOT_RETIRED,
    COMPACTION_STARTED, COMPACTION_PUBLISHED, MANIFEST_ADVANCED,
    COARSE_PASS, FINE_PROBE,
    WARMUP_BEGIN, WARMUP_END, EXECUTABLE_CACHE_MISS,
    REPLICA_STATE, BATCH_ROUTED, BATCH_REDISPATCHED,
    REFRESH_BEGIN, REFRESH_END,
)

# trace ids: cheap, process-unique, monotonic within a session — NOT
# uuids (minting happens on the submit hot path)
_TRACE_PREFIX = os.urandom(3).hex()
_trace_counter = itertools.count()


def mint_trace_id() -> str:
    """A process-unique trace id, e.g. ``"3fa9c1-0000002a"``."""
    return f"{_TRACE_PREFIX}-{next(_trace_counter):08x}"


class Event(typing.NamedTuple):
    """One published event.  Immutable; shared by every consumer.

    A NamedTuple rather than a (frozen) dataclass: construction happens
    once per publish on the serving hot path, and the tuple C path is
    several times cheaper than per-field ``object.__setattr__``.
    """

    seq: int                 # bus-assigned, dense, monotonically increasing
    type: str
    t: float                 # wall-clock seconds (time.time())
    payload: dict


class EventCursor:
    """One consumer's position in the bus's ring.

    ``poll`` returns the events published since the last poll (up to
    ``max_events``); when the consumer fell more than the ring capacity
    behind, the overwritten events are skipped and counted in
    ``dropped`` — the stream never blocks and never duplicates.
    """

    def __init__(self, bus: "EventBus", name: str):
        self._bus = bus
        self.name = name
        self.next_seq = bus._next      # subscribe at the current tail
        self.dropped = 0
        self.delivered = 0

    def poll(self, max_events: int | None = None) -> list[Event]:
        return self._bus._poll(self, max_events)

    def close(self) -> None:
        self._bus._unsubscribe(self)


class EventBus:
    """Bounded multi-consumer ring buffer with non-blocking publish."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = int(capacity)
        self._ring: list[Event | None] = [None] * self.capacity
        self._next = 0                   # seq the next publish gets
        self._lock = threading.Lock()
        self._published: dict[str, int] = {}
        self._cursors: list[EventCursor] = []

    # -- publishing ----------------------------------------------------------

    def publish(self, type: str, **payload) -> int:
        """Append one event; returns its seq.  Never blocks on consumers:
        the only wait is the ring's own short lock, and overflow
        overwrites the oldest slot instead of stalling the caller."""
        t = time.time()
        with self._lock:
            seq = self._next
            self._ring[seq % self.capacity] = Event(seq=seq, type=type,
                                                    t=t, payload=payload)
            self._next = seq + 1
            self._published[type] = self._published.get(type, 0) + 1
        return seq

    # -- consuming -----------------------------------------------------------

    def subscribe(self, name: str | None = None) -> EventCursor:
        """New consumer cursor, positioned at the current tail (it sees
        only events published after this call)."""
        with self._lock:
            cur = EventCursor(self, name or f"consumer-{len(self._cursors)}")
            self._cursors.append(cur)
            return cur

    def _poll(self, cursor: EventCursor,
              max_events: int | None = None) -> list[Event]:
        with self._lock:
            head = self._next
            lo = max(cursor.next_seq, head - self.capacity)
            cursor.dropped += lo - cursor.next_seq
            hi = head if max_events is None else min(head, lo + max_events)
            out = [self._ring[i % self.capacity] for i in range(lo, hi)]
            cursor.next_seq = hi
            cursor.delivered += len(out)
        return out

    def _unsubscribe(self, cursor: EventCursor) -> None:
        with self._lock:
            if cursor in self._cursors:
                self._cursors.remove(cursor)

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        """Publisher-side totals per type plus per-consumer delivered /
        dropped accounting (the metrics layer exports these)."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "published": int(self._next),
                "published_by_type": dict(self._published),
                "consumers": {
                    c.name: {"delivered": c.delivered,
                             "dropped": c.dropped,
                             "lag": int(self._next - c.next_seq)}
                    for c in self._cursors
                },
            }
