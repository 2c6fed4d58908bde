"""Request/response surface of the discovery service.

Requests enter the system through the continuous-batching runtime
(:class:`~repro.service.scheduler.RequestScheduler`): ``submit`` returns a
future per request, a background worker coalesces queued arrivals into
bucket-snapped micro-batches, and every response carries the split
``queue_ms`` / ``compute_ms`` latency.

``serve_discovery`` survives as a thin **compatibility adapter** over the
scheduler: it drains an iterable of requests and yields responses in
request order, exactly like the synchronous loop it replaced — the
batching underneath is now the scheduler's (coalescing window + bucket
ladder) rather than fixed ``max_batch`` chunks, which only changes *when*
device dispatches happen, never which response belongs to which request.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Iterator, Sequence


@dataclasses.dataclass
class DiscoveryRequest:
    """One discovery-by-attribute query.

    Exactly one of:
    * ``column_id`` — a column already resident in the catalog snapshot
      (position in the snapshot ordering);
    * ``values``    — a raw string column to profile on the fly.
    """

    name: str = "query"
    column_id: int | None = None
    values: Sequence[str] | None = None
    k: int | None = None            # trim below the engine's k if smaller
    # caller-supplied trace id; None lets the scheduler (or the engine,
    # for direct calls) mint one at submit.  Carried through every event
    # and span this request generates.  NOTE: load drivers reuse request
    # objects, so the scheduler's per-submission id lives on the queue
    # item — this field only seeds it
    trace_id: str | None = None
    # stashed (geometry, numeric, words, sigs) profile of an uploaded
    # column — written by DiscoveryEngine.profile_request (the scheduler
    # calls it at submit time, in the submitter's thread) so the formed
    # batch's device path never profiles; keyed by signature geometry and
    # re-profiled on mismatch, z-scored per pinned snapshot at resolve
    _profile: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)

    def __post_init__(self):
        if (self.column_id is None) == (self.values is None):
            raise ValueError("pass exactly one of column_id= or values=")


@dataclasses.dataclass
class ColumnMatch:
    column_id: int
    column: str
    table: str
    score: float


@dataclasses.dataclass
class DiscoveryResponse:
    name: str
    matches: list[ColumnMatch]
    n_candidates: int               # columns actually scored for this query
    cached: bool = False
    queue_ms: float = 0.0           # submit -> batch formation (scheduler)
    compute_ms: float = 0.0         # engine resolve+plan+execute share
    latency_ms: float = 0.0         # queue_ms + compute_ms
    trace_id: str | None = None     # minted at submit, threaded end-to-end
    # per-phase spans [{"phase": str, "ms": float, ...}, ...] partitioning
    # latency_ms exactly: the scheduler contributes profile/queue, the
    # engine contributes pin/resolve/plan/candidates/execute/finalize
    # (batch-level walls divided by batch size, same normalization as
    # compute_ms; an execute span carries "compile_ms" when its bucket/
    # grid paid first contact).  sum(ms) == latency_ms to float precision
    trace: list = dataclasses.field(default_factory=list)


def serve_discovery(engine, requests: Iterable[DiscoveryRequest],
                    max_batch: int = 64,
                    scheduler=None) -> Iterator[DiscoveryResponse]:
    """Drain ``requests`` through ``engine``; yield responses in request
    order.

    Compatibility adapter over :class:`RequestScheduler`: each request is
    submitted as it is drawn from the iterable (with ``block=True``, so a
    full queue is backpressure on the producer, never a shed) and
    responses are yielded strictly in submission order regardless of the
    order batches complete in.  ``max_batch`` caps the scheduler's formed
    batches, preserving the old chunking bound.  Pass an existing
    ``scheduler`` to share one runtime across callers; otherwise a
    private one is created and closed on exhaustion.
    """
    from repro_torch.service.scheduler import RequestScheduler, SchedulerConfig

    own = scheduler is None
    if own:
        scheduler = RequestScheduler(
            engine, SchedulerConfig(max_batch=int(max_batch)))
    pending: deque = deque()
    try:
        for req in requests:
            pending.append(scheduler.submit(req, block=True))
            while pending and pending[0].done():
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()
    finally:
        if own:
            scheduler.close()
