"""Continuous-batching request runtime for the discovery engine.

The synchronous serving surface (``serve_discovery`` draining an iterable
in fixed-size chunks) cannot coalesce arrivals across callers, has no
backpressure, and forms whatever batch size the iterable happened to
yield — mostly *not* the sizes the 2-D grid planner is fastest at.  This
module replaces it with an asynchronous scheduler:

* :meth:`RequestScheduler.submit` is the request entry point: it enqueues
  one :class:`~repro.service.api.DiscoveryRequest` and immediately
  returns a ``concurrent.futures.Future`` that resolves to the
  :class:`~repro.service.api.DiscoveryResponse` (or raises
  :class:`DeadlineExpired`).  Uploaded (``values=``) columns are profiled
  **in the submitter's thread** against the engine's current snapshot
  geometry, so the worker's formed-batch path is pure scoring dispatch;
* a single background worker forms **micro-batches** by coalescing the
  queued arrivals within a bounded wait window (``max_wait_ms``), in
  priority order (higher first, FIFO within a priority);
* formed batches are **snapped to a bucket ladder** (``batch_buckets``):
  the engine pads each batch up to the smallest bucket that fits, so
  only a handful of compiled executables — and the planner grid choices
  measured for exactly those sizes — ever exist, instead of one per odd
  batch size.  The ladder is installed on the engine's planner at
  scheduler construction (``launch.costmodel.derive_batch_buckets`` can
  derive it from a measured ``BENCH_service.json`` batch sweep);
* **deadline-aware admission**: a request submitted with ``deadline_ms=``
  is dropped at batch-formation time once its deadline has passed (its
  future raises :class:`DeadlineExpired`) — a queue that fell behind
  sheds dead work instead of computing answers nobody is waiting for.
  The coalescing window also **shrinks** to the earliest queued
  deadline: the worker never idles past a moment that would expire a
  request it could still serve (``stats()["window_shrunk"]`` counts the
  cut windows);
* **bounded-queue load shedding**: when ``max_queue`` requests are
  already waiting, ``submit`` raises :class:`SchedulerOverloadError`
  (or blocks for backpressure with ``block=True`` — what the
  ``serve_discovery`` compat adapter uses).

Each formed batch runs through ``engine.query_batch`` — one pinned MVCC
snapshot version end-to-end, exactly like a direct call — and every
response carries the split ``queue_ms`` / ``compute_ms`` latency.  The
worker opens each formed batch's span record
(:mod:`repro_torch.exec.tracing`): ``wait`` (blocked for arrivals, or in
the coalescing window), ``form`` (pop, stage, expire), ``batch`` (the
engine's phases under it) and ``deliver`` (``finalize_batch``, with the
done-callbacks futures run on this thread, and the metrics drain); their
totals are ``stats()["trace"]``.
Scheduler counters (formed-batch size histogram, bucket hits,
expirations, sheds, queue depth) surface through ``scheduler.stats()``
and, once attached, under ``engine.stats()["scheduler"]``.

Typical serving-loop wiring::

    engine = DiscoveryEngine.from_catalog(store, model, EngineConfig())
    with RequestScheduler(engine) as scheduler:
        fut = scheduler.submit(request, deadline_ms=50.0)
        ...                          # any thread, any number of callers
        response = fut.result()
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import threading
import time
import typing
from concurrent.futures import Future, InvalidStateError

from repro_torch.exec import tracing
from repro_torch.exec.plan import DEFAULT_BATCH_BUCKETS
from repro_torch.service import events as EV


class DeadlineExpired(TimeoutError):
    """The request's deadline passed while it waited in the queue."""


class SchedulerOverloadError(RuntimeError):
    """The bounded request queue is full; the request was shed."""


@dataclasses.dataclass
class SchedulerConfig:
    max_queue: int = 1024         # bounded admission: beyond this, shed
    max_wait_ms: float = 2.0      # batch-formation coalescing window
    # cap on the number of requests per formed batch; None = top bucket
    max_batch: int | None = None
    # padded-batch bucket ladder; None = the engine's configured ladder,
    # falling back to exec.plan.DEFAULT_BATCH_BUCKETS
    batch_buckets: tuple | None = None
    # hold batch dispatch while the engine's AOT warmup is running
    # (engine.warm_event cleared): admission keeps accepting, deadlines
    # keep counting, but no batch pays a first-contact compile mid-warmup.
    # False dispatches through a running warmup (legacy behaviour)
    wait_for_warm: bool = True
    # injectable time source (monotonic seconds): tests swap in a fake
    # clock (tests/_fixtures.FakeClock) to drive deadline expiry without
    # real sleeps.  The coalescing wait derives its timeout from this
    # clock, so a frozen fake clock must be paired with max_wait_ms=0
    clock: typing.Callable[[], float] = time.perf_counter


@dataclasses.dataclass(eq=False)
class _Item:
    request: object
    future: Future
    t_submit: float
    deadline: float | None        # absolute perf_counter second, or None
    # per-SUBMISSION identity: load drivers reuse request objects, so the
    # trace id lives on the queue item, not the request
    trace_id: str = ""
    profile_ms: float = 0.0       # submit-time upload profiling wall


def finalize_batch(items, responses, t_start: float, *, metrics=None) -> None:
    """Stamp scheduler-side latency fields on each response and resolve
    its future.  Shared by the inline worker path and the fleet replica
    delivery path (:mod:`repro.service.fleet`): ``t_start`` is the moment
    scoring began, so ``queue_ms`` covers coalescing *plus* any replica
    queue wait.  A future that already resolved (a re-dispatched batch
    whose abandoned first owner un-hung later) is left alone — the
    second resolution is swallowed, never raised into a worker thread."""
    for it, r in zip(items, responses):
        r.queue_ms = (t_start - it.t_submit) * 1e3
        r.latency_ms = r.queue_ms + r.compute_ms
        # prepend the scheduler-side spans: profile (measured at submit)
        # and queue (the remainder of queue_ms), so the full trace still
        # sums EXACTLY to latency_ms
        r.trace = ([{"phase": "profile", "ms": it.profile_ms},
                    {"phase": "queue", "ms": r.queue_ms - it.profile_ms}]
                   + r.trace)
        if metrics is not None:
            metrics.observe_response(r)
        try:
            it.future.set_result(r)
        except InvalidStateError:
            pass


def fail_batch(items, exc: BaseException) -> None:
    """Resolve every future in ``items`` with ``exc`` (cancelled or
    already-resolved futures are skipped).  Used by the fleet when a
    batch exhausts its re-dispatch budget — the caller gets a clean
    error, never a silently dropped request."""
    for it in items:
        try:
            it.future.set_exception(exc)
        except InvalidStateError:
            pass


class RequestScheduler:
    """Future-based async front door over a :class:`DiscoveryEngine`.

    One worker thread drives the engine; any number of threads submit.
    The engine's ``query_batch`` stays callable directly (it is
    reentrant) — the scheduler only owns arrival coalescing, batch
    formation, deadlines, and admission control.
    """

    def __init__(self, engine, config: SchedulerConfig | None = None):
        self.engine = engine
        self.config = config or SchedulerConfig()
        self._clock = self.config.clock
        ladder = (self.config.batch_buckets
                  or engine.config.batch_buckets
                  or DEFAULT_BATCH_BUCKETS)
        self.buckets = tuple(sorted(int(b) for b in ladder))
        self._bucket_set = frozenset(self.buckets)
        if self.buckets[0] < 1:
            raise ValueError(f"batch buckets must be >= 1; got {ladder!r}")
        # install the ladder on the engine so ITS padding (and therefore
        # the planner's per-bucket grid choice + compile cache) snaps to
        # the same sizes the scheduler forms.  Deliberately persistent:
        # direct query_batch callers keep snapping to the same shapes
        # after this scheduler closes (padding up is result-transparent —
        # padded rows are sliced off — and shape reuse is the point).
        # A fleet front end (`service.fleet.EngineFleet`) exposes
        # install_buckets to propagate the ladder to every replica
        install = getattr(engine, "install_buckets", None)
        if install is not None:
            install(self.buckets)
        else:
            engine.config.batch_buckets = self.buckets
            engine.planner.config.batch_buckets = self.buckets
        # formed-batch sink: an engine-compatible fleet exposes
        # dispatch_batch — the worker hands the staged batch to the
        # router instead of running it inline, and replica workers
        # resolve the futures (reporting back via note_completed)
        self._dispatch = getattr(engine, "dispatch_batch", None)
        self.max_batch = (int(self.config.max_batch)
                          if self.config.max_batch is not None
                          else self.buckets[-1])
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1; "
                             f"got {self.config.max_batch!r}")

        self._heap: list[tuple[int, int, _Item]] = []
        self._seq = itertools.count()
        self._cv = threading.Condition()
        self._closed = False
        self._stop = False
        self._counters = {"submitted": 0, "completed": 0, "failed": 0,
                          "shed": 0, "expired": 0, "batches": 0,
                          "bucket_hits": 0, "bucket_misses": 0,
                          "window_shrunk": 0, "max_queue_depth": 0,
                          "warm_held": 0}
        self._batch_hist: dict[int, int] = {}
        # the worker's spans; the engine's tracer numbers the records and
        # keeps them (a fleet front end has none: records stay local)
        self._spans = tracing.SpanTotals()
        self._tracer = getattr(engine, "tracer", None)
        # observability plane: adopt the engine's bus/metrics when it has
        # one (EngineConfig.metrics=True); every publish site guards on
        # None so the disabled path stays event-free
        self.events = getattr(engine, "events", None)
        self.metrics = getattr(engine, "metrics", None)
        if self.metrics is not None:
            self.metrics.bind_scheduler(self)
        engine.attach_scheduler(self)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="freyja-scheduler")
        self._worker.start()

    # -- submission ----------------------------------------------------------

    def submit(self, request, *, deadline_ms: float | None = None,
               priority: int = 0, block: bool = False) -> Future:
        """Enqueue ``request``; returns a future for its response.

        ``deadline_ms`` — relative deadline; once passed, the request is
        expired at batch-formation time and the future raises
        :class:`DeadlineExpired`.  ``priority`` — higher runs first
        (FIFO within a priority).  ``block=True`` turns a full queue
        into backpressure (wait for space) instead of an immediate
        :class:`SchedulerOverloadError`.
        """
        with self._cv:
            # cheap pre-check so a shed (or closed-scheduler) request
            # never pays the profiling below; the authoritative check
            # re-runs under the lock at enqueue time
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if len(self._heap) >= self.config.max_queue and not block:
                self._counters["shed"] += 1
                self._publish(EV.REQUEST_SHED, name=request.name,
                              queued=len(self._heap))
                raise SchedulerOverloadError(
                    f"request queue full ({self.config.max_queue} "
                    f"waiting); request {request.name!r} shed")
        # per-submission trace id: minted HERE (or seeded by the caller
        # via request.trace_id) and threaded through every event and span
        # this submission generates
        trace_id = getattr(request, "trace_id", None) or EV.mint_trace_id()
        # the clock starts BEFORE profiling: upload profiling is part of
        # the request's end-to-end latency and of its deadline budget
        now = self._clock()
        profile_ms = 0.0
        if getattr(request, "values", None) is not None:
            # profile the uploaded column HERE, in the submitter's
            # thread: the worker's formed-batch path never pays the
            # per-request device profiling
            self.engine.profile_request(request)
            profile_ms = (self._clock() - now) * 1e3
        item = _Item(request=request, future=Future(), t_submit=now,
                     deadline=(now + deadline_ms / 1e3
                               if deadline_ms is not None else None),
                     trace_id=trace_id, profile_ms=profile_ms)
        with self._cv:
            while True:
                if self._closed:
                    raise RuntimeError("scheduler is closed")
                if len(self._heap) < self.config.max_queue:
                    break
                if not block:
                    self._counters["shed"] += 1
                    self._publish(EV.REQUEST_SHED, name=request.name,
                                  trace_id=trace_id,
                                  queued=len(self._heap))
                    raise SchedulerOverloadError(
                        f"request queue full ({self.config.max_queue} "
                        f"waiting); request {request.name!r} shed")
                self._cv.wait()
            heapq.heappush(self._heap,
                           (-int(priority), next(self._seq), item))
            self._counters["submitted"] += 1
            self._counters["max_queue_depth"] = max(
                self._counters["max_queue_depth"], len(self._heap))
            self._cv.notify_all()
        self._publish(EV.REQUEST_ADMITTED, trace_id=trace_id,
                      name=request.name, priority=int(priority),
                      deadline_ms=deadline_ms, profile_ms=profile_ms)
        return item.future

    def _publish(self, type: str, **payload) -> None:
        if self.events is not None:
            self.events.publish(type, **payload)

    # -- worker -------------------------------------------------------------

    def _loop(self) -> None:
        rec = None
        while True:
            if rec is None:            # a batch that formed empty keeps its record
                traced = self.metrics is not None or tracing.profiling()
                rec = (self._tracer.begin(traced) if self._tracer is not None
                       else tracing.Record(0, traced))
            items = self._next_batch(rec)
            if items is None:
                return
            if not items:
                rec.close(rec.top())                 # its form span
                continue
            self._wait_for_warm(rec)
            self._run_batch(items, rec)
            rec = None

    def _wait_for_warm(self, rec) -> None:
        """Hold batch dispatch while the engine's AOT warmup runs (its
        ``warm_event`` is cleared only for a warmup's duration — it starts
        set, so a never-warmed engine is never held).  Polled so a
        ``close()`` during warmup still shuts the worker down promptly.
        The hold is a ``wait`` span of ``rec``."""
        if not self.config.wait_for_warm:
            return
        ev = getattr(self.engine, "warm_event", None)
        if ev is None or ev.is_set():
            return
        with self._cv:
            self._counters["warm_held"] += 1
        span = rec.next(rec.top(), "wait")
        try:
            while not ev.wait(timeout=0.05):
                with self._cv:
                    if self._stop:
                        return
        finally:
            rec.next(span, "form")

    def _next_batch(self, rec) -> list[_Item] | None:
        """Block for arrivals, coalesce within the wait window, then pop
        up to ``max_batch`` items in priority order.  None = shut down.
        ``rec``'s ``wait`` span covers the blocking and the window; its
        ``form`` span, left open, the rest."""
        span = rec.open("wait")
        with self._cv:
            while not self._heap and not self._stop:
                self._cv.wait()
            if not self._heap:
                rec.close(span)
                return None                      # stopped and drained
            if self.config.max_wait_ms > 0 and not self._stop:
                t_end = self._clock() + self.config.max_wait_ms / 1e3
                while len(self._heap) < self.max_batch and not self._stop:
                    # deadline-aware shrink: waiting past the earliest
                    # queued deadline converts a live request into an
                    # expiration, so the window is cut to that deadline —
                    # the batch forms smaller but every admitted request
                    # that can still make it, makes it
                    bound = t_end
                    for _, _, it in self._heap:
                        if it.deadline is not None and it.deadline < bound:
                            bound = it.deadline
                    left = bound - self._clock()
                    if left <= 0:
                        if bound < t_end:
                            self._counters["window_shrunk"] += 1
                        break
                    self._cv.wait(timeout=left)
            rec.next(span, "form")
            # partition as we pop so expired requests never consume live
            # batch slots: keep drawing from the queue until max_batch
            # UNEXPIRED items are staged (or it drains) — a backlog of
            # dead heads must not shrink the batch the live tail gets
            now = self._clock()
            staged, dead = [], []
            while self._heap and len(staged) < self.max_batch:
                it = heapq.heappop(self._heap)[2]
                if it.deadline is not None and now > it.deadline:
                    dead.append(it)
                else:
                    staged.append(it)
            self._cv.notify_all()                # wake blocked submitters
        # future mutations happen OUTSIDE the lock (done-callbacks may
        # re-enter submit); set_running first — set_exception on a
        # caller-cancelled future would raise and kill the worker
        live, n_expired = [], 0
        for it in dead:
            if it.future.set_running_or_notify_cancel():
                n_expired += 1
                self._publish(EV.REQUEST_EXPIRED, trace_id=it.trace_id,
                              name=it.request.name,
                              waited_ms=(now - it.t_submit) * 1e3)
                it.future.set_exception(DeadlineExpired(
                    f"request {it.request.name!r} expired after "
                    f"{(now - it.t_submit) * 1e3:.1f}ms in queue"))
        for it in staged:
            if it.future.set_running_or_notify_cancel():
                live.append(it)
        if n_expired:
            with self._cv:
                self._counters["expired"] += n_expired
        return live

    def _run_batch(self, items: list[_Item], rec) -> None:
        """Run a formed batch (``rec``'s ``form`` span is the open one)
        and deliver it; fold ``rec``'s spans."""
        t_start = self._clock()
        n = len(items)
        # counters mutate UNDER the lock: stats() snapshots the same
        # dict concurrently, and Python's per-opcode interleaving made
        # the old unlocked increments observable as torn reads
        # (sum(batch_size_hist) != batches mid-update)
        with self._cv:
            self._counters["batches"] += 1
            self._batch_hist[n] = self._batch_hist.get(n, 0) + 1
            key = "bucket_hits" if n in self._bucket_set else "bucket_misses"
            self._counters[key] += 1
        self._publish(EV.BATCH_FORMED, n=n,
                      trace_ids=[it.trace_id for it in items])
        span = rec.top()                         # form
        if self._dispatch is not None:
            # fleet handoff: the router places this formed batch on a
            # replica; that replica's worker resolves the futures (via
            # finalize_batch) and reports back through note_completed
            self._dispatch(items)
            self._fold(rec, span)
            return
        span = rec.next(span, "batch")
        try:
            responses = self.engine.query_batch(
                [it.request for it in items],
                trace_ids=[it.trace_id for it in items], record=rec)
        except BaseException as e:
            with self._cv:
                self._counters["failed"] += n
            for it in items:
                try:
                    it.future.set_exception(e)
                except InvalidStateError:
                    pass
            self._fold(rec, span)
            return
        span = rec.next(span, "deliver")
        finalize_batch(items, responses, t_start, metrics=self.metrics)
        with self._cv:
            self._counters["completed"] += n
        if self.metrics is not None:
            # fold this batch's events into the registry now, so the
            # metrics cursor tails the ring closely (zero-drop guarantee
            # at any load the worker keeps up with) and a scrape between
            # batches sees current counters
            self.metrics.drain()
        self._fold(rec, span)

    def _fold(self, rec, span: int) -> None:
        """Close ``rec``'s last scheduler span and fold the scheduler's
        spans (the record's top level) into ``stats()["trace"]``."""
        rec.close(span)
        top = [i for i, p in enumerate(rec.parents) if p < 0]
        with self._cv:
            self._spans.add(rec, top)

    # -- fleet reporting ----------------------------------------------------

    def note_completed(self, n: int) -> None:
        """Fleet replica workers report delivered requests here so
        ``stats()['completed']`` stays the single source of truth no
        matter which thread finished the batch."""
        with self._cv:
            self._counters["completed"] += int(n)

    def note_failed(self, n: int) -> None:
        with self._cv:
            self._counters["failed"] += int(n)

    # -- lifecycle / observability ------------------------------------------

    def close(self, drain: bool = True) -> None:
        """Stop accepting submissions and shut the worker down.  With
        ``drain=True`` (default) queued requests are still served; with
        ``drain=False`` they fail fast with a ``RuntimeError``."""
        with self._cv:
            if self._closed and self._stop:
                return
            self._closed = True
            self._stop = True
            if not drain:
                while self._heap:
                    _, _, it = heapq.heappop(self._heap)
                    if it.future.set_running_or_notify_cancel():
                        it.future.set_exception(RuntimeError(
                            "scheduler closed before the request was "
                            "served"))
            self._cv.notify_all()
        self._worker.join()

    def __enter__(self) -> "RequestScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._heap)

    def stats(self) -> dict:
        """Scheduler counters: queue depth (current/max), formed-batch
        size histogram, bucket hit/miss counts, expirations, sheds,
        deadline-shrunk coalescing windows; ``trace``: the worker's spans
        (``wait``, ``form``, ``batch``, ``deliver``) by name, each with its
        count and total, self and max ms."""
        with self._cv:
            depth = len(self._heap)
            c = dict(self._counters)
            hist = dict(sorted(self._batch_hist.items()))
            closed = self._closed
            spans = self._spans.as_dict()
        return {
            "queue_depth": depth,
            "max_queue": self.config.max_queue,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "batch_size_hist": hist,
            "closed": closed,
            **c,
            "trace": {"spans": spans},
        }
