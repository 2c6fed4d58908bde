"""Engine-replica fleet: N discovery engines behind a load-aware router.

The port of ``repro.service.fleet``. One
:class:`~repro_torch.service.scheduler.RequestScheduler` worker thread is
the whole serving plane of a single engine; this module multiplies the
plane:

* :class:`EngineReplica` — one :class:`~repro_torch.service.engine.DiscoveryEngine`
  (typically a :class:`~repro_torch.service.catalog.CatalogReader` follower
  on its own device slice: one device from
  :func:`repro_torch.launch.mesh.make_replica_devices`, and a mesh from
  :func:`repro_torch.launch.mesh.make_replica_meshes` when the slice holds
  two or more) driven by its own
  worker thread, moving through the lifecycle

  ::

      WARMING ──► SERVING ──► DRAINING ──► EVICTED
         │            │            │
         └────────────┴────────────┴──► EVICTED   (failure / kill / hang)

  A replica warms via ``engine.warmup()`` (the bucket ladder's plans, run
  once) before it takes traffic; draining finishes its queue then retires;
  eviction is terminal and closes the engine so every pinned snapshot
  refcount returns to zero once in-flight work unpins.

* :class:`FleetRouter` — a **pure, deterministic** placement policy over
  :class:`ReplicaSnapshot` tuples: only SERVING replicas are eligible,
  replicas more than ``max_depth_spread`` requests above the least-loaded
  one are excluded (bounded spread ⇒ no ready replica starves), and among
  the rest the one with the lowest estimated completion time
  ``(queue_depth + n_items) × cost_per_item`` wins, ties broken by depth
  then replica id.  ``cost_per_item`` comes from the engine's last
  executed plan through the cost model
  (:func:`repro_torch.launch.costmodel.plan_cost_per_query`).  Purity is
  the point: the property tests drive ``choose`` with arbitrary synthetic
  states.

* :class:`EngineFleet` — owns the replicas, the router, a health-check
  loop (dead-worker and hung-heartbeat eviction), and **batch
  re-dispatch**: a batch stranded on a failed replica is atomically
  transferred and re-placed on a survivor, up to ``max_redispatch``
  attempts, after which its futures fail with a clean
  :class:`~repro_torch.service.scheduler.SchedulerOverloadError` — an
  accepted future always resolves, a batch is never silently dropped.  The
  fleet presents the scheduler-facing engine surface (``dispatch_batch``,
  ``install_buckets``, ``warm_event``, ``profile_request``, ``stats``),
  so ``RequestScheduler(fleet)`` is a drop-in upgrade, and publishes
  ``replica_state`` / ``batch_routed`` / ``batch_redispatched`` events
  on the shared event bus (folded into ``redispatches_total`` /
  ``router_queue_depth`` by :class:`~repro_torch.service.metrics.ServiceMetrics`).

:class:`FaultInjector` is the test hook the hardening layer is built on:
it kills (raises) or hangs (blocks) a replica worker at named points —
``mid_batch``, ``mid_warmup``, ``mid_drain`` — without touching
production code paths.

**Devices and streams.** Each replica's engine lives on the device
:func:`~repro_torch.launch.mesh.make_replica_devices` gives it (its sharded
plans on its slice's mesh). Every kernel launch makes its tensors' card the
thread's current device (``kernels._build.on_device``), so a worker thread
serves a replica on any card. On one card
every replica shares the card and its default stream: torch's current
stream is per thread and starts at the default stream, so the replica
workers, the submitting threads (which profile uploads) and the rolling
refresher all enqueue their work on one stream. Two consequences follow.
The caching allocator reuses a freed block in stream order, so MVCC
retirement (a version's tensors freed on whichever thread unpins it last)
and ``Executor.extended`` (run on the refresher) need no extra
synchronization. And the kernels whose launch stages an ensemble in a
module-global constant bank (the two scorers, ``gbdt_infer``) hold one host
lock a library across their enqueues, which makes each call's conditions
and launches atomic on that one stream. A stream per replica is not done:
it would need ``wait_stream``/``record_stream`` at each of those hand-offs
and a condition buffer per stream.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import typing
from concurrent.futures import Future

from repro_torch.launch.costmodel import plan_cost_per_query
from repro_torch.service import events as EV
from repro_torch.service.scheduler import (SchedulerOverloadError, _Item,
                                           fail_batch, finalize_batch)

# -- replica lifecycle states ------------------------------------------------

WARMING = "warming"
SERVING = "serving"
DRAINING = "draining"
EVICTED = "evicted"
REPLICA_STATES = (WARMING, SERVING, DRAINING, EVICTED)


class ReplicaKilled(RuntimeError):
    """Raised inside a replica worker by an armed kill fault."""


# -- fault injection (test hook) ---------------------------------------------

class FaultInjector:
    """Kill or hang a replica worker at a named execution point.

    Production code never constructs one — the fleet threads an optional
    injector through to each replica, whose worker calls
    ``injector.check(point, replica_id)`` at the named points:

    ``mid_warmup``   before the WARMING replica runs ``engine.warmup()``
    ``mid_batch``    after a batch is claimed, before the engine scores it
    ``mid_drain``    before a DRAINING replica processes a queued batch

    ``kill`` raises :class:`ReplicaKilled` (the worker's failure path
    evicts and re-dispatches); ``hang`` blocks the worker until
    :meth:`release_hangs` — the heartbeat goes stale and the health
    check evicts it.  The points deliberately live in the *fleet* layer,
    outside ``engine.query_batch``: a hung worker holds no snapshot pin,
    so eviction can prove refcounts return to zero.
    """

    POINTS = ("mid_batch", "mid_warmup", "mid_drain")
    MODES = ("kill", "hang")

    def __init__(self):
        self._lock = threading.Lock()
        self._arms: list[dict] = []
        self._release = threading.Event()
        self.fired: list[tuple[str, int, str]] = []

    def arm(self, point: str, *, replica: int | None = None,
            mode: str = "kill", times: int = 1) -> None:
        """Arm ``point`` to fire ``times`` times (on ``replica``, or on
        whichever replica reaches it first when ``None``)."""
        if point not in self.POINTS:
            raise ValueError(f"unknown point {point!r}; want {self.POINTS}")
        if mode not in self.MODES:
            raise ValueError(f"unknown mode {mode!r}; want {self.MODES}")
        with self._lock:
            self._arms.append({"point": point, "replica": replica,
                               "mode": mode, "times": int(times)})

    def check(self, point: str, replica_id: int) -> None:
        with self._lock:
            arm = next((a for a in self._arms
                        if a["point"] == point and a["times"] > 0
                        and a["replica"] in (None, replica_id)), None)
            if arm is None:
                return
            arm["times"] -= 1
            self.fired.append((point, replica_id, arm["mode"]))
            mode = arm["mode"]
        if mode == "kill":
            raise ReplicaKilled(
                f"fault injected at {point} on replica {replica_id}")
        self._release.wait()            # hang until the test releases us

    def release_hangs(self) -> None:
        """Unblock every hung worker (they find their replica evicted and
        exit; any late batch completion loses the delivery claim)."""
        self._release.set()


# -- router ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaSnapshot:
    """One replica's routing-relevant state at a point in time."""

    replica_id: int
    state: str
    queue_depth: int                    # requests queued + in flight
    cost_per_item: float = 1.0          # modeled seconds per request


class FleetRouter:
    """Pure deterministic batch placement over replica snapshots.

    ``choose`` is a function of its arguments alone — no clock, no
    randomness, no internal state — which is what makes the routing
    invariants property-testable:

    * never places on a non-SERVING replica (returns ``None`` if no
      replica serves);
    * deterministic: identical snapshots ⇒ identical placement;
    * bounded spread: a replica more than ``max_depth_spread`` requests
      above the least-loaded SERVING replica is excluded, so by
      induction ``max_depth - min_depth ≤ max_depth_spread + n_items``
      over any placement sequence — no eligible replica starves while
      another backs up unboundedly.
    """

    def __init__(self, max_depth_spread: int = 64):
        if max_depth_spread < 0:
            raise ValueError(
                f"max_depth_spread must be >= 0; got {max_depth_spread}")
        self.max_depth_spread = int(max_depth_spread)

    def choose(self, snapshots: typing.Sequence[ReplicaSnapshot],
               n_items: int = 1) -> int | None:
        """Replica id for the next ``n_items``-request batch, or ``None``
        when no replica is SERVING.  Picks the minimum estimated
        completion time ``(queue_depth + n_items) * cost_per_item`` among
        spread-eligible SERVING replicas (ties: depth, then id)."""
        eligible = [s for s in snapshots if s.state == SERVING]
        if not eligible:
            return None
        d_min = min(s.queue_depth for s in eligible)
        cap = d_min + self.max_depth_spread
        best = min((s for s in eligible if s.queue_depth <= cap),
                   key=lambda s: ((s.queue_depth + n_items)
                                  * max(s.cost_per_item, 1e-12),
                                  s.queue_depth, s.replica_id))
        return best.replica_id


# -- batches -----------------------------------------------------------------

class _FleetBatch:
    """A formed batch moving through the fleet.

    Ownership and completion are both atomic claims so the unavoidable
    races — an evicting health check re-dispatching while the original
    worker finishes, a hung worker un-hanging after its batch was served
    elsewhere — each resolve to exactly one winner:

    * ``assign``/``release`` track which replica currently holds the
      batch; eviction only re-dispatches batches it can ``release`` from
      the dead replica (a batch already transferred is never re-placed
      twice);
    * ``finish`` claims the right to resolve the futures; the loser of a
      double-execution race drops its responses on the floor.
    """

    __slots__ = ("items", "attempts", "owner", "_done", "_lock")

    def __init__(self, items: list):
        self.items = items
        self.attempts = 0               # re-dispatches so far
        self.owner: int | None = None
        self._done = False
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.items)

    def assign(self, replica_id: int) -> bool:
        with self._lock:
            if self._done:
                return False
            self.owner = replica_id
            return True

    def release(self, replica_id: int) -> bool:
        """Take the batch away from ``replica_id`` (eviction). False if
        it already completed or was already transferred elsewhere."""
        with self._lock:
            if self._done or self.owner != replica_id:
                return False
            self.owner = None
            return True

    def finish(self) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            return True

    @property
    def done(self) -> bool:
        return self._done


# -- replica -----------------------------------------------------------------

class EngineReplica:
    """One engine + one worker thread + a bounded lifecycle.

    The worker: warm (optionally via ``engine.warmup()``), flip SERVING,
    then pop queued batches and score them through ``engine.query_batch``
    — one pinned MVCC snapshot per batch, exactly like direct serving.
    Every state flip is reported to the fleet, which publishes the
    ``replica_state`` event and recomputes the fleet-level warm gate.
    """

    def __init__(self, replica_id: int, engine, *, fleet: "EngineFleet",
                 clock: typing.Callable[[], float], injector=None):
        self.replica_id = int(replica_id)
        self.engine = engine
        self._fleet = fleet
        self._clock = clock
        self._injector = injector
        self._cv = threading.Condition()
        self._queue: collections.deque[_FleetBatch] = collections.deque()
        self._inflight: _FleetBatch | None = None
        self._depth = 0                 # requests queued + in flight
        self.state = WARMING
        self.heartbeat = clock()
        self.batches_served = 0
        self.requests_served = 0
        self._worker = threading.Thread(
            target=self._run, daemon=True,
            name=f"freyja-replica-{self.replica_id}")

    def start(self) -> None:
        self._worker.start()

    # -- router-facing views -------------------------------------------------

    def cost_per_item(self) -> float:
        plan = getattr(self.engine, "last_plan", None)
        cost = getattr(plan, "cost", None) if plan is not None else None
        v = plan_cost_per_query(cost)
        return v if v is not None else 1.0

    def snapshot_state(self) -> ReplicaSnapshot:
        with self._cv:
            return ReplicaSnapshot(replica_id=self.replica_id,
                                   state=self.state,
                                   queue_depth=self._depth,
                                   cost_per_item=self.cost_per_item())

    # -- fleet-facing control ------------------------------------------------

    def enqueue(self, batch: _FleetBatch) -> bool:
        """Accept ``batch`` if SERVING.  True also for an already-done
        batch (nothing left to place); False tells the caller to pick
        another replica."""
        with self._cv:
            if self.state != SERVING:
                return False
            if not batch.assign(self.replica_id):
                return True             # completed while in transit
            self._queue.append(batch)
            self._depth += len(batch)
            self._cv.notify_all()
            return True

    def begin_drain(self) -> None:
        """Stop taking new placements; finish the queue, then retire."""
        self._set_state(DRAINING, reason="drain")

    def evict(self, reason: str = "") -> list[_FleetBatch]:
        """Terminal transition: mark EVICTED, close the engine (releasing
        its pinned head snapshot), and return the unfinished batches this
        replica still owned — the fleet re-dispatches them."""
        with self._cv:
            if self.state == EVICTED:
                return []
            old, self.state = self.state, EVICTED
            stranded = list(self._queue)
            self._queue.clear()
            if self._inflight is not None:
                stranded.insert(0, self._inflight)
            self._depth = 0
            self._cv.notify_all()
        self._fleet._on_state(self, old, EVICTED, reason)
        try:
            self.engine.close()
        except Exception:
            pass
        # only batches we can atomically take away from this replica get
        # re-dispatched; ones that completed (or were already transferred
        # by a racing eviction path) are left alone
        return [b for b in stranded if b.release(self.replica_id)]

    # -- worker --------------------------------------------------------------

    def _check_fault(self, point: str) -> None:
        if self._injector is not None:
            self._injector.check(point, self.replica_id)

    def _set_state(self, new: str, reason: str = "") -> None:
        with self._cv:
            old = self.state
            if old == new or old == EVICTED:
                return
            if new == SERVING and old != WARMING:
                return                  # a drain during warmup sticks
            self.state = new
            self._cv.notify_all()
        self._fleet._on_state(self, old, new, reason)

    def _run(self) -> None:
        try:
            self._check_fault("mid_warmup")
            if self.engine.config.warmup and self.engine.warmup_report is None:
                self.engine.warmup()
        except BaseException as e:
            self._fleet._on_replica_failure(self, e)
            return
        self._set_state(SERVING)
        while True:
            with self._cv:
                while not self._queue and self.state == SERVING:
                    self.heartbeat = self._clock()
                    self._cv.wait(timeout=0.05)
                if self.state == EVICTED:
                    return
                if not self._queue:     # DRAINING and queue empty
                    break
                batch = self._queue.popleft()
                self._inflight = batch
                draining = self.state == DRAINING
                self.heartbeat = self._clock()
            t_exec = self._clock()
            try:
                if draining:
                    self._check_fault("mid_drain")
                self._check_fault("mid_batch")
                responses = self.engine.query_batch(
                    [it.request for it in batch.items],
                    trace_ids=[it.trace_id for it in batch.items])
            except BaseException as e:
                self._fleet._on_replica_failure(self, e)
                return
            self._fleet._deliver(self, batch, responses, t_exec)
            with self._cv:
                self._inflight = None
                self._depth -= len(batch)
                self.heartbeat = self._clock()
        # drained: the queue is empty and no new placement can land
        self._fleet._on_drained(self)


# -- fleet -------------------------------------------------------------------

@dataclasses.dataclass
class FleetConfig:
    # router fairness bound: a replica this many requests above the
    # least-loaded one is skipped until the gap closes
    max_depth_spread: int = 64
    # health-check cadence; 0 disables the background thread (tests call
    # check_health() by hand with a fake clock)
    health_interval_s: float = 0.25
    # a busy replica whose heartbeat is older than this is declared hung
    # and evicted (must exceed the worst first batch: kernel builds included)
    hang_timeout_s: float = 30.0
    # WARMING gets its own (much larger) stall budget: a warmup
    # legitimately holds the worker for the whole ladder
    warmup_timeout_s: float = 300.0
    # re-dispatch budget per batch; None = one attempt per replica
    max_redispatch: int | None = None
    # rolling-refresh cadence: the fleet polls the catalog and refreshes
    # replicas onto new manifest versions ONE AT A TIME (each keeps
    # serving its pinned MVCC head while its new state builds, so a
    # manifest advance never pauses the fleet).  0 disables the
    # background thread (tests call roll_refresh() by hand)
    refresh_interval_s: float = 0.0
    # padded-batch ladder installed on every replica at construction
    # (None keeps each engine's own)
    batch_buckets: tuple | None = None
    # injectable time source shared by heartbeats and queue_ms stamping —
    # MUST tick the same epoch as the scheduler's clock
    clock: typing.Callable[[], float] = time.perf_counter


class EngineFleet:
    """N engine replicas + router + health plane, behind the engine
    surface :class:`~repro_torch.service.scheduler.RequestScheduler` expects.

    ``RequestScheduler(fleet)`` hands every formed batch to
    :meth:`dispatch_batch`; replica workers resolve the futures.  The
    fleet is also directly callable (:meth:`query_batch`) for
    scheduler-less use.
    """

    def __init__(self, engines: list, config: FleetConfig | None = None,
                 *, events=None, metrics=None, injector=None):
        if not engines:
            raise ValueError("a fleet needs at least one engine")
        self.config = config or FleetConfig()
        if self.config.max_redispatch is None:
            self.config.max_redispatch = len(engines)
        self._clock = self.config.clock
        # one observability plane for the whole fleet: adopt the given
        # bus, else whatever the first engine carries (from_catalog wires
        # all replicas onto one shared bus)
        self.events = events if events is not None else \
            getattr(engines[0], "events", None)
        self.metrics = metrics if metrics is not None else \
            getattr(engines[0], "metrics", None)
        self.router = FleetRouter(self.config.max_depth_spread)
        self.warm_event = threading.Event()
        self._lock = threading.Lock()
        self._pending: collections.deque[_FleetBatch] = collections.deque()
        self._counters = {"dispatched": 0, "completed": 0, "failed": 0,
                          "redispatches": 0, "evictions": 0,
                          "state_changes": 0, "rolling_refreshes": 0}
        self._scheduler = None
        self._closed = False
        self.replicas = [
            EngineReplica(i, eng, fleet=self, clock=self._clock,
                          injector=injector)
            for i, eng in enumerate(engines)]
        if self.config.batch_buckets is not None:
            self.install_buckets(self.config.batch_buckets)
        for r in self.replicas:
            r.start()
        self._stop = threading.Event()
        self._health = None
        if self.config.health_interval_s > 0:
            self._health = threading.Thread(target=self._health_loop,
                                            daemon=True,
                                            name="freyja-fleet-health")
            self._health.start()
        self._refresher = None
        if self.config.refresh_interval_s > 0:
            self._refresher = threading.Thread(target=self._refresh_loop,
                                               daemon=True,
                                               name="freyja-fleet-refresh")
            self._refresher.start()

    @classmethod
    def from_catalog(cls, catalog, model, engine_config=None, *,
                     n_replicas: int = 2, config: FleetConfig | None = None,
                     devices=None, lazy: bool = False, injector=None
                     ) -> "EngineFleet":
        """Build ``n_replicas`` follower engines over one catalog root.

        ``catalog`` is a :class:`~repro_torch.service.catalog.CatalogStore`
        (or anything with ``.root``) or a root path.  Each replica gets its
        own :class:`~repro_torch.service.catalog.CatalogReader` follower
        and its own slice of ``devices`` (default: every visible card; a
        host without one raises unless the caller passes
        ``devices=[torch.device("cpu")]``): a slice of two or more devices
        becomes the replica's mesh
        (:func:`repro_torch.launch.mesh.make_replica_meshes`), a smaller one
        its device (:func:`repro_torch.launch.mesh.make_replica_devices`);
        all replicas share one event bus + metrics registry when the config
        enables them.  Engine warmup is deferred into each replica's
        WARMING state so the fleet comes up concurrently, not serially.
        """
        from repro_torch.launch.mesh import make_replica_devices, make_replica_meshes
        from repro_torch.service.catalog import CatalogReader
        from repro_torch.service.engine import DiscoveryEngine, EngineConfig

        root = getattr(catalog, "root", catalog)
        engine_config = engine_config or EngineConfig()
        placed = make_replica_devices(n_replicas, devices=devices)
        meshes = make_replica_meshes(n_replicas, devices=devices)
        bus = metrics = None
        if engine_config.metrics:
            from repro_torch.service.metrics import ServiceMetrics
            bus = EV.EventBus()
            metrics = ServiceMetrics(bus)
        engines = []
        for i in range(n_replicas):
            reader = CatalogReader(root, lazy=lazy, events=bus)
            cfg = dataclasses.replace(engine_config, warmup=False)
            eng = DiscoveryEngine(reader.snapshot(lazy=lazy), model,
                                  cfg, device=placed[i], mesh=meshes[i], events=bus)
            # restore the warmup policy AFTER construction: the replica
            # worker runs it inside the WARMING state instead of the
            # constructor running it serially here
            cfg.warmup = engine_config.warmup
            # auto=False: replicas do NOT poll per query batch — the
            # fleet's rolling refresher advances them one at a time, so
            # a manifest advance can never trigger N simultaneous
            # rebuilds across the fleet (the refresh storm)
            eng.follow(reader, auto=False)
            engines.append(eng)
        return cls(engines, config=config, events=bus, metrics=metrics,
                   injector=injector)

    # -- scheduler-compat engine surface ------------------------------------

    @property
    def batch_buckets(self) -> tuple:
        """The padded-batch ladder installed on the replicas."""
        return self.replicas[0].engine.batch_buckets

    def install_buckets(self, buckets: tuple) -> None:
        """Install a padded-batch ladder on every replica, so all planners
        pad identically."""
        for r in self.replicas:
            r.engine.install_buckets(buckets)

    def attach_scheduler(self, scheduler) -> None:
        self._scheduler = scheduler

    def profile_request(self, request) -> None:
        """Profile an uploaded column against the catalog geometry (all
        replicas follow the same catalog, so any live engine's head
        works)."""
        for r in self.replicas:
            if r.state != EVICTED:
                r.engine.profile_request(request)
                return
        raise RuntimeError("no live replica to profile against")

    # -- dispatch ------------------------------------------------------------

    def dispatch_batch(self, items: list) -> None:
        """Scheduler handoff: route one formed batch onto a replica.
        Non-blocking — the replica worker resolves the futures."""
        batch = _FleetBatch(items)
        with self._lock:
            self._counters["dispatched"] += 1
        self._place(batch)

    def query_batch(self, requests: list, *, trace_ids=None,
                    timeout: float | None = None) -> list:
        """Blocking convenience: dispatch and wait.  Lets the fleet stand
        in for an engine with no scheduler in front."""
        now = self._clock()
        if trace_ids is None:
            trace_ids = [getattr(r, "trace_id", "") or EV.mint_trace_id()
                         for r in requests]
        items = [_Item(request=r, future=Future(), t_submit=now,
                       deadline=None, trace_id=t)
                 for r, t in zip(requests, trace_ids)]
        self.dispatch_batch(items)
        return [it.future.result(timeout=timeout) for it in items]

    def _place(self, batch: _FleetBatch) -> None:
        while True:
            snaps = [r.snapshot_state() for r in self.replicas]
            rid = self.router.choose(snaps, n_items=len(batch))
            if rid is None:
                if any(s.state == WARMING for s in snaps):
                    # hold until a replica finishes warming; _on_state
                    # flushes this queue on the WARMING→SERVING flip
                    with self._lock:
                        self._pending.append(batch)
                    if not any(r.state == SERVING for r in self.replicas):
                        return
                    # a replica flipped SERVING between snapshot and
                    # append — reclaim the batch and place it ourselves
                    with self._lock:
                        try:
                            self._pending.remove(batch)
                        except ValueError:
                            return      # a flush beat us to it
                    continue
                self._fail_batch(batch, SchedulerOverloadError(
                    f"no serving replica available for a "
                    f"{len(batch)}-request batch "
                    f"(states: {[s.state for s in snaps]})"))
                return
            if self.replicas[rid].enqueue(batch):
                self._publish(EV.BATCH_ROUTED, replica=rid, n=len(batch),
                              queue_depth=snaps[rid].queue_depth
                              + len(batch))
                return
            # the chosen replica left SERVING between snapshot and
            # enqueue — re-snapshot and pick again

    def _flush_pending(self) -> None:
        while True:
            if not any(r.state == SERVING for r in self.replicas):
                if any(r.state == WARMING for r in self.replicas):
                    return              # a later flip will flush
                with self._lock:
                    stranded = list(self._pending)
                    self._pending.clear()
                for b in stranded:
                    self._fail_batch(b, SchedulerOverloadError(
                        "every fleet replica was evicted before this "
                        "batch could be placed"))
                return
            with self._lock:
                if not self._pending:
                    return
                batch = self._pending.popleft()
            self._place(batch)

    def _redispatch(self, batches: list[_FleetBatch],
                    from_replica: int) -> None:
        for b in batches:
            b.attempts += 1
            if b.attempts > self.config.max_redispatch:
                self._fail_batch(b, SchedulerOverloadError(
                    f"batch of {len(b)} exhausted its re-dispatch budget "
                    f"({self.config.max_redispatch}) after repeated "
                    f"replica failures"))
                continue
            with self._lock:
                self._counters["redispatches"] += 1
            self._publish(EV.BATCH_REDISPATCHED, replica=from_replica,
                          n=len(b), attempts=b.attempts)
            self._place(b)

    def _fail_batch(self, batch: _FleetBatch, exc: Exception) -> None:
        if not batch.finish():
            return
        fail_batch(batch.items, exc)
        with self._lock:
            self._counters["failed"] += len(batch)
        if self._scheduler is not None:
            self._scheduler.note_failed(len(batch))

    # -- replica callbacks ---------------------------------------------------

    def _deliver(self, replica: EngineReplica, batch: _FleetBatch,
                 responses: list, t_exec: float) -> None:
        if not batch.finish():
            return                      # served elsewhere during a race
        finalize_batch(batch.items, responses, t_exec,
                       metrics=self.metrics)
        replica.batches_served += 1
        replica.requests_served += len(batch)
        with self._lock:
            self._counters["completed"] += len(batch)
        if self._scheduler is not None:
            self._scheduler.note_completed(len(batch))
        if self.metrics is not None:
            self.metrics.drain()

    def _on_state(self, replica: EngineReplica, old: str, new: str,
                  reason: str) -> None:
        with self._lock:
            self._counters["state_changes"] += 1
            if new == EVICTED:
                self._counters["evictions"] += 1
        self._publish(EV.REPLICA_STATE, replica=replica.replica_id,
                      state=new, prev=old, reason=reason)
        self._update_warm()
        if new == SERVING or new == EVICTED:
            self._flush_pending()

    def _on_replica_failure(self, replica: EngineReplica,
                            exc: BaseException) -> None:
        stranded = replica.evict(reason=f"{type(exc).__name__}: {exc}")
        if stranded:
            self._redispatch(stranded, replica.replica_id)

    def _on_drained(self, replica: EngineReplica) -> None:
        stranded = replica.evict(reason="drained")
        if stranded:                    # a placement raced the drain
            self._redispatch(stranded, replica.replica_id)

    def _update_warm(self) -> None:
        states = [r.state for r in self.replicas]
        # set while anyone serves — and ALSO once everyone is evicted,
        # so a scheduler holding on warm_event dispatches into _place
        # and gets clean failures instead of hanging forever
        if SERVING in states or all(s == EVICTED for s in states):
            self.warm_event.set()
        else:
            self.warm_event.clear()

    def _publish(self, type: str, **payload) -> None:
        if self.events is not None:
            self.events.publish(type, **payload)

    # -- rolling refresh -----------------------------------------------------

    def _refresh_loop(self) -> None:
        while not self._stop.wait(self.config.refresh_interval_s):
            try:
                self.roll_refresh()
            except Exception:
                pass                    # a torn replica refresh must not
                                        # kill the cadence thread

    def roll_refresh(self) -> int:
        """One rolling-refresh sweep: poll each live replica's follower
        and refresh it onto the newest catalog version, strictly one
        replica at a time.  MVCC keeps the refreshing replica serving
        its pinned head until the new state swaps in, and the other
        replicas are untouched until their turn — so serving never
        pauses and queries are never dropped by an ingest.  Returns how
        many replicas actually moved to a new version."""
        n = 0
        for r in self.replicas:
            if self._closed or r.state == EVICTED:
                continue
            eng = r.engine
            head = getattr(eng, "_head", None)
            v0 = head.version if head is not None else None
            try:
                eng._maybe_follow(force=True)
            except Exception:
                continue                # this replica retries next sweep
            head = getattr(eng, "_head", None)
            if head is not None and head.version != v0:
                n += 1
        if n:
            with self._lock:
                self._counters["rolling_refreshes"] += n
        return n

    # -- health --------------------------------------------------------------

    def _health_loop(self) -> None:
        while not self._stop.wait(self.config.health_interval_s):
            self.check_health()

    def check_health(self, now: float | None = None) -> list[int]:
        """One health sweep: evict replicas whose worker died without
        transitioning, or whose heartbeat is older than the hang
        timeout.  Returns the replica ids evicted this sweep (tests call
        this directly with a pinned ``now``)."""
        now = self._clock() if now is None else now
        evicted = []
        for r in self.replicas:
            if r.state == EVICTED:
                continue
            dead = r._worker.ident is not None and not r._worker.is_alive()
            limit = (self.config.warmup_timeout_s if r.state == WARMING
                     else self.config.hang_timeout_s)
            hung = (now - r.heartbeat) > limit
            if dead or hung:
                why = "worker died" if dead else (
                    f"heartbeat stale for {now - r.heartbeat:.1f}s")
                self._on_replica_failure(r, RuntimeError(why))
                evicted.append(r.replica_id)
        return evicted

    # -- lifecycle / observability ------------------------------------------

    def drain_replica(self, replica_id: int) -> None:
        """Gracefully retire one replica (finish queue, then evict)."""
        self.replicas[replica_id].begin_drain()

    def close(self, drain: bool = True) -> None:
        """Shut the fleet down.  ``drain=True`` lets every replica finish
        its queue first; ``drain=False`` evicts immediately and fails
        whatever was queued with :class:`SchedulerOverloadError`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._health is not None:
            self._health.join()
        if self._refresher is not None:
            self._refresher.join()
        if drain:
            for r in self.replicas:
                r.begin_drain()
            for r in self.replicas:
                r._worker.join(timeout=60.0)
        for r in self.replicas:
            for b in r.evict(reason="close"):
                self._fail_batch(b, SchedulerOverloadError(
                    "fleet closed before this batch ran"))
        with self._lock:
            stranded = list(self._pending)
            self._pending.clear()
        for b in stranded:
            self._fail_batch(b, SchedulerOverloadError(
                "fleet closed before this batch was placed"))
        self._update_warm()

    def __enter__(self) -> "EngineFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def queue_depth(self) -> int:
        return sum(r.snapshot_state().queue_depth for r in self.replicas)

    def stats(self) -> dict:
        with self._lock:
            c = dict(self._counters)
            pending = len(self._pending)
        reps = {}
        for r in self.replicas:
            s = r.snapshot_state()
            reps[r.replica_id] = {
                "state": s.state, "queue_depth": s.queue_depth,
                "cost_per_item": s.cost_per_item,
                "batches_served": r.batches_served,
                "requests_served": r.requests_served,
                "engine_version": getattr(r.engine, "_head", None).version
                if getattr(r.engine, "_head", None) is not None else None,
            }
        out = {
            "n_replicas": len(self.replicas),
            "max_depth_spread": self.router.max_depth_spread,
            "max_redispatch": self.config.max_redispatch,
            "pending": pending,
            "warm": self.warm_event.is_set(),
            "replicas": reps,
            **c,
        }
        if self._scheduler is not None:
            out["scheduler"] = self._scheduler.stats()
        return out
