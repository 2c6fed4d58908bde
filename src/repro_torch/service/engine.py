"""DiscoveryEngine: batched query serving over pinned catalog snapshots.

The port of ``repro.service.engine``. The engine is a thin serving shell
around the port's query-execution layer (``repro_torch.exec``): per
micro-batch of concurrent queries it asks the
:class:`~repro_torch.exec.plan.Planner` for a plan (candidate stage and
budget, chosen from lake size and the cost model) and hands the padded batch
to the version's :class:`~repro_torch.exec.executor.Executor`, whose
kernels run on the engine's device (``device=``, default the card). This
module owns only serving concerns:

* **MVCC snapshot pinning**: every query batch pins one immutable
  per-version state (snapshot, LSH index, executor with its resident
  tensors) for its whole pipeline, so a concurrent ``refresh`` — a follower
  picking up a new catalog version, or a compaction swap — never tears a
  batch. Retired versions are released by refcount: the last in-flight
  batch to unpin one closes its executor (after its results reached the
  host) and frees the device tensors;
* request resolution (resident column ids vs uploaded raw columns, which
  are profiled and signed once per signature geometry and stashed on the
  request, so a scheduler can pay that device work at submit time);
* micro-batch padding to the next ``batch_pad`` multiple or, with a bucket
  ladder installed (:meth:`DiscoveryEngine.install_buckets`, from
  ``EngineConfig.batch_buckets`` at construction, by the
  :class:`~repro_torch.service.scheduler.RequestScheduler` or by
  ``warmup``), to the smallest ladder bucket that fits;
* a **cost-aware LRU cache** namespaced by snapshot version, so a result
  computed against version v can never answer a query served at v+1;
* **follower mode** (:meth:`DiscoveryEngine.follow`) and the incremental
  refresh (``EngineConfig.incremental``): an append-only manifest advance
  extends the resident state by its delta rows (``Executor.extended``);
* warmup (:meth:`DiscoveryEngine.warmup`): every bucket of the ladder x the
  plans the mode serves, run once before traffic;
* per-plan serving statistics via :meth:`DiscoveryEngine.stats`, and the
  serving plane's events, the executor's compiles and tier counts included.

Modes (``EngineConfig.mode``): ``lsh`` (the hybrid pruned plan, sharded
over the mesh when the engine has one of several devices), ``full`` (brute
scan on one device), ``sharded`` (brute scan over the mesh), ``tiered``
(coarse digest, then the fine tier over the survivors; local only) and
``auto`` (the planner picks by cost, sharding when the lake justifies the
mesh).

Sharded plans place work on a 2-D (query × data) device grid over the
engine's ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`): the
planner factorizes the mesh into ``grid=(q_shards, d_shards)`` per
micro-batch, or the operator pins one with ``EngineConfig.grid``. The
executed grid is surfaced in ``stats()["last_plan"]``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Callable

import numpy as np

from repro_torch.core import features as FT
from repro_torch.core.ingest import ingest_string_columns
from repro_torch.core.predictor import JoinQualityModel
from repro_torch.device import resolve_device
from repro_torch.exec import tracing
from repro_torch.exec.executor import Executor, pad_rows
from repro_torch.exec.plan import DEFAULT_BATCH_BUCKETS, MODES, Planner, PlannerConfig
from repro_torch.kernels.profile_distance import quantize_profiles_streamed
from repro_torch.service import events as EV
from repro_torch.service.api import ColumnMatch, DiscoveryRequest, DiscoveryResponse
from repro_torch.service.catalog import (CatalogSnapshot, CatalogStore,
                                         fold_moments, manifest_delta,
                                         moments_from_stats, profile_and_sign)
from repro_torch.service.lsh import LSHConfig, LSHIndex

# what ``EngineConfig.executable_cache_dir`` would persist does not exist in
# the port: it compiles no XLA executables, and the only artifacts it builds
# (the kernel libraries) already persist across processes in ``_build``'s
# content-keyed build directory
_NO_EXECUTABLE_CACHE = (
    "executable_cache_dir: the port has no executables to serialize; its "
    "kernel libraries persist across processes in the build directory of "
    "repro_torch.kernels._build, keyed by their sources (see ROADMAP.md)")


@dataclasses.dataclass
class EngineConfig:
    k: int = 10
    mode: str = "lsh"          # "lsh" | "full" | "sharded" | "auto" | "tiered"
    lsh: LSHConfig = dataclasses.field(default_factory=LSHConfig)
    candidate_frac: float = 0.2        # LSH budget as a fraction of the lake
    max_candidates: int = 4096         # absolute cap on that budget
    # resident profile-matrix dtype: "fp32" | "fp16" | "int8" — quantized
    # sidecars shrink the corpus stream (dequant happens after the gather /
    # in-kernel); parity vs fp32 top-k is test-gated
    profile_dtype: str = "fp32"
    batch_pad: int = 8                 # pad micro-batches to this multiple
    # padded-batch bucket ladder installed at construction: micro-batches
    # snap UP to the smallest bucket that fits instead of the next
    # batch_pad multiple, so only the ladder's shapes are ever
    # compiled/planned.  None = batch_pad padding until a scheduler or
    # warmup installs one (DiscoveryEngine.install_buckets)
    batch_buckets: tuple | None = None
    cache_entries: int = 1024
    exclude_same_table: bool = True
    shard_axes: tuple = ("data",)
    cost_fn: Callable | None = None    # measured cost model (planner hook)
    # (q_shards, d_shards) device grid for sharded plans; None lets the
    # planner factorize the mesh per micro-batch from batch size, lake size
    # and the cost model
    grid: tuple | None = None
    # observability: True stands up an EventBus (engine.events) + the
    # standard ServiceMetrics registry (engine.metrics) — every serving
    # component publishes into it and `discover --metrics-port` / a
    # MetricsServer can export it.  False (default) keeps the hot path
    # event-free; per-request phase traces are recorded either way.  True
    # also turns the tracer's device times and profiler ranges on (as a
    # running torch.profiler does; see repro_torch.exec.tracing)
    metrics: bool = False
    # warmup: False = first-contact costs on the serving path; True /
    # "serve" = run the bucket-ladder plans the configured mode would serve
    # once before traffic; "full" = every admissible (bucket × plan kind).
    # The scheduler holds batch dispatch until ``engine.warm_event`` sets
    warmup: bool | str = False
    # the JAX package's persistent executable cache: must stay None (the
    # port raises when it is set — see _NO_EXECUTABLE_CACHE)
    executable_cache_dir: str | None = None
    # delta-proportional refresh: True lets a follower refresh extend the
    # resident state when the manifest advance is append-only (same MinHash
    # geometry, same tombstones, old segments a prefix) — O(delta) hashing
    # and upload instead of an O(lake) rebuild.  Requires float32 resident
    # profiles; any other advance falls back to a rebuild
    incremental: bool = False
    # corpus-axis bucket ladder: pad the placed corpus UP to the smallest
    # bucket that fits (sentinel rows score -inf), so in-bucket ingest
    # deltas keep every plan's budgets and tensor shapes.  None =
    # exact-size placement
    column_buckets: tuple | None = None
    # when live columns exceed this fraction of the current bucket, a
    # daemon thread warms the next bucket's plan set ahead of the crossing
    prewarm_fraction: float = 0.75


@dataclasses.dataclass(eq=False)
class _VersionState:
    """Everything a query batch needs from one catalog version, immutable
    after construction and released by refcount."""

    snapshot: CatalogSnapshot
    # zscored numeric profiles (C, F_NUM): a fp32 ndarray, or a lazy
    # ZscoreView (lazy snapshot + quantized sidecar) — both row-indexable
    z: np.ndarray
    w: np.ndarray                      # word features (C, F_WORDS)
    lsh: LSHIndex
    executor: Executor
    refs: int = 1                      # the head reference
    # the version's FROZEN normalization stats: a delta-built state keeps
    # its predecessor's (mean, std) so resident device rows stay valid
    # without a rescale; every query — resident or uploaded — z-scores
    # against these, never the snapshot's recomputed stats
    mean: np.ndarray | None = None
    std: np.ndarray | None = None
    # accumulated float64 profile moments {count, sum, sumsq}: folded
    # O(delta) per incremental refresh, reconstructed exactly from
    # (mean, std, count) on full builds — feeds stats_drift reporting
    moments: dict | None = None

    @property
    def version(self) -> int:
        return int(self.snapshot.version)


class DiscoveryEngine:
    """Serves discovery queries from pinned catalog snapshots.

    ``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`) is where
    sharded plans run; local plans and query profiling run on ``device``,
    which defaults to the mesh's first device with a mesh, else the card."""

    def __init__(self, snapshot: CatalogSnapshot, model: JoinQualityModel,
                 config: EngineConfig | None = None, *, device=None, mesh=None,
                 events=None):
        config = config if config is not None else EngineConfig()
        if config.mode not in MODES:
            raise ValueError(f"unknown mode {config.mode!r}; "
                             f"want one of {MODES}")
        if config.mode == "sharded" and mesh is None:
            raise ValueError("sharded mode needs a mesh")
        if config.executable_cache_dir is not None:
            raise NotImplementedError(_NO_EXECUTABLE_CACHE)
        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config
        self.model = model
        self.planner = Planner(PlannerConfig(
            k=config.k, candidate_frac=config.candidate_frac,
            max_candidates=config.max_candidates,
            n_bands=config.lsh.n_bands,
            n_coarse_bands=config.lsh.n_coarse_bands,
            shard_axes=tuple(config.shard_axes),
            column_buckets=tuple(config.column_buckets or ())),
            cost_fn=config.cost_fn)
        self.install_buckets(config.batch_buckets or ())
        self._cache: OrderedDict[bytes, tuple[list[ColumnMatch], float]] = \
            OrderedDict()
        self._cache_lock = threading.Lock()
        self._counters = {"queries": 0, "batches": 0, "cache_hits": 0,
                          "cache_misses": 0, "cache_admitted": 0,
                          "cache_rejected": 0, "cache_evicted": 0,
                          "scored_columns": 0,
                          "refreshes": 0, "refreshes_coalesced": 0}
        # one span tree per batch (scheduler -> engine -> executor stages),
        # folded under _slock; see repro_torch.exec.tracing
        self.tracer = tracing.Tracer()
        self._plan_counts: dict[str, int] = {}
        self.last_plan = None
        self._slock = threading.Lock()
        self._head: _VersionState | None = None
        self._live: set[_VersionState] = set()
        self._reader = None
        self._follow_auto = True
        self._scheduler = None
        self._prewarmed: set[int] = set()
        self._refresh_stats = {"count": 0, "incremental": 0, "full": 0,
                               "last_ms": 0.0, "last_delta_columns": 0,
                               "bytes_uploaded_total": 0,
                               "recompiles_total": 0}
        # observability plane: events/metrics exist only when configured
        # (publish sites guard on None so the disabled hot path pays one
        # attribute read, nothing else).  An externally supplied bus
        # (``events=``) is adopted as-is WITHOUT a private aggregator —
        # the fleet shares one bus + one ServiceMetrics across replicas
        self._closed = False
        self.events = events
        self.metrics = None
        if config.metrics and events is None:
            from repro_torch.service.metrics import ServiceMetrics
            self.events = EV.EventBus()
            self.metrics = ServiceMetrics(self.events)
        # warmup plane: warm_event starts SET so a never-warmed engine (or
        # a scheduler racing construction) is not held hostage — warmup()
        # clears it only for its own duration
        self.warm_event = threading.Event()
        self.warm_event.set()
        self.warmup_report: dict | None = None
        self.refresh(snapshot)
        if config.warmup:
            self.warmup()

    @classmethod
    def from_catalog(cls, catalog: CatalogStore, model: JoinQualityModel,
                     config: EngineConfig | None = None, *, device=None, mesh=None):
        return cls(catalog.snapshot(), model, config=config, device=device, mesh=mesh)

    # -- snapshot management (MVCC) -----------------------------------------

    def refresh(self, snapshot: CatalogSnapshot, *,
                _coalesced: int = 0) -> None:
        """Swap in a new catalog snapshot (after add/drop/compact).

        In-flight query batches keep the version they pinned — the old
        state is retired only once its last batch unpins it.  The result
        cache is cleared; entries racing this swap land under the retired
        version's namespace and can never hit again.

        With ``EngineConfig.incremental`` and an attached reader, an
        append-only manifest advance takes the **delta path**: the new
        state extends the predecessor in place (O(delta) hashing, only
        the new rows uploaded, executables inherited — zero recompiles)
        instead of rebuilding from scratch.  ``_coalesced`` counts the
        intermediate manifest versions this refresh collapsed (the
        follower passes it through for observability)."""
        with self._slock:
            if self._closed:     # a follower poll racing eviction: the
                return           # closed engine must not grow new states
            version_from = (self._head.version if self._head is not None
                            else None)
            c_from = (self._head.snapshot.n_columns
                      if self._head is not None else 0)
        t0 = time.perf_counter()
        if self.events is not None:
            self.events.publish(EV.REFRESH_BEGIN, version_from=version_from,
                                version_to=int(snapshot.version))
        st = self._try_delta(snapshot)
        incremental = st is not None
        if st is None:
            st = self._build_state(snapshot)
        with self._slock:
            old, self._head = self._head, st
            self._live.add(st)
            with self._cache_lock:
                self._cache.clear()
            self._counters["refreshes"] += 1
        if old is not None:
            self._release(old)
        recompiles = 0
        if incremental:
            # the delta executor inherited the predecessor's warmed units —
            # no re-warm; near bucket capacity, warm the NEXT bucket in the
            # background
            self._maybe_prewarm(st)
        elif self.config.warmup and self.warmup_report is not None:
            # a rebuilt version means a fresh executor with an empty warm
            # table — re-warm it so the swap doesn't reintroduce first-
            # contact costs (guarded on a prior warmup: __init__'s refresh
            # runs before the configured warmup, which then warms the head)
            report = self.warmup()
            recompiles = int(report.get("cache_misses", 0))
        ms = (time.perf_counter() - t0) * 1e3
        delta_columns = (st.snapshot.n_columns - c_from if incremental
                         else st.snapshot.n_columns)
        bytes_up = int(st.executor.bytes_uploaded)
        with self._slock:
            rs = self._refresh_stats
            rs["count"] += 1
            rs["incremental" if incremental else "full"] += 1
            rs["last_ms"] = ms
            rs["last_delta_columns"] = delta_columns
            rs["bytes_uploaded_total"] += bytes_up
            rs["recompiles_total"] += recompiles
        if self.events is not None:
            self.events.publish(
                EV.REFRESH_END, version_from=version_from,
                version_to=st.version, incremental=incremental,
                delta_columns=delta_columns, bytes_uploaded=bytes_up,
                recompiles=recompiles, coalesced=_coalesced, ms=ms)

    def _try_delta(self, snapshot: CatalogSnapshot) -> _VersionState | None:
        """Build the new head as a delta over the current one, or None
        when the delta path is inadmissible — no reader, incremental off,
        quantized resident profiles, or a manifest advance that is not
        append-only (drop / compaction / re-sign).  The caller then falls
        back to a full rebuild.

        The predecessor is pinned for the duration so a racing release
        can never close its executor mid-extension."""
        cfg = self.config
        if (not cfg.incremental or self._reader is None
                or cfg.profile_dtype != "fp32"):
            return None
        with self._slock:
            if self._closed or self._head is None:
                return None
            old = self._head
            old.refs += 1
        try:
            try:
                old_m = self._reader.manifest(old.version)
                new_m = self._reader.manifest(snapshot.version)
            except KeyError:       # fell off the reader's bounded tail
                return None
            if manifest_delta(old_m, new_m) is None:
                return None
            c_old = old.snapshot.n_columns
            d = snapshot.n_columns - c_old
            if d < 0 or old.mean is None:
                return None
            prof = snapshot.profiles
            # frozen stats: the delta rows z-score with the PREDECESSOR's
            # (mean, std), so the resident device rows need no rescale
            num_new = np.asarray(prof.numeric[c_old:], np.float64)
            z_rows = ((num_new - old.mean) / old.std).astype(np.float32)
            w_rows = np.asarray(prof.words[c_old:])
            lsh = old.lsh.extend(snapshot.signatures[c_old:])
            n_pad = (self.planner.snap_columns(snapshot.n_columns)
                     if self.planner.config.column_buckets else None)
            executor = old.executor.extended(
                z_rows, w_rows,
                table_ids=np.asarray(snapshot.table_ids[c_old:], np.int32),
                band_keys=lsh.keys[c_old:],
                coarse_keys=(None if lsh.coarse is None
                             else lsh.coarse[c_old:]),
                n_padded=n_pad)
            # host z concat is an accepted O(lake) memcpy (MB-scale);
            # the delta-proportionality claim is about device placement,
            # hashing and recompiles
            z = (np.concatenate([np.asarray(old.z, np.float32), z_rows])
                 if d else old.z)
            moments = fold_moments(old.moments, {
                "count": d, "sum": num_new.sum(axis=0),
                "sumsq": (num_new * num_new).sum(axis=0)})
            return _VersionState(snapshot=snapshot, z=z, w=prof.words,
                                 lsh=lsh, executor=executor,
                                 mean=old.mean, std=old.std,
                                 moments=moments)
        except NotImplementedError:
            return None            # executor can't extend this placement
        finally:
            self._release(old)

    # -- next-bucket prewarm -------------------------------------------------

    def _maybe_prewarm(self, st: _VersionState) -> None:
        """Kick a background warm of the NEXT column bucket once occupancy
        crosses ``prewarm_fraction``, so a future bucket-boundary crossing
        swaps onto warmed units."""
        if not (self.planner.config.column_buckets and self.batch_buckets):
            return
        cur = st.executor.n_columns
        if st.snapshot.n_columns < self.config.prewarm_fraction * cur:
            return
        nxt = self.planner.next_column_bucket(cur)
        if nxt is None or nxt in self._prewarmed:
            return
        self._prewarmed.add(nxt)
        threading.Thread(target=self._prewarm_safe, args=(int(nxt),),
                         daemon=True, name="freyja-prewarm").start()

    def _prewarm_safe(self, bucket: int) -> None:
        try:
            self.prewarm_bucket(bucket)
        except Exception:
            pass    # best effort: a failed prewarm only means a
                    # first-contact run at the actual crossing

    def prewarm_bucket(self, bucket: int) -> dict:
        """Synchronously warm the serving plan set at ``bucket`` corpus
        columns on the current head's executor (on a stand-in of that size,
        see ``Executor.aot_compile``). The warmed units land in the head's
        table under corpus-width-qualified keys, which ``Executor.extended``
        carries forward.  ``refresh`` calls this on a daemon thread near
        bucket capacity; tests call it directly."""
        st = self._pin()
        try:
            return st.executor.aot_compile(self._ladder_plans(int(bucket), "serve"),
                                           n_columns=int(bucket),
                                           progress=self._warm_progress)
        finally:
            self._release(st)

    def follow(self, reader, *, auto: bool = True) -> None:
        """Attach a :class:`~repro_torch.service.catalog.CatalogReader`; every
        query batch first tails the manifest chain and refreshes onto the
        newest published version.  ``auto=False`` attaches without the
        per-batch polling — an external driver (the fleet's rolling
        refresher) calls ``_maybe_follow(force=True)`` on its own cadence
        so replicas never all rebuild at once."""
        self._reader = reader
        self._follow_auto = bool(auto)
        # adopt the follower into this engine's observability plane so
        # its manifest_advanced events land on the same bus
        if self.events is not None and getattr(reader, "events", None) is None:
            reader.events = self.events
        self._maybe_follow(force=True)

    def attach_scheduler(self, scheduler) -> None:
        """Register the continuous-batching runtime driving this engine so
        its counters surface under ``stats()["scheduler"]`` (called by
        ``RequestScheduler.__init__``; the latest attached wins)."""
        self._scheduler = scheduler

    @property
    def batch_buckets(self) -> tuple:
        """The installed padded-batch ladder, ascending; empty when none is
        (micro-batches then pad to the next ``batch_pad`` multiple)."""
        return self.planner.config.batch_buckets

    def install_buckets(self, buckets) -> None:
        """Install the padded-batch ladder micro-batches snap to, its one
        copy. It outlives the scheduler that installed it: padding is
        result-transparent, and shape reuse is the point."""
        self.planner.config.batch_buckets = tuple(sorted({int(b) for b in buckets}))

    # -- AOT warmup ----------------------------------------------------------

    def warmup(self, scope: str | None = None) -> dict:
        """Warm the admissible plan set before admitting traffic: every
        bucket of the padded-batch ladder × the plans
        :meth:`Planner.plan_set` enumerates for it (``scope="serve"`` —
        the served plan plus its recall baseline; ``scope="full"`` — every
        admissible candidate kind), each run once on sentinel queries
        (``Executor.aot_compile``).

        With no ladder installed, installs the default one first, so serving
        pads onto the warmed shapes. ``warm_event`` is cleared for the
        duration; a scheduler holds batch dispatch until it sets again.
        Returns (and stashes as ``warmup_report``) the compile/hit counts
        and walls."""
        if scope is None:
            w = self.config.warmup
            scope = w if isinstance(w, str) and w else "serve"
        if scope not in ("serve", "full"):
            raise ValueError(f"unknown warmup scope {scope!r}; "
                             f"want 'serve' or 'full'")
        if not self.batch_buckets:
            self.install_buckets(DEFAULT_BATCH_BUCKETS)
        buckets = self.batch_buckets
        t0 = time.perf_counter()
        self.warm_event.clear()
        st = self._pin()
        try:
            entries = self._ladder_plans(st.executor.n_columns, scope)
            if self.events is not None:
                self.events.publish(EV.WARMUP_BEGIN, scope=scope,
                                    buckets=list(buckets),
                                    n_plans=len(entries))
            report = st.executor.aot_compile(entries, progress=self._warm_progress)
        finally:
            self._release(st)
            self.warm_event.set()
        report["scope"] = scope
        report["buckets"] = list(buckets)
        report["wall_ms"] = (time.perf_counter() - t0) * 1e3
        if self.events is not None:
            self.events.publish(
                EV.WARMUP_END, scope=scope,
                executables=report["n_executables"],
                cache_hits=report["cache_hits"],
                cache_misses=report["cache_misses"],
                wall_ms=report["wall_ms"])
        self.warmup_report = report
        return report

    def _ladder_plans(self, n_columns: int, scope: str) -> list:
        """``(plan, batch)`` for each rung of the installed ladder (else the
        default one) and each plan ``scope`` warms at ``n_columns``."""
        return [(plan, b) for b in self.batch_buckets or DEFAULT_BATCH_BUCKETS
                for plan in self.planner.plan_set(
                    n_columns=n_columns, n_queries=b, mode=self.config.mode,
                    mesh=self.mesh, grid=self.config.grid, scope=scope)]

    def _warm_progress(self, name: str, n_queries: int, remaining: int, ms) -> None:
        """``Executor.aot_compile``'s report of one unit as events:
        ``compile_begin`` before it runs (``ms`` None), then
        ``executable_cache_miss`` and ``compile_end``."""
        if self.events is None:
            return
        unit = dict(plan=name, grid=[], n_queries=n_queries, k=0)
        if ms is None:
            self.events.publish(EV.COMPILE_BEGIN, **unit, source="warmup")
            return
        self.events.publish(EV.EXECUTABLE_CACHE_MISS, name=name,
                            n_queries=n_queries, remaining=remaining)
        self.events.publish(EV.COMPILE_END, **unit, ms=ms, source="warmup")

    def _maybe_follow(self, force: bool = False) -> None:
        reader = self._reader
        if reader is None or (not force and not self._follow_auto):
            return
        new = reader.poll()
        if new:
            # a burst of manifest advances collapses into ONE refresh onto
            # the newest version (latest-snapshot path: race-proof against
            # a compaction deleting an intermediate version's segments) —
            # a follower behind by N versions pays one build, not N
            coalesced = len(new) - 1
            if coalesced:
                with self._slock:
                    self._counters["refreshes_coalesced"] += coalesced
            self.refresh(reader.snapshot(), _coalesced=coalesced)

    def _build_state(self, snapshot: CatalogSnapshot) -> _VersionState:
        prof = snapshot.profiles
        w = prof.words
        lsh = LSHIndex.build(snapshot.signatures, self.config.lsh)
        dt = self.config.profile_dtype
        # corpus-axis bucket padding applies to full builds too, so the
        # traced shapes match what later delta refreshes re-dispatch
        n_pad = (self.planner.snap_columns(snapshot.n_columns)
                 if self.planner.config.column_buckets else None)
        # moments reconstruct EXACTLY from the snapshot stats — no O(lake)
        # float64 pass; delta refreshes fold onto these
        mean, std = prof.mean, prof.std
        moments = moments_from_stats(mean, std, snapshot.n_columns)
        if snapshot.lazy and dt != "fp32":
            # lazy snapshot + quantized sidecar: stream the quantizer over
            # the memmapped raw profiles in blocks (byte-identical sidecar
            # to the eager path) and never materialize the lake-sized fp32
            # z-score matrix — per-row resolve and the exact rescore
            # re-z-score just the rows they gather, through the lazy view
            sidecar, scale = quantize_profiles_streamed(
                prof.numeric, prof.mean, prof.std, dt)
            zv = prof.zscored_view()
            executor = Executor(
                sidecar, w, self.model.gbdt.astuple(),
                table_ids=snapshot.table_ids, band_keys=lsh.keys,
                coarse_keys=lsh.coarse, profile_dtype=dt,
                z_scale=scale, fp32_rows=zv.__getitem__,
                n_padded=n_pad, device=self.device, mesh=self.mesh)
            return _VersionState(snapshot=snapshot, z=zv, w=w, lsh=lsh,
                                 executor=executor, mean=mean, std=std,
                                 moments=moments)
        z = prof.zscored.astype(np.float32)
        executor = Executor(
            z, w, self.model.gbdt.astuple(),
            table_ids=snapshot.table_ids, band_keys=lsh.keys,
            coarse_keys=lsh.coarse,
            profile_dtype=dt, n_padded=n_pad,
            device=self.device, mesh=self.mesh)
        return _VersionState(snapshot=snapshot, z=z, w=w, lsh=lsh,
                             executor=executor, mean=mean, std=std,
                             moments=moments)

    def _pin(self) -> _VersionState:
        with self._slock:
            if self._closed:
                raise RuntimeError("engine is closed")
            st = self._head
            st.refs += 1
        if self.events is not None:      # publish outside the lock
            self.events.publish(EV.SNAPSHOT_PINNED, version=st.version,
                                refs=st.refs)
        return st

    def _release(self, st: _VersionState) -> None:
        with self._slock:
            st.refs -= 1
            dead = st.refs == 0
            if dead:
                self._live.discard(st)
        if dead:
            st.executor.close()
            if self.events is not None:
                self.events.publish(EV.SNAPSHOT_RETIRED, version=st.version)

    # -- lifecycle (fleet drain/evict hook) ---------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Retire this engine: refuse new pins and release the head's
        construction reference.  The drain hook fleet eviction relies on —
        in-flight batches keep their pinned version until their own
        ``finally`` unpins it, so once the last one finishes every live
        state's refcount reaches zero and its executor is closed.
        Idempotent; a closed engine still answers ``stats()``."""
        with self._slock:
            if self._closed:
                return
            self._closed = True
            head = self._head
        if head is not None:
            self._release(head)

    # -- compat surface (head-state views) ----------------------------------

    @property
    def snapshot(self) -> CatalogSnapshot:
        return self._head.snapshot

    @property
    def version(self) -> int:
        return self._head.version

    @property
    def lsh(self) -> LSHIndex:
        return self._head.lsh

    @property
    def _executor(self) -> Executor:
        return self._head.executor

    @property
    def _z_np(self) -> np.ndarray:
        return self._head.z

    @property
    def _w_np(self) -> np.ndarray:
        return self._head.w

    @property
    def n_columns(self) -> int:
        return self._head.snapshot.n_columns

    @property
    def candidate_budget(self) -> int:
        return self.planner.candidate_budget(self.n_columns)

    # -- query path ---------------------------------------------------------

    def query(self, request: DiscoveryRequest) -> DiscoveryResponse:
        return self.query_batch([request])[0]

    def query_batch(self, requests: list[DiscoveryRequest], *,
                    trace_ids: list[str] | None = None, record=None
                    ) -> list[DiscoveryResponse]:
        """Serve one micro-batch against one pinned snapshot version.

        Reentrant: the scheduler's worker, direct callers, and racing
        ``refresh``/follower swaps may all run concurrently — each call
        pins its own version end-to-end and the result cache/counters
        are lock-guarded.  ``compute_ms`` on each response is this
        call's per-query share; ``queue_ms`` stays 0 unless a scheduler
        delivered the batch.  ``trace_ids`` threads the scheduler's
        per-submission ids through; direct callers get fresh ids (or the
        request's own ``trace_id``) and a trace whose spans sum to
        ``compute_ms``.  ``record`` is the scheduler's
        :class:`~repro_torch.exec.tracing.Record` of the formed batch,
        whose open ``batch`` span the engine's phases go under; without
        one the engine opens a record of its own."""
        t0 = tracing.now()
        if trace_ids is None:
            trace_ids = [r.trace_id or EV.mint_trace_id() for r in requests]
        rec = self.tracer.begin() if record is None else record
        rec.trace_ids = trace_ids
        rec.arm(self.config.metrics or tracing.profiling(), self.device)
        first = len(rec.names)
        root = rec.open("batch", t0) if record is None else None
        phase = rec.open("pin", t0)
        try:
            self._maybe_follow()
            st = self._pin()
            try:
                responses, counts = self._query_pinned(st, requests, trace_ids, rec, phase)
            finally:
                self._release(st)
        except BaseException:
            rec.unwind(first)
            raise
        if root is not None:
            rec.close(root)
        rec.read_device()
        with self._slock:                  # one locked fold per batch
            if counts is not None:
                n_req, n_todo, scored = counts
                self._counters["queries"] += n_req
                self._counters["batches"] += 1
                self._counters["cache_hits"] += n_req - n_todo
                self._counters["cache_misses"] += n_todo
                self._counters["scored_columns"] += scored
            self.tracer.fold(rec, first)
        return responses

    def _query_pinned(self, st: _VersionState, requests: list[DiscoveryRequest],
                      trace_ids: list[str], rec, phase: int):
        """The batch's responses and its counts ``(requests, misses, scored
        columns)``, or None where the snapshot is empty. ``phase`` is the
        open ``pin`` span; the phases that follow it are contiguous, so the
        per-query shares in each response's trace sum EXACTLY to
        ``compute_ms``."""
        if st.snapshot.n_columns == 0:
            rec.close(phase)
            return [DiscoveryResponse(name=r.name, matches=[],
                                      n_candidates=0, trace_id=tid)
                    for r, tid in zip(requests, trace_ids)], None
        phases = [phase]

        def step(name: str) -> None:
            phases.append(rec.next(phases[-1], name))

        step("resolve")
        zq, wq, sigq, tq, qid = self._resolve(requests, st)
        keys = [self._cache_key(st, zq[i], wq[i], sigq[i], requests[i])
                for i in range(len(requests))]

        responses: list[DiscoveryResponse | None] = [None] * len(requests)
        todo = []
        scored = 0
        for i, key in enumerate(keys):
            hit = self._cache_get(key)
            if hit is not None:
                responses[i] = DiscoveryResponse(
                    name=requests[i].name,
                    matches=self._trim(hit, requests[i]),
                    n_candidates=0, cached=True, trace_id=trace_ids[i])
            else:
                todo.append(i)

        compile_ms = None
        if todo:
            step("plan")
            scores, ids, ncand, plan, compile_ms = self._rank_rows(
                zq[todo], wq[todo], sigq[todo], tq[todo], qid[todo], st,
                step=step, trace=rec)
            # the plan's cost was modeled for the PADDED batch — normalize
            # by that count, not len(todo), or a lone miss looks batch_pad×
            # costlier than the same query served in a full batch
            cost_per_query = (plan.cost.get("total_flops", 0.0)
                              / max(plan.cost.get("n_queries", 1), 1))
            with rec.span("matches"):
                matches = [self._matches(scores[row], ids[row], st)
                           for row in range(len(todo))]
            with rec.span("cache"):      # admitted in row order
                walked = 0
                for row, i in enumerate(todo):
                    walked += self._cache_put(keys[i], matches[row], cost_per_query)
                rec.count("cache_walked", walked)
            with rec.span("respond"):
                for row, i in enumerate(todo):
                    responses[i] = DiscoveryResponse(
                        name=requests[i].name,
                        matches=self._trim(matches[row], requests[i]),
                        n_candidates=int(ncand[row]), trace_id=trace_ids[i])
                    scored += int(ncand[row])
            rec.count("scored_columns", scored)
        else:
            step("finalize")

        if self.events is not None:
            missed = set(todo)
            hits = [trace_ids[i] for i in range(len(requests)) if i not in missed]
            if hits:
                self.events.publish(EV.CACHE_HIT, n=len(hits),
                                    trace_ids=hits, version=st.version)
            if todo:
                self.events.publish(EV.CACHE_MISS, n=len(todo),
                                    trace_ids=[trace_ids[i] for i in todo],
                                    version=st.version)
        t_end = rec.close(phases[-1])
        n = max(len(requests), 1)
        dt_ms = (t_end - rec.t0[phase]) / 1e6 / n
        spans = [{"phase": rec.names[j], "ms": (rec.t1[j] - rec.t0[j]) / 1e6 / n}
                 for j in phases]
        if compile_ms is not None:
            for s in spans:                # annotate, never add a span —
                if s["phase"] == "execute":  # the sum must stay exact
                    s["compile_ms"] = compile_ms
        for r in responses:
            r.compute_ms = dt_ms
            r.latency_ms = r.queue_ms + dt_ms
            r.trace = r.trace + [dict(s) for s in spans]
        return responses, (len(requests), len(todo), scored)

    def trace_records(self) -> list[dict]:
        """The last :data:`~repro_torch.exec.tracing.RING` batch records,
        oldest first, ready for a JSON dump: each span's name, parent index,
        start and end (ns on the profiler's clock), the stages' device
        intervals where they were timed, and the batch's counters."""
        with self._slock:
            return self.tracer.records()

    # -- observability ------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters for capacity planning (the ``/stats`` payload):
        query/batch totals, cache hit/miss/admission counts, the per-plan
        query histogram, snapshot-version lifecycle (current version,
        refresh count, live pinned states), the last executed plan with
        its modeled cost, and — when a :class:`RequestScheduler` is
        attached — the scheduler's counters (queue depth, formed-batch
        size histogram, bucket hits, expirations, sheds).  ``trace`` holds
        the tracer's totals: per span name its count and total, self and max
        ms; device ms per stage; device idle ms put down to the host spans
        that covered it (``execute.idle`` between stages); the counters."""
        # one consistent snapshot: counters, cache occupancy, plan
        # histogram and version lifecycle are all read under the same
        # locks that guard their writers (lock order _slock -> _cache_lock
        # matches refresh()), so a stats() racing a batch fold or a cache
        # admission can never see a torn view (e.g. hits+misses != queries)
        with self._slock:
            plans = dict(self._plan_counts)
            head = self._head
            version = head.version
            n_columns = head.snapshot.n_columns
            exec_columns = head.executor.n_columns
            live = len(self._live)
            rs = dict(self._refresh_stats)
            prewarmed = sorted(self._prewarmed)
            trace = self.tracer.totals()
            with self._cache_lock:     # admission counters live under it
                c = dict(self._counters)
                cache_size = len(self._cache)
        out = {
            "queries": c["queries"], "batches": c["batches"],
            "scored_columns": c["scored_columns"],
            "cache": {
                "hits": c["cache_hits"], "misses": c["cache_misses"],
                "admitted": c["cache_admitted"],
                "rejected": c["cache_rejected"],
                "evicted": c["cache_evicted"],
                "size": cache_size,
                "capacity": self.config.cache_entries,
            },
            "plans": plans,
            "n_columns": n_columns,
            "snapshot": {"version": version, "refreshes": c["refreshes"],
                         "live_states": live},
            "refresh": {**rs,
                        "coalesced": c["refreshes_coalesced"],
                        "stats_drift": _stats_drift(head),
                        "column_bucket": exec_columns,
                        "prewarmed": prewarmed},
            "trace": trace,
        }
        if self._scheduler is not None:
            out["scheduler"] = self._scheduler.stats()
        if self.last_plan is not None:
            p = self.last_plan
            out["last_plan"] = {"kind": p.kind, "budget": p.budget,
                                "n_shards": p.n_shards,
                                "grid": list(p.grid), "k": p.k,
                                "cost": p.cost}
        return out

    # -- internals ----------------------------------------------------------

    def _pad_target(self, n_queries: int) -> int:
        """Padded size of an ``n_queries`` micro-batch: the installed bucket
        ladder, else the next ``batch_pad`` multiple."""
        if self.batch_buckets:
            return self.planner.snap_batch(n_queries)
        bp = max(self.config.batch_pad, 1)
        return -(-max(int(n_queries), 1) // bp) * bp

    def _rank_rows(self, zq, wq, sigq, tq, qid,
                   st: _VersionState | None = None, step=None, trace=None):
        """Plan + execute one padded micro-batch through ``repro_torch.exec``:
        ``(scores, ids, n_scored, plan, compile_ms)``, ``compile_ms`` the
        wall of a shape's first contact, else None.

        ``step(name)`` (optional) opens each contiguous phase after the
        caller's ``plan`` — candidates / execute / finalize — of its span
        tree; ``trace`` is the batch's record, which the executor's stages
        go into. Publishes the compile and tier events."""
        step = step or (lambda name: None)
        st = st if st is not None else self._head
        (zq, wq, sigq, tq, qid), q = pad_rows(
            (zq, wq, sigq, tq, qid),
            self._pad_target(np.asarray(zq).shape[0]))
        pad = zq.shape[0]

        # plan against the executor's (bucket-padded) corpus width, not
        # the live count: plan statics then stay fixed inside a bucket,
        # which is what lets an in-bucket ingest delta re-dispatch the
        # same compiled executables with zero recompiles
        plan = self.planner.plan(n_columns=st.executor.n_columns,
                                 n_queries=pad, mode=self.config.mode,
                                 mesh=self.mesh, grid=self.config.grid)
        step("candidates")
        qkeys = (st.lsh.query_keys(sigq) if plan.candidates != "all"
                 else None)
        qcoarse = (st.lsh.coarse_query_keys(sigq)
                   if plan.candidates == "tiered" else None)
        step("execute")
        ex, ev = st.executor, self.events
        first = ex.first_contact(plan, pad)
        shape = dict(plan=plan.kind, grid=list(plan.grid), n_queries=pad, k=plan.k)
        if first and ev is not None:
            ev.publish(EV.COMPILE_BEGIN, **shape)
        t0 = time.perf_counter()
        with tracing.active(trace):
            res = ex.execute(plan, zq, wq, tq, qid, qkeys=qkeys, qcoarse=qcoarse)
        compile_ms = (time.perf_counter() - t0) * 1e3 if first else None
        sc, ids, ncand = res
        if first and ev is not None:
            ev.publish(EV.COMPILE_END, **shape, ms=compile_ms)
        if ev is not None and res.tier is not None:
            n_hits, n_surv = res.tier
            ev.publish(EV.COARSE_PASS, n_queries=pad, n_columns=ex.n_live,
                       survivor_budget=plan.survivor_budget, hits_mean=float(n_hits.mean()),
                       survivors_mean=float(n_surv.mean()), survivors_max=int(n_surv.max()),
                       survivor_fraction=float(n_surv.mean()) / max(ex.n_live, 1))
            ev.publish(EV.FINE_PROBE, n_queries=pad, budget=plan.budget,
                       survivor_budget=plan.survivor_budget, scored_mean=float(ncand.mean()))
        step("finalize")
        self.last_plan = plan
        with self._slock:
            self._plan_counts[plan.kind] = \
                self._plan_counts.get(plan.kind, 0) + q
        return sc[:q], ids[:q], ncand[:q], plan, compile_ms

    def _resolve(self, requests, st: _VersionState | None = None):
        """Requests -> stacked (zq, wq, sigq, tq, qid) numpy rows."""
        st = st if st is not None else self._head
        snap = st.snapshot
        n = len(requests)
        zq = np.zeros((n, FT.F_NUM), np.float32)
        wq = np.zeros((n, FT.F_WORDS), np.uint32)
        sigq = np.zeros((n, snap.signatures.shape[1]), np.uint32)
        tq = np.full((n,), -1, np.int32)
        qid = np.full((n,), -1, np.int32)

        external = [i for i, r in enumerate(requests) if r.values is not None]
        for i, req in enumerate(requests):
            if req.column_id is not None:
                cid = int(req.column_id)
                if not 0 <= cid < snap.n_columns:
                    raise IndexError(f"column_id {cid} outside catalog "
                                     f"(0..{snap.n_columns - 1})")
                zq[i] = st.z[cid]
                wq[i] = st.w[cid]
                sigq[i] = snap.signatures[cid]
                qid[i] = cid
                if self.config.exclude_same_table:
                    tq[i] = int(snap.table_ids[cid])
        if external:
            profs = self._ensure_profiled([requests[i] for i in external],
                                          st)
            prof = snap.profiles
            # the version's FROZEN stats, not the snapshot's recomputed
            # ones: a delta-built state z-scored its resident rows with
            # the predecessor's (mean, std), and uploaded queries must
            # live in the same space or scores skew post-ingest
            mean = st.mean if st.mean is not None else prof.mean
            std = st.std if st.std is not None else prof.std
            for (_, num, words, sigs), i in zip(profs, external):
                zq[i] = (num - mean) / std
                wq[i] = words
                sigq[i] = sigs
        return zq, wq, sigq, tq, qid

    def profile_request(self, request: DiscoveryRequest) -> None:
        """Profile + MinHash an uploaded (``values=``) request against the
        current head's signature geometry and stash the raw profile on the
        request.  The scheduler calls this at **submit time**, in the
        submitter's thread, so the worker's formed-batch path is pure
        scoring dispatch; a no-op for resident (``column_id=``) requests
        and for requests already stashed with a matching geometry."""
        if request.values is None:
            return
        st = self._pin()
        try:
            self._ensure_profiled([request], st)
        finally:
            self._release(st)

    def _ensure_profiled(self, requests, st: _VersionState) -> list[tuple]:
        """Return one (geometry, numeric, words, sigs) profile per request
        for ``st``'s signature geometry, stashing fresh ones on the
        requests.  The stash is geometry-keyed, not version-keyed: a
        refresh that keeps the MinHash geometry reuses the device
        profiling and only re-z-scores (cheap numpy) at resolve.  The
        returned tuples — not re-reads of the mutable stash, which a
        concurrent profile against a different geometry may replace — are
        what the caller must consume."""
        snap = st.snapshot
        geom = (sigq_width(snap), int(snap.minhash_seed))
        out: dict[int, tuple] = {}
        todo, queued = [], set()
        for r in requests:
            p = r._profile                 # snapshot the mutable field once
            if p is not None and p[0] == geom:
                out[id(r)] = p
            elif id(r) not in queued:      # one profile per request object
                queued.add(id(r))
                todo.append(r)
        if todo:
            batch, _ = ingest_string_columns(
                [(r.name, r.values) for r in todo])
            num, words, sigs = profile_and_sign(batch, *geom,
                                                device=self.device)
            for row, r in enumerate(todo):
                p = (geom, num[row], words[row], sigs[row])
                r._profile = p
                out[id(r)] = p
        return [out[id(r)] for r in requests]

    def _matches(self, scores, ids,
                 st: _VersionState | None = None) -> list[ColumnMatch]:
        st = st if st is not None else self._head
        snap = st.snapshot
        out = []
        for s, i in zip(scores, ids):
            if not np.isfinite(s) or i < 0:
                continue
            tid = int(snap.table_ids[i])
            out.append(ColumnMatch(
                column_id=int(i), column=snap.names[i],
                table=snap.table_names.get(tid, str(tid)),
                score=float(s)))
        return out

    def _trim(self, matches, request):
        k = request.k if request.k is not None else self.config.k
        return list(matches[:k])

    def _cache_key(self, st: _VersionState, z_row, w_row, sig_row,
                   request) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(z_row.tobytes())
        h.update(w_row.tobytes())
        h.update(sig_row.tobytes())     # LSH results depend on the signature
        h.update(f"{self.config.mode}|{self.config.k}|"
                 f"{self.config.exclude_same_table}|"
                 f"{request.column_id}".encode())
        # version prefix = cache namespace: an insert racing a refresh lands
        # under its (retired) version and is unreachable from the new head
        return st.version.to_bytes(8, "big", signed=True) + h.digest()

    def _cache_get(self, key):
        with self._cache_lock:
            hit = self._cache.get(key)
            if hit is None:
                return None
            self._cache.move_to_end(key)
            return hit[0]

    def _cache_put(self, key, matches, cost: float) -> int:
        """Cost-aware admission: when full, the cheapest (oldest on ties)
        resident entry is the victim — and a new entry cheaper than every
        resident one is not admitted at all (cheap plans are cheap to
        recompute; a full-scan result outranks any pruned one). Returns the
        entries the victim search walked."""
        cap = self.config.cache_entries
        if cap <= 0:
            return 0
        with self._cache_lock:
            if key in self._cache:
                self._cache[key] = (matches, cost)
                self._cache.move_to_end(key)
                return 0
            walked = 0
            if len(self._cache) >= cap:
                victim, vcost = None, np.inf
                walked = len(self._cache)
                for k_, (_, c_) in self._cache.items():  # oldest-first:
                    if c_ < vcost:                       # ties go oldest
                        victim, vcost = k_, c_
                if cost < vcost:
                    self._counters["cache_rejected"] += 1
                    return walked
                del self._cache[victim]
                self._counters["cache_evicted"] += 1
            self._cache[key] = (matches, cost)
            self._counters["cache_admitted"] += 1
            return walked


def _stats_drift(st: _VersionState) -> float:
    """How far the lake's TRUE normalization has drifted from the state's
    frozen (mean, std), in current-std units: ``max |mean_now - frozen| /
    std_now``.  Delta refreshes fold true moments O(delta), so this stays
    exact without rescoring anything; operators watch it to decide when a
    full rebuild (which re-freezes the stats) is worth scheduling."""
    m, frozen = st.moments, st.mean
    if m is None or frozen is None or not int(m["count"]):
        return 0.0
    n = float(m["count"])
    mean_now = np.asarray(m["sum"], np.float64) / n
    var = np.maximum(np.asarray(m["sumsq"], np.float64) / n
                     - mean_now * mean_now, 0.0)
    std_now = np.maximum(np.sqrt(var), 1e-6)
    return float(np.max(np.abs(mean_now - np.asarray(frozen, np.float64))
                        / std_now))


def sigq_width(snapshot: CatalogSnapshot) -> int:
    return int(snapshot.signatures.shape[1])


def measure_recall(engine: DiscoveryEngine, query_ids: np.ndarray,
                   k: int | None = None) -> dict:
    """Recall@k of the engine's (pruned) top-k against the full scan on the
    same pinned snapshot version, plus the fraction of the lake scored.

    Shard-aware on both sides: the pruned run reports the global number of
    columns scored (summed over the data shards only), and the exact
    baseline is the sharded full scan on the same (q_shards, d_shards) grid
    whenever the engine's plan is sharded."""
    k = k or engine.config.k
    if k > engine.config.k:
        raise ValueError(f"k={k} exceeds the engine's configured "
                         f"k={engine.config.k}; the pruned side can only "
                         f"return config.k results")
    reqs = [DiscoveryRequest(name=f"q{int(q)}", column_id=int(q), k=k)
            for q in query_ids]
    st = engine._pin()                  # both sides see one version
    try:
        zq, wq, sigq, tq, qid = engine._resolve(reqs, st)
        got_s, got_ids, ncand, plan, _ = engine._rank_rows(zq, wq, sigq, tq,
                                                           qid, st)
        # plan the baseline at the padded size the served plan's grid was
        # chosen against, so its q_shards stay admissible
        pad = engine._pad_target(len(reqs))
        base_plan = engine.planner.plan(
            n_columns=st.executor.n_columns, n_queries=pad,
            mode="sharded" if plan.sharded else "full",
            mesh=engine.mesh if plan.sharded else None,
            grid=plan.grid if plan.sharded else None)
        full_s, full_ids, _ = st.executor.execute(base_plan, zq, wq, tq, qid)
        n_columns = st.snapshot.n_columns
    finally:
        engine._release(st)
    hits, total = 0, 0
    for row in range(len(reqs)):
        want = set(full_ids[row][:k][np.isfinite(full_s[row][:k])].tolist())
        got = set(got_ids[row][:k][np.isfinite(got_s[row][:k])].tolist())
        hits += len(want & got)
        total += len(want)
    return {"recall": hits / max(total, 1),
            "scored_fraction": float(ncand.mean()) / max(n_columns, 1),
            "candidate_budget": engine.candidate_budget,
            "plan": plan.kind, "baseline_plan": base_plan.kind,
            "k": k, "n_queries": len(reqs)}
