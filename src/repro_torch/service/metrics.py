"""Prometheus-style metrics for the serving plane.

Three layers:

* a minimal metric **registry** (:class:`MetricsRegistry`) holding
  counters, gauges, and fixed-bucket histograms — rendered in the
  Prometheus text exposition format (``render``) and as a plain nested
  dict for bench JSON snapshots (``collect``);
* :class:`ServiceMetrics` — the standard serving wiring: one event-bus
  consumer (:meth:`drain`) folds the structured event stream
  (``request_admitted``, ``batch_formed``, ``cache_hit`` …) into
  counters, plus **direct instrumentation** for the per-request latency
  split (``observe_response`` feeds the queue / compute / end-to-end
  histograms the event stream is too coarse for);
* :class:`MetricsServer` — an optional stdlib-HTTP endpoint thread
  serving ``GET /metrics`` (enable with ``discover --metrics-port`` or
  by constructing one around ``engine.metrics``).

The registry is deliberately dependency-free (no prometheus_client):
the point is the *contract* — a text exposition any scraper parses —
not the client library.  ``parse_exposition`` is the inverse used by
the CI smoke gate and the golden tests.
"""
from __future__ import annotations

import bisect
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.service import events as EV

# fixed bucket ladders (milliseconds; +Inf is implicit)
DEFAULT_LATENCY_BUCKETS_MS = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                              100.0, 200.0, 500.0, 1000.0, 2500.0, 5000.0)
BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
COMPILE_BUCKETS_MS = (10.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
                      5000.0, 10000.0, 30000.0)
SURVIVOR_FRACTION_BUCKETS = (0.005, 0.01, 0.02, 0.05, 0.1, 0.2, 0.5, 1.0)
REFRESH_BUCKETS_MS = (1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                      1000.0, 2500.0, 5000.0, 15000.0, 60000.0)
DELTA_COLUMNS_BUCKETS = (16, 64, 256, 1024, 4096, 16384, 65536)


def _fmt(v: float) -> str:
    """Prometheus-style number: integers bare, floats repr'd."""
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    esc = lambda v: str(v).replace("\\", "\\\\").replace('"', '\\"')
    inner = ",".join(f'{k}="{esc(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._lock = registry._lock     # one registry-wide lock: a render
        self._children: dict = {}       # is one consistent snapshot

    def _child_key(self, labels: dict) -> tuple:
        return tuple(sorted(labels.items()))


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        k = self._child_key(labels)
        with self._lock:
            self._children[k] = self._children.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._child_key(labels), 0.0))

    def _render(self) -> list[str]:
        return [f"{self.name}{_label_str(dict(k))} {_fmt(v)}"
                for k, v in sorted(self._children.items())] or \
            [f"{self.name} 0"]

    def _collect(self):
        return {_label_str(dict(k)) or "": v
                for k, v in self._children.items()} or {"": 0.0}


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._children[self._child_key(labels)] = float(value)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._children.get(self._child_key(labels), 0.0))

    _render = Counter._render
    _collect = Counter._collect


class Histogram(_Metric):
    """Fixed-bucket histogram: cumulative ``_bucket{le=...}`` series plus
    ``_sum`` / ``_count``, exactly the Prometheus contract."""

    kind = "histogram"

    def __init__(self, name, help, registry, buckets):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf last
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._observe_locked(v)

    def _observe_locked(self, value: float) -> None:
        # caller holds the registry lock (hot paths batch several
        # observations into one lock round)
        self._counts[bisect.bisect_left(self.buckets, value)] += 1
        self._sum += value
        self._count += 1

    def _render(self) -> list[str]:
        out, cum = [], 0
        for le, n in zip(self.buckets + (math.inf,), self._counts):
            cum += n
            out.append(f'{self.name}_bucket{{le="{_fmt(le)}"}} {cum}')
        out.append(f"{self.name}_sum {_fmt(self._sum)}")
        out.append(f"{self.name}_count {self._count}")
        return out

    def _collect(self):
        cum, buckets = 0, {}
        for le, n in zip(self.buckets + (math.inf,), self._counts):
            cum += n
            buckets[_fmt(le)] = cum
        return {"buckets": buckets, "sum": self._sum, "count": self._count}


class MetricsRegistry:
    """Named metrics with idempotent registration and atomic snapshots."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(f"metric {name!r} already registered "
                                     f"as a {m.kind}")
                return m
            m = cls(name, help, self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_LATENCY_BUCKETS_MS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def render(self) -> str:
        """Text exposition (one consistent snapshot under the registry
        lock: a scrape during a concurrent batch can't interleave a
        counter from one batch with a histogram from another)."""
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                lines.extend(m._render())
        return "\n".join(lines) + "\n"

    def collect(self) -> dict:
        """Nested plain-dict snapshot (bench JSON)."""
        with self._lock:
            return {name: {"type": m.kind, "values": m._collect()}
                    for name, m in sorted(self._metrics.items())}


def parse_exposition(text: str) -> dict[str, dict[str, float]]:
    """Inverse of :meth:`MetricsRegistry.render`:
    ``{series_name: {label_string_or_empty: value}}`` — what the CI
    smoke gate asserts against the live endpoint."""
    out: dict[str, dict[str, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, val = line.rsplit(" ", 1)
        if "{" in series:
            name, rest = series.split("{", 1)
            labels = "{" + rest
        else:
            name, labels = series, ""
        out.setdefault(name, {})[labels] = \
            math.inf if val == "+Inf" else float(val)
    return out


# ---------------------------------------------------------------------------
# standard serving wiring
# ---------------------------------------------------------------------------

class ServiceMetrics:
    """The serving plane's standard metric set over one event bus.

    Event-derived counters update on :meth:`drain` (the scheduler worker
    drains after every formed batch; a scrape drains too, so counters
    are current even with no traffic between scrapes).  The latency
    histograms are **direct instrumentation** — ``observe_response`` per
    served request — because one event per request would be the wrong
    trade on the hot path.
    """

    def __init__(self, bus: EV.EventBus,
                 registry: MetricsRegistry | None = None):
        self.bus = bus
        self.registry = registry or MetricsRegistry()
        self._cursor = bus.subscribe("metrics")
        self._scheduler = None
        r = self.registry
        self.requests_admitted = r.counter(
            "requests_admitted_total", "requests accepted by the scheduler")
        self.requests_shed = r.counter(
            "requests_shed_total", "requests dropped by bounded admission")
        self.requests_expired = r.counter(
            "requests_expired_total", "requests whose deadline lapsed queued")
        self.requests_completed = r.counter(
            "requests_completed_total", "responses delivered to futures")
        self.batches_formed = r.counter(
            "batches_formed_total", "micro-batches staged by the worker")
        self.batch_size = r.histogram(
            "batch_size", "formed micro-batch sizes",
            buckets=BATCH_SIZE_BUCKETS)
        self.cache_hits = r.counter(
            "cache_hits_total", "engine result-cache hits")
        self.cache_misses = r.counter(
            "cache_misses_total", "engine result-cache misses")
        self.compiles = r.counter(
            "compiles_total", "executor first-contact compiles")
        self.compile_ms = r.histogram(
            "compile_ms", "first-contact compile+execute wall (ms)",
            buckets=COMPILE_BUCKETS_MS)
        self.warmups = r.counter(
            "warmups_total", "engine AOT warmup passes completed")
        self.executable_cache_misses = r.counter(
            "executable_cache_misses_total",
            "warmup executables compiled fresh (cache miss)")
        self.warmup_remaining = r.gauge(
            "warmup_remaining",
            "executables still to warm in the running warmup pass")
        self.snapshot_pins = r.counter(
            "snapshot_pins_total", "MVCC snapshot pins")
        self.snapshots_retired = r.counter(
            "snapshots_retired_total", "MVCC versions fully released")
        self.compactions_started = r.counter(
            "compactions_started_total", "background compactions begun")
        self.compactions_published = r.counter(
            "compactions_published_total", "compaction swaps CAS-published")
        self.manifest_version = r.gauge(
            "catalog_manifest_version", "newest observed manifest version")
        self.queue_depth = r.gauge(
            "scheduler_queue_depth", "requests waiting in the scheduler")
        self.events_published = r.gauge(
            "event_bus_published_total", "events published into the bus")
        self.events_dropped = r.gauge(
            "event_bus_dropped_total",
            "events a consumer missed to ring overflow")
        self.coarse_passes = r.counter(
            "coarse_passes_total",
            "tiered candidate stage coarse digest sweeps")
        self.fine_probes = r.counter(
            "fine_probes_total",
            "tiered candidate stage fine probes over gathered survivors")
        self.survivor_fraction = r.histogram(
            "coarse_survivor_fraction",
            "fraction of the lake surviving the coarse digest pass",
            buckets=SURVIVOR_FRACTION_BUCKETS)
        self.batches_routed = r.counter(
            "batches_routed_total",
            "formed batches placed on a replica by the fleet router")
        self.redispatches = r.counter(
            "redispatches_total",
            "batches re-dispatched off a failed or evicted replica")
        self.replica_state_changes = r.counter(
            "replica_state_changes_total",
            "fleet replica lifecycle transitions (labeled by new state)")
        self.router_queue_depth = r.gauge(
            "router_queue_depth",
            "per-replica request queue depth at the last routed placement")
        self.refresh_ms = r.histogram(
            "refresh_ms", "snapshot refresh wall time (ms)",
            buckets=REFRESH_BUCKETS_MS)
        self.refresh_delta_columns = r.histogram(
            "refresh_delta_columns",
            "columns (re)placed per refresh — the delta on incremental "
            "refreshes, the full lake on rebuilds",
            buckets=DELTA_COLUMNS_BUCKETS)
        self.refreshes_incremental = r.counter(
            "refreshes_incremental_total",
            "refreshes served by the delta path (no rebuild)")
        self.refreshes_full = r.counter(
            "refreshes_full_total", "refreshes that rebuilt from scratch")
        self.placement_bytes_uploaded = r.counter(
            "placement_bytes_uploaded_total",
            "host->device bytes moved by refresh placements")
        self.refresh_recompiles = r.counter(
            "refresh_recompiles_total",
            "executables compiled fresh during a refresh re-warm")
        self.refreshes_coalesced = r.counter(
            "refreshes_coalesced_total",
            "pending manifest advances folded into a single refresh")
        self.queue_ms = r.histogram(
            "request_queue_ms", "submit -> batch formation wait (ms)")
        self.compute_ms = r.histogram(
            "request_compute_ms", "engine pipeline share per request (ms)")
        self.latency_ms = r.histogram(
            "request_latency_ms", "end-to-end latency incl queue (ms)")

    # -- direct instrumentation ---------------------------------------------

    def bind_scheduler(self, scheduler) -> None:
        """Let gauge refreshes read live queue depth (latest bind wins)."""
        self._scheduler = scheduler

    def observe_response(self, response) -> None:
        # one lock round for the four per-response updates — this runs
        # in the scheduler worker's critical path once per served request
        q = float(response.queue_ms)
        c = float(response.compute_ms)
        l = float(response.latency_ms)
        comp = self.requests_completed._children
        with self.registry._lock:
            comp[()] = comp.get((), 0.0) + 1.0
            self.queue_ms._observe_locked(q)
            self.compute_ms._observe_locked(c)
            self.latency_ms._observe_locked(l)

    # -- event consumption ---------------------------------------------------

    _EVENT_COUNTERS = {
        EV.REQUEST_ADMITTED: "requests_admitted",
        EV.REQUEST_SHED: "requests_shed",
        EV.REQUEST_EXPIRED: "requests_expired",
        EV.SNAPSHOT_PINNED: "snapshot_pins",
        EV.SNAPSHOT_RETIRED: "snapshots_retired",
        EV.COMPACTION_STARTED: "compactions_started",
        EV.COMPACTION_PUBLISHED: "compactions_published",
    }

    def drain(self) -> int:
        """Fold pending events into the registry; returns the number
        consumed.  Cheap (dict increments), safe from any thread.

        The simple counter types are bulk-counted into a plain dict
        first and applied as one locked increment per *type* — at
        serving rates ``request_admitted`` alone arrives once per
        submission, so per-event locked increments would make the
        worker's post-batch drain a measurable GIL tax."""
        evs = self._cursor.poll()
        counts: dict[str, int] = {}
        lookup = self._EVENT_COUNTERS.get
        for ev in evs:
            simple = lookup(ev.type)
            if simple is not None:
                counts[simple] = counts.get(simple, 0) + 1
            elif ev.type == EV.BATCH_FORMED:
                self.batches_formed.inc()
                self.batch_size.observe(ev.payload.get("n", 0))
            elif ev.type == EV.CACHE_HIT:
                self.cache_hits.inc(ev.payload.get("n", 1))
            elif ev.type == EV.CACHE_MISS:
                self.cache_misses.inc(ev.payload.get("n", 1))
            elif ev.type == EV.COMPILE_END:
                self.compiles.inc()
                self.compile_ms.observe(ev.payload.get("ms", 0.0))
            elif ev.type == EV.WARMUP_BEGIN:
                self.warmup_remaining.set(ev.payload.get("n_plans", 0))
            elif ev.type == EV.WARMUP_END:
                self.warmups.inc()
                self.warmup_remaining.set(0)
            elif ev.type == EV.EXECUTABLE_CACHE_MISS:
                self.executable_cache_misses.inc()
                rem = ev.payload.get("remaining")
                if rem is not None:
                    self.warmup_remaining.set(rem)
            elif ev.type == EV.COARSE_PASS:
                self.coarse_passes.inc()
                frac = ev.payload.get("survivor_fraction")
                if frac is not None:
                    self.survivor_fraction.observe(frac)
            elif ev.type == EV.FINE_PROBE:
                self.fine_probes.inc()
            elif ev.type == EV.MANIFEST_ADVANCED:
                v = ev.payload.get("version")
                if v is not None:
                    self.manifest_version.set(
                        max(self.manifest_version.value(), float(v)))
            elif ev.type == EV.BATCH_ROUTED:
                self.batches_routed.inc()
                rep = ev.payload.get("replica")
                depth = ev.payload.get("queue_depth")
                if rep is not None and depth is not None:
                    self.router_queue_depth.set(float(depth),
                                                replica=str(rep))
            elif ev.type == EV.BATCH_REDISPATCHED:
                self.redispatches.inc()
            elif ev.type == EV.REFRESH_END:
                p = ev.payload
                self.refresh_ms.observe(p.get("ms", 0.0))
                self.refresh_delta_columns.observe(p.get("delta_columns", 0))
                if p.get("incremental"):
                    self.refreshes_incremental.inc()
                else:
                    self.refreshes_full.inc()
                self.placement_bytes_uploaded.inc(p.get("bytes_uploaded", 0))
                self.refresh_recompiles.inc(p.get("recompiles", 0))
                if p.get("coalesced"):
                    self.refreshes_coalesced.inc(p["coalesced"])
            elif ev.type == EV.REPLICA_STATE:
                self.replica_state_changes.inc(
                    state=str(ev.payload.get("state", "")))
        for name, k in counts.items():
            getattr(self, name).inc(k)
        return len(evs)

    def _refresh_gauges(self) -> None:
        bus = self.bus.stats()
        self.events_published.set(bus["published"])
        for name, c in bus["consumers"].items():
            self.events_dropped.set(c["dropped"], consumer=name)
        if self._scheduler is not None:
            self.queue_depth.set(self._scheduler.queue_depth)

    # -- snapshots -----------------------------------------------------------

    def render(self) -> str:
        self.drain()
        self._refresh_gauges()
        return self.registry.render()

    def collect(self) -> dict:
        self.drain()
        self._refresh_gauges()
        return self.registry.collect()


# ---------------------------------------------------------------------------
# HTTP endpoint
# ---------------------------------------------------------------------------

class MetricsServer:
    """Stdlib-HTTP metrics endpoint (``GET /metrics``) on a daemon thread.

    ``source`` is anything with a ``render() -> str`` (a
    :class:`ServiceMetrics` or a bare :class:`MetricsRegistry`).
    ``port=0`` binds an ephemeral port — read it back from ``.port``
    (what the tests and the CI smoke gate do).
    """

    def __init__(self, source, port: int = 0, host: str = "127.0.0.1"):
        self.source = source
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = outer.source.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):    # no per-scrape stderr noise
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="freyja-metrics")
        self._thread.start()

    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
