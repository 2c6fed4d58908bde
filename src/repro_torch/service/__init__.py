"""Online join-discovery service on the port, the counterpart of
``repro.service`` without the replica fleet (``ROADMAP.md`` queue 6).

Layers (bottom-up):

* ``catalog``   — persistent on-disk column catalog (shared format with the
  JAX package): :class:`CatalogStore` (immutable delta segments, versioned
  manifest chain advanced by compare-and-swap, advisory
  :class:`WriterLease` for compaction; ingest profiled and signed on the
  store's device) and :class:`CatalogReader` (tails the chain, serves
  immutable snapshots keyed by version);
* ``compactor`` — :class:`BackgroundCompactor`: off-thread compaction;
* ``lsh``       — banded-MinHash band keys and the probe;
* ``engine``    — :class:`DiscoveryEngine`: batches concurrent queries,
  pins one snapshot version per batch, plans each micro-batch through the
  executor (``repro_torch.exec``) on its device, and fronts it with a
  version-namespaced cost-aware result cache; ``engine.follow(reader)``
  turns it into a read replica;
* ``scheduler`` — :class:`RequestScheduler`: the continuous-batching
  request runtime;
* ``api``       — request/response dataclasses and ``serve_discovery``;
* ``events``    — the bounded multi-consumer :class:`EventBus`;
* ``metrics``   — :class:`MetricsRegistry`, :class:`ServiceMetrics` and
  :class:`MetricsServer`;
* ``loadgen``   — ``run_open_loop``, Poisson arrivals through the scheduler.
"""
from repro_torch.service.api import (ColumnMatch, DiscoveryRequest,
                                     DiscoveryResponse, serve_discovery)
from repro_torch.service.catalog import (CatalogReader, CatalogSnapshot,
                                         CatalogStore, ColumnCatalog,
                                         LeaseHeldError, WriterLease, add_lake,
                                         materialize_snapshot)
from repro_torch.service.compactor import BackgroundCompactor
from repro_torch.service.engine import DiscoveryEngine, EngineConfig, measure_recall
from repro_torch.service.events import Event, EventBus, EventCursor, mint_trace_id
from repro_torch.service.lsh import (LSHConfig, LSHIndex, band_keys,
                                     coarse_band_keys)
from repro_torch.service.metrics import (MetricsRegistry, MetricsServer,
                                         ServiceMetrics, parse_exposition)
from repro_torch.service.scheduler import (DeadlineExpired, RequestScheduler,
                                           SchedulerConfig, SchedulerOverloadError)

__all__ = [
    "ColumnMatch", "DiscoveryRequest", "DiscoveryResponse", "serve_discovery",
    "CatalogReader", "CatalogSnapshot", "CatalogStore", "ColumnCatalog",
    "LeaseHeldError", "WriterLease", "add_lake", "materialize_snapshot",
    "BackgroundCompactor",
    "DiscoveryEngine", "EngineConfig", "measure_recall",
    "Event", "EventBus", "EventCursor", "mint_trace_id",
    "LSHConfig", "LSHIndex", "band_keys", "coarse_band_keys",
    "MetricsRegistry", "MetricsServer", "ServiceMetrics", "parse_exposition",
    "DeadlineExpired", "RequestScheduler", "SchedulerConfig",
    "SchedulerOverloadError",
]
