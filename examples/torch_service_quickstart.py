"""Discovery-service quickstart on the PyTorch/CUDA port: a catalog of raw
string tables, served.

Builds a tiny on-disk catalog from plain Python string columns, restarts an
engine from it, adds a table incrementally, and asks both kinds of query —
a catalog-resident column and an uploaded (external) column — first through
the continuous-batching scheduler (the async front door: futures, deadlines,
coalesced batches), then through the ``serve_discovery`` compat adapter.
The counterpart of ``examples/service_quickstart.py``; ingest, profiling
and scoring run on ``--device`` (default: the card).

  python examples/torch_service_quickstart.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.gbdt import GBDTConfig  # noqa: E402
from repro_torch.core.lakegen import LakeSpec, generate_lake  # noqa: E402
from repro_torch.core.predictor import train_quality_model  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.service import (ColumnCatalog, DiscoveryEngine,  # noqa: E402
                                 DiscoveryRequest, EngineConfig, RequestScheduler,
                                 serve_discovery)


def fake_table(prefix: str, n: int = 300, overlap: float = 0.0):
    """Two columns: ids drawn from a namespace that can overlap another's."""
    base = "shared" if overlap else prefix
    ids = [f"{base}_{i}" for i in range(int(n * (1 - overlap)), n * 2)]
    cities = [f"city_{i % 40}" for i in range(n)]
    return [(f"{prefix}_id", ids[:n]), (f"{prefix}_city", cities)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions on the host)")
    dev = resolve_device(ap.parse_args(argv).device)
    root = tempfile.mkdtemp(prefix="freyja_svc_")

    # --- offline: ingest tables, persist the catalog -----------------------
    catalog = ColumnCatalog(root, device=dev)
    catalog.add_table("users", fake_table("users", overlap=0.5))
    catalog.add_table("orders", fake_table("orders", overlap=0.5))
    catalog.add_table("events", fake_table("events"))

    # a quality model trained on a synthetic lake generalizes (paper claim)
    lake = generate_lake(LakeSpec(n_domains=8, n_tables=16, row_budget=512,
                                  rows_log_mean=5.5, seed=0))
    model = train_quality_model([lake], GBDTConfig(n_trees=20, depth=4),
                                n_query=48, device=dev)

    # --- online: restart from disk, serve ----------------------------------
    engine = DiscoveryEngine.from_catalog(ColumnCatalog(root, device=dev), model,
                                          EngineConfig(k=3), device=dev)
    print(f"engine over {engine.n_columns} columns "
          f"from {len(catalog.tables())} tables @ {root}")

    # incremental add while serving
    catalog.add_table("sessions", fake_table("sessions", overlap=0.5))
    engine.refresh(catalog.snapshot())
    print(f"after incremental add: {engine.n_columns} columns")

    requests = [
        DiscoveryRequest(name="resident", column_id=0),
        DiscoveryRequest(name="uploaded",
                         values=[f"shared_{i}" for i in range(200, 500)]),
    ]

    # async front door: submit from any thread, get a future per request;
    # the worker coalesces arrivals into bucket-snapped micro-batches
    with RequestScheduler(engine) as scheduler:
        futures = [scheduler.submit(r, deadline_ms=5_000.0)
                   for r in requests]
        for resp in (f.result() for f in futures):
            print(f"{resp.name}: scored {resp.n_candidates} columns "
                  f"(queue {resp.queue_ms:.1f}ms + "
                  f"compute {resp.compute_ms:.1f}ms)")
            for m in resp.matches:
                print(f"  {m.table}.{m.column}  q={m.score:.3f}")

    # compat adapter: same responses, request order, scheduler inside
    for resp in serve_discovery(engine, requests):
        print(f"{resp.name} (served again): {len(resp.matches)} matches")

    stats = engine.stats()
    plan = stats.get("last_plan", {})
    sched = stats.get("scheduler", {})
    print(f"served via plan {plan.get('kind')} "
          f"(budget {plan.get('budget')}); "
          f"cache {stats['cache']['hits']} hits / "
          f"{stats['cache']['misses']} misses; "
          f"batches {sched.get('batches')} sized "
          f"{sched.get('batch_size_hist')}")
    engine.close()


if __name__ == "__main__":
    main()
