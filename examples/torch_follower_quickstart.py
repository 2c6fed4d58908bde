"""Follower-mode quickstart on the PyTorch/CUDA port: concurrent writers, a
background compactor, and a read replica tailing the manifest chain.

One catalog root, three roles sharing it:

* two **writer** threads ingest tables concurrently — each ``add_table``
  appends an immutable delta segment and CAS-advances the versioned
  manifest chain (a lost race just retries against the new head);
* a **background compactor** merges the delta segments off-thread and
  CAS-publishes the swap, replaying any segment that landed mid-build;
* a **follower** engine (``engine.follow(reader)``) tails the chain and
  refreshes onto each new version before serving — queries pin one
  immutable snapshot for their whole pipeline, so an in-flight batch
  never tears across a swap.

The counterpart of ``examples/follower_quickstart.py``; ingest, profiling
and scoring run on ``--device`` (default: the card).

  python examples/torch_follower_quickstart.py [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import threading

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core.gbdt import GBDTConfig  # noqa: E402
from repro_torch.core.lakegen import LakeSpec, generate_lake  # noqa: E402
from repro_torch.core.predictor import train_quality_model  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.service import (BackgroundCompactor, CatalogReader,  # noqa: E402
                                 CatalogStore, DiscoveryEngine, DiscoveryRequest,
                                 EngineConfig)


def fake_table(prefix: str, n: int = 240):
    ids = [f"shared_{i}" for i in range(n // 2, n + n // 2)]
    cities = [f"city_{i % 40}" for i in range(n)]
    return [(f"{prefix}_id", ids), (f"{prefix}_city", cities)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions on the host)")
    dev = resolve_device(ap.parse_args(argv).device)
    root = tempfile.mkdtemp(prefix="freyja_follow_")
    store = CatalogStore(root, device=dev)
    store.add_table("seed", fake_table("seed"))

    model = train_quality_model(
        [generate_lake(LakeSpec(n_domains=8, n_tables=16, row_budget=512,
                                rows_log_mean=5.5, seed=0))],
        GBDTConfig(n_trees=20, depth=4), n_query=48, device=dev)

    # the read replica: its own handle, nothing shared with the writers
    engine = DiscoveryEngine.from_catalog(CatalogStore(root, device=dev), model,
                                          EngineConfig(k=3), device=dev)
    engine.follow(CatalogReader(root))
    print(f"follower at version {engine.version}: "
          f"{engine.n_columns} columns @ {root}")

    # two ingest workers race CAS on the manifest; the compactor folds the
    # deltas they produce without ever blocking them
    def worker(tag: str, n_tables: int):
        handle = CatalogStore(root, device=dev)      # one handle per worker
        for i in range(n_tables):
            handle.add_table(f"{tag}{i}", fake_table(f"{tag}{i}"))

    with BackgroundCompactor(store, min_segments=4) as compactor:
        writers = [threading.Thread(target=worker, args=(tag, 3))
                   for tag in ("red", "blue")]
        for t in writers:
            t.start()
        for t in writers:
            t.join()
        compactor.maybe_compact()
        compactor.wait()

    # the follower's next query observes everything the writers published
    resp = engine.query(DiscoveryRequest(
        name="uploaded", values=[f"shared_{i}" for i in range(200, 500)]))
    print(f"follower caught up to version {engine.version}: "
          f"{engine.n_columns} columns, "
          f"{len(store.manifest['segments'])} segment(s) after compaction")
    for m in resp.matches:
        print(f"  {m.table}.{m.column}  q={m.score:.3f}")
    snap_stats = engine.stats()["snapshot"]
    print(f"refreshes={snap_stats['refreshes']} "
          f"live_states={snap_stats['live_states']} "
          f"cas_retries(writer0)={store.stats['cas_retries']}")
    engine.close()


if __name__ == "__main__":
    main()
