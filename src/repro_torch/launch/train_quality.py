"""The paper's core experiment on the port: train the general-purpose
join-quality model on synthetic lakes, evaluate ranking quality on a
held-out lake, and save the model for reuse (FREYJA ships one model, no
per-lake fine-tuning).

  PYTHONPATH=src python -m repro_torch.launch.train_quality [--device cpu]

The counterpart of ``examples/train_quality_model.py``: the same lakes
(seeds 100 and 101 to train, seed 0 held out, with a different spec), the
same model (50 oblivious trees of depth 5) and the same printed P@k. The
model file is the ``.npz`` both packages load.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake, select_queries
from repro_torch.core.predictor import train_quality_model
from repro_torch.core.profiles import profile_lake
from repro_torch.device import resolve_device

_LAKE = dict(row_budget=2048, rows_log_mean=6.8, coverage_range=(0.5, 1.0),
             gran_ratio=(4, 8))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join("artifacts", "quality_model.npz"),
                    help="where to save the trained model")
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.time()
    train_lakes = [generate_lake(LakeSpec(n_domains=14, n_tables=40, seed=s, **_LAKE))
                   for s in (100, 101)]
    print(f"generated {len(train_lakes)} training lakes "
          f"({sum(l.n_columns for l in train_lakes)} columns) "
          f"in {time.time()-t0:.1f}s")

    t0 = time.time()
    model = train_quality_model(train_lakes, GBDTConfig(), n_query=128, device=dev)
    print(f"trained GBDT (50 oblivious trees, depth 5): "
          f"R² = {model.train_r2:.3f} in {time.time()-t0:.1f}s")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    model.save(args.out)
    print(f"saved to {args.out}")

    # held-out evaluation (different seed AND different spec)
    lake = generate_lake(LakeSpec(n_domains=20, n_tables=60, seed=0, **_LAKE))
    prof = profile_lake(lake.batch, device=dev)
    idx = DiscoveryIndex(profiles=prof, model=model, table_ids=lake.table)
    qids = select_queries(lake, 30)
    for k in (1, 3, 5, 10):
        scores, ids = rank(idx, qids, k=k, device=dev)
        valid = np.isfinite(scores)
        sem = lake.is_semantic(np.repeat(qids, k),
                               ids.reshape(-1)).reshape(len(qids), k)
        print(f"held-out lake P@{k:2d} = {(sem & valid).sum()/valid.sum():.3f}")


if __name__ == "__main__":
    main()
