"""Data augmentation via join discovery on the PyTorch/CUDA port — the
paper's downstream use case: a base table is widened with the best-ranked
joinable columns before training a model on it. The counterpart of
``examples/discover_augment.py``; every stage runs on ``--device``
(default: the card).

  python examples/torch_discover_augment.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.discovery import DiscoveryIndex  # noqa: E402
from repro_torch.core.gbdt import GBDTConfig  # noqa: E402
from repro_torch.core.lakegen import LakeSpec, generate_lake, select_queries  # noqa: E402
from repro_torch.core.predictor import train_quality_model  # noqa: E402
from repro_torch.core.profiles import profile_lake  # noqa: E402
from repro_torch.data import augmented_table_pipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions on the host)")
    dev = resolve_device(ap.parse_args(argv).device)

    lake = generate_lake(LakeSpec(n_domains=12, n_tables=30, row_budget=1024,
                                  rows_log_mean=6.2, seed=4))
    prof = profile_lake(lake.batch, device=dev)
    model = train_quality_model([lake], GBDTConfig(n_trees=30, depth=4),
                                n_query=64, device=dev)
    index = DiscoveryIndex(profiles=prof, model=model, table_ids=lake.table)

    base_cols = select_queries(lake, 5)
    print("augmenting base columns with discovered join partners:\n")
    total_new = 0
    for q in base_cols:
        ids, scores = augmented_table_pipeline(lake, index, int(q), k=3, device=dev)
        partners = [(lake.batch.names[i], f"{s:.3f}")
                    for i, s in zip(ids, scores) if np.isfinite(s) and s > 0.1]
        total_new += len(partners)
        print(f"  base {lake.batch.names[q]:22s} += {partners}")
    print(f"\n{total_new} columns discovered for augmentation across "
          f"{len(base_cols)} base tables")
    assert total_new > 0


if __name__ == "__main__":
    main()
