"""Train the benchmark's frozen join-quality model on the host.

    PYTHONPATH=src python perfbench/model/train.py

The recipe of ``chip_smoke.py``'s model path: the evaluation lakes
``bench_lake(100)``, ``bench_lake(101)`` and ``hard_lake(102)``, 128 label
queries a lake, ``GBDTConfig()`` (50 oblivious trees of depth 5), trained by
the port on the CPU. The file it writes, ``quality_gbdt.npz``, is committed:
the benchmark loads it as an input, as a served model loads its weights, and
both the program and the plain reference read the same ensemble from it.
Nothing trains during a benchmark run.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "..", "src"))

from repro_torch.core.gbdt import GBDTConfig  # noqa: E402
from repro_torch.core.lakegen import LakeSpec, generate_lake  # noqa: E402
from repro_torch.core.predictor import train_quality_model  # noqa: E402

_BENCH = dict(n_domains=20, n_tables=60, row_budget=2048, rows_log_mean=6.8,
              coverage_range=(0.5, 1.0), gran_ratio=(4, 8))
_HARD = dict(n_domains=24, n_tables=70, row_budget=2048, rows_log_mean=6.8,
             coverage_range=(0.6, 1.0), p_multi_gran=0.9, gran_ratio=(4, 10),
             n_collision_groups=6, collision_frac=0.8, zipf_range=(0.2, 1.6))
TRAIN_LAKES = (LakeSpec(**_BENCH, seed=100), LakeSpec(**_BENCH, seed=101),
               LakeSpec(**_HARD, seed=102))
N_LABEL_QUERIES = 128


def main() -> None:
    t0 = time.perf_counter()
    lakes = [generate_lake(spec) for spec in TRAIN_LAKES]
    model = train_quality_model(lakes, GBDTConfig(), n_query=N_LABEL_QUERIES,
                                device="cpu")
    out = os.path.join(HERE, "quality_gbdt.npz")
    model.save(out)
    info = {"recipe": "chip_smoke.py model path: TRAIN_LAKES = bench_lake(100), "
                      "bench_lake(101), hard_lake(102); n_query=128; seed=0",
            "gbdt_config": {"n_trees": 50, "depth": 5, "learning_rate": 0.1,
                            "n_bins": 32, "l2": 1.0, "min_child_weight": 4.0,
                            "seed": 0},
            "device": "cpu", "train_r2": float(model.train_r2),
            "columns": [int(lake.n_columns) for lake in lakes],
            "seconds": round(time.perf_counter() - t0, 1),
            "npz_bytes": os.path.getsize(out),
            "feats_sum": int(np.asarray(model.gbdt.feats).sum()),
            "leaves_sum": float(np.asarray(model.gbdt.leaves, np.float64).sum())}
    with open(os.path.join(HERE, "provenance.json"), "w") as f:
        json.dump(info, f, indent=1)
        f.write("\n")
    print(json.dumps(info))


if __name__ == "__main__":
    main()
