"""FREYJA discovery from the command line, on the port: build a lake,
profile it, train (or load) the join-quality model, and answer
discovery-by-attribute queries.

  PYTHONPATH=src python -m repro_torch.launch.discover --tables 40 --queries 10
  PYTHONPATH=src python -m repro_torch.launch.discover --device cpu --tables 12

The offline branch of ``repro.launch.discover``, with the same flags and
output, plus ``--device`` (default: the card). Every stage runs on that
device: profiling, the training labels and distances (``quality_cdf`` and
``profile_distance`` kernels) and the ranking (the fused scorer).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core.discovery import DiscoveryIndex, rank
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.lakegen import LakeSpec, generate_lake, select_queries
from repro_torch.core.predictor import JoinQualityModel, train_quality_model
from repro_torch.core.profiles import profile_lake
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=40)
    ap.add_argument("--domains", type=int, default=16)
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--model", default=None, help="path to a trained model .npz")
    ap.add_argument("--save-model", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    lake = generate_lake(LakeSpec(n_domains=args.domains, n_tables=args.tables,
                                  seed=args.seed))
    print(f"lake: {lake.n_columns} columns, {lake.raw_bytes/1e6:.1f} MB raw "
          f"({time.perf_counter()-t0:.1f}s)")

    t0 = time.perf_counter()
    prof = profile_lake(lake.batch, device=dev)
    print(f"profiles: {prof.numeric.shape} in {time.perf_counter()-t0:.2f}s "
          f"({prof.nbytes()/1e3:.1f} KB = "
          f"{100*prof.nbytes()/max(lake.raw_bytes,1):.2f}% of raw)")

    if args.model:
        model = JoinQualityModel.load(args.model)
        print(f"loaded model (train R² {model.train_r2:.3f})")
    else:
        t0 = time.perf_counter()
        model = train_quality_model([lake], GBDTConfig(), device=dev)
        print(f"trained model R² {model.train_r2:.3f} "
              f"({time.perf_counter()-t0:.1f}s)")
        if args.save_model:
            model.save(args.save_model)

    index = DiscoveryIndex(profiles=prof, model=model, names=lake.batch.names,
                           table_ids=lake.table)
    qids = select_queries(lake, args.queries)
    t0 = time.perf_counter()
    scores, ids = rank(index, qids, k=args.k, device=dev)
    dt = time.perf_counter() - t0
    valid = (ids >= 0).reshape(-1)          # k > lake size pads with -1
    sem = lake.is_semantic(np.repeat(qids, args.k),
                           np.maximum(ids.reshape(-1), 0)) & valid
    print(f"query: {len(qids)} queries in {dt:.3f}s "
          f"({dt/max(len(qids),1)*1e3:.1f} ms/query), "
          f"P@{args.k} = {sem.sum()/max(valid.sum(), 1):.3f}")
    for qi, i_row in list(zip(qids, ids))[:3]:
        names = [lake.batch.names[j] for j in i_row[:5] if j >= 0]
        print(f"  q={lake.batch.names[qi]} -> {names}")


if __name__ == "__main__":
    main()
