"""Quickstart on the PyTorch/CUDA port: the paper's Fig. 1 toy example, end
to end.

Three tiny datasets (happiness scores, store satisfaction, population data);
FREYJA must propose D1.Country = D3.X and D1.Country = D2.Country as the
best joins for D1.Country, and must NOT propose D1.Schengen = D2.Discount
near the top. The counterpart of ``examples/quickstart.py``; every stage
runs on ``--device`` (default: the card).

  python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.core.discovery import DiscoveryIndex, rank  # noqa: E402
from repro_torch.core.gbdt import GBDTConfig  # noqa: E402
from repro_torch.core.ingest import ingest_string_columns  # noqa: E402
from repro_torch.core.lakegen import LakeSpec, generate_lake  # noqa: E402
from repro_torch.core.predictor import train_quality_model  # noqa: E402
from repro_torch.core.profiles import profile_lake  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

D1 = {
    "D1.Country": ["Mexico", "Spain", "U.S.", "France"],
    "D1.Happiness": ["6.595", "6.354", "6.892", "6.592"],
    "D1.Schengen": ["N", "Y", "N", "Y"],
}
D2 = {
    "D2.Country": ["Spain", "Spain", "Germany", "Italy"],
    "D2.Code": ["ESP", "ESP", "GER", "ITA"],
    "D2.Location": ["Barcelona", "Madrid", "Munich", "Rome"],
    "D2.Discount": ["Y", "N", "N", "Y"],
    "D2.Satis": ["7.7", "8.5", "8", "7.7"],
}
D3 = {
    "D3.X": ["Spain", "U.S.", "Mexico", "Germany"],
    "D3.Y": ["47M", "330M", "123M", "83M"],
    "D3.Z": ["2020", "2020", "2020", "2020"],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the kernels' "
                         "plain versions on the host)")
    dev = resolve_device(ap.parse_args(argv).device)

    cols, tids = [], []
    for tid, table in enumerate((D1, D2, D3)):
        for name, values in table.items():
            cols.append((name, values))
            tids.append(tid)
    batch, sketches = ingest_string_columns(cols, table_ids=tids)
    profiles = profile_lake(batch, device=dev)

    print("training the general-purpose quality model on synthetic lakes...")
    lakes = [generate_lake(LakeSpec(n_domains=10, n_tables=24, row_budget=1024,
                                    rows_log_mean=6.0, seed=s)) for s in (2, 5)]
    model = train_quality_model(lakes, GBDTConfig(n_trees=30, depth=4),
                                n_query=48, device=dev)
    print(f"  model train R² = {model.train_r2:.3f} (no fine-tuning on the toy lake)")

    index = DiscoveryIndex(profiles=profiles, model=model,
                           names=batch.names, table_ids=np.asarray(tids))
    q = batch.names.index("D1.Country")
    scores, ids = rank(index, np.asarray([q]), k=5, device=dev)
    print("\ntop joins for D1.Country:")
    for s, i in zip(scores[0], ids[0]):
        if np.isfinite(s):
            print(f"  {batch.names[i]:15s} score={s:.3f}")
    ranked = [batch.names[i] for i in ids[0]]
    assert ranked[0] == "D3.X", ranked
    assert "D2.Country" in ranked[:3], ranked
    # Two binary Y/N columns (D1.Schengen, D2.Discount) have a high multiset
    # Jaccard AND K = 1, so a purely syntactic metric cannot reject that
    # join; it is reported, not asserted, as in the JAX example.
    qs = batch.names.index("D1.Schengen")
    s2, i2 = rank(index, np.asarray([qs]), k=3, device=dev)
    print("\nD1.Schengen top matches (binary-column caveat):",
          [(batch.names[i], f"{s:.2f}") for i, s in zip(i2[0], s2[0])
           if np.isfinite(s)])
    print("\nOK: country columns ranked first (paper Example 1 reproduced)")


if __name__ == "__main__":
    main()
