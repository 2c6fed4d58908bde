"""Find the highest rate a configuration sustains: one set-up, then open-loop
Poisson windows at fixed rates.

    python3 perfbench/knee.py --workload full1m.batch --seed 7 --seconds 10 \
        --rates 2000 3000 4000 5000

For each rate it prints the rate achieved, the latency quantiles from the
due time, the generator's lateness, the deepest queue and the median latency
of the window's first and last quarters: a queue that grows shows as a last
quarter far above the first. The knee is the highest rate whose queue does
not grow; a cell offers a fixed share of it, written into its traffic file.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

T_PROCESS = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell whose configuration to load")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness, traffic
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 3
    manifest = harness.load_manifest()
    _, entry = harness.find_cell(manifest, args.workload)
    config = harness.load_config(entry)
    prog = harness.setup(config, args.seed, torch.device("cuda:0"), print)
    sched = prog["scheduler"]
    try:
        for i, rate in enumerate(args.rates):
            before = sched.stats()
            mix = traffic.Mix({"arrivals": "poisson", "rate_qps": rate,
                               "queries": "resident_uniform"},
                              harness.piece("arrivals", "poisson"),
                              harness.piece("queries", "resident_uniform"))
            w = traffic.run(mix, sched, prog["shape"].n_columns, args.seed + i,
                            args.seconds, int(config["engine"]["k"]))
            after = sched.stats()
            lat = w.log.latency_ms()
            ok = np.isfinite(lat)
            due = w.log.t_due - w.t_start
            quarter = lambda a, b: float(np.median(lat[ok & (due >= a) & (due < b)]))
            hist = {int(n): int(c) - int(before["batch_size_hist"].get(n, 0))
                    for n, c in after["batch_size_hist"].items()}
            done = int((ok & (w.log.t_done <= w.t_stop)).sum())
            print(json.dumps({
                "rate": rate, "achieved": done / w.seconds, "requests": w.log.n,
                "failed": int((~ok).sum()),
                "p50": float(np.quantile(lat[ok], .5)), "p95": float(np.quantile(lat[ok], .95)),
                "p99": float(np.quantile(lat[ok], .99)),
                "first_quarter_p50": quarter(0, args.seconds / 4),
                "last_quarter_p50": quarter(3 * args.seconds / 4, args.seconds),
                "lateness_p99": float(np.quantile(w.lateness_ms, .99)),
                "max_queue_depth": after["max_queue_depth"],
                "batches": {n: c for n, c in sorted(hist.items()) if c}}), flush=True)
    finally:
        sched.close()
        prog["engine"].close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
