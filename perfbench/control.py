"""The check's control: the plain reference, one precision lower, in the
program's place.

    python3 perfbench/control.py --config full1m --seeds 11 12 13

For each seed it draws the lake and the first ``check.sample`` distinct
columns that the seed's ``resident_uniform`` requests name, answers them with the reference at
the configuration's precision and with the control (``full1m``: bfloat16
profiles for float32; ``tiered4m``: an int4 sidecar for int8 and a bfloat16
re-rank for float32), and prints the numbers the run compares, the
control's answers standing where the program's stand. The benchmark's own
runs do not run it; its readings set the upper end of each limit
(``PERF.md``).
"""
import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def control_numbers(config: dict, seed: int, device, log=print) -> dict:
    from perfbench import harness
    n, want = int(config["lake"]["n_columns"]), int(config["check"]["sample"])
    draws = harness.piece("queries", "resident_uniform").columns({}, seed, n, 64 * want)
    qids = np.array(list(dict.fromkeys(draws.tolist()))[:want])
    return harness.reference_numbers(config, seed, qids, None, None, device, log,
                                     pad=harness.top_bucket(config), control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    entry = {c["name"]: c for c in harness.load_manifest()["configs"]}[args.config]
    config = harness.load_config(entry)
    for seed in args.seeds:
        t = time.perf_counter()
        out = control_numbers(config, seed, "cuda:0")
        torch.cuda.empty_cache()
        print(json.dumps({"config": args.config, "seed": seed, "control": out,
                          "seconds": round(time.perf_counter() - t, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
