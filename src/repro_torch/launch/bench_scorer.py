"""Time the fused scorers, gbdt_infer and lsh_probe at the main path's shapes.

  PYTHONPATH=src python -m repro_torch.launch.bench_scorer --tag new

Scores Q = 64 random query profiles against a shared corpus of 100k random
profiles and against per-query gathered corpora (64 x 4096 rows for
float32, 64 x 2048 for the sidecars), with a random T = 50, D = 5 ensemble,
over float32, int8 and fp16 corpora. Runs the same ensemble over
(6.4M, 23) random feature rows with ``gbdt_infer`` (the two-stage scorer's
shape), and probes (64, B) random query keys against (100k, B) corpus keys
with ``lsh_probe`` at B = 64 (the pruned plans' fine bands) and B = 16 (the
tiered coarse digest). Inputs come from a fixed seed. Each kernel is held
against its plain version bit for bit and timed with CUDA events as
``chip_smoke.py`` times kernels (L2 flushed, the launch queued behind a
device spin). To compare two checkouts on one card, run this file by its
path with ``PYTHONPATH`` pointing at each checkout's ``src`` in turn: the
kernels are those of the ``repro_torch`` it imports. Prints the card and one
JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.device import hashes_to_torch, to_bits
from repro_torch.kernels import ref
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda
from repro_torch.kernels.lsh_probe import lsh_probe_cuda
from repro_torch.kernels.profile_distance import (fused_score_cuda, fused_score_q_cuda,
                                                  quantize_profiles)

Q, N, T, D = 64, 100_000, 50, 5
GATHERED_M = {"fp32": 4096, "int8": 2048, "fp16": 2048}
BANDS = {"lsh_probe": 64, "lsh_probe coarse": 16}


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.add_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="", help="label of this run in the JSON line")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_scorer: no CUDA device is available")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)

    r = np.random.default_rng(0)
    zq = torch.from_numpy(r.normal(size=(Q, FT.F_NUM)).astype(np.float32)).to(dev)
    wq = hashes_to_torch(r.integers(0, 30, (Q, FT.F_WORDS)).astype(np.uint32), dev)
    z = r.normal(size=(N, FT.F_NUM)).astype(np.float32)
    wc = hashes_to_torch(r.integers(0, 30, (N, FT.F_WORDS)).astype(np.uint32), dev)
    g = (torch.from_numpy(r.integers(0, FT.F_DIST, (T, D)).astype(np.int32)).to(dev),
         torch.from_numpy(r.uniform(0, 1.5, (T, D)).astype(np.float32)).to(dev),
         torch.from_numpy(r.normal(size=(T, 1 << D)).astype(np.float32)).to(dev), 0.25)
    flush = torch.empty(16 * 1024 * 1024, device=dev)
    wq_b = to_bits(wq)
    out = {"tag": args.tag}
    for dtype, m in GATHERED_M.items():
        side, scale = quantize_profiles(z, dtype)
        zc, sc = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
        idx = torch.from_numpy(r.integers(0, N, (Q, m))).to(dev)
        for geo, zs, ws in (("shared", zc, wc), ("gathered", zc[idx].contiguous(),
                                                   wc[idx].contiguous())):
            ws_b = to_bits(ws)
            if dtype == "fp32":
                fn = lambda: fused_score_cuda(zq, wq_b, zs, ws_b, *g)
                want = ref.fused_score_ref(zq, wq, zs, ws, *g)
            else:
                fn = lambda: fused_score_q_cuda(zq, wq_b, zs, sc, ws_b, *g)
                want = ref.fused_score_q_ref(zq, wq, zs, sc, ws, *g)
            equal = bool(torch.equal(fn(), want))
            out[f"{dtype}_{geo}"] = {"ms": time_ms(fn, args.reps, flush), "equal": equal,
                                     "shape": list(zs.shape)}
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((Q * N, FT.F_DIST), generator=gen, device=dev).abs_()
    fn = lambda: gbdt_infer_cuda(x, *g)
    out["gbdt_infer"] = {"ms": time_ms(fn, args.reps, flush),
                         "equal": bool(torch.equal(fn(), ref.gbdt_infer_ref(x, *g))),
                         "shape": list(x.shape)}
    del x
    for name, b in BANDS.items():
        qk = torch.randint(0, 40, (Q, b), generator=gen, device=dev, dtype=torch.int32)
        ck = torch.randint(0, 40, (N, b), generator=gen, device=dev, dtype=torch.int32)
        fn = lambda: lsh_probe_cuda(qk, ck)
        out[name] = {"ms": time_ms(fn, args.reps, flush),
                     "equal": bool(torch.equal(fn(), ref.lsh_probe_ref(qk, ck))),
                     "shape": [Q, N, b]}
    print(json.dumps(out), flush=True)
    if not all(v["equal"] for k, v in out.items() if k != "tag"):
        raise SystemExit("bench_scorer: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
