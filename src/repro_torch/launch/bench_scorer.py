"""Time the port's kernels at the main path's shapes.

  PYTHONPATH=src python -m repro_torch.launch.bench_scorer --tag new

Scores Q = 64 random query profiles against a shared corpus of 100k random
profiles and against per-query gathered corpora (64 x 4096 rows for
float32, 64 x 2048 for the sidecars), with a random T = 50, D = 5 ensemble,
over float32, int8 and fp16 corpora. Runs the same ensemble over
(6.4M, 23) random feature rows with ``gbdt_infer`` (the two-stage scorer's
shape), and probes (64, B) random query keys against (100k, B) corpus keys
with ``lsh_probe`` at B = 64 (the pruned plans' fine bands) and B = 16 (the
tiered coarse digest). Probes (64, 64) query keys against 64 x 2048
survivor rows of a (100k, 64) table with ``lsh_probe_gathered``: pre-gathered,
read in place through their positions where the kernel takes positions (from
the table, and from a copy at a 4-byte offset, which takes the one-key
variant), and the gather-then-probe route. Runs ``quality_cdf`` at the labels' (128, 391)
and the exact metric's (64, 100k), beside an empty kernel's launch floor
where the library has one. Signs (16384, 256) and (8, 256) values (10%
sentinel cells) under P = 128 permutations with ``minhash``: ingest's chunk
and an upload's padded 8 columns; beside them, where the library has it,
the card's rate for minhash's loop (``int_rate``: multiply-add chains
alone and with a running min). Inputs come from a fixed seed. Each kernel is
held against its plain version bit for bit and timed with CUDA events as
``chip_smoke.py`` times kernels (L2 flushed, the launch queued behind a
device spin).

To compare two checkouts on one card, run this file by its path with
``PYTHONPATH`` pointing at each checkout's ``src`` in turn: the kernels are
those of the ``repro_torch`` it imports (parent, change, change, parent in
one call; entries the imported checkout lacks are skipped). Prints the card
and one JSON line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.device import hashes_to_torch, to_bits
from repro_torch.kernels import _build, quality_cdf, ref
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda
from repro_torch.kernels.lsh_probe import lsh_probe_cuda, lsh_probe_gathered_cuda
from repro_torch.kernels.minhash import make_permutations, minhash_cuda
from repro_torch.kernels.profile_distance import (fused_score_cuda, fused_score_q_cuda,
                                                  quantize_profiles)

Q, N, T, D = 64, 100_000, 50, 5
GATHERED_M = {"fp32": 4096, "int8": 2048, "fp16": 2048}
BANDS = {"lsh_probe": 64, "lsh_probe coarse": 16}
SURVIVORS = 2048                    # the tiered plan's survivor budget at 100k
CDF_SHAPES = {"quality_cdf labels": (128, 391), "quality_cdf exact metric": (Q, N)}
CDF_PARAMS = (0.25, 0.19, 0.44, 0.28, 0.0, 1.0)
MINHASH_SHAPES = {"minhash": (16384, 256, 128), "minhash upload": (8, 256, 128)}
# int_rate: blocks of 256 threads a SM (16 warps a scheduler), steps of 16 chains
INT_RATE_BLOCKS_PER_SM, INT_RATE_ITERS, INT_RATE_CHAINS = 8, 2000, 16


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


def launch_floor(device) -> None:
    """Launch one empty kernel (``csrc/launch_floor.cu``) on ``device``'s
    current stream through the kernels' ctypes path: the floor a
    latency-bound launch is compared with. Counted as no kernel's launch."""
    lib = _build.library("launch_floor")
    _build.check("launch_floor",
                 lib.freyja_launch_floor(torch.cuda.current_stream(device).cuda_stream))


def int_rate(device, with_min: bool, blocks: int) -> None:
    """Launch ``csrc/int_rate.cu`` on ``device``'s current stream: ``blocks``
    x 256 threads x ``INT_RATE_ITERS`` x 16 multiply-adds, each followed by a
    min if ``with_min``. Counted as no kernel's launch."""
    out = torch.empty(blocks * 256, dtype=torch.int32, device=device)
    lib = _build.library("int_rate")
    _build.check("int_rate", lib.freyja_int_rate(out.data_ptr(), int(with_min), blocks,
                                                 INT_RATE_ITERS,
                                                 torch.cuda.current_stream(device).cuda_stream))


def int_rate_ops(blocks: int) -> int:
    """The multiply-adds (and, with the min, the hashes) one ``int_rate``
    launch computes."""
    return blocks * 256 * INT_RATE_ITERS * INT_RATE_CHAINS


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

    def bench(name, fn, want, shape):
        """Time ``fn`` and hold its result against ``want()`` (None: no
        result to check)."""
        out[name] = {"ms": time_ms(fn, args.reps, flush),
                     "equal": want is None or bool(torch.equal(fn(), want())),
                     "shape": list(shape)}

    for dtype, m in GATHERED_M.items():
        side, scale = quantize_profiles(z, dtype)
        zc, sc = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
        idx = torch.from_numpy(r.integers(0, N, (Q, m))).to(dev)
        for geo, zs, ws in (("shared", zc, wc), ("gathered", zc[idx].contiguous(),
                                                   wc[idx].contiguous())):
            ws_b = to_bits(ws)
            if dtype == "fp32":
                bench(f"{dtype}_{geo}", lambda: fused_score_cuda(zq, wq_b, zs, ws_b, *g),
                      lambda: ref.fused_score_ref(zq, wq, zs, ws, *g), zs.shape)
            else:
                bench(f"{dtype}_{geo}", lambda: fused_score_q_cuda(zq, wq_b, zs, sc, ws_b, *g),
                      lambda: ref.fused_score_q_ref(zq, wq, zs, sc, ws, *g), zs.shape)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((Q * N, FT.F_DIST), generator=gen, device=dev).abs_()
    bench("gbdt_infer", lambda: gbdt_infer_cuda(x, *g), lambda: ref.gbdt_infer_ref(x, *g),
          x.shape)
    del x
    for name, b in BANDS.items():
        qk = torch.randint(0, 40, (Q, b), generator=gen, device=dev, dtype=torch.int32)
        ck = torch.randint(0, 40, (N, b), generator=gen, device=dev, dtype=torch.int32)
        bench(name, lambda: lsh_probe_cuda(qk, ck), lambda: ref.lsh_probe_ref(qk, ck), (Q, N, b))
    qk = torch.randint(0, 40, (Q, 64), generator=gen, device=dev, dtype=torch.int32)
    table = torch.randint(0, 40, (N, 64), generator=gen, device=dev, dtype=torch.int32)
    pos = torch.randint(0, N, (Q, SURVIVORS), generator=gen, device=dev)
    kg = table[pos]
    want = ref.lsh_probe_gathered_ref(qk, kg)
    bench("lsh_probe_gathered", lambda: lsh_probe_gathered_cuda(qk, kg), lambda: want, kg.shape)
    bench("lsh_probe_gathered gather+probe", lambda: lsh_probe_gathered_cuda(qk, table[pos]),
          lambda: want, kg.shape)
    if "pos" in inspect.signature(lsh_probe_gathered_cuda).parameters:
        bench("lsh_probe_gathered in place", lambda: lsh_probe_gathered_cuda(qk, table, pos),
              lambda: want, kg.shape)
        # the one-key variant: the same table at a 4-byte offset
        tu = torch.empty(table.numel() + 1, dtype=torch.int32, device=dev)[1:]
        tu = tu.view(table.shape).copy_(table)
        bench("lsh_probe_gathered in place, unaligned", lambda: lsh_probe_gathered_cuda(qk, tu, pos),
              lambda: want, kg.shape)
        del tu
    del kg
    for name, shape in CDF_SHAPES.items():
        j = torch.rand(shape, generator=gen, device=dev) * 0.5
        k = torch.rand(shape, generator=gen, device=dev)
        bench(name, lambda: quality_cdf.quality_cdf_cuda(j, k, *CDF_PARAMS),
              lambda: ref.quality_cdf_ref(j, k, *CDF_PARAMS), shape)
    for name, (c, rows, p) in MINHASH_SHAPES.items():
        vals = r.integers(0, 2 ** 32 - 1, (c, rows), dtype=np.uint64).astype(np.uint32)
        vals[r.random((c, rows)) < 0.1] = FT.HASH_SENTINEL
        v = hashes_to_torch(vals, dev)
        a, b = (hashes_to_torch(x, dev) for x in make_permutations(p, 0))
        v_b, a_b, b_b = to_bits(v), to_bits(a), to_bits(b)
        bench(name, lambda: minhash_cuda(v_b, a_b, b_b),
              lambda: to_bits(ref.minhash_ref(v, a, b)), (c, rows, p))
    if "int_rate" in getattr(_build, "HARNESS", ()):
        blocks = INT_RATE_BLOCKS_PER_SM * _build.sm_count(dev)
        for name, with_min in (("int_rate IMAD", False), ("int_rate IMAD + min", True)):
            bench(name, lambda: int_rate(dev, with_min, blocks), None,
                  (blocks, 256, INT_RATE_ITERS, INT_RATE_CHAINS))
            out[name]["ops_per_s"] = int_rate_ops(blocks) / (out[name]["ms"] * 1e-3)
    if "launch_floor" in getattr(_build, "HARNESS", ()):
        bench("launch floor", lambda: launch_floor(dev), None, ())
    print(json.dumps(out), flush=True)
    if not all(v["equal"] for k, v in out.items() if k != "tag"):
        raise SystemExit("bench_scorer: a kernel differs from its plain version")


if __name__ == "__main__":
    main()
