#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FREYJA on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases:

0. the card: name, count, and ``nvidia-smi``'s name and power limit;
1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version at ragged small shapes;
3. four paths at real size, through the port's own entry points, each
   with the launch counts set to 0 just before it and read just after it:
   a. the discovery query: train the join-quality model (T=50, D=5) on the
      default lake, ingest a 100k-column x 256-row scaled lake (profiles +
      MinHash, P=128), build the LSH index (B=64 fine bands, S=16 coarse
      digest), and run a batch of 64 queries (k=10) under the ``all``,
      ``hybrid`` and ``lsh`` candidate stages over float32 profiles;
   b. the large-lake scale path: int8 and fp16 executors over the same
      profiles, the ``tiered`` plan (coarse digest scan, survivor gather,
      gathered fine probe, quantized scorer, exact float32 re-rank) and the
      quantized ``all`` scans; the plan ``mode="auto"`` picks is logged.
   c. the model path: train the join-quality model (T=50, D=5) on the
      JAX package's evaluation mix (``benchmarks/common.bench_model``: two
      plain lakes and one adversarial lake, 128 label queries each), with
      the distance tensor and the labels on the card; the two-stage scorer
      (distance tensor, then the ensemble) for the 64 queries against the
      100k-column profiles; the exact metric on a held-out lake.
   d. the serving path: ingest the 100k-column lake into a fresh on-disk
      ``CatalogStore`` (``add_batch``, one segment), open two
      ``DiscoveryEngine``s from disk (float32 ``lsh``; int8 ``auto``, which
      picks ``tiered`` at this size), each warmed over the batch ladder,
      incremental, on the default column buckets, and serve 256 requests
      (the 64 planted queries x 4) and 16 uploaded raw columns through a
      ``RequestScheduler`` from 4 client threads; then a second handle
      appends a 1,024-column table and the ``lsh`` engine follows it
      through ``Executor.extended``. Every formed batch is held against
      ``Executor.execute`` on the pinned version's executor (exactly) and
      the plain pipeline (up to exact ties, equal ``n_candidates``); the
      followed answers against a fresh executor over the same rows
      (exactly); the retired version's device memory must be released.
   Each plan's ids are held against a plain pipeline over the same
   candidates (plain probes and plain scorers); the quantized top-10 must
   overlap the float32 one by at least 0.99. The model path's distances
   must equal the plain version's, its labels lie within 1e-6 of them on
   the same side of the training threshold, the two-stage scores match
   the fused scorer's, and the predictions correlate with the exact
   metric (> 0.6);
4. each kernel at the main path's shapes and inputs: against its plain
   version, and timed with CUDA events beside its bound (the gathered probe
   in both forms and beside the earlier gather-then-probe route; an empty
   kernel's launch floor beside ``quality_cdf``);
5. one profiled batch of each plan and one two-stage scorer call: device
   time by operation and the device's idle share; the tiered plan also
   through the earlier route of its fine probe.

It prints one ``kernels`` JSON line and, last, one ``ok`` JSON line; any
failure raises and exits non-zero. It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import features as FT                      # noqa: E402
from repro_torch.core.gbdt import GBDTConfig                      # noqa: E402
from repro_torch.core import quality                              # noqa: E402
from repro_torch.core.discovery import DiscoveryIndex, rank       # noqa: E402
from repro_torch.core.lakegen import (LakeSpec, ScaledLakeSpec,   # noqa: E402
                                      generate_lake, generate_scaled_lake,
                                      select_queries, select_scaled_queries)
from repro_torch.core.predictor import (POSITIVE_LABEL,           # noqa: E402
                                        exact_jk, gbdt_to_torch, label_pairs,
                                        predict_scores, train_quality_model)
from repro_torch.core.profiles import lake_profiles, profile_lake  # noqa: E402
from repro_torch.device import from_bits, hashes_to_torch, to_bits  # noqa: E402
from repro_torch.exec import stages                               # noqa: E402
from repro_torch.exec.executor import Executor, pad_rows, pad_topk  # noqa: E402
from repro_torch.exec.plan import (DEFAULT_COLUMN_BUCKETS, Planner,  # noqa: E402
                                   PlannerConfig, QueryPlan)
from repro_torch.kernels import _build, ops, ref                  # noqa: E402
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda        # noqa: E402
from repro_torch.kernels.lsh_probe import (PAD_CORPUS, PAD_QUERY,  # noqa: E402
                                           lsh_probe_cuda, lsh_probe_gathered_cuda)
from repro_torch.kernels.minhash import (make_permutations,       # noqa: E402
                                         minhash_cuda)
from repro_torch.kernels.profile_distance import (                # noqa: E402
    fused_score_cuda, fused_score_q_cuda, profile_distance_cuda, quantize_profiles)
from repro_torch.kernels.quality_cdf import quality_cdf_cuda      # noqa: E402
from repro_torch.launch.bench_scorer import launch_floor          # noqa: E402
from repro_torch.service import catalog                           # noqa: E402
from repro_torch.service import (CatalogReader, CatalogStore,     # noqa: E402
                                 DiscoveryEngine, DiscoveryRequest, EngineConfig,
                                 RequestScheduler)
from repro_torch.service.lsh import LSHConfig, LSHIndex           # noqa: E402

# the main path's geometry
N_COLUMNS, N_ROWS, N_PERM, N_BANDS, N_QUERIES, K = 100_000, 256, 128, 64, 64, 10
N_COARSE = 16           # coarse super-band digest width S
OVERLAP_GATE = 0.99     # quantized vs float32 top-k overlap (tests/test_scale.py)
# scores: the tolerances of tests/test_kernels.py (float32 GBDT sums)
RTOL, ATOL = 1e-4, 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s outside the
# tensor cores, and int32 ops/s taken as half the float32 rate
HBM_BPS, F32_OPS, I32_OPS = 3.35e12, 67e12, 33.5e12
TPU_KERNELS = {
    "fused_score": "src/repro/kernels/profile_distance.py:123",
    "minhash": "src/repro/kernels/minhash.py:44",
    "lsh_probe": "src/repro/kernels/lsh_probe.py:58",
    "lsh_probe_gathered": "src/repro/kernels/lsh_probe.py:116",
    "fused_score_q": "src/repro/kernels/profile_distance.py:258",
    "profile_distance": "src/repro/kernels/profile_distance.py:61",
    "gbdt_infer": "src/repro/kernels/gbdt_infer.py:56",
    "quality_cdf": "src/repro/kernels/quality_cdf.py:39",
}
# which path of phase 3 each kernel belongs to (its launches are read there)
PATH_OF = {"fused_score": "discovery", "minhash": "discovery", "lsh_probe": "discovery",
           "lsh_probe_gathered": "scale", "fused_score_q": "scale",
           "profile_distance": "model", "gbdt_infer": "model", "quality_cdf": "model"}
SIDE_BYTES = {"int8": 1, "fp16": 2}
# kernels' times before their redesign, at the phase-4 shapes (PERF.md's
# kernel table: NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
EARLIER_MS = {"fused_score": 1.1280, "fused_score gathered": 0.1154,
              "fused_score_q": 1.1161, "fused_score_q gathered": 0.1010,
              "gbdt_infer": 1.2519, "lsh_probe": 0.2425, "lsh_probe coarse": 0.0422,
              "lsh_probe_gathered pre-gathered": 0.0223, "quality_cdf": 0.0073,
              "quality_cdf exact metric": 0.0506}
# the model path: the JAX package's evaluation lakes (benchmarks/common.py),
# bench_lake(100), bench_lake(101) and hard_lake(102) to train on, as
# bench_model does, and bench_lake(0) held out
_BENCH = dict(n_domains=20, n_tables=60, row_budget=2048, rows_log_mean=6.8,
              coverage_range=(0.5, 1.0), gran_ratio=(4, 8))
_HARD = dict(n_domains=24, n_tables=70, row_budget=2048, rows_log_mean=6.8,
             coverage_range=(0.6, 1.0), p_multi_gran=0.9, gran_ratio=(4, 10),
             n_collision_groups=6, collision_frac=0.8, zipf_range=(0.2, 1.6))
TRAIN_LAKES = (LakeSpec(**_BENCH, seed=100), LakeSpec(**_BENCH, seed=101),
               LakeSpec(**_HARD, seed=102))
HELD_OUT_LAKE = LakeSpec(**_BENCH, seed=0)
N_LABEL_QUERIES, N_EXACT_QUERIES = 128, 30
LABEL_ATOL = 1e-6       # labels vs their plain version (erff vs torch.erf)
CORR_GATE = 0.6         # prediction vs exact metric (tests/test_discovery.py:86)
# the serving path: requests per planted query, uploaded raw columns, client
# threads, and the appended table the follower picks up
SERVE_REPEATS, N_UPLOADS, N_CLIENTS = 4, 16, 4
FOLLOW_LAKE = ScaledLakeSpec(n_columns=1024, seed=6)
PLAIN_ROWS = 64         # query rows per plain-pipeline chunk
# the caching allocator hands out a cached block whole when splitting it
# would leave under 1 MiB, so a freed tensor may release up to that much
# more than its size rounded to 512 bytes
ALLOC_SLACK = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def sync_wall(t0: float) -> float:
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work
# ---------------------------------------------------------------------------

def bound_ms(n_bytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0):
    t_bytes = n_bytes / HBM_BPS
    t_ops = f32_ops / F32_OPS + i32_ops / I32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def fused_score_bound(q: int, corpus_rows: int, pairs: int, t: int, d: int,
                      num_bytes: int = 4):
    """Query and corpus profiles and the trees read once, one score per pair
    written once; per pair 21 subs and abs, T·D threshold compares, T adds
    and one divide (float32), and the 10x10 word compare-or, its sentinel
    tests and count, the first-word test and T·D index shifts/ors (int32).
    A shared corpus has N rows and Q·N pairs; a gathered one Q·M of each.
    A sidecar (``num_bytes`` 1 or 2 per numeric slot) adds its 21 scales to
    the bytes and one dequantizing multiply per slot to each pair."""
    n_bytes = q * (FT.F_NUM + FT.F_WORDS) * 4 \
        + corpus_rows * (FT.F_NUM * num_bytes + FT.F_WORDS * 4) + t * d * 8 \
        + t * (1 << d) * 4 + pairs * 4 + (FT.F_NUM * 4 if num_bytes != 4 else 0)
    f32 = pairs * (2 * FT.F_NUM + t * d + t + 1 + (FT.F_NUM if num_bytes != 4 else 0))
    i32 = pairs * (2 * FT.N_FREQ_WORDS ** 2 + 2 * FT.N_FREQ_WORDS + 2 + 2 * t * d)
    return bound_ms(n_bytes, f32, i32)


def minhash_bound(c: int, r: int, p: int):
    """Values read once, signatures written once; per (column, row,
    permutation) a multiply, an add, a sentinel compare, a select and a min."""
    return bound_ms(c * r * 4 + p * 8 + c * p * 4, 0.0, 5.0 * c * r * p)


def lsh_probe_bound(q: int, c: int, b: int):
    """Keys read once, the hit mask written once; a compare and an or per
    (query, column, band)."""
    return bound_ms((q + c) * b * 4 + q * c * 4, 0.0, 2.0 * q * c * b)


def lsh_probe_gathered_bound(q: int, c: int, b: int):
    """Each query's own (C', B) gathered keys and its B keys read once, the
    (Q, C') hit mask written once; a compare and an or per key."""
    return bound_ms(q * c * b * 4 + q * b * 4 + q * c * 4, 0.0, 2.0 * q * c * b)


def lsh_probe_indexed_bound(q: int, c: int, b: int, rows: int):
    """The indexed form: the ``rows`` distinct table rows that the (Q, C')
    int64 positions name (B keys each) and the positions and query keys
    read once, the (Q, C') hit mask written once; a compare and an or per
    (query, survivor, band)."""
    return bound_ms(rows * b * 4 + q * c * 8 + q * b * 4 + q * c * 4, 0.0, 2.0 * q * c * b)


def profile_distance_bound(q: int, n: int):
    """Query and corpus profiles read once, the (Q, N, F_DIST) tensor written
    once; per pair 21 subs and abs and one divide (float32), and the 10x10
    word compare-or, its sentinel tests and count and the first-word test
    (int32)."""
    n_bytes = (q + n) * (FT.F_NUM + FT.F_WORDS) * 4 + q * n * FT.F_DIST * 4
    f32 = q * n * (2 * FT.F_NUM + 1)
    i32 = q * n * (2 * FT.N_FREQ_WORDS ** 2 + 2 * FT.N_FREQ_WORDS + 2)
    return bound_ms(n_bytes, f32, i32)


def gbdt_infer_bound(n: int, f: int, t: int, d: int):
    """Rows and trees read once, one prediction per row written once; per row
    T·D threshold compares and T adds (float32), T·D index shifts/ors
    (int32)."""
    n_bytes = n * f * 4 + t * d * 8 + t * (1 << d) * 4 + n * 4
    return bound_ms(n_bytes, n * (t * d + t), n * 2 * t * d)


def quality_cdf_bound(n: int):
    """J and K read once, Q written once; per pair two truncated CDFs, each
    a subtract, two divides, an erf (~25 operations), an add, a multiply,
    a subtract and a clamp, and the product (float32)."""
    return bound_ms(n * 12, n * (2 * 32 + 1))


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Mean CUDA-event time of ``fn`` with a cold L2: a 64 MB buffer is
    rewritten before every timed launch. The card then spins for ~0.5 ms
    (``torch.cuda._sleep``) while the host runs ``fn``'s Python wrapper and
    enqueues its kernel, so the start event fires with the launch already
    queued: the time is the device's, not the wrapper's (for a kernel of
    tens of microseconds the wrapper's host time is of the same order)."""
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


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions at ragged small shapes
# ---------------------------------------------------------------------------

def _random_gbdt(r, t, d, dev):
    return (torch.from_numpy(r.integers(0, FT.F_DIST, (t, d)).astype(np.int32)).to(dev),
            torch.from_numpy(r.normal(size=(t, d)).astype(np.float32)).to(dev),
            torch.from_numpy(r.normal(size=(t, 1 << d)).astype(np.float32)).to(dev),
            float(np.float32(r.normal())))


def _random_profiles(r, lead, dev):
    z = torch.from_numpy(r.normal(size=(*lead, FT.F_NUM)).astype(np.float32)).to(dev)
    w = r.integers(0, 9, (*lead, FT.F_WORDS)).astype(np.uint32)
    w.reshape(-1, FT.F_WORDS)[::3, :4] = FT.HASH_SENTINEL
    return z, hashes_to_torch(w, dev)


def _adversarial(r, q, lead, t, d, dtype, dev):
    """Inputs and an ensemble that punish a flipped leaf: thresholds taken
    from the pairs' own feature values (0.0, -0.0, the overlap steps k/10,
    1.0, exact |dz| values, |dz| = 0 planted), one (feature, threshold)
    repeated across trees, a query with NaN numeric slots. Returns (zq, wq,
    sidecar, scale, wc, gbdt) on ``dev``; the sidecar is float32 for fp32."""
    zq = r.normal(size=(q, FT.F_NUM)).astype(np.float32)
    z = r.normal(size=(*lead, FT.F_NUM)).astype(np.float32)
    z.reshape(-1, FT.F_NUM)[::5, 3] = zq[0, 3]
    zq[-1, ::4] = np.nan
    wq = r.integers(0, 12, (q, FT.F_WORDS)).astype(np.uint32)
    wc = r.integers(0, 12, (*lead, FT.F_WORDS)).astype(np.uint32)
    wq[::2, 5:8] = FT.HASH_SENTINEL
    wc.reshape(-1, FT.F_WORDS)[::3, :4] = FT.HASH_SENTINEL
    side, scale = (z, np.ones(FT.F_NUM, np.float32)) if dtype == "fp32" else \
        quantize_profiles(z.reshape(-1, FT.F_NUM), dtype)
    side = side.reshape(z.shape)
    zq_t, wq_t, wc_t = torch.from_numpy(zq).to(dev), hashes_to_torch(wq, dev), hashes_to_torch(wc, dev)
    zc_t, sc_t = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
    zf = zc_t if dtype == "fp32" else zc_t.to(torch.float32) * sc_t
    x = ref.profile_distance_ref(zq_t, wq_t, zf, wc_t).reshape(-1, FT.F_DIST).cpu().numpy()
    steps = np.arange(11, dtype=np.float32) / np.float32(10)
    feats = r.integers(0, FT.F_DIST, (t, d)).astype(np.int32)
    thrs = np.empty((t, d), np.float32)
    for k, f in np.ndenumerate(feats):
        if f == FT.F_NUM:
            pool = steps
        elif f == FT.F_NUM + 1:
            pool = np.float32([0.0, -0.0, 1.0])
        else:
            vals = x[:, f][np.isfinite(x[:, f])]
            pool = np.concatenate([np.float32([0.0, -0.0]), r.choice(vals, 4)])
        thrs[k] = r.choice(pool)
    feats[1::3, 0], thrs[1::3, 0] = feats[0, 0], thrs[0, 0]
    g = (torch.from_numpy(feats).to(dev), torch.from_numpy(thrs).to(dev),
         torch.from_numpy(r.normal(size=(t, 1 << d)).astype(np.float32)).to(dev),
         float(np.float32(r.normal())))
    return zq_t, wq_t, zc_t, sc_t, wc_t, g


def _adversarial_rows(r, n, f, t, d, dev):
    """Feature rows and an ensemble that punish a flipped leaf: thresholds
    drawn from the rows' own values, 0.0 and -0.0; rows at 0.0, -0.0 and
    NaN; every third row exactly at one threshold, and that (feature,
    threshold) pair repeated in every third tree."""
    x = r.normal(size=(n, f)).astype(np.float32)
    x[::4] = np.round(x[::4], 1)
    x[1::6, ::2] = -0.0
    x[2::6, ::3] = 0.0
    x[5::7, 1::4] = np.nan
    feats = r.integers(0, f, (t, d)).astype(np.int32)
    pool = np.concatenate([np.float32([0.0, -0.0]), r.choice(x[np.isfinite(x)], 64)])
    thrs = r.choice(pool, (t, d)).astype(np.float32)
    feats[1::3, 0], thrs[1::3, 0] = feats[0, 0], thrs[0, 0]
    x[::3, feats[0, 0]] = thrs[0, 0]
    g = (torch.from_numpy(feats).to(dev), torch.from_numpy(thrs).to(dev),
         torch.from_numpy(r.normal(size=(t, 1 << d)).astype(np.float32)).to(dev),
         float(np.float32(r.normal())))
    return torch.from_numpy(x).to(dev), g


def _scorer_equal(name, got, want, shape) -> None:
    if not torch.equal(got, want):
        err = float((got - want).abs().max())
        raise AssertionError(f"{name} differs from its plain version at {shape}: "
                             f"max |err| {err}, {int((got != want).sum())} scores")


def _equal_nan(name, got, want) -> None:
    """Bit-equal, with NaN in the same places."""
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan) and torch.equal(got[~nan], want[~nan])):
        raise AssertionError(f"{name}: kernel differs from its plain version")


def check_ragged(dev) -> None:
    r = np.random.default_rng(0)
    for q, n, t, d in [(1, 1, 1, 1), (5, 300, 50, 5), (13, 1029, 13, 6), (9, 77, 50, 8)]:
        zq, wq = _random_profiles(r, (q,), dev)
        g = _random_gbdt(r, t, d, dev)
        for lead in ((n,), (q, n)):
            zc, wc = _random_profiles(r, lead, dev)
            _scorer_equal("fused_score", ops.fused_score(zq, wq, zc, wc, g),
                          ref.fused_score_ref(zq, wq, zc, wc, *g), (q, lead, t, d))
    for c, rows, p in [(1, 1, 1), (7, 700, 64), (33, 256, 128), (9, 1000, 300)]:
        vals = r.integers(0, 2 ** 32 - 1, (c, rows), dtype=np.uint64).astype(np.uint32)
        vals[0, rows // 2:] = FT.HASH_SENTINEL
        v = hashes_to_torch(vals, dev)
        a, b = (hashes_to_torch(x, dev) for x in make_permutations(p, seed=2))
        if not torch.equal(ops.minhash(v, a, b), ref.minhash_ref(v, a, b)):
            raise AssertionError(f"minhash differs from its plain version at {(c, rows, p)}")
    for q, c, b in [(1, 1, 1), (11, 777, 32), (3, 100, 256)]:
        qk = hashes_to_torch(r.integers(0, 40, (q, b)).astype(np.uint32), dev)
        ck = hashes_to_torch(r.integers(0, 40, (c, b)).astype(np.uint32), dev)
        if not torch.equal(ops.lsh_probe(qk, ck), ref.lsh_probe_ref(qk, ck)):
            raise AssertionError(f"lsh_probe differs from its plain version at {(q, c, b)}")
    # every path of the probe: B = 16 and 64 in registers, other B from
    # shared memory, several query groups (Q = 65, 130), C = 1000 not a
    # multiple of the 128-column tile, sentinel rows, and keys at a 4-byte
    # offset (the 4-byte copies)
    for q in (1, 63, 65, 130):
        for b in (1, 7, 12, 16, 64, 256):
            qk = r.integers(0, 60, (q, b)).astype(np.uint32)
            ck = r.integers(0, 60, (1000, b)).astype(np.uint32)
            ck[::5] = PAD_CORPUS
            ck[-1, -1] = qk[0, -1]
            if q > 1:
                qk[-1] = PAD_QUERY
            qk, ck = to_bits(hashes_to_torch(qk, dev)), to_bits(hashes_to_torch(ck, dev))
            views = [ck]
            if b in (12, 16, 64):
                unaligned = torch.empty(ck.numel() + 1, dtype=torch.int32, device=dev)[1:]
                views.append(unaligned.view(ck.shape).copy_(ck))
            for keys in views:
                if not torch.equal(lsh_probe_cuda(qk, keys), ref.lsh_probe_ref(qk, ck)):
                    raise AssertionError(f"lsh_probe differs from its plain version at "
                                         f"{(q, 1000, b)}, offset {keys.data_ptr() % 16}")
    # B % 4 == 0 up to 64 over an aligned table takes the kernel's 16-byte
    # loads (16 lanes a row), every other B (1 to 8 keys a lane) and an
    # unaligned (offset) view of the keys the one-key loads (32 lanes a row)
    for q, c, b in [(1, 1, 1), (3, 300, 16), (5, 257, 64), (2, 1000, 256),
                    (3, 100, 12), (2, 333, 7), (4, 129, 4), (3, 200, 8), (2, 300, 32),
                    (3, 150, 100), (2, 260, 128)]:
        qk = r.integers(0, 40, (q, b)).astype(np.uint32)
        ck = r.integers(0, 40, (q, c, b)).astype(np.uint32)
        ck[:, ::3] = PAD_CORPUS
        qk[-1] = PAD_QUERY
        qk = to_bits(hashes_to_torch(qk, dev))
        ck = to_bits(hashes_to_torch(ck, dev))
        unaligned = torch.empty(ck.numel() + 1, dtype=torch.int32, device=dev)[1:]
        unaligned.copy_(ck.reshape(-1))
        for keys in (ck, unaligned.view(ck.shape)):
            got = from_bits(lsh_probe_gathered_cuda(qk, keys))
            if not torch.equal(got.to(torch.int32),
                               ref.lsh_probe_gathered_ref(from_bits(qk), from_bits(keys))):
                raise AssertionError(f"lsh_probe_gathered differs from its plain version "
                                     f"at {(q, c, b)}")
        # the indexed form over a resident table (aligned and at a 4-byte
        # offset): repeated positions within and across queries, negative
        # ones counted from the end
        n = 2 * c + 3
        table = r.integers(0, 40, (n, b)).astype(np.uint32)
        table[::4] = PAD_CORPUS
        pos = r.integers(-n, n, (q, c))
        pos[:, 1::3] = pos[:, :1]
        pos[-1, ::2] = pos[0, ::2]
        table = to_bits(hashes_to_torch(table, dev))
        pos = torch.from_numpy(pos).to(dev)
        unaligned = torch.empty(table.numel() + 1, dtype=torch.int32, device=dev)[1:]
        for keys in (table, unaligned.view(table.shape).copy_(table)):
            if not torch.equal(lsh_probe_gathered_cuda(qk, keys, pos),
                               ref.lsh_probe_gathered_ref(qk, table[pos])):
                raise AssertionError(f"lsh_probe_gathered (indexed) differs from its plain "
                                     f"version at {(q, c, b)}, table offset "
                                     f"{keys.data_ptr() % 16}")
    for dtype in SIDE_BYTES:
        for q, n, t, d in [(1, 1, 1, 1), (5, 300, 50, 5), (13, 1029, 13, 6)]:
            zq, wq = _random_profiles(r, (q,), dev)
            g = _random_gbdt(r, t, d, dev)
            for lead in ((n,), (q, n)):
                z, wc = _random_profiles(r, lead, dev)
                side, scale = quantize_profiles(z.cpu().numpy().reshape(-1, FT.F_NUM), dtype)
                zc = torch.from_numpy(side.reshape(z.shape)).to(dev)
                sc = torch.from_numpy(scale).to(dev)
                _scorer_equal(f"fused_score_q ({dtype})", ops.fused_score_q(zq, wq, zc, sc, wc, g),
                              ref.fused_score_q_ref(zq, wq, zc, sc, wc, *g), (q, lead, t, d))
    # ensembles that punish a flipped leaf, both geometries, every dtype;
    # (1000, 5) and (2, 15) are scored in chunks of trees
    for dtype in ("fp32", *SIDE_BYTES):
        for q, lead, t, d in [(5, (300,), 50, 5), (4, (4, 77), 50, 8), (3, (40,), 13, 6),
                              (5, (5, 300), 50, 5), (3, (3, 1029), 13, 6),
                              (3, (300,), 1000, 5), (3, (3, 200), 2, 15)]:
            zq, wq, zc, sc, wc, g = _adversarial(r, q, lead, t, d, dtype, dev)
            if dtype == "fp32":
                got, want = ops.fused_score(zq, wq, zc, wc, g), ref.fused_score_ref(zq, wq, zc, wc, *g)
            else:
                got = ops.fused_score_q(zq, wq, zc, sc, wc, g)
                want = ref.fused_score_q_ref(zq, wq, zc, sc, wc, *g)
            _scorer_equal(f"adversarial {dtype}", got, want, (q, lead, t, d))
    # the model path's kernels: distances and the ensemble bit for bit, the
    # labels within LABEL_ATOL (NaN where the plain version has NaN)
    for q, n in [(1, 1), (5, 300), (13, 1029), (9, 77)]:
        zq, wq = _random_profiles(r, (q,), dev)
        zc, wc = _random_profiles(r, (n,), dev)
        if not torch.equal(ops.profile_distance(zq, wq, zc, wc),
                           ref.profile_distance_ref(zq, wq, zc, wc)):
            raise AssertionError(f"profile_distance differs from its plain version at {(q, n)}")
    for n, f, t, d in [(1, FT.F_DIST, 1, 1), (1, FT.F_DIST, 13, 6), (1, FT.F_DIST, 50, 8),
                       (1000, FT.F_DIST, 50, 5), (4099, FT.F_DIST, 13, 6),
                       (777, 24, 50, 8), (300, 5, 1, 1)]:
        feats, thrs, leaves, base = _random_gbdt(r, t, d, dev)
        feats = feats % f
        x = torch.from_numpy(r.normal(size=(n, f)).astype(np.float32)).to(dev)
        x[::3, feats[0, 0]] = thrs[0, 0]          # features exactly at a threshold
        g = (feats, thrs, leaves, base)
        if not torch.equal(ops.gbdt_infer(x, g), ref.gbdt_infer_ref(x, *g)):
            raise AssertionError(f"gbdt_infer differs from its plain version at {(n, f, t, d)}")
    # ensembles that punish a flipped leaf; (1000, 5) is scored in chunks
    # of trees, (1, 15) beside 128 KB of leaves, F = 200 in 128-row tiles;
    # an offset view takes the 4-byte copies
    for n, f, t, d in [(1000, FT.F_DIST, 50, 5), (777, 24, 50, 8), (300, 5, 13, 6),
                       (4099, FT.F_DIST, 1000, 5), (513, 24, 1000, 5), (200, FT.F_DIST, 1, 15),
                       (300, 200, 50, 5), (2000, FT.F_DIST, 50, 5), (2000, 24, 50, 5)]:
        x, g = _adversarial_rows(r, n, f, t, d, dev)
        views = [x]
        if n == 2000:
            views.append(torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x))
        for rows in views:
            if not torch.equal(ops.gbdt_infer(rows, g), ref.gbdt_infer_ref(x, *g)):
                raise AssertionError(f"gbdt_infer differs from its plain version on an "
                                     f"adversarial ensemble at {(n, f, t, d)}, offset "
                                     f"{rows.data_ptr() % 16}")
    # quality_cdf bit for bit, NaN in place: the one-pair walk (small n, or
    # j and k at different offsets), and the 4-pair walk (n from 4·256 pairs
    # an SM) with its scalar head and tail (n % 4, views at 1-3 floats past
    # a 16-byte boundary)
    for shape, off_j, off_k in [((1,), 0, 0), ((3,), 0, 0), ((5,), 0, 0), ((1000,), 0, 0),
                                ((4097,), 0, 0), ((7, 13), 0, 0), ((128, 401), 0, 0),
                                ((300_001,), 0, 0), ((200_003,), 1, 1), ((200_003,), 3, 3),
                                ((200_003,), 1, 2)]:
        n = int(np.prod(shape))
        jb = torch.from_numpy(r.uniform(-0.1, 0.6, n + 3).astype(np.float32)).to(dev)
        kb = torch.from_numpy(r.uniform(-0.1, 1.1, n + 3).astype(np.float32)).to(dev)
        jb[::11] = float("nan")
        j, k = jb[off_j:off_j + n].view(shape), kb[off_k:off_k + n].view(shape)
        for s in quality.STRICTNESS.values():
            args = (j, k, quality.MU_J + s, quality.SIGMA_J, quality.MU_K, quality.SIGMA_K)
            _equal_nan(f"quality_cdf at {shape}, offsets {(off_j, off_k)}",
                       ops.quality_cdf(*args), ref.quality_cdf_ref(*args))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 3: the discovery query at real size
# ---------------------------------------------------------------------------

def run_plans(run: dict, runs: dict, reps: int) -> None:
    """Execute each (executor, plan, query batch): one first batch, then
    ``reps`` synchronized steady batches; results and walls go into ``run``."""
    for name, (executor, plan, args) in runs.items():
        t0 = time.perf_counter()
        run["results"][name] = executor.execute(plan, *args)
        first = sync_wall(t0)
        run["tiers"][name] = executor.last_tier_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            executor.execute(plan, *args)
        steady = sync_wall(t0) / reps
        run["qps"][name] = len(args[0]) / steady
        run["steady_ms"][name] = steady * 1e3
        run["runs"][name] = (executor, plan, args)
        log(f"plan {name} ({plan.kind}, {executor.profile_dtype}): budget {plan.budget}, "
            f"survivor budget {plan.survivor_budget}, first batch {first * 1e3:.2f} ms, "
            f"steady {steady * 1e3:.3f} ms/batch = {run['qps'][name]:.1f} queries/s "
            f"(Q={len(args[0])}, k={K})")


def main_path(dev, n_columns=N_COLUMNS, n_queries=N_QUERIES, reps=5):
    """The discovery path: train, ingest, index and query over float32
    profiles through the port's entry points. Returns everything the checks,
    the scale path and the kernel phase need."""
    walls = {}
    t0 = time.perf_counter()
    train_lake = generate_lake(LakeSpec(n_domains=16, n_tables=40, seed=0))
    model = train_quality_model([train_lake], GBDTConfig(), device=dev)
    walls["train"] = sync_wall(t0)
    log(f"train: {train_lake.n_columns} columns, T={model.gbdt.n_trees} "
        f"D={model.gbdt.depth}, R^2 {model.train_r2:.4f}, {walls['train']:.2f} s")

    t0 = time.perf_counter()
    lake = generate_scaled_lake(ScaledLakeSpec(n_columns=n_columns, seed=5))
    walls["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    numeric, words, sigs = catalog.profile_and_sign(lake.batch, n_perm=N_PERM, seed=0, device=dev)
    walls["ingest"] = sync_wall(t0)
    prof = lake_profiles(numeric, words, lake.batch.n_rows)
    t0 = time.perf_counter()
    index = LSHIndex.build(sigs, LSHConfig(n_bands=N_BANDS, n_coarse_bands=N_COARSE))
    walls["lsh_build"] = time.perf_counter() - t0
    log(f"ingest: {lake.n_columns} columns x {lake.batch.row_budget} rows generated in "
        f"{walls['generate']:.2f} s, profiled + signed (P={N_PERM}) in "
        f"{walls['ingest']:.3f} s, band keys (B={N_BANDS}, S={N_COARSE}) in "
        f"{walls['lsh_build']:.3f} s")

    t0 = time.perf_counter()
    executor = Executor(prof.zscored, prof.words, model.gbdt.astuple(),
                        table_ids=lake.table, band_keys=index.keys, device=dev)
    walls["place"] = sync_wall(t0)
    qids = select_scaled_queries(lake, n_queries)
    z = prof.zscored.astype(np.float32)
    batch = (z[qids], prof.words[qids], lake.table[qids].astype(np.int32), qids,
             index.query_keys(sigs[qids]))
    planner = Planner(PlannerConfig(k=K))
    hybrid = planner.plan(n_columns=lake.n_columns, mode="lsh")
    plans = {"all": planner.plan(n_columns=lake.n_columns, mode="full"),
             "hybrid": hybrid,
             "lsh": QueryPlan(candidates="lsh", budget=hybrid.budget, k=K)}
    run = dict(model=model, lake=lake, prof=prof, sigs=sigs, index=index, qids=qids,
               batch=batch, plans=plans, walls=walls, executor=executor,
               results={}, qps={}, steady_ms={}, tiers={}, runs={})
    run_plans(run, {name: (executor, plan, batch) for name, plan in plans.items()}, reps)
    return run


def scale_path(run: dict, dev, reps=5) -> None:
    """The large-lake scale path over the discovery path's profiles and
    index: int8 and fp16 executors (only the sidecar and its scale on the
    card), the tiered plan over the int8 sidecar and the quantized full
    scans, each re-ranked exactly in float32."""
    prof, index, lake, model = run["prof"], run["index"], run["lake"], run["model"]
    executors = {}
    for dtype in SIDE_BYTES:
        t0 = time.perf_counter()
        executors[dtype] = Executor(prof.zscored, prof.words, model.gbdt.astuple(),
                                    table_ids=lake.table, band_keys=index.keys,
                                    coarse_keys=index.coarse, profile_dtype=dtype,
                                    device=dev)
        run["walls"][f"place_{dtype}"] = sync_wall(t0)
    qids = run["qids"]
    batch = run["batch"] + (index.coarse_query_keys(run["sigs"][qids]),)
    planner = Planner(PlannerConfig(k=K))
    tiered = planner.plan(n_columns=lake.n_columns, n_queries=len(qids), mode="tiered")
    auto = planner.plan(n_columns=lake.n_columns, n_queries=len(qids), mode="auto")
    log(f"auto: at {lake.n_columns} columns and Q={len(qids)} mode='auto' picks "
        f"{auto.kind} (budget {auto.budget}, survivor budget {auto.survivor_budget}; "
        f"{'the' if auto == tiered else 'not the'} tiered plan run below)")
    run.update(auto=auto, scale_executors=executors)
    run_plans(run, {"tiered_int8": (executors["int8"], tiered, batch),
                    "all_int8": (executors["int8"], run["plans"]["all"], batch),
                    "all_fp16": (executors["fp16"], run["plans"]["all"], batch)}, reps)


def model_path(run: dict, dev, reps=3) -> None:
    """The model path: train on the evaluation mix with the distances and
    labels on the card, score the discovery path's queries against its
    100k-column profiles with the two-stage scorer, and compute the exact
    metric on the held-out lake."""
    walls = run["walls"]
    t0 = time.perf_counter()
    lakes = [generate_lake(spec) for spec in TRAIN_LAKES]
    walls["model_lakes"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = train_quality_model(lakes, GBDTConfig(), n_query=N_LABEL_QUERIES, device=dev)
    walls["model_train"] = sync_wall(t0)
    log(f"model: trained on {[lake.n_columns for lake in lakes]} columns "
        f"({N_LABEL_QUERIES} label queries each) in {walls['model_train']:.2f} s "
        f"(lakes generated in {walls['model_lakes']:.2f} s), T={model.gbdt.n_trees} "
        f"D={model.gbdt.depth}, R^2 {model.train_r2:.4f}")

    prof, qids = run["prof"], run["qids"]
    t0 = time.perf_counter()
    scores = predict_scores(model, prof, qids, device=dev)
    first = sync_wall(t0)
    t0 = time.perf_counter()
    for _ in range(reps):
        predict_scores(model, prof, qids, device=dev)
    walls["two_stage"] = sync_wall(t0) / reps
    log(f"two-stage scorer: ({len(qids)}, {prof.n_columns}) scores, distance tensor "
        f"{len(qids) * prof.n_columns * FT.F_DIST * 4 / 1e6:.0f} MB, first call "
        f"{first * 1e3:.2f} ms, steady {walls['two_stage'] * 1e3:.2f} ms")

    t0 = time.perf_counter()
    held = generate_lake(HELD_OUT_LAKE)
    held_prof = profile_lake(held.batch, device=dev)
    held_q = select_queries(held, N_EXACT_QUERIES)
    j, k = (torch.from_numpy(a).to(dev) for a in exact_jk(held, held_q, device=dev))
    exact = quality.continuous_quality(j, k, model.strictness)
    pred = predict_scores(model, held_prof, held_q, device=dev)
    index = DiscoveryIndex(held_prof, model, names=held.batch.names, table_ids=held.table)
    ranked = {kk: rank(index, held_q, k=kk, device=dev) for kk in (1, 5, 10)}
    walls["exact_metric"] = sync_wall(t0)
    run["model_run"] = dict(model=model, lakes=lakes, scores=scores, held=held,
                            held_q=held_q, exact=exact.cpu().numpy(), pred=pred,
                            ranked=ranked, jk=(j, k))


def check_model_path(run, dev) -> dict:
    """Hold the model path against the plain versions: at each training
    lake's label queries, the distance tensor equal and the labels within
    LABEL_ATOL on the same side of the training threshold; the two-stage
    scores against the fused scorer; the predictions against the exact
    metric (correlation gate) and rank's P@k (information only)."""
    m = run["model_run"]
    model = m["model"]
    s = model.strictness
    params = (quality.MU_J + s, quality.SIGMA_J, quality.MU_K, quality.SIGMA_K)
    label_err = 0.0
    for i, lake in enumerate(m["lakes"]):
        # the label queries build_training_set draws (train_quality_model's seed + i)
        c = lake.n_columns
        qids = np.random.default_rng(i).choice(c, size=min(N_LABEL_QUERIES, c), replace=False)
        prof = profile_lake(lake.batch, device=dev)
        d, y = label_pairs(lake, prof, qids, s, device=dev)
        z = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
        w = hashes_to_torch(prof.words, dev)
        qi = torch.from_numpy(qids.astype(np.int64)).to(dev)
        if not torch.equal(d, ref.profile_distance_ref(z[qi], w[qi], z, w)):
            raise AssertionError(f"model path, lake {i}: distances differ from the plain version")
        j, k = (torch.from_numpy(a).to(dev) for a in exact_jk(lake, qids, device=dev))
        y_ref = ref.quality_cdf_ref(j, k, *params)
        err = float((y - y_ref).abs().max())
        if not err <= LABEL_ATOL:
            raise AssertionError(f"model path, lake {i}: labels differ by {err}")
        if not torch.equal(y > POSITIVE_LABEL, y_ref > POSITIVE_LABEL):
            raise AssertionError(f"model path, lake {i}: a label crosses the "
                                 f"{POSITIVE_LABEL} selection threshold")
        label_err = max(label_err, err)

    prof, qids = run["prof"], run["qids"]
    z = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
    w = hashes_to_torch(prof.words, dev)
    qi = torch.from_numpy(qids.astype(np.int64)).to(dev)
    fused = ops.fused_score(z[qi], w[qi], z, w, gbdt_to_torch(model.gbdt.astuple(), dev))
    fused = fused.cpu().numpy()
    np.testing.assert_allclose(m["scores"], fused, rtol=RTOL, atol=ATOL,
                               err_msg="two-stage scorer vs fused scorer")
    two_stage_err = float(np.abs(m["scores"] - fused).max())

    exact, pred = m["exact"], m["pred"]
    mask = (exact > 0.01) | (pred > 0.01)
    corr = float(np.corrcoef(exact[mask], pred[mask])[0, 1])
    held, held_q = m["held"], m["held_q"]
    p_at = {}
    for kk, (sc, ids) in m["ranked"].items():
        valid = np.isfinite(sc)
        sem = held.is_semantic(np.repeat(held_q, kk), ids.reshape(-1)).reshape(len(held_q), kk)
        p_at[kk] = float((sem & valid).sum() / max(valid.sum(), 1))
    log(f"check: model-path distances equal the plain version at the {len(m['lakes'])} "
        f"training lakes' label queries; labels within {label_err} of it (gate "
        f"{LABEL_ATOL}), none across {POSITIVE_LABEL}; two-stage vs fused scorer at "
        f"{m['scores'].shape}: max |err| {two_stage_err}")
    log(f"exact metric on the held-out lake ({held.n_columns} columns, {len(held_q)} "
        f"queries): correlation with the prediction {corr:.4f} over {int(mask.sum())} "
        f"pairs with signal (gate {CORR_GATE}); P@k (information only) {p_at}")
    if not corr > CORR_GATE:
        raise AssertionError(f"prediction vs exact metric: correlation {corr} <= {CORR_GATE}")
    return dict(label_err=label_err, two_stage_err=two_stage_err, corr=corr, p_at=p_at)


def _same_ranking(name, s_ref, i_ref, s, i, tol=RTOL) -> None:
    """Ids equal up to the order of exact score ties; scores close."""
    s_ref, i_ref = s_ref.cpu().numpy(), i_ref.cpu().numpy()
    if (np.isfinite(s) != np.isfinite(s_ref)).any():
        raise AssertionError(f"{name}: finite slots differ from the plain top-k")
    both = np.isfinite(s)
    np.testing.assert_allclose(s[both], s_ref[both], rtol=tol, atol=ATOL, err_msg=name)
    for row in range(s.shape[0]):
        a, b = set(i_ref[row][i_ref[row] >= 0]), set(i[row][i[row] >= 0])
        for d in a ^ b:
            sd = s_ref[row][list(i_ref[row]).index(d)] if d in a else s[row][list(i[row]).index(d)]
            other = s[row] if d in a else s_ref[row]
            near = np.min(np.abs(other[np.isfinite(other)] - sd))
            if near > tol * max(1.0, abs(sd)):
                raise AssertionError(f"{name}: row {row} id {d} (score {sd}) has no tie")


def reference_candidates(kind, zq, qkeys, z, ckeys, excl):
    """The candidate priorities of ``stages.candidate_priorities``, with the
    plain probe in place of the kernel."""
    hit = ref.lsh_probe_ref(qkeys, ckeys)
    if kind == "lsh":
        prio = torch.where(hit > 0, 0.0, float("-inf"))
    else:
        proxy = (2.0 * zq) @ z.T - (z * z).sum(1)[None]
        prio = hit.to(torch.float32) * stages._LSH_PRIORITY_BOOST + proxy / (1.0 + proxy.abs())
    return torch.where(excl, float("-inf"), prio)


def check_main_path(run, dev) -> dict:
    """Hold every plan's ranking against the plain scorer's top-k over the
    same candidates and masks; report recall@k of the pruned plans."""
    zq_np, wq_np, tq_np, qids, qk_np = run["batch"]
    prof, model = run["prof"], run["model"]
    z = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
    w = hashes_to_torch(prof.words, dev)
    ck = hashes_to_torch(run["index"].keys, dev)
    cids = torch.arange(z.shape[0], device=dev)
    tids = torch.from_numpy(run["lake"].table.astype(np.int64)).to(dev)
    zq = torch.from_numpy(zq_np).to(dev)
    wq, qk = hashes_to_torch(wq_np, dev), hashes_to_torch(qk_np, dev)
    tq = torch.from_numpy(tq_np.astype(np.int64)).to(dev)
    qid = torch.from_numpy(qids.astype(np.int64)).to(dev)
    g = gbdt_to_torch(model.gbdt.astuple(), dev)
    excl = stages.exclusion_mask(cids, tids, tq, qid)
    checks = {}
    for name, plan in run["plans"].items():
        sc, ids, n_scored = run["results"][name]
        if sc.shape != (len(qids), K) or ids.shape != (len(qids), K):
            raise AssertionError(f"{name}: result shape {sc.shape}")
        if np.isnan(sc).any():
            raise AssertionError(f"{name}: NaN scores")
        if name == "all":
            s = torch.where(excl, float("-inf"), ref.fused_score_ref(zq, wq, z, w, *g))
            s_ref, i_ref = stages.merge_topk(s, cids, K)
            n_ref = np.full(len(qids), z.shape[0])
            if not np.isfinite(sc).all():
                raise AssertionError("all: a full scan left a top-k slot empty")
        else:
            prio = reference_candidates(plan.candidates, zq, qk, z, ck, excl)
            pos, valid = stages.gather_candidates(prio, plan.budget)
            s = torch.where(valid, ref.fused_score_ref(zq, wq, z[pos], w[pos], *g),
                            float("-inf"))
            s_ref, i_ref = stages.merge_topk(s, cids[pos], K)
            n_ref = valid.sum(1).cpu().numpy()
        _same_ranking(name, s_ref, i_ref, sc, ids)
        if not np.array_equal(n_scored, n_ref):
            raise AssertionError(f"{name}: n_scored differs from the plain candidate count")
        checks[name] = float(n_scored.mean())
    full = run["results"]["all"][1]
    recall = {}
    for name in ("hybrid", "lsh"):
        got = run["results"][name][1]
        recall[name] = float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
                                      for a, b in zip(got, full)]))
    lake = run["lake"]
    partners = float(np.mean([np.isin(ids[ids >= 0], lake.partners(q)).mean()
                              for q, ids in zip(qids, full)]))
    log(f"check: every plan's ids equal the plain scorer's top-{K} over the same "
        f"candidates (up to exact ties); mean columns scored {checks}")
    log(f"recall@{K} vs all (information only): {recall}; "
        f"planted-partner precision@{K} of all: {partners:.4f}")
    return dict(recall=recall, scored=checks, partner_precision=partners)


def reference_rerank(zq, wq, z32, w, g, sc, ids, k):
    """The exact float32 re-rank with the plain scorer: the scan's (Q, R)
    candidates rescored from their float32 rows, invalid slots excluded."""
    safe = ids.clamp(min=0)
    s = torch.where(torch.isfinite(sc), ref.fused_score_ref(zq, wq, z32[safe], w[safe], *g),
                    float("-inf"))
    s2, pos = stages.topk_stable(s, min(k, s.shape[1]))
    return s2, torch.where(torch.isfinite(s2), torch.gather(ids, 1, pos), -1)


def reference_tiered(zq, qk, qc, side, scale, ck, coarse, excl, plan, block_c):
    """The tiered candidate stage with the plain probes, written out: digest
    hits expanded to blocks by a per-block hit sum, the proxy fill, the
    survivor gather, then the plain gathered probe and proxy over the
    survivors and the fine gather. Returns the positions and counts."""
    zf = side.to(torch.float32) * scale
    fill = (2.0 * zq) @ zf.T - (zf * zf).sum(1)[None]
    hit = ref.lsh_probe_ref(qc, coarse)
    blocks = torch.arange(hit.shape[1], device=hit.device) // block_c
    per_block = torch.zeros((hit.shape[0], int(blocks[-1]) + 1), device=hit.device)
    block_hit = per_block.index_add_(1, blocks, hit.to(torch.float32))[:, blocks] > 0
    prio = (torch.where(block_hit, stages._LSH_PRIORITY_BOOST, 0.0) + hit.to(torch.float32)
            + fill / (1.0 + fill.abs()))
    surv = min(max(plan.survivor_budget, plan.budget), side.shape[0])
    budget = min(plan.budget, surv)
    pos, valid = stages.gather_candidates(torch.where(excl, float("-inf"), prio), surv)
    zg = zf[pos]
    proxy = 2.0 * torch.einsum("qf,qmf->qm", zq, zg) - (zg * zg).sum(-1)
    prio2 = (ref.lsh_probe_gathered_ref(qk, ck[pos]).to(torch.float32)
             * stages._LSH_PRIORITY_BOOST + proxy / (1.0 + proxy.abs()))
    pos2, valid2 = stages.gather_candidates(torch.where(valid, prio2, float("-inf")), budget)
    return dict(pos=pos, gpos=torch.gather(pos, 1, pos2), valid2=valid2,
                n_hits=((hit > 0) & ~excl).sum(1), n_surv=(block_hit & ~excl).sum(1))


def check_scale_path(run, dev) -> dict:
    """Hold each plan of the scale path against a plain pipeline over the
    same candidates (plain probes, plain quantized scorer, plain exact
    re-rank); gate the quantized top-k overlap with the float32 one."""
    zq_np, wq_np, tq_np, qids, qk_np = run["batch"]
    prof, model, index = run["prof"], run["model"], run["index"]
    z32 = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
    w = hashes_to_torch(prof.words, dev)
    cids = torch.arange(z32.shape[0], device=dev)
    tids = torch.from_numpy(run["lake"].table.astype(np.int64)).to(dev)
    zq = torch.from_numpy(zq_np).to(dev)
    wq, qk = hashes_to_torch(wq_np, dev), hashes_to_torch(qk_np, dev)
    qc = hashes_to_torch(index.coarse_query_keys(run["sigs"][qids]), dev)
    tq = torch.from_numpy(tq_np.astype(np.int64)).to(dev)
    qid = torch.from_numpy(qids.astype(np.int64)).to(dev)
    g = gbdt_to_torch(model.gbdt.astuple(), dev)
    excl = stages.exclusion_mask(cids, tids, tq, qid)
    k_scan = 4 * K                                  # the executor's over-fetch
    out = {}
    for name in ("tiered_int8", "all_int8", "all_fp16"):
        executor, plan, _ = run["runs"][name]
        sc, ids, n_scored = run["results"][name]
        side, scale = quantize_profiles(prof.zscored, executor.profile_dtype)
        side, scale = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
        if sc.shape != (len(qids), K) or np.isnan(sc).any():
            raise AssertionError(f"{name}: result shape {sc.shape} or NaN scores")
        if plan.candidates == "all":
            s = torch.where(excl, float("-inf"),
                            ref.fused_score_q_ref(zq, wq, side, scale, w, *g))
            s_scan, i_scan = stages.merge_topk(s, cids, k_scan)
            n_ref = np.full(len(qids), z32.shape[0])
        else:
            tr = reference_tiered(zq, qk, qc, side, scale,
                                  hashes_to_torch(index.keys, dev),
                                  hashes_to_torch(index.coarse, dev), excl, plan,
                                  executor.survivor_block)
            gpos = tr["gpos"]
            s = torch.where(tr["valid2"], ref.fused_score_q_ref(zq, wq, side[gpos], scale,
                                                                w[gpos], *g), float("-inf"))
            s_scan, i_scan = stages.merge_topk(s, cids[gpos], min(k_scan, gpos.shape[1]))
            n_ref = tr["valid2"].sum(1).cpu().numpy()
            for got, want, what in zip(run["tiers"][name], (tr["n_hits"], tr["n_surv"]),
                                       ("coarse hits", "survivors")):
                if not np.array_equal(got, want.cpu().numpy()):
                    raise AssertionError(f"{name}: {what} differ from the plain pipeline's")
            run["tiered_ref"] = tr
            log(f"{name}: mean coarse hits {float(tr['n_hits'].float().mean()):.1f}, "
                f"mean digest survivors {float(tr['n_surv'].float().mean()):.1f} of "
                f"{z32.shape[0]} columns, survivor budget {tr['pos'].shape[1]}")
        s_ref, i_ref = reference_rerank(zq, wq, z32, w, g, s_scan, i_scan, K)
        _same_ranking(name, s_ref, i_ref, sc, ids)
        if not np.array_equal(n_scored, n_ref):
            raise AssertionError(f"{name}: n_scored differs from the plain candidate count")
        out[name] = float(n_scored.mean())
    full = run["results"]["all"][1]
    overlap = {name: float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
                                    for a, b in zip(run["results"][name][1], full)]))
               for name in ("tiered_int8", "all_int8", "all_fp16")}
    log(f"check: every scale-path plan's ids equal its plain pipeline's top-{K} (up to exact "
        f"ties), n_scored and tier counts equal; mean columns scored {out}")
    log(f"top-{K} overlap with float32 all: {overlap} (tiered: recall, information only; "
        f"quantized all: gate {OVERLAP_GATE})")
    for name in ("all_int8", "all_fp16"):
        if overlap[name] < OVERLAP_GATE:
            raise AssertionError(f"{name}: top-{K} overlap {overlap[name]} with float32 "
                                 f"is below {OVERLAP_GATE}")
    return dict(scored=out, overlap=overlap)


# ---------------------------------------------------------------------------
# phase 3d: the serving path at real size
# ---------------------------------------------------------------------------

def _engine_config(**kw) -> EngineConfig:
    # no result cache: every request of the repeated query set is computed
    # (and held against the executor); the next-bucket background warm is
    # off so the retired version's memory can be read without it
    return EngineConfig(k=K, lsh=LSHConfig(n_bands=N_BANDS, n_coarse_bands=N_COARSE),
                        warmup="serve", incremental=True,
                        column_buckets=DEFAULT_COLUMN_BUCKETS, cache_entries=0,
                        prewarm_fraction=2.0, **kw)


def _uploads(n: int):
    """Raw string columns a client uploads (values from a private pool)."""
    r = np.random.default_rng(11)
    return [[f"up{i}_{v}" for v in r.integers(0, 40 + 10 * i, 200)] for i in range(n)]


def _serve(engine, requests, n_clients: int):
    """Submit ``requests`` through a scheduler from ``n_clients`` threads;
    return the responses in request order, every formed batch as
    (requests, responses), the wall and the scheduler's counters."""
    formed, real = [], engine.query_batch

    def spy(reqs, **kw):
        out = real(reqs, **kw)
        formed.append((list(reqs), out))
        return out

    engine.query_batch = spy
    futures = [None] * len(requests)
    try:
        with RequestScheduler(engine) as sch:
            def client(c):
                for i in range(c, len(requests), n_clients):
                    futures[i] = sch.submit(requests[i], block=True)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            responses = [f.result(timeout=300) for f in futures]
            wall = time.perf_counter() - t0
            stats = sch.stats()
    finally:
        engine.query_batch = real
    return responses, formed, wall, stats


def serve_path(run: dict, dev) -> dict:
    """Ingest, open two engines from disk, serve through the scheduler,
    follow an append. Returns what ``check_serve_path`` needs; the retired
    version stays pinned until the check has read it."""
    lake, model, qids = run["lake"], run["model"], run["qids"]
    root = tempfile.mkdtemp(prefix="freyja_serve_")
    out = dict(root=root, walls={})
    t0 = time.perf_counter()
    store = CatalogStore(root, n_perm=N_PERM, minhash_seed=0, device=dev)
    n_tables = int(lake.batch.table_ids.max()) + 1
    store.add_batch(lake.batch, [f"t{i}" for i in range(n_tables)])
    out["walls"]["ingest"] = sync_wall(t0)
    log(f"serve: ingested {lake.n_columns} columns x {lake.batch.row_budget} rows "
        f"({n_tables} tables, one segment, P={N_PERM}) in {out['walls']['ingest']:.2f} s")

    engines = {}
    for name, cfg in (("lsh_fp32", _engine_config(mode="lsh")),
                      ("auto_int8", _engine_config(mode="auto", profile_dtype="int8"))):
        t0 = time.perf_counter()
        eng = DiscoveryEngine.from_catalog(CatalogStore(root, device=dev), model, cfg,
                                           device=dev)
        out["walls"][f"open_{name}"] = sync_wall(t0)
        engines[name] = eng
        rep = eng.warmup_report
        plan = eng.planner.plan(n_columns=eng._executor.n_columns, n_queries=64,
                                mode=cfg.mode)
        log(f"serve: engine {name} opened from disk in {out['walls'][f'open_' + name]:.2f} s "
            f"(corpus bucket {eng._executor.n_columns}); warmup {rep['wall_ms']:.1f} ms: "
            f"{ {k: rep[k] for k in ('scope', 'buckets', 'n_executables', 'cache_misses')} }; "
            f"mode {cfg.mode!r} plans {plan.kind} at a 64-query batch")
    out["engines"] = engines

    uploads = _uploads(N_UPLOADS)
    out["served"] = {}
    for name, eng in engines.items():
        reqs = ([DiscoveryRequest(name=f"q{int(q)}.{r}", column_id=int(q))
                 for r in range(SERVE_REPEATS) for q in qids]
                + [DiscoveryRequest(name=f"up{i}", values=v) for i, v in enumerate(uploads)])
        st = eng._pin()          # the version these batches serve (released in the check)
        responses, formed, wall, stats = _serve(eng, reqs, N_CLIENTS)
        torch.cuda.synchronize()
        lat = np.asarray([r.latency_ms for r in responses])
        spans: dict = {}
        for r in responses:                # the per-request phase trace
            for sp in r.trace:
                spans[sp["phase"]] = spans.get(sp["phase"], 0.0) + sp["ms"] / len(responses)
        out["served"][name] = dict(state=st, responses=responses, formed=formed,
                                   wall=wall, qps=len(reqs) / wall,
                                   p50=float(np.percentile(lat, 50)),
                                   p99=float(np.percentile(lat, 99)), stats=stats,
                                   spans=spans)
        log(f"serve: {name}: {len(reqs)} requests from {N_CLIENTS} clients in {wall:.3f} s "
            f"= {len(reqs) / wall:.1f} queries/s; latency p50 {out['served'][name]['p50']:.2f} ms "
            f"p99 {out['served'][name]['p99']:.2f} ms (scheduler-stamped queue + compute); "
            f"{stats['batches']} batches, sizes {stats['batch_size_hist']}, plans "
            f"{eng.stats()['plans']}; mean ms a request by phase "
            f"{ {k: round(v, 3) for k, v in spans.items()} }")

    # follow: a second handle appends one table; the lsh engine extends
    eng = engines["lsh_fp32"]
    eng.follow(CatalogReader(root))
    old = eng._pin()
    follow = generate_scaled_lake(FOLLOW_LAKE)
    batch = dataclasses.replace(follow.batch, names=[f"f{i}" for i in range(follow.n_columns)],
                                table_ids=np.zeros((follow.n_columns,), np.int32))
    t0 = time.perf_counter()
    CatalogStore(root, device=dev).add_batch(batch, ["follow"])
    out["walls"]["append"] = sync_wall(t0)
    t0 = time.perf_counter()
    eng._maybe_follow(force=True)
    out["walls"]["refresh"] = sync_wall(t0)
    new = eng._pin()
    reqs = ([DiscoveryRequest(name=f"f{int(q)}", column_id=int(q)) for q in qids]
            + [DiscoveryRequest(name=f"fu{i}", values=v) for i, v in enumerate(uploads)]
            + [DiscoveryRequest(name=f"new{i}", column_id=lake.n_columns + i)
               for i in range(0, follow.n_columns, 128)])
    out["follow"] = dict(old=old, new=new, requests=reqs,
                         responses=eng.query_batch(reqs), refresh=eng.stats()["refresh"])
    rs = out["follow"]["refresh"]
    log(f"serve: follow: appended {follow.n_columns} columns in {out['walls']['append']:.2f} s; "
        f"refresh v{old.version} -> v{new.version} ({'incremental' if rs['incremental'] else 'full'}) "
        f"in {out['walls']['refresh'] * 1e3:.1f} ms (engine {rs['last_ms']:.1f} ms), "
        f"{new.executor.bytes_uploaded} bytes uploaded (the full placement: "
        f"{old.executor.bytes_uploaded} bytes)")
    return out


def _as_arrays(responses):
    s = np.full((len(responses), K), -np.inf, np.float32)
    i = np.full((len(responses), K), -1, np.int64)
    for row, r in enumerate(responses):
        for col, m in enumerate(r.matches):
            s[row, col], i[row, col] = m.score, m.column_id
    return s, i


def _batch_inputs(engine, st, requests):
    """A formed batch's padded executor inputs, as the engine builds them."""
    zq, wq, sigq, tq, qid = engine._resolve(requests, st)
    (zq, wq, sigq, tq, qid), q = pad_rows((zq, wq, sigq, tq, qid),
                                          engine._pad_target(len(requests)))
    plan = engine.planner.plan(n_columns=st.executor.n_columns, n_queries=zq.shape[0],
                               mode=engine.config.mode)
    return plan, (zq, wq, tq, qid, st.lsh.query_keys(sigq), st.lsh.coarse_query_keys(sigq)), q


def plain_serve(ex, plan, zq, wq, tq, qid, qkeys, qcoarse, dev):
    """The executor's pipeline with the plain probes and scorers, over the
    executor's resident tensors (its sentinel pad rows included)."""
    g = ex._gbdt
    zq = torch.from_numpy(np.asarray(zq, np.float32)).to(dev)
    wq = hashes_to_torch(wq, dev)
    tq = torch.from_numpy(np.asarray(tq, np.int64)).to(dev)
    qid = torch.from_numpy(np.asarray(qid, np.int64)).to(dev)
    qk, qc = to_bits(hashes_to_torch(qkeys, dev)), to_bits(hashes_to_torch(qcoarse, dev))
    side, scale, w, cids = ex._z, ex._zscale, ex._w, ex._cids
    quantized = side.dtype != torch.float32

    def score(zc, wc):
        if quantized:
            return ref.fused_score_q_ref(zq, wq, zc, scale, wc, *g)
        return ref.fused_score_ref(zq, wq, zc, wc, *g)

    spec = ex._local_spec(plan)
    excl = stages.exclusion_mask(cids, ex._tids, tq, qid)
    if plan.candidates == "all":
        s = torch.where(excl, float("-inf"), score(side, w))
        sc, ids = stages.merge_topk(s, cids, spec["k"])
        n = stages.live_count(cids).expand(zq.shape[0])
    elif plan.candidates == "tiered":
        tr = reference_tiered(zq, qk, qc, side, scale, ex._ckeys, ex._coarse, excl, plan,
                              ex.survivor_block)
        gpos = tr["gpos"]
        s = torch.where(tr["valid2"], score(side[gpos], w[gpos]), float("-inf"))
        sc, ids = stages.merge_topk(s, cids[gpos], min(spec["k"], gpos.shape[1]))
        n = tr["valid2"].sum(1)
    else:
        zf = side.to(torch.float32) * scale
        prio = reference_candidates(plan.candidates, zq, qk, zf, ex._ckeys, excl)
        pos, valid = stages.gather_candidates(prio, spec["budget"])
        s = torch.where(valid, score(side[pos], w[pos]), float("-inf"))
        sc, ids = stages.merge_topk(s, cids[pos], spec["k"])
        n = valid.sum(1)
    if ex._fp32_rows is not None:         # the exact float32 re-rank, plain
        safe = ids.clamp(0, ex.n_live - 1)
        zg = torch.from_numpy(np.asarray(ex._fp32_rows(safe.cpu().numpy()), np.float32)).to(dev)
        s = torch.where(torch.isfinite(sc), ref.fused_score_ref(zq, wq, zg, w[safe], *g),
                        float("-inf"))
        sc, pos = stages.topk_stable(s, min(plan.k, s.shape[1]))
        ids = torch.where(torch.isfinite(sc), torch.gather(ids, 1, pos), -1)
    sc, ids = pad_topk(sc.cpu().numpy(), ids.cpu().numpy(), plan.k)
    return sc, ids, n.cpu().numpy()


def check_serve_path(serve: dict, dev, smi: str) -> dict:
    """Hold every formed batch against the pinned executor (exactly) and
    the plain pipeline, the followed answers against a fresh executor, and
    the retired version's device memory; release every pin."""
    out = {}
    for name, rec in serve["served"].items():
        eng, st = serve["engines"][name], rec["state"]
        if any(r.cached for r in rec["responses"]):
            raise AssertionError(f"{name}: a response came from the result cache")
        n_rows = 0
        for reqs, responses in rec["formed"]:
            plan, args, q = _batch_inputs(eng, st, reqs)
            sc, ids, n = st.executor.execute(plan, *args)
            s_got, i_got = _as_arrays(responses)
            if not (np.array_equal(i_got, ids[:q]) and np.array_equal(s_got, sc[:q])):
                raise AssertionError(f"{name}: a response differs from Executor.execute "
                                     f"on its pinned version")
            if [r.n_candidates for r in responses] != n[:q].tolist():
                raise AssertionError(f"{name}: n_candidates differs from the executor's")
            for lo in range(0, len(args[0]), PLAIN_ROWS):
                part = [a[lo:lo + PLAIN_ROWS] for a in args]
                s_ref, i_ref, n_ref = plain_serve(st.executor, plan, *part, dev)
                _same_ranking(f"{name} plain", torch.from_numpy(s_ref), torch.from_numpy(i_ref),
                              sc[lo:lo + PLAIN_ROWS], ids[lo:lo + PLAIN_ROWS])
                if not np.array_equal(n_ref, n[lo:lo + PLAIN_ROWS]):
                    raise AssertionError(f"{name}: n_scored differs from the plain pipeline's")
            n_rows += q
        if n_rows != len(rec["responses"]):
            raise AssertionError(f"{name}: {n_rows} rows checked of {len(rec['responses'])}")
        out[name] = dict(batches=len(rec["formed"]), plan=eng.stats()["last_plan"]["kind"])
    log(f"check: serve: every formed batch equals Executor.execute on its pinned version "
        f"and the plain pipeline (up to exact ties, equal n_candidates): {out}")

    f, eng = serve["follow"], serve["engines"]["lsh_fp32"]
    new, old = f["new"], f["old"]
    if not f["refresh"]["incremental"] or new.version <= old.version:
        raise AssertionError(f"serve: the follower did not refresh incrementally: {f['refresh']}")
    fresh = Executor(new.z, new.w, eng.model.gbdt.astuple(),
                     table_ids=new.snapshot.table_ids, band_keys=new.lsh.keys,
                     coarse_keys=new.lsh.coarse, n_padded=new.executor.n_columns, device=dev)
    plan, args, q = _batch_inputs(eng, new, f["requests"])
    want = fresh.execute(plan, *args)
    got = new.executor.execute(plan, *args)
    s_resp, i_resp = _as_arrays(f["responses"])
    if not all(np.array_equal(a, b) for a, b in zip(got, want)) or not (
            np.array_equal(i_resp, want[1][:q]) and np.array_equal(s_resp, want[0][:q])):
        raise AssertionError("serve: the extended executor differs from a fresh one")
    if [r.n_candidates for r in f["responses"]] != want[2][:q].tolist():
        raise AssertionError("serve: the followed n_candidates differ from a fresh executor's")
    fresh.close()
    del fresh

    # the retired version: released by its last pin, its rows freed
    held = old.executor._rows_bundle.arrays
    rows = [t for k, t in held.items() if k != "zscale" and t is not None]
    expect = sum(-(-t.nbytes // 512) * 512 for t in rows)
    slack = ALLOC_SLACK * len(rows)
    del held, rows
    eng._release(old)          # the engine's head moved on: still open
    if old.executor.closed:
        raise AssertionError("serve: a version still pinned by a batch was closed")
    allocated = (torch.cuda.memory_allocated if dev.type == "cuda"
                 else lambda _: 0)    # a host rehearsal has no device allocator
    torch.cuda.synchronize()
    before = allocated(dev)
    for name, rec in serve["served"].items():
        serve["engines"][name]._release(rec["state"])
    torch.cuda.synchronize()
    freed = before - allocated(dev)
    if not old.executor.closed or (dev.type == "cuda"
                                   and not expect <= freed <= expect + slack):
        raise AssertionError(f"serve: retiring v{old.version} freed {freed} bytes; its "
                             f"resident corpus holds {expect} (+ up to {slack} of "
                             f"allocator blocks)")
    eng._release(new)
    for e in serve["engines"].values():
        e.close()
    shutil.rmtree(serve["root"], ignore_errors=True)
    log(f"check: serve: the followed engine's answers equal a fresh executor's exactly; "
        f"retiring v{old.version} closed its executor and freed {freed} bytes "
        f"(resident corpus {expect}); card {smi}")
    return dict(out, freed=freed, expected=expect)


# ---------------------------------------------------------------------------
# phase 4: kernels at the main path's shapes and inputs
# ---------------------------------------------------------------------------

def measure_kernels(run, dev, launches: dict) -> list:
    flush = torch.empty(16 * 1024 * 1024, dtype=torch.float32, device=dev)
    zq_np, wq_np, _, qids, qk_np = run["batch"]
    prof = run["prof"]
    g = gbdt_to_torch(run["model"].gbdt.astuple(), dev)
    t, d = g[0].shape
    zq = torch.from_numpy(zq_np).to(dev)
    wq = hashes_to_torch(wq_np, dev)
    z = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
    w = hashes_to_torch(prof.words, dev)
    out = []

    def earlier(name):
        return f", before the redesign {EARLIER_MS[name]:.4f} ms" if name in EARLIER_MS else ""

    def record(name, got, want, exact, k_fn, p_fn, bound, reps, plain_reps):
        """``exact``: True for bit-equality, or an absolute tolerance."""
        if exact is True:
            if not torch.equal(got, want):
                raise AssertionError(f"{name}: kernel differs from its plain version")
            err = 0.0
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=exact)
            err = float((got - want).abs().max())
        ms, plain_ms = time_ms(k_fn, reps, flush), time_ms(p_fn, plain_reps, flush)
        b_ms, b_by = bound
        row = {"name": name, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{name}.cu",
               "replaces": TPU_KERNELS[name], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": None}
        log(f"kernel {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"{b_ms / ms:.1%} of it{earlier(name)}), plain {plain_ms:.3f} ms, max |err| {err}")
        return row

    # fused_score, shared corpus: the full scan's (Q, N) geometry
    wq_b, w_b = to_bits(wq), to_bits(w)
    f32, th, lv = g[0].contiguous(), g[1].contiguous(), g[2].contiguous()
    got = ops.fused_score(zq, wq, z, w, g)
    want = ref.fused_score_ref(zq, wq, z, w, *g)
    out.append(record("fused_score", got, want, True,
                      lambda: fused_score_cuda(zq, wq_b, z, w_b, f32, th, lv, g[3]),
                      lambda: ref.fused_score_ref(zq, wq, z, w, *g),
                      fused_score_bound(zq.shape[0], z.shape[0], zq.shape[0] * z.shape[0], t, d), 20, 3))
    # fused_score, gathered: the hybrid plan's (Q, M, F) candidates
    hybrid = run["plans"]["hybrid"]
    ck = hashes_to_torch(run["index"].keys, dev)
    qk = hashes_to_torch(qk_np, dev)
    cids = torch.arange(z.shape[0], device=dev)
    tids = torch.from_numpy(run["lake"].table.astype(np.int64)).to(dev)
    tq = torch.from_numpy(run["batch"][2].astype(np.int64)).to(dev)
    qid = torch.from_numpy(qids.astype(np.int64)).to(dev)
    prio = reference_candidates("hybrid", zq, qk, z, ck,
                                stages.exclusion_mask(cids, tids, tq, qid))
    pos, _ = stages.gather_candidates(prio, hybrid.budget)
    zg, wg = z[pos].contiguous(), w[pos].contiguous()
    wg_b = to_bits(wg)
    _scorer_equal("fused_score (gathered)", ops.fused_score(zq, wq, zg, wg, g),
                  ref.fused_score_ref(zq, wq, zg, wg, *g), tuple(zg.shape))
    g_ms = time_ms(lambda: fused_score_cuda(zq, wq_b, zg, wg_b, f32, th, lv, g[3]), 20, flush)
    g_plain = time_ms(lambda: ref.fused_score_ref(zq, wq, zg, wg, *g), 3, flush)
    gb_ms, gb_by = fused_score_bound(zq.shape[0], pos.numel(), pos.numel(), t, d)
    log(f"kernel fused_score (gathered {tuple(zg.shape)}): {g_ms:.4f} ms "
        f"(bound {gb_ms:.4f} ms by {gb_by}{earlier('fused_score gathered')}), "
        f"plain {g_plain:.3f} ms, max |err| 0.0")

    # minhash at ingest's geometry: one chunk of profile_and_sign's column walk
    # (the scaled lake's 256 rows and 100k columns need no padding)
    v = hashes_to_torch(run["lake"].batch.values32[:catalog.CHUNK_COLUMNS], dev)
    a, b = (hashes_to_torch(x, dev) for x in make_permutations(N_PERM, 0))
    v_b, a_b, b_b = to_bits(v), to_bits(a), to_bits(b)
    out.append(record("minhash", ops.minhash(v, a, b), ref.minhash_ref(v, a, b), True,
                      lambda: minhash_cuda(v_b, a_b, b_b),
                      lambda: ref.minhash_ref(v, a, b),
                      minhash_bound(*v.shape, N_PERM), 10, 2))

    # lsh_probe at the pruned plans' geometry: (Q, B) against (C, B)
    qk_b, ck_b = to_bits(qk), to_bits(ck)
    out.append(record("lsh_probe", ops.lsh_probe(qk, ck), ref.lsh_probe_ref(qk, ck), True,
                      lambda: lsh_probe_cuda(qk_b, ck_b),
                      lambda: ref.lsh_probe_ref(qk, ck),
                      lsh_probe_bound(qk.shape[0], ck.shape[0], qk.shape[1]), 20, 3))
    # ... and at the tiered coarse digest scan's: (Q, S) against (C, S)
    qc = hashes_to_torch(run["index"].coarse_query_keys(run["sigs"][qids]), dev)
    cc = hashes_to_torch(run["index"].coarse, dev)
    if not torch.equal(ops.lsh_probe(qc, cc), ref.lsh_probe_ref(qc, cc)):
        raise AssertionError("lsh_probe (coarse digest) differs from its plain version")
    qc_b, cc_b = to_bits(qc), to_bits(cc)
    c_ms = time_ms(lambda: lsh_probe_cuda(qc_b, cc_b), 20, flush)
    cb_ms, cb_by = lsh_probe_bound(qc.shape[0], cc.shape[0], qc.shape[1])
    log(f"kernel lsh_probe (coarse digest {tuple(qc.shape)} x {tuple(cc.shape)}): "
        f"{c_ms:.4f} ms (bound {cb_ms:.4f} ms by {cb_by}, {cb_ms / c_ms:.1%} of it"
        f"{earlier('lsh_probe coarse')})")

    # lsh_probe_gathered at the tiered fine probe's geometry: (Q, B) against
    # each query's C' survivors, read in place from the resident (N, B) table
    # through their positions, as the tiered plan calls it
    # (the row's "form": "indexed"; before this form the row timed the
    # pre-gathered one, whose time and bound are kept beside it as
    # "pre_gathered_ms" and "pre_gathered_bound_ms")
    tr = run["tiered_ref"]
    pos = tr["pos"].contiguous()
    distinct = torch.unique(pos).numel()
    out.append(record("lsh_probe_gathered", ops.lsh_probe_gathered(qk, ck, pos),
                      ref.lsh_probe_gathered_ref(qk, ck[pos]), True,
                      lambda: lsh_probe_gathered_cuda(qk_b, ck_b, pos),
                      lambda: ref.lsh_probe_gathered_ref(qk, ck[pos]),
                      lsh_probe_indexed_bound(*pos.shape, qk.shape[1], distinct), 20, 3))
    # ... the pre-gathered form over the same rows (the TPU kernel's
    # signature), and the earlier route: the (Q, C', B) copy, then the probe
    kg = ck[pos].contiguous()
    kg_b = to_bits(kg)
    if not torch.equal(ops.lsh_probe_gathered(qk, kg), ref.lsh_probe_gathered_ref(qk, kg)):
        raise AssertionError("lsh_probe_gathered (pre-gathered) differs from its plain version")
    pg_ms = time_ms(lambda: lsh_probe_gathered_cuda(qk_b, kg_b), 20, flush)
    route_ms = time_ms(lambda: lsh_probe_gathered_cuda(qk_b, ck_b[pos]), 20, flush)
    fused_ms = time_ms(lambda: lsh_probe_gathered_cuda(qk_b, ck_b, pos), 20, flush)
    pgb_ms, pgb_by = lsh_probe_gathered_bound(*kg.shape)
    out[-1].update(form="indexed", distinct_rows=distinct, pre_gathered_ms=pg_ms,
                   pre_gathered_bound_ms=pgb_ms)
    log(f"kernel lsh_probe_gathered (pre-gathered {tuple(kg.shape)}): {pg_ms:.4f} ms (bound "
        f"{pgb_ms:.4f} ms by {pgb_by}, {pgb_ms / pg_ms:.1%} of it"
        f"{earlier('lsh_probe_gathered pre-gathered')}); the earlier route (gather the "
        f"survivors' keys, then probe) {route_ms:.4f} ms vs in place {fused_ms:.4f} ms; "
        f"{distinct} distinct rows of {pos.numel()} positions")

    # fused_score_q over the int8 sidecar: the quantized full scan's (Q, N)
    side, scale = quantize_profiles(prof.zscored, "int8")
    zs, sc = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
    out.append(record("fused_score_q", ops.fused_score_q(zq, wq, zs, sc, w, g),
                      ref.fused_score_q_ref(zq, wq, zs, sc, w, *g), True,
                      lambda: fused_score_q_cuda(zq, wq_b, zs, sc, w_b, f32, th, lv, g[3]),
                      lambda: ref.fused_score_q_ref(zq, wq, zs, sc, w, *g),
                      fused_score_bound(zq.shape[0], zs.shape[0], zq.shape[0] * zs.shape[0],
                                        t, d, num_bytes=1), 20, 3))
    # ... gathered: the tiered plan's (Q, M, F) scored candidates
    zsg, wsg = zs[tr["gpos"]].contiguous(), w[tr["gpos"]].contiguous()
    wsg_b = to_bits(wsg)
    _scorer_equal("fused_score_q (gathered)", ops.fused_score_q(zq, wq, zsg, sc, wsg, g),
                  ref.fused_score_q_ref(zq, wq, zsg, sc, wsg, *g), tuple(zsg.shape))
    gq_ms = time_ms(lambda: fused_score_q_cuda(zq, wq_b, zsg, sc, wsg_b, f32, th, lv, g[3]),
                    20, flush)
    gq_plain = time_ms(lambda: ref.fused_score_q_ref(zq, wq, zsg, sc, wsg, *g), 3, flush)
    gqb_ms, gqb_by = fused_score_bound(zq.shape[0], tr["gpos"].numel(), tr["gpos"].numel(),
                                       t, d, num_bytes=1)
    log(f"kernel fused_score_q (gathered int8 {tuple(zsg.shape)}): {gq_ms:.4f} ms "
        f"(bound {gqb_ms:.4f} ms by {gqb_by}{earlier('fused_score_q gathered')}), "
        f"plain {gq_plain:.3f} ms, max |err| 0.0")
    # ... and over the fp16 sidecar, shared and gathered
    side, scale = quantize_profiles(prof.zscored, "fp16")
    zh, sh = torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev)
    for geo, zc, wc in (("shared", zh, w), ("gathered", zh[tr["gpos"]].contiguous(), wsg)):
        _scorer_equal(f"fused_score_q (fp16 {geo})", ops.fused_score_q(zq, wq, zc, sh, wc, g),
                      ref.fused_score_q_ref(zq, wq, zc, sh, wc, *g), tuple(zc.shape))
        wc_b = to_bits(wc)
        h_ms = time_ms(lambda: fused_score_q_cuda(zq, wq_b, zc, sh, wc_b, f32, th, lv, g[3]),
                       20, flush)
        h_bound, h_by = fused_score_bound(zq.shape[0], zc.numel() // FT.F_NUM,
                                          zq.shape[0] * zc.shape[-2], t, d, num_bytes=2)
        log(f"kernel fused_score_q (fp16 {geo} {tuple(zc.shape)}): {h_ms:.4f} ms "
            f"(bound {h_bound:.4f} ms by {h_by}), max |err| 0.0")

    # the model path: no single PyTorch call computes any of its three
    # functions (a gather-compare-sum, an oblivious-tree walk, a product of
    # truncated CDFs), so library_ms stays null
    # profile_distance at the two-stage scorer's (Q, N) against the lake
    dist = ops.profile_distance(zq, wq, z, w)
    out.append(record("profile_distance", dist, ref.profile_distance_ref(zq, wq, z, w), True,
                      lambda: profile_distance_cuda(zq, wq_b, z, w_b),
                      lambda: ref.profile_distance_ref(zq, wq, z, w),
                      profile_distance_bound(zq.shape[0], z.shape[0]), 20, 2))
    # gbdt_infer over that tensor's (Q·N, F_DIST) rows
    rows = dist.view(-1, FT.F_DIST)
    out.append(record("gbdt_infer", ops.gbdt_infer(rows, g), ref.gbdt_infer_ref(rows, *g), True,
                      lambda: gbdt_infer_cuda(rows, f32, th, lv, g[3]),
                      lambda: ref.gbdt_infer_ref(rows, *g),
                      gbdt_infer_bound(rows.shape[0], FT.F_DIST, t, d), 20, 2))
    del dist, rows
    # quality_cdf at the labels' shape: the first training lake's label
    # queries against the lake (the exact metric of its pairs)
    m = run["model_run"]
    lake = m["lakes"][0]
    c = lake.n_columns
    lq = np.random.default_rng(0).choice(c, size=min(N_LABEL_QUERIES, c), replace=False)
    j, k = (torch.from_numpy(a).to(dev) for a in exact_jk(lake, lq, device=dev))
    qp = (quality.MU_J + m["model"].strictness, quality.SIGMA_J, quality.MU_K,
          quality.SIGMA_K, 0.0, 1.0)
    out.append(record("quality_cdf", ops.quality_cdf(j, k, *qp),
                      ref.quality_cdf_ref(j, k, *qp), True,
                      lambda: quality_cdf_cuda(j, k, *qp),
                      lambda: ref.quality_cdf_ref(j, k, *qp),
                      quality_cdf_bound(j.numel()), 50, 10))
    # ... beside the launch floor: an empty kernel through the same ctypes
    # path, timed the same way
    floor_ms = time_ms(lambda: launch_floor(dev), 50, flush)
    log(f"launch floor (an empty kernel, timed as the kernels): {floor_ms:.4f} ms; "
        f"quality_cdf at {tuple(j.shape)} {out[-1]['ms']:.4f} ms")
    # ... and at (Q, N) = (64, 100k) (uniform J, K from a seed)
    r = np.random.default_rng(11)
    shape = (zq.shape[0], z.shape[0])
    jl = torch.from_numpy(r.uniform(0, 0.5, shape).astype(np.float32)).to(dev)
    kl = torch.from_numpy(r.uniform(0, 1, shape).astype(np.float32)).to(dev)
    _equal_nan(f"quality_cdf at {shape}", ops.quality_cdf(jl, kl, *qp),
               ref.quality_cdf_ref(jl, kl, *qp))
    l_ms = time_ms(lambda: quality_cdf_cuda(jl, kl, *qp), 20, flush)
    l_plain = time_ms(lambda: ref.quality_cdf_ref(jl, kl, *qp), 5, flush)
    lb_ms, lb_by = quality_cdf_bound(jl.numel())
    log(f"kernel quality_cdf (at {shape}): {l_ms:.4f} ms (bound {lb_ms:.4f} ms by {lb_by}, "
        f"{lb_ms / l_ms:.1%} of it{earlier('quality_cdf exact metric')}), plain "
        f"{l_plain:.3f} ms, max |err| 0.0")
    return out


# ---------------------------------------------------------------------------
# phase 5: where a batch's device time goes
# ---------------------------------------------------------------------------

def trace_plans(run) -> None:
    """Device time by operation over one steady batch of each plan and one
    two-stage scorer call (torch.profiler), beside the unprofiled steady
    wall. The tiered plan is traced a second time through the earlier route
    of its fine probe (the survivors' keys gathered into a copy first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def trace(name, fn, steady):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # device-side events only: a host op's own row repeats its kernels' time
        rows = sorted(((e.key[:48], e.self_device_time_total / 1e3, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda row: -row[1])
        busy = sum(ms for _, ms, _ in rows)
        log(f"trace {name}: device busy {busy:.3f} ms of a {steady:.3f} ms steady call "
            f"(idle share {max(0.0, 1 - busy / steady):.1%}); by self device time: "
            + "; ".join(f"{key} {ms:.3f} ms x{n}" for key, ms, n in rows[:8]))
        return busy

    busy = {}
    for name, (executor, plan, args) in run["runs"].items():
        busy[name] = trace(name, lambda: executor.execute(plan, *args), run["steady_ms"][name])
    model = run["model_run"]["model"]
    trace("two_stage", lambda: predict_scores(model, run["prof"], run["qids"]),
          run["walls"]["two_stage"] * 1e3)

    executor, plan, args = run["runs"]["tiered_int8"]
    in_place = stages.tiered_priorities

    def gathered_first(zq, qkeys, zg, keys, valid, pos=None):
        return in_place(zq, qkeys, zg, keys[pos], valid)

    stages.tiered_priorities = gathered_first
    try:
        executor.execute(plan, *args)
        t0 = time.perf_counter()
        for _ in range(5):
            executor.execute(plan, *args)
        steady = sync_wall(t0) / 5 * 1e3
        before = trace("tiered_int8 (earlier route: survivors' keys gathered first)",
                       lambda: executor.execute(plan, *args), steady)
    finally:
        stages.tiered_priorities = in_place
    log(f"tiered_int8 device busy: earlier route {before:.3f} ms, keys read in place "
        f"{busy['tiered_int8']:.3f} ms ({busy['tiered_int8'] - before:+.3f} ms)")


def counted(path: str, required, drive):
    """Drive one path of phase 3 with every launch count set to 0 just
    before it, read the counts just after, and fail if a kernel of the path
    never launched. Returns (what ``drive`` returned, the counts)."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = drive()
    counts = dict(_build.launch_counts)
    geometry = {k: dict(v) for k, v in _build.geometry_counts.items()}
    log(f"phase 3 ({path} path) in {sync_wall(t0):.2f} s; launches {counts}; "
        f"scorer launches by geometry {geometry}")
    missing = [k for k in required if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels of the {path} path never launched: {missing}")
    return out, counts


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available; this script "
                         "runs the port on an NVIDIA card")
    dev = torch.device("cuda")
    t_all = time.perf_counter()
    # phase 0: the card
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"phase 0: device {name} x{count}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; card {smi}")

    # phase 1: build
    t0 = time.perf_counter()
    paths = _build.build()
    for kernel in _build.KERNELS:
        _build.library(kernel)
    log(f"phase 1: built {len(paths)} kernels in {time.perf_counter() - t0:.2f} s: "
        f"{sorted(p.name for p in paths.values())}")

    # phase 2: ragged shapes
    t0 = time.perf_counter()
    check_ragged(dev)
    log(f"phase 2: kernels equal their plain versions at ragged shapes "
        f"({time.perf_counter() - t0:.2f} s)")

    # phase 3: each path counted on its own
    run, discovery = counted("discovery", ("fused_score", "minhash", "lsh_probe"),
                             lambda: main_path(dev))
    _, scale = counted("scale", ("lsh_probe", "lsh_probe_gathered", "fused_score_q",
                                 "fused_score"), lambda: scale_path(run, dev))
    _, model = counted("model", ("profile_distance", "gbdt_infer", "quality_cdf"),
                       lambda: model_path(run, dev))
    served, serve_counts = counted(
        "serve", ("fused_score", "fused_score_q", "minhash", "lsh_probe",
                  "lsh_probe_gathered"), lambda: serve_path(run, dev))
    counts = {"discovery": discovery, "scale": scale, "model": model}
    launches = {k: counts[PATH_OF[k]][k] for k in _build.KERNELS}
    t0 = time.perf_counter()
    check_main_path(run, dev)
    check_scale_path(run, dev)
    check_model_path(run, dev)
    check_serve_path(served, dev, smi)
    log(f"phase 3 check: {time.perf_counter() - t0:.2f} s")
    log(f"serve summary ({smi}): ingest {served['walls']['ingest']:.2f} s; "
        + "; ".join(f"{name} warmup {served['engines'][name].warmup_report['wall_ms']:.1f} ms, "
                    f"{rec['qps']:.1f} queries/s, p50 {rec['p50']:.2f} ms, "
                    f"p99 {rec['p99']:.2f} ms" for name, rec in served["served"].items())
        + f"; refresh {served['walls']['refresh'] * 1e3:.1f} ms, "
        f"{served['follow']['new'].executor.bytes_uploaded} bytes uploaded "
        f"(full placement {served['follow']['old'].executor.bytes_uploaded}); "
        f"launches {serve_counts}")

    # phase 4: kernels at the main path's shapes
    t0 = time.perf_counter()
    kernels = measure_kernels(run, dev, launches)
    log(f"phase 4: {time.perf_counter() - t0:.2f} s")

    # phase 5: device time by operation, per plan
    t0 = time.perf_counter()
    trace_plans(run)
    log(f"phase 5: {time.perf_counter() - t0:.2f} s; total {time.perf_counter() - t_all:.2f} s")
    log(f"card: {smi}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
