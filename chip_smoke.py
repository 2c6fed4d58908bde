#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FREYJA on one NVIDIA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout; needs one card
    python3 chip_smoke.py --plans [ROOT]   # the plans and 3j a) of a checkout,
                                           # measured as phase 5 measures them

Phases:

0. the card: name, count, and ``nvidia-smi``'s name and power limit;
1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once);
2. each kernel against its plain PyTorch version at ragged small shapes
   (the top-k kernel bit-equal at every rows x columns x k x kind of
   ``TOPK_*``: ties, all -inf, signed zeros, NaNs with payloads; the lsh
   stage's ties at the budgets; positions past 2^22), and the three
   kernels that stage an ensemble in a constant bank
   (``fused_score``, ``fused_score_q``, ``gbdt_infer``) under two host
   threads calling them with two different ensembles;
3. ten paths at real size, through the port's own entry points, each
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
   e. the replica fleet: an ``EngineFleet`` of two catalog followers, both
      on the card, opened over the serving path's catalog at its head and
      warmed; 272 requests through ``RequestScheduler(fleet)`` from 4
      clients; a second handle appends a 1,024-column table and the fleet
      rolls the refresh over its replicas; then a second burst with
      replica 1 killed mid-batch by a ``FaultInjector``. Every formed
      batch of both bursts is held against its replica's pinned
      ``Executor.execute`` (exactly) and the plain pipeline; the rolled
      replicas against a fresh executor (exactly); the killed replica's
      batch must be re-dispatched, every future resolved, its engine
      closed and its resident corpus freed.
   f. multi-device plans: the discovery path's lake, queries and float32
      profiles over ``make_grid_mesh`` of four copies of the card (the
      tiles of a grid run in turn on it): ``all``, ``hybrid`` and ``lsh``
      on the (1, 4), (2, 2) and (4, 1) grids, ``all`` over an int8
      executor (dequantized at placement) at (1, 4), ``rank_sharded``, and
      a ``DiscoveryEngine(mode="sharded", grid=(2, 2))`` over the 64
      planted queries. Every grid x kind is held against a plain sharded
      pipeline (the same tiles through the plain probe and scorer, the
      same two-phase merge): ids up to exact ties, ``n_scored`` exactly;
      every grid's ``all`` against the local ``all``; the int8 scan
      against the plain pipeline re-ranked exactly and against the
      float32 scan (top-10 overlap >= 0.99); the engine against its own
      executor. On one card a grid adds no device throughput: its
      queries/s beside the local plan's show what tiling and the merge
      cost.
   g. the language-model serving path, which launches no FREYJA kernel but
      the MoE router's ``topk`` (the run fails if another launches, or if
      the MoE families launch no ``topk``): (a) smollm-360m as
      configured (32 layers, d_model 960, bf16) through
      ``launch.serve.main`` with its defaults (batch 4, prompt 64, 32 new
      tokens), then the same generation timed: prefill ms, decode ms a
      step (CUDA events, the mean of the steady steps), tokens/s,
      ``max_memory_allocated``, and one profiled decode step; (b) the same
      weights in float32 (TF32 off): 16 decode steps after a 64-token
      prefill against the teacher-forced forward pass (rtol 2e-2, atol
      2e-4, tests/test_models.py:80), and the bf16 decode logits against
      the float32 forward (max |diff| / max |logit| < 0.05,
      tests/test_serve.py:40); (c) every other family at its published
      width, cut in depth only (``LM_FAMILIES``; Mixtral's 4,608-token
      prompt wraps its 4,096-slot ring; the MoEs at capacity factor 8, so
      no token drops), float32, 8 decode steps against the forward pass at
      (b)'s tolerance; (d) a 2-layer smollm-360m drawn on the host, copied
      to the card: forward and decode logits equal the host's (rtol 1e-4,
      atol 1e-5).
   h. the language-model training path, which launches no FREYJA kernel
      but the router's ``topk`` either (the same rule): (a) smollm-360m as
      configured (bf16 weights, float32 moments, block remat) through
      ``launch.train.main`` with its defaults (batch 8, seq 256, ``--mesh
      none``), 20 steps with a checkpoint every 10, then ``--steps 22`` on
      the same directory, which must resume at step 20 and end at step 22;
      then the steady step timed by CUDA events (mean after 3 warm-up
      steps), tokens/s, model TFLOP/s (6·N·tokens a step) against the H100
      SXM's dense bf16 peak, ``max_memory_allocated`` and one profiled
      step; (b) a 2-layer float32 smollm-360m drawn on the host, copied to
      the card: gradients, then 3 train steps on both (loss, grad norm,
      moments, parameters), ``accum=2`` against ``accum=1`` on the card
      (tests/test_train.py:86's rule), and a checkpoint written on the card
      restored on the host bit for bit; (c) every other family at its
      published width cut in depth (``LM_FAMILIES``; Mixtral at 1 layer,
      ``TRAIN_LAYERS``), batch 2, one step as configured: its loss equals
      the cross-entropy of a no-grad forward pass over the same weights,
      its grad norm is finite and positive; (d) ``examples/
      torch_train_lm.py`` at its defaults (200 steps): its loss falls.
   i. the sharded language-model path (``dist``: logical-axis rules,
      ZeRO-1 moments, the MoE's tp/ep collectives, the int8 error-feedback
      compressor), which launches no FREYJA kernel but the router's
      ``topk`` either (the same rule): (a) smollm-360m as configured (32
      layers, bf16, batch 8 x 256) on ``make_local_mesh(model=2,
      devices=[card] * 4)``, a (2, 2) mesh over four copies of the card,
      in tp mode with ZeRO-1 moments: the steady step by CUDA events,
      tokens/s, kernels a step, one profiled step's idle share and
      ``max_memory_allocated``, beside (h)'s unsharded step of this run;
      then ``launch.train --mesh local`` for 3 steps (a (1, 1) mesh on the
      one card); (b) the same model at full width cut to 4 layers, float32
      (TF32 off), on that mesh in tp, fsdp and dp: 3 steps against the
      single-device step at the data ranks' split (``accum=2``: the same
      float32 sums of two 2-row gradients) by (h) b)'s rules (loss, grad
      norm, lr, moments, parameters), and one step with the int8
      compressor: the gradients it receives against that step's, the
      loss, and the update bit for bit against a one-device
      ``adamw_update`` of the gradients it returned; the distance of both
      to the ``accum=1`` step is logged beside; (c) phi3.5-moe (ep) and mixtral-8x22b (tp) at their
      published width cut to 1 layer, float32, on ``[card] * 8`` as a
      (2, 4) mesh: the sharded forward on the card against the same call
      on a host mesh (max |diff| / max |logit| < 1e-5, the sharded-MoE
      bound of tests/test_torch_dist.py), at 2 x 64 tokens.
   j. the dry run beside the card (``launch.dryrun`` on ``meta``, then the
      same cell for real): (a) the paper's cell, ``freyja-discovery``
      (16,777,216 columns, 64 queries, k=100) with a 4 x 1 mesh, then
      ``build_sharded_pipeline`` over ``make_grid_mesh(1, 4)`` of four
      copies of the card, the profiles drawn on the card from a seeded
      generator: the placement within 1% of four times the cell's argument
      bytes, the ids equal to the plain pipeline's (chunks of 1M columns
      merged by the plain top-k) up to exact ties, the wall and
      ``max_memory_allocated`` beside the cell's peak, one profiled call;
      (b), (c) rwkv6-3b and zamba2-2.7b at ``long_500k`` with a 1 x 1
      mesh, then the full-width model and a 524,288-token cache (``len``
      524,287) on the card: the placement within 1% of the argument bytes,
      one ``decode_step`` by CUDA events beside the cell's ``bound_s``,
      ``max_memory_allocated`` beside its peak, one profiled step; they
      launch no FREYJA kernel (the run fails if one does); (d) the test cell (whisper-base, ``decode_32k``, the single mesh)
      through the dry run on the card's host, its argument bytes the JAX dry
      run's 408,764,460.
   Each plan's ids are held against a plain pipeline over the same
   candidates (plain probes, plain scorers and the plain top-k
   ``ref.topk_ref``); every path's ``topk`` launches are logged; the
   quantized top-10 must
   overlap the float32 one by at least 0.99. The model path's distances
   must equal the plain version's, its labels lie within 1e-6 of them on
   the same side of the training threshold, the two-stage scores match
   the fused scorer's, and the predictions correlate with the exact
   metric (> 0.6);
4. each kernel at the main path's shapes and inputs: against its plain
   version, and timed with CUDA events beside its bound (the gathered probe
   in both forms and beside the earlier gather-then-probe route; an empty
   kernel's launch floor beside ``quality_cdf``; the top-k kernel at every
   site's shape beside its bound, its plain version, the stable sort it
   replaced and ``torch.topk``; the tiered coarse pass's priority kernel at
   the benchmark's (256, 4,194,304) with block_c 32 and a proxy, and at the
   main path's (64, 100k), beside its bytes bound and its plain version);
5. each plan's batch and the two-stage scorer call profiled (five calls
   after an unrecorded window, divided by them; whether the window holds
   whole calls is logged): device time by operation, the top-k kernel's and any sort's,
   and the device's idle share (the run fails if a plan's batch runs a
   sort kernel); the tiered plan also through the earlier route of its
   fine probe.

It prints one ``kernels`` JSON line and, last, one ``ok`` JSON line; any
failure raises and exits non-zero. It imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import runpy
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
from repro_torch.core.discovery import (DiscoveryIndex, rank,     # noqa: E402
                                        rank_sharded)
from repro_torch.core.lakegen import (LakeSpec, ScaledLakeSpec,   # noqa: E402
                                      generate_lake, generate_scaled_lake,
                                      select_queries, select_scaled_queries)
from repro_torch.core.predictor import (POSITIVE_LABEL,           # noqa: E402
                                        exact_jk, gbdt_to_torch, label_pairs,
                                        predict_scores, train_quality_model)
from repro_torch.core.profiles import lake_profiles, profile_lake  # noqa: E402
from repro_torch.device import from_bits, hashes_to_torch, to_bits  # noqa: E402
from repro_torch.configs import freyja_discovery as FD            # noqa: E402
from repro_torch.exec import stages                               # noqa: E402
from repro_torch.exec.sharded import (build_sharded_pipeline,     # noqa: E402
                                      place_sharded_corpus)
from repro_torch.exec.executor import (RESCORE_MULT, Executor,    # noqa: E402
                                       _live_ids, pad_rows, pad_topk)
from repro_torch.exec.plan import (DEFAULT_COLUMN_BUCKETS, SURVIVOR_BLOCK,  # noqa: E402
                                   Planner, PlannerConfig, QueryPlan)
from repro_torch.kernels import _build, ops, ref                  # noqa: E402
from repro_torch.kernels.candidate_priority import candidate_priority_cuda  # noqa: E402
from repro_torch.kernels.coarse_priority import coarse_priority_cuda  # noqa: E402
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda        # noqa: E402
from repro_torch.kernels.lsh_probe import (PAD_CORPUS, PAD_QUERY,  # noqa: E402
                                           lsh_probe_cuda, lsh_probe_gathered_cuda)
from repro_torch.kernels.minhash import (make_permutations,       # noqa: E402
                                         minhash_cuda)
from repro_torch.kernels.profile_distance import (                # noqa: E402
    fused_score_cuda, fused_score_q_cuda, profile_distance_cuda, quantize_profiles)
from repro_torch.kernels.quality_cdf import quality_cdf_cuda      # noqa: E402
from repro_torch.kernels.topk import topk_cuda                    # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager           # noqa: E402
from repro_torch.data.pipeline import TokenPipeline               # noqa: E402
from repro_torch.dist import sharding as shd                      # noqa: E402
from repro_torch.dist.collectives import gather                   # noqa: E402
from repro_torch.dist.compression import make_int8_ef_allreduce   # noqa: E402
from repro_torch.launch import serve as launch_serve              # noqa: E402
from repro_torch.launch import train as launch_train              # noqa: E402
from repro_torch.launch import dryrun                             # noqa: E402
from repro_torch.launch.bench_scorer import (INT_RATE_BLOCKS_PER_SM,  # noqa: E402
                                            int_rate, int_rate_ops, launch_floor)
from repro_torch.launch.dryrun import FREYJA_DEPTH, FREYJA_TREES  # noqa: E402
from repro_torch.launch.mesh import make_grid_mesh, make_local_mesh  # noqa: E402
from repro_torch.models import encdec as lm_encdec                # noqa: E402
from repro_torch.models import registry as lm_registry            # noqa: E402
from repro_torch.models import transformer as lm_transformer      # noqa: E402
from repro_torch.serve.engine import generate                     # noqa: E402
from repro_torch.service import catalog                           # noqa: E402
from repro_torch.service.catalog import CatalogSnapshot           # noqa: E402
from repro_torch.service import (CatalogReader, CatalogStore,     # noqa: E402
                                 DiscoveryEngine, DiscoveryRequest, EngineConfig,
                                 EngineFleet, FaultInjector, RequestScheduler)
from repro_torch.service.fleet import EVICTED, SERVING, WARMING   # noqa: E402
from repro_torch.service.lsh import LSHConfig, LSHIndex           # noqa: E402
from repro_torch.train.loop import batch_to_device                # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,  # noqa: E402
                                         init_opt_state)
from repro_torch.train.trainer import build_train_step, cross_entropy, loss_fn  # noqa: E402

# the main path's geometry
N_COLUMNS, N_ROWS, N_PERM, N_BANDS, N_QUERIES, K = 100_000, 256, 128, 64, 64, 10
UPLOAD_COLUMNS = 8      # an upload's columns, padded as service/catalog.py pads them
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
    # no pallas_call: jax.lax.top_k (XLA's TopK) in merge_topk, and at
    # stages.py:155, :223, executor.py:153, moe.py:92, profiles.py:150
    "topk": "src/repro/exec/stages.py:205",
    # no pallas_call: XLA in the tiered coarse pass, after its probe
    "coarse_priority": "src/repro/exec/stages.py:113",
    # no pallas_call: XLA in the lsh and hybrid candidate stage, after its probe
    "candidate_priority": "src/repro/exec/stages.py:61",
}
# which path of phase 3 each kernel belongs to (its launches are read there)
PATH_OF = {"fused_score": "discovery", "minhash": "discovery", "lsh_probe": "discovery",
           "lsh_probe_gathered": "scale", "fused_score_q": "scale",
           "profile_distance": "model", "gbdt_infer": "model", "quality_cdf": "model",
           "topk": "discovery", "coarse_priority": "scale", "candidate_priority": "discovery"}
SIDE_BYTES = {"int8": 1, "fp16": 2}
# kernels' times before their redesign, at the phase-4 shapes (PERF.md's
# kernel table: NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
EARLIER_MS = {"fused_score": 1.1280, "fused_score gathered": 0.1154,
              "fused_score_q": 1.1161, "fused_score_q gathered": 0.1010,
              "gbdt_infer": 1.2519, "lsh_probe": 0.2425, "lsh_probe coarse": 0.0422,
              "lsh_probe_gathered pre-gathered": 0.0223, "quality_cdf": 0.0073,
              "quality_cdf exact metric": 0.0506, "minhash": 0.1215,
              "minhash upload": 0.0178}
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
# the fleet path: replicas on the one card, and the table its rolling
# refresh picks up
N_REPLICAS, ROLL_LAKE = 2, ScaledLakeSpec(n_columns=1024, seed=7)
PLAIN_ROWS = 64         # query rows per plain-pipeline chunk
# the sharded path: grids over N_GRID_DEVICES copies of the card
GRIDS, N_GRID_DEVICES = ((1, 4), (2, 2), (4, 1)), 4
# the language-model path: launch/serve's defaults (batch, prompt, new
# tokens) at smollm-360m's full width and depth; decode against the forward
# pass at tests/test_models.py:80's tolerance, the bf16 run against float32
# at tests/test_serve.py:40's bound, the card against the host at
# tests/test_kernels.py's
LM_ARCH, LM_BATCH, LM_PROMPT, LM_NEW, LM_CHECK_NEW = "smollm-360m", 4, 64, 32, 16
DECODE_RTOL, DECODE_ATOL, BF16_REL = 2e-2, 2e-4, 0.05
LM_STEADY_FROM = 3      # decode steps before this one are warm-up
# every other family at its published width, cut in depth only: layers (None:
# as configured), batch, prompt tokens; 8 decode steps each
LM_FAMILIES = {
    "qwen3-4b": (2, 2, 64), "qwen1.5-32b": (2, 2, 64), "stablelm-3b": (2, 2, 64),
    "mixtral-8x22b": (2, 1, 4608),      # past its 4,096-token window: the ring wraps
    "phi3.5-moe-42b-a6.6b": (2, 2, 64),
    "zamba2-2.7b": (6, 2, 64),          # one attn_every period
    "rwkv6-3b": (2, 2, 64),
    "phi-3-vision-4.2b": (2, 2, 1024),  # 576 image-stub positions first
    "whisper-base": (None, 2, 1024),    # 6 + 6 layers; 1,024 encoder frames
}
LM_FAMILY_NEW = 8
# the language-model training path: launch/train's defaults (batch 8, seq
# 256, lr 3e-4) at smollm-360m's full width and depth; a resume from the
# step-20 checkpoint; the steady step timed after TRAIN_WARM warm-up steps
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME_TO = 20, 10, 22
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TIMED, TRAIN_WARM = 8, 256, 10, 3
# NVIDIA's data sheet, H100 SXM, dense bf16 tensor-core peak (700 W)
H100_BF16_TFLOPS = 989.0
# the card against the host: 3 float32 steps of a 2-layer model at batch 4,
# seq 64, the learning rate warming up over them (tests/test_torch_ckpt.py)
TRAIN_CHECK_STEPS, TRAIN_CHECK_B, TRAIN_CHECK_S = 3, 4, 64
TRAIN_CHECK_OPT = AdamWConfig(lr=1e-3, warmup_steps=5)
# the step's metrics, card against host: the loss a float32 sum, the norm
# a function of the gradients and held at their rtol (at full width the
# card's differed from the host's by 2.4e-5 on an H100 80GB HBM3), the
# learning rate from the step
TRAIN_CHECK_RTOL = {"loss": 1e-5, "grad_norm": RTOL, "lr": 1e-6}
# the families' train step: LM_FAMILIES' depth cuts at batch 2, except
# Mixtral-8x22B at 1 layer: at 2 layers its float32 training state (weights,
# gradients, two moments; 16 B a parameter) is 80.6 GiB, more than the
# card's 80 GB; at 1 layer in bf16 with float32 moments its step peaked at
# 58.9 GiB on an H100 80GB HBM3
TRAIN_FAMILY_BATCH, TRAIN_LAYERS = 2, {"mixtral-8x22b": 1}
# whisper-base's decoder tokens (its published maximum target length)
TRAIN_WHISPER_TOKENS = 448
# the step's loss against a no-grad forward over the same weights in bf16:
# the same kernels, except the MoEs' index_add_, whose atomics may sum in
# another order
TRAIN_LOSS_RTOL = 1e-3
# the sharded language-model path: a (2, 2) mesh over four copies of the
# card for smollm-360m (its steady step timed as 3h's), 4 layers at full
# width for the float32 checks, launch.train --mesh local for 3 steps, and
# the MoEs at published width, 1 layer, on a (2, 4) mesh of eight copies at
# a token count the host runs in seconds (b x s)
SHARD_MODEL, SHARD_CARDS, SHARD_CHECK_LAYERS, SHARD_LAUNCH_STEPS = 2, 4, 4, 3
SHARD_MOES = ("phi3.5-moe-42b-a6.6b", "mixtral-8x22b")
SHARD_MOE_MESH, SHARD_MOE_B, SHARD_MOE_S = (2, 4), 2, 64
# the card's sharded MoE forward against the host's: max |diff| / max
# |logit|, the sharded-MoE bound of tests/test_torch_dist.py (float32 sums
# over d_model 6144 and d_ff 16384 in another order; the elementwise
# rtol 1e-4 / atol 1e-5 of 3g d) was reached 1.262x by Mixtral, max |diff|
# 1.52e-5 of max |logit| ~5, on an H100 80GB HBM3)
SHARD_MOE_REL = 1e-5
# the dry run beside the card (3j): a) the paper's cell over four copies of
# the card (its 16M profiles drawn there: a seeded generator, word hashes
# from a small vocabulary so that frequent words overlap, tables of 8
# columns), held against the plain pipeline in chunks of 1M columns (whole,
# its (64, 16M, 23) float32 features would take ~94 GB); b), c) the
# sub-quadratic models' long_500k cells on one card; every placement within
# 1% of the dry run's argument bytes; d) the test cell's argument bytes, the
# JAX dry run's figure
DRY_SHARDS, DRY_SEED, DRY_VOCAB, DRY_TABLE_WIDTH = 4, 23, 4096, 8
DRY_PLAIN_CHUNK = 1 << 20
DRY_LONG = ("rwkv6-3b", "zamba2-2.7b")
DRY_ARG_RTOL = 0.01
DRY_TEST_CELL_ARGUMENT_BYTES = 408_764_460
# phase 5 profiles this many calls of each plan, after one unrecorded
# window: a profile window can lose its first call's kernels (a one-call
# window showed 0-0.2 ms busy for plans that ten-call windows put at
# 0.66-0.75 ms; H100, torch 2.11). A spin kernel marking each call was no
# count of the calls held: 11 of 88 warm windows lost a marker while
# holding every call's kernels. The window's own kernel counts are.
TRACE_CALLS = 5
# ``--plans``: synchronized batches a plan's steady wall is the mean of
PLANS_REPS = 100
# the tiered coarse pass at the benchmark's tiered4m batch: queries, columns
# and survivor block (perfbench/configs/tiered4m.json)
COARSE_Q, COARSE_C, COARSE_BLOCK = 256, 4_194_304, 32
# the lsh and hybrid candidate stage at the benchmark's hybrid4m batch:
# queries and columns (perfbench/configs/hybrid4m.json)
CAND_Q, CAND_C = 256, 4_194_304
# the top-k kernel's device functions, as the profiler names them
TOPK_KERNEL_NAMES = ("warp_topk", "radix_round", "collect", "bitonic_chunk", "bitonic_global")
# phase 2's top-k shapes: rows, columns and k (k = N too, wherever k <= N),
# over every kind of row of _topk_rows
TOPK_ROWS, TOPK_COLUMNS = (0, 1, 3, 64), (1, 2, 31, 33, 1000, 100_003)
TOPK_KS = (0, 1, 10, 40, 128, 2048, 4096, 8192)
TOPK_KINDS = ("random", "equal", "three", "neg_inf", "special")
# float32 bit patterns of the "special" rows: signed zeros, infinities, quiet
# and signalling NaNs of both signs with payloads, and ordinary values
TOPK_SPECIAL = np.array([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                         0xFFC00000, 0x7FC00001, 0xFFC00005, 0x7F800001, 0xFF800003,
                         0x3F800000, 0xBF800000, 0x3F000000, 0x00000001, 0x80000001],
                        dtype=np.uint32).view(np.float32)
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
    permutation) a multiply-add and a min, and per value its sentinel test
    and the replacement of a sentinel (the test belongs to the value, not to
    each permutation)."""
    return bound_ms(c * r * 4 + p * 8 + c * p * 4, 0.0, 2.0 * c * r * p + 2.0 * c * r)


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


def topk_bound(r: int, n: int, k: int):
    """The scores read once, the (R, k) int64 positions written once; a
    compare or two an element is far below the integer rate."""
    return bound_ms(r * n * 4 + r * k * 8)


def coarse_priority_bound(q: int, c: int, proxy: bool = True):
    """The hit mask (int32) and the proxy (float32) read once, the priority
    (float32) written once: 12 bytes an element (8 without a proxy); the
    columns' ids and tables and the queries' ids, tables and two counts
    (int64) once."""
    return bound_ms(q * c * (12 if proxy else 8) + c * 16 + q * 32)


def candidate_priority_bound(q: int, c: int, proxy: bool = True):
    """The hit mask (int32) and g (float32) read once, the priority (float32)
    written once: 12 bytes an element (8 for lsh, without g); the columns'
    norms, ids and tables (20 bytes a column, 16 for lsh) and the queries'
    ids and tables (int64) once."""
    return bound_ms(q * c * (12 if proxy else 8) + c * (20 if proxy else 16) + q * 16)


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
    # (16, 25,000) shared and (16, 1,024) gathered: a 16-query batch's tiles
    # on a (1, 4) grid over 100k columns at budget 4,096
    for q, n, t, d in [(1, 1, 1, 1), (5, 300, 50, 5), (13, 1029, 13, 6), (9, 77, 50, 8),
                       (16, 25_000, 50, 5), (16, 1024, 50, 5)]:
        zq, wq = _random_profiles(r, (q,), dev)
        g = _random_gbdt(r, t, d, dev)
        for lead in ((n,), (q, n)):
            zc, wc = _random_profiles(r, lead, dev)
            _scorer_equal("fused_score", ops.fused_score(zq, wq, zc, wc, g),
                          ref.fused_score_ref(zq, wq, zc, wc, *g), (q, lead, t, d))
    # the narrow and the wide block (C >= 4096); column 0's back half, every
    # column's first row and the last column are sentinels
    for c, rows, p in [(1, 1, 1), (7, 700, 64), (33, 256, 128), (9, 1000, 300),
                       (4099, 300, 37)]:
        vals = r.integers(0, 2 ** 32 - 1, (c, rows), dtype=np.uint64).astype(np.uint32)
        vals[0, rows // 2:] = FT.HASH_SENTINEL
        vals[:, 0] = vals[-1] = FT.HASH_SENTINEL
        v = hashes_to_torch(vals, dev)
        a, b = (hashes_to_torch(x, dev) for x in make_permutations(p, seed=2))
        if not torch.equal(ops.minhash(v, a, b), ref.minhash_ref(v, a, b)):
            raise AssertionError(f"minhash differs from its plain version at {(c, rows, p)}")
    for q, c, b in [(1, 1, 1), (11, 777, 32), (3, 100, 256), (16, 25_000, 64)]:
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


def _topk_rows(r: int, n: int, kind: str, seed: int, dev) -> torch.Tensor:
    """(r, n) float32 rows: normal draws, all equal, three values, all -inf,
    or the special patterns mixed with small integers."""
    g = np.random.default_rng(seed)
    if kind == "random":
        x = g.normal(size=(r, n)).astype(np.float32)
    elif kind == "equal":
        x = np.full((r, n), 0.75, np.float32)
    elif kind == "three":
        x = g.choice(np.array([0.0, -1.0, 2.0], np.float32), (r, n))
    elif kind == "neg_inf":
        x = np.full((r, n), -np.inf, np.float32)
    else:
        x = np.where(g.random((r, n)) < 0.5, g.choice(TOPK_SPECIAL, (r, n)),
                     g.integers(-2, 3, (r, n)).astype(np.float32))
    return torch.from_numpy(x).to(dev)


def _topk_equal(name: str, x, k: int) -> None:
    got, want = topk_cuda(x, k), ref.topk_ref(x, k)
    if not (torch.equal(got, want) and torch.equal(x.gather(1, got).view(torch.int32),
                                                   x.gather(1, want).view(torch.int32))):
        raise AssertionError(f"topk {name} k={k}: kernel differs from its plain version")


def check_topk(dev) -> int:
    """The top-k kernel against its plain version (positions and the value
    bits they gather, ``torch.equal``) at every (rows, columns, k, kind) of
    phase 2; then the lsh stage's ties at the budget gathers' k and
    positions past 2^22 in a 4.2M-column row. Returns the cases checked."""
    cases = 0
    for r in TOPK_ROWS:
        for n in TOPK_COLUMNS:
            for i, kind in enumerate(TOPK_KINDS):
                x = _topk_rows(r, n, kind, seed=r * 1000 + n + i, dev=dev)
                for k in sorted({*TOPK_KS, n}):
                    if k <= n:
                        _topk_equal(f"{kind} {tuple(x.shape)}", x, k)
                        cases += 1
    g = np.random.default_rng(5)
    hits = np.full((64, N_COLUMNS), -np.inf, np.float32)
    for i in range(64):
        hits[i, g.choice(N_COLUMNS, 60 * i, replace=False)] = 0.0
    hits = torch.from_numpy(hits).to(dev)
    for k in (K, 2048, 4096, 8192):
        _topk_equal("lsh ties (64, 100k)", hits, k)
    tile = torch.randn((2, FD.N_COLUMNS // DRY_SHARDS), generator=torch.Generator(
        dev).manual_seed(1), device=dev)
    tile[:, -7:] = 1e6
    _topk_equal("late positions", tile, FD.TOP_K)
    torch.cuda.synchronize()
    return cases + 5


def check_concurrent(dev, n_threads: int = 8, n_calls: int = 1000) -> dict:
    """``n_threads`` host threads on one stream, each calling a kernel that
    stages its ensemble in the library's constant bank with one of two
    ensembles (50 x 5, and 1000 x 5, scored in chunks of trees), ``n_calls``
    times each, at small shapes where the host side of a call is most of
    its time: every call must launch and equal its plain version."""
    from concurrent.futures import ThreadPoolExecutor
    r = np.random.default_rng(3)
    out = {}
    for kernel in ("fused_score", "fused_score_q", "gbdt_infer"):
        cases = []
        for t in (50, 1000):
            g = _random_gbdt(r, t, 5, dev)
            if kernel == "gbdt_infer":
                x = torch.from_numpy(r.normal(size=(256, FT.F_DIST)).astype(np.float32)).to(dev)
                cases.append((lambda x=x, g=g: ops.gbdt_infer(x, g), ref.gbdt_infer_ref(x, *g)))
                continue
            zq, wq = _random_profiles(r, (1,), dev)
            zc, wc = _random_profiles(r, (128,), dev)
            if kernel == "fused_score":
                cases.append((lambda a=(zq, wq, zc, wc), g=g: ops.fused_score(*a, g),
                              ref.fused_score_ref(zq, wq, zc, wc, *g)))
                continue
            side, scale = quantize_profiles(zc.cpu().numpy(), "int8")
            a = (zq, wq, torch.from_numpy(side).to(dev), torch.from_numpy(scale).to(dev), wc)
            cases.append((lambda a=a, g=g: ops.fused_score_q(*a, g), ref.fused_score_q_ref(*a, *g)))
        start = threading.Barrier(n_threads)

        def hammer(call):
            start.wait(timeout=60)
            return [call() for _ in range(n_calls)]

        with ThreadPoolExecutor(n_threads) as pool:
            futures = [pool.submit(hammer, cases[i % 2][0]) for i in range(n_threads)]
            results = [f.result(timeout=300) for f in futures]
        torch.cuda.synchronize()
        bad = sum(not torch.equal(got, cases[i % 2][1])
                  for i, outs in enumerate(results) for got in outs)
        if bad:
            raise AssertionError(f"{kernel}: {bad} of {n_calls * n_threads} concurrent calls "
                                 f"with two ensembles differ from their plain versions")
        out[kernel] = n_calls * n_threads
    return out


# ---------------------------------------------------------------------------
# phase 3: the discovery query at real size
# ---------------------------------------------------------------------------

def run_plans(run: dict, runs: dict, reps: int) -> None:
    """Execute each (executor, plan, query batch): one first batch, then
    ``reps`` synchronized steady batches; results and walls go into ``run``."""
    for name, (executor, plan, args) in runs.items():
        t0 = time.perf_counter()
        res = executor.execute(plan, *args)
        first = sync_wall(t0)
        run["results"][name], run["tiers"][name] = res, res.tier
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


def plain_topk(x, k: int):
    """``stages.topk_stable`` through the top-k kernel's plain version
    (``ref.topk_ref``): the plain pipelines below take every top-k from it,
    so the plans, which run the kernel, are held against the plain order."""
    pos = ref.topk_ref(x, k)
    return x.gather(1, pos), pos


def plain_merge(scores, cids, k: int):
    """``stages.merge_topk`` over :func:`plain_topk`."""
    sc, pos = plain_topk(scores, min(k, scores.shape[1]))
    if cids.dim() == 1:
        cids = cids[None].expand(scores.shape[0], -1)
    return sc, torch.where(torch.isfinite(sc), torch.gather(cids, 1, pos), -1)


def plain_gather(prio, budget: int):
    """``stages.gather_candidates`` over :func:`plain_topk`."""
    pval, pos = plain_topk(prio, budget)
    return pos, torch.isfinite(pval)


def plain_merge_sharded(tiles, k: int, axis_sizes, device):
    """``stages.merge_topk_sharded`` over :func:`plain_topk`: the tiles'
    pairs concatenated in ``stages.gather_order``, ranked once more."""
    parts = [tiles[i] for i in stages.gather_order(axis_sizes)]
    s = torch.cat([p[0].to(device) for p in parts], 1)
    i = torch.cat([p[1].to(device) for p in parts], 1)
    return (*plain_merge(s, i, k), sum(p[2].to(device) for p in parts))


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
            s_ref, i_ref = plain_merge(s, cids, K)
            n_ref = np.full(len(qids), z.shape[0])
            if not np.isfinite(sc).all():
                raise AssertionError("all: a full scan left a top-k slot empty")
        else:
            prio = reference_candidates(plan.candidates, zq, qk, z, ck, excl)
            pos, valid = plain_gather(prio, plan.budget)
            s = torch.where(valid, ref.fused_score_ref(zq, wq, z[pos], w[pos], *g),
                            float("-inf"))
            s_ref, i_ref = plain_merge(s, cids[pos], K)
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
    s2, pos = plain_topk(s, min(k, s.shape[1]))
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
    pos, valid = plain_gather(torch.where(excl, float("-inf"), prio), surv)
    zg = zf[pos]
    proxy = 2.0 * torch.einsum("qf,qmf->qm", zq, zg) - (zg * zg).sum(-1)
    prio2 = (ref.lsh_probe_gathered_ref(qk, ck[pos]).to(torch.float32)
             * stages._LSH_PRIORITY_BOOST + proxy / (1.0 + proxy.abs()))
    pos2, valid2 = plain_gather(torch.where(valid, prio2, float("-inf")), budget)
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
            s_scan, i_scan = plain_merge(s, cids, k_scan)
            n_ref = np.full(len(qids), z32.shape[0])
        else:
            tr = reference_tiered(zq, qk, qc, side, scale,
                                  hashes_to_torch(index.keys, dev),
                                  hashes_to_torch(index.coarse, dev), excl, plan,
                                  SURVIVOR_BLOCK)
            gpos = tr["gpos"]
            s = torch.where(tr["valid2"], ref.fused_score_q_ref(zq, wq, side[gpos], scale,
                                                                w[gpos], *g), float("-inf"))
            s_scan, i_scan = plain_merge(s, cids[gpos], min(k_scan, gpos.shape[1]))
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


@contextlib.contextmanager
def _spied(engines):
    """Record every batch each engine's ``query_batch`` serves: yields one
    list of (requests, responses) per engine."""
    formed = [[] for _ in engines]
    reals = [eng.query_batch for eng in engines]
    for eng, real, out in zip(engines, reals, formed):
        def spy(reqs, _real=real, _out=out, **kw):
            res = _real(reqs, **kw)
            _out.append((list(reqs), res))
            return res
        eng.query_batch = spy
    try:
        yield formed
    finally:
        for eng, real in zip(engines, reals):
            eng.query_batch = real


def _submit(front, requests, n_clients: int):
    """Submit ``requests`` through a scheduler over ``front`` (an engine or
    a fleet) from ``n_clients`` threads; return the responses in request
    order, the wall and the scheduler's counters."""
    futures = [None] * len(requests)
    with RequestScheduler(front) as sch:
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
    return responses, wall, stats


def _serve(engine, requests, n_clients: int):
    """:func:`_submit` over one engine, with every formed batch as
    (requests, responses)."""
    with _spied([engine]) as (formed,):
        responses, wall, stats = _submit(engine, requests, n_clients)
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
        sc, ids = plain_merge(s, cids, spec["k"])
        n = stages.live_count(cids).expand(zq.shape[0])
    elif plan.candidates == "tiered":
        tr = reference_tiered(zq, qk, qc, side, scale, ex._ckeys, ex._coarse, excl, plan,
                              SURVIVOR_BLOCK)
        gpos = tr["gpos"]
        s = torch.where(tr["valid2"], score(side[gpos], w[gpos]), float("-inf"))
        sc, ids = plain_merge(s, cids[gpos], min(spec["k"], gpos.shape[1]))
        n = tr["valid2"].sum(1)
    else:
        zf = side.to(torch.float32) * scale
        prio = reference_candidates(plan.candidates, zq, qk, zf, ex._ckeys, excl)
        pos, valid = plain_gather(prio, spec["budget"])
        s = torch.where(valid, score(side[pos], w[pos]), float("-inf"))
        sc, ids = plain_merge(s, cids[pos], spec["k"])
        n = valid.sum(1)
    if ex._fp32_rows is not None:         # the exact float32 re-rank, plain
        safe = ids.clamp(0, ex.n_live - 1)
        zg = torch.from_numpy(np.asarray(ex._fp32_rows(safe.cpu().numpy()), np.float32)).to(dev)
        s = torch.where(torch.isfinite(sc), ref.fused_score_ref(zq, wq, zg, w[safe], *g),
                        float("-inf"))
        sc, pos = plain_topk(s, min(plan.k, s.shape[1]))
        ids = torch.where(torch.isfinite(sc), torch.gather(ids, 1, pos), -1)
    sc, ids = pad_topk(sc.cpu().numpy(), ids.cpu().numpy(), plan.k)
    return sc, ids, n.cpu().numpy()


def check_formed(name, eng, st, formed, dev) -> int:
    """Hold each formed batch of engine ``eng`` against ``Executor.execute``
    on its pinned version ``st`` (exactly) and the plain pipeline (up to
    exact ties, equal ``n_candidates``). Returns the rows checked."""
    n_rows = 0
    for reqs, responses in formed:
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
    return n_rows


def check_fresh(name, eng, st, requests, responses, dev) -> None:
    """Hold the answers of version ``st`` (its executor, and ``responses``
    to ``requests``) against a fresh executor over the same rows, exactly."""
    fresh = Executor(st.z, st.w, eng.model.gbdt.astuple(),
                     table_ids=st.snapshot.table_ids, band_keys=st.lsh.keys,
                     coarse_keys=st.lsh.coarse, n_padded=st.executor.n_columns, device=dev)
    plan, args, q = _batch_inputs(eng, st, requests)
    want = fresh.execute(plan, *args)
    got = st.executor.execute(plan, *args)
    s_resp, i_resp = _as_arrays(responses)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)) or not (
            np.array_equal(i_resp, want[1][:q]) and np.array_equal(s_resp, want[0][:q])):
        raise AssertionError(f"{name}: the extended executor differs from a fresh one")
    if [r.n_candidates for r in responses] != want[2][:q].tolist():
        raise AssertionError(f"{name}: the followed n_candidates differ from a fresh executor's")
    fresh.close()


def corpus_bytes(executor) -> tuple[int, int]:
    """The bytes an executor's resident rows hold (each tensor rounded to
    the allocator's 512) and the allocator slack their release may add."""
    rows = [t for k, t in executor._rows_bundle.arrays.items()
            if k != "zscale" and t is not None]
    return sum(-(-t.nbytes // 512) * 512 for t in rows), ALLOC_SLACK * len(rows)


def check_serve_path(serve: dict, dev, smi: str) -> dict:
    """Hold every formed batch against the pinned executor (exactly) and
    the plain pipeline, the followed answers against a fresh executor, and
    the retired version's device memory; release every pin."""
    out = {}
    for name, rec in serve["served"].items():
        eng, st = serve["engines"][name], rec["state"]
        if any(r.cached for r in rec["responses"]):
            raise AssertionError(f"{name}: a response came from the result cache")
        n_rows = check_formed(name, eng, st, rec["formed"], dev)
        if n_rows != len(rec["responses"]):
            raise AssertionError(f"{name}: {n_rows} rows checked of {len(rec['responses'])}")
        out[name] = dict(batches=len(rec["formed"]), plan=eng.stats()["last_plan"]["kind"])
    log(f"check: serve: every formed batch equals Executor.execute on its pinned version "
        f"and the plain pipeline (up to exact ties, equal n_candidates): {out}")

    f, eng = serve["follow"], serve["engines"]["lsh_fp32"]
    new, old = f["new"], f["old"]
    if not f["refresh"]["incremental"] or new.version <= old.version:
        raise AssertionError(f"serve: the follower did not refresh incrementally: {f['refresh']}")
    check_fresh("serve", eng, new, f["requests"], f["responses"], dev)

    # the retired version: released by its last pin, its rows freed
    expect, slack = corpus_bytes(old.executor)
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
    log(f"check: serve: the followed engine's answers equal a fresh executor's exactly; "
        f"retiring v{old.version} closed its executor and freed {freed} bytes "
        f"(resident corpus {expect}); card {smi}")
    return dict(out, freed=freed, expected=expect)


# ---------------------------------------------------------------------------
# phase 3e: the replica fleet at real size
# ---------------------------------------------------------------------------

def _fleet_burst(fleet, requests, tag: str) -> dict:
    """One burst through ``RequestScheduler(fleet)`` from N_CLIENTS threads,
    every replica engine's formed batches recorded."""
    with _spied([r.engine for r in fleet.replicas]) as formed:
        responses, wall, stats = _submit(fleet, requests, N_CLIENTS)
    torch.cuda.synchronize()
    lat = np.asarray([r.latency_ms for r in responses])
    st = fleet.stats()
    split = {rid: (sum(len(reqs) for reqs, _ in formed[rid]), len(formed[rid]))
             for rid in range(len(formed))}
    out = dict(requests=requests, responses=responses, formed=formed, wall=wall,
               qps=len(requests) / wall, p50=float(np.percentile(lat, 50)),
               p99=float(np.percentile(lat, 99)), scheduler=stats, split=split,
               redispatches=st["redispatches"], evictions=st["evictions"])
    log(f"fleet: {tag}: {len(requests)} requests from {N_CLIENTS} clients in {wall:.3f} s "
        f"= {out['qps']:.1f} queries/s; latency p50 {out['p50']:.2f} ms p99 {out['p99']:.2f} ms; "
        f"{stats['batches']} batches, sizes {stats['batch_size_hist']}; (requests, batches) "
        f"by replica {split}; {st['redispatches']} re-dispatched, {st['evictions']} evicted")
    return out


def fleet_path(run: dict, served: dict, dev) -> dict:
    """Open a two-replica fleet over the serving path's catalog at its
    current head, serve a burst, append a table and roll the refresh over
    the replicas, then kill replica 1 mid-batch during a second burst. The
    versions each burst served stay pinned until ``check_fleet_path``."""
    lake, model, qids = run["lake"], run["model"], run["qids"]
    root, out = served["root"], {}
    injector = FaultInjector()
    t0 = time.perf_counter()
    # the default devices on the card (every replica on the one card); a
    # host rehearsal names the CPU
    fleet = EngineFleet.from_catalog(root, model, _engine_config(mode="lsh"),
                                     n_replicas=N_REPLICAS, injector=injector,
                                     devices=None if dev.type == "cuda" else [dev])
    deadline = time.perf_counter() + 300
    while any(r.state == WARMING for r in fleet.replicas) and time.perf_counter() < deadline:
        time.sleep(0.01)
    if any(r.state != SERVING for r in fleet.replicas):
        raise AssertionError(f"fleet: a replica did not warm: {fleet.stats()}")
    out["walls"] = {"open": sync_wall(t0)}
    out.update(fleet=fleet, injector=injector)
    reps = fleet.replicas
    log(f"fleet: {len(reps)} replicas on {[str(r.engine.device) for r in reps]} opened from "
        f"disk and warmed in {out['walls']['open']:.2f} s; versions "
        f"{[r.engine.version for r in reps]}; warmups "
        f"{[round(r.engine.warmup_report['wall_ms'], 1) for r in reps]} ms; states "
        f"{[r.state for r in reps]}")

    uploads = _uploads(N_UPLOADS)

    def burst(tag):
        return ([DiscoveryRequest(name=f"{tag}q{int(q)}.{r}", column_id=int(q))
                 for r in range(SERVE_REPEATS) for q in qids]
                + [DiscoveryRequest(name=f"{tag}up{i}", values=v) for i, v in enumerate(uploads)])

    out["pins1"] = [r.engine._pin() for r in reps]
    out["burst1"] = _fleet_burst(fleet, burst("a"), "burst 1")

    # rolling refresh: a second handle appends a table, and the fleet moves
    # its replicas onto the new version one at a time
    roll = generate_scaled_lake(ROLL_LAKE)
    batch = dataclasses.replace(roll.batch, names=[f"r{i}" for i in range(roll.n_columns)],
                                table_ids=np.zeros((roll.n_columns,), np.int32))
    before = [r.engine.stats()["refresh"]["incremental"] for r in reps]
    CatalogStore(root, device=dev).add_batch(batch, ["roll"])
    t0 = time.perf_counter()
    moved = fleet.roll_refresh()
    out["walls"]["roll"] = sync_wall(t0)
    out["roll"] = dict(moved=moved, incremental=[
        r.engine.stats()["refresh"]["incremental"] - b for r, b in zip(reps, before)])
    n_live = reps[0].engine.n_columns
    reqs = ([DiscoveryRequest(name=f"r{int(q)}", column_id=int(q)) for q in qids]
            + [DiscoveryRequest(name=f"ru{i}", values=v) for i, v in enumerate(uploads)]
            + [DiscoveryRequest(name=f"new{i}", column_id=n_live - roll.n_columns + i)
               for i in range(0, roll.n_columns, 128)])
    out["pins2"] = [r.engine._pin() for r in reps]
    out["roll"].update(requests=reqs, responses=[r.engine.query_batch(reqs) for r in reps])
    log(f"fleet: rolled {moved} replicas onto v{reps[0].engine.version} "
        f"({out['roll']['incremental']} incremental refreshes) in "
        f"{out['walls']['roll'] * 1e3:.1f} ms after a {roll.n_columns}-column append; "
        f"{n_live} columns live")

    # kill replica 1 at its next batch: its batch is re-dispatched to replica 0
    injector.arm("mid_batch", replica=1)
    out["burst2"] = _fleet_burst(fleet, burst("b"), "burst 2 (replica 1 killed mid-batch)")
    return out


def check_fleet_path(fleet_run: dict, dev, smi: str) -> dict:
    """Hold both bursts' formed batches against each replica's pinned
    version and the plain pipeline, the rolled replicas against a fresh
    executor, and the killed replica's eviction: its batch re-dispatched,
    its engine closed, every executor it held closed and its corpus freed."""
    fleet, injector = fleet_run["fleet"], fleet_run["injector"]
    reps = fleet.replicas
    for tag, pins in (("burst1", fleet_run["pins1"]), ("burst2", fleet_run["pins2"])):
        b = fleet_run[tag]
        rows = sum(check_formed(f"fleet {tag} replica {rid}", r.engine, pins[rid],
                                b["formed"][rid], dev) for rid, r in enumerate(reps))
        if rows != len(b["requests"]) or [r.name for r in b["responses"]] != \
                [r.name for r in b["requests"]]:
            raise AssertionError(f"fleet {tag}: {rows} rows served of {len(b['requests'])}")
        if any(r.cached for r in b["responses"]):
            raise AssertionError(f"fleet {tag}: a response came from the result cache")
    b1, b2 = fleet_run["burst1"], fleet_run["burst2"]
    if b1["evictions"] or b1["redispatches"]:
        raise AssertionError(f"fleet: a replica failed during burst 1: {fleet.stats()}")
    for pin, r in zip(fleet_run["pins1"], reps):
        r.engine._release(pin)
    log("check: fleet: every formed batch of both bursts equals Executor.execute on its "
        "replica's pinned version and the plain pipeline (up to exact ties, equal "
        "n_candidates); every request answered once")

    roll = fleet_run["roll"]
    if roll["moved"] != len(reps) or roll["incremental"] != [1] * len(reps):
        raise AssertionError(f"fleet: the rolling refresh did not move every replica "
                             f"incrementally: {roll}")
    for rid, r in enumerate(reps):
        check_fresh(f"fleet replica {rid}", r.engine, fleet_run["pins2"][rid],
                    roll["requests"], roll["responses"][rid], dev)
    log("check: fleet: each rolled replica's answers equal a fresh executor's exactly")

    # the kill: the batch re-dispatched, replica 1 evicted and its version freed
    killed, st = reps[1], fleet_run["pins2"][1]
    if injector.fired != [("mid_batch", 1, "kill")] or b2["redispatches"] < 1 \
            or b2["evictions"] != 1:
        raise AssertionError(f"fleet: the kill of replica 1 was not re-dispatched: fired "
                             f"{injector.fired}, {fleet.stats()}")
    if killed.state != EVICTED or not killed.engine.closed or reps[0].state != SERVING:
        raise AssertionError(f"fleet: states after the kill {[r.state for r in reps]}")
    if b2["split"][1] != (0, 0) or b2["split"][0][0] != len(b2["requests"]):
        raise AssertionError(f"fleet: replica 0 did not serve the whole second burst: "
                             f"{b2['split']}")
    expect, slack = corpus_bytes(st.executor)
    if st.refs != 1 or st.executor.closed:
        raise AssertionError(f"fleet: the killed replica's head holds {st.refs} pins")
    allocated = (torch.cuda.memory_allocated if dev.type == "cuda"
                 else lambda _: 0)    # a host rehearsal has no device allocator
    torch.cuda.synchronize()
    before = allocated(dev)
    killed.engine._release(st)
    torch.cuda.synchronize()
    freed = before - allocated(dev)
    held = [fleet_run["pins1"][1], st]
    if st.refs != 0 or killed.engine._live or not all(p.executor.closed for p in held) or (
            dev.type == "cuda" and not expect <= freed <= expect + slack):
        raise AssertionError(f"fleet: evicting replica 1 left refs {st.refs}, live "
                             f"{len(killed.engine._live)}, freed {freed} bytes of a "
                             f"{expect}-byte corpus (+ up to {slack})")
    reps[0].engine._release(fleet_run["pins2"][0])
    fleet.close()
    if any(r.state != EVICTED or not r.engine.closed or r.engine._live for r in reps):
        raise AssertionError("fleet: close left a replica serving or a version pinned")
    log(f"check: fleet: replica 1 killed mid-batch, {b2['redispatches']} batch(es) "
        f"re-dispatched to replica 0, every future resolved; its engine closed, its head's "
        f"pins returned to 0 and retiring it freed {freed} bytes (resident corpus {expect}); "
        f"card {smi}")
    return dict(freed=freed, expected=expect)


# ---------------------------------------------------------------------------
# phase 3f: multi-device plans over four copies of the card
# ---------------------------------------------------------------------------

def _card(dev) -> torch.device:
    return dev if dev.index is not None or dev.type != "cuda" else torch.device(
        "cuda", torch.cuda.current_device())


def sharded_path(run: dict, dev, reps=5) -> dict:
    """3f: the main path's lake and queries over a grid mesh of
    ``N_GRID_DEVICES`` copies of the card (its tiles run in turn on it):
    ``all``, ``hybrid`` and ``lsh`` over float32 profiles on every grid of
    ``GRIDS``, ``all`` over an int8 executor (dequantized at placement) at
    (1, 4), ``rank_sharded`` once, and a ``DiscoveryEngine(mode="sharded",
    grid=(2, 2))`` over the planted queries."""
    prof, index, lake, model = run["prof"], run["index"], run["lake"], run["model"]
    pool = [_card(dev)] * N_GRID_DEVICES
    mesh = make_grid_mesh(1, N_GRID_DEVICES, devices=pool)
    walls = run["walls"]
    executors = {}
    for dtype in ("fp32", "int8"):
        t0 = time.perf_counter()
        executors[dtype] = Executor(prof.zscored, prof.words, model.gbdt.astuple(),
                                    table_ids=lake.table, band_keys=index.keys,
                                    profile_dtype=dtype, mesh=mesh)
        walls[f"place_sharded_{dtype}"] = sync_wall(t0)
    planner = Planner(PlannerConfig(k=K))
    n, qn = lake.n_columns, len(run["qids"])
    plans, runs = {}, {}
    for g in GRIDS:
        hybrid = planner.plan(n_columns=n, n_queries=qn, mode="lsh", mesh=mesh, grid=g)
        plans[g] = {"all": planner.plan(n_columns=n, n_queries=qn, mode="sharded",
                                        mesh=mesh, grid=g),
                    "hybrid": hybrid,
                    "lsh": QueryPlan(candidates="lsh", sharded=True, budget=hybrid.budget,
                                     k=K, grid=g)}
        for kind, plan in plans[g].items():
            runs[f"sharded_{kind}_{g[0]}x{g[1]}"] = (executors["fp32"], plan, run["batch"])
    runs["sharded_all_int8_1x4"] = (executors["int8"], plans[(1, 4)]["all"], run["batch"])
    run_plans(run, runs, reps)

    t0 = time.perf_counter()
    ranked = rank_sharded(DiscoveryIndex(prof, model, table_ids=lake.table), run["qids"],
                          mesh, k=K)
    walls["rank_sharded"] = sync_wall(t0)
    snap = CatalogSnapshot(profiles=prof, signatures=run["sigs"], table_ids=lake.table,
                           names=lake.batch.names,
                           table_names={int(t): f"t{int(t)}" for t in np.unique(lake.table)},
                           version=0)
    t0 = time.perf_counter()
    engine = DiscoveryEngine(snap, model, EngineConfig(k=K, mode="sharded", grid=(2, 2),
                                                       cache_entries=0), mesh=mesh)
    responses = engine.query_batch([DiscoveryRequest(name=f"q{int(q)}", column_id=int(q))
                                    for q in run["qids"]])
    walls["sharded_engine"] = sync_wall(t0)
    log(f"sharded: rank_sharded at {qn} queries in {walls['rank_sharded'] * 1e3:.2f} ms; "
        f"engine (mode sharded, grid (2, 2)) opened and served {len(responses)} requests in "
        f"{walls['sharded_engine']:.3f} s; placements {walls['place_sharded_fp32']:.3f} s "
        f"(fp32), {walls['place_sharded_int8']:.3f} s (int8, dequantized at placement)")
    return dict(mesh=mesh, plans=plans, ranked=ranked, engine=engine, responses=responses)


def plain_sharded(plan, grid, corpus, zq, wq, tq, qid, qk, g, dev, k=K):
    """The grid pipeline with the plain probe, scorer and top-k: the same
    (query shard, column shard) tiles and the same two-phase merge
    (:func:`plain_merge_sharded`, ``stages.assemble_query_shards``).
    ``corpus`` is (z, w, cids, tids, keys) on the card; the grid must divide
    the batch and the lake."""
    q_sh, d_sh = grid
    z, w, cids, tids, ck = corpus
    if zq.shape[0] % q_sh or z.shape[0] % d_sh:
        raise ValueError(f"grid {grid} does not divide {zq.shape[0]} queries x "
                         f"{z.shape[0]} columns")
    ql, per = zq.shape[0] // q_sh, z.shape[0] // d_sh
    rows = []
    for qi in range(q_sh):
        qs = slice(qi * ql, (qi + 1) * ql)
        tiles = []
        for di in range(d_sh):
            cs = slice(di * per, (di + 1) * per)
            excl = stages.exclusion_mask(cids[cs], tids[cs], tq[qs], qid[qs])
            if plan.candidates == "all":
                s = torch.where(excl, float("-inf"),
                                ref.fused_score_ref(zq[qs], wq[qs], z[cs], w[cs], *g))
                sc, ids = plain_merge(s, cids[cs], k)
                tiles.append((sc, ids, stages.live_count(cids[cs]).expand(ql)))
                continue
            prio = reference_candidates(plan.candidates, zq[qs], qk[qs], z[cs], ck[cs], excl)
            pos, valid = plain_gather(prio, min(plan.budget_per_shard, per))
            s = torch.where(valid, ref.fused_score_ref(zq[qs], wq[qs], z[cs][pos], w[cs][pos],
                                                       *g), float("-inf"))
            sc, ids = plain_merge(s, cids[cs][pos], k)
            tiles.append((sc, ids, valid.sum(1)))
        rows.append(plain_merge_sharded(tiles, k, (d_sh,), dev))
    return stages.assemble_query_shards(rows, (q_sh,), dev)


def check_sharded_path(run, sharded: dict, dev) -> dict:
    """Hold every grid x kind against the plain sharded pipeline (ids up to
    exact ties, ``n_scored`` exactly), every grid's ``all`` against the local
    ``all``, the int8 scan against the plain pipeline over the dequantized
    profiles re-ranked exactly and against the float32 scan (top-K overlap
    >= OVERLAP_GATE), ``rank_sharded`` against the plain pipeline without
    the table mask, and the engine's answers against its own executor."""
    zq_np, wq_np, tq_np, qids, qk_np = run["batch"]
    prof, model, lake = run["prof"], run["model"], run["lake"]
    z32 = torch.from_numpy(prof.zscored.astype(np.float32)).to(dev)
    w = hashes_to_torch(prof.words, dev)
    corpus = (z32, w, torch.arange(z32.shape[0], device=dev),
              torch.from_numpy(lake.table.astype(np.int64)).to(dev),
              hashes_to_torch(run["index"].keys, dev))
    zq = torch.from_numpy(zq_np).to(dev)
    wq, qk = hashes_to_torch(wq_np, dev), hashes_to_torch(qk_np, dev)
    tq = torch.from_numpy(tq_np.astype(np.int64)).to(dev)
    qid = torch.from_numpy(qids.astype(np.int64)).to(dev)
    g = gbdt_to_torch(model.gbdt.astuple(), dev)
    local_s, local_i, _ = run["results"]["all"]
    for grid, plans in sharded["plans"].items():
        for kind, plan in plans.items():
            name = f"sharded_{kind}_{grid[0]}x{grid[1]}"
            sc, ids, n_scored = run["results"][name]
            s_ref, i_ref, n_ref = plain_sharded(plan, grid, corpus, zq, wq, tq, qid, qk, g, dev)
            _same_ranking(name, s_ref, i_ref, sc, ids)
            if not np.array_equal(n_scored, n_ref.cpu().numpy()):
                raise AssertionError(f"{name}: n_scored differs from the plain pipeline's")
            if kind == "all":
                _same_ranking(f"{name} vs local all", torch.from_numpy(local_s),
                              torch.from_numpy(local_i), sc, ids)
    # int8: the plain pipeline over the dequantized profiles, over-fetching
    # RESCORE_MULT x K, then the exact re-rank
    side, scale = quantize_profiles(prof.zscored.astype(np.float32), "int8")
    zdq = torch.from_numpy(side).to(dev).to(torch.float32) * torch.from_numpy(scale).to(dev)
    plan = sharded["plans"][(1, 4)]["all"]
    s8, i8, n8 = plain_sharded(plan, (1, 4), (zdq,) + corpus[1:], zq, wq, tq, qid, qk, g, dev,
                               k=RESCORE_MULT * K)
    s8, i8 = reference_rerank(zq, wq, z32, w, g, s8, i8, K)
    sc, ids, n_scored = run["results"]["sharded_all_int8_1x4"]
    _same_ranking("sharded_all_int8_1x4", s8, i8, sc, ids)
    if not np.array_equal(n_scored, n8.cpu().numpy()):
        raise AssertionError("sharded_all_int8_1x4: n_scored differs from the plain pipeline's")
    full = run["results"]["sharded_all_1x4"][1]
    overlap = float(np.mean([len(set(a[a >= 0]) & set(b[b >= 0])) / max((b >= 0).sum(), 1)
                             for a, b in zip(ids, full)]))
    if overlap < OVERLAP_GATE:
        raise AssertionError(f"sharded int8 all: top-{K} overlap {overlap} < {OVERLAP_GATE}")
    # rank_sharded: the sharded full scan without the same-table mask
    rplan = Planner(PlannerConfig(k=K)).plan(n_columns=lake.n_columns, n_queries=len(qids),
                                             mode="sharded", mesh=sharded["mesh"])
    none = torch.full_like(tq, -1)
    s_ref, i_ref, _ = plain_sharded(rplan, rplan.grid, corpus, zq, wq, none, qid, qk, g, dev)
    _same_ranking(f"rank_sharded at {rplan.grid}", s_ref, i_ref, *sharded["ranked"])
    # the engine against its own executor, on the version and plan it served
    engine = sharded["engine"]
    last = engine.stats()["last_plan"]
    if last["kind"] != "sharded-all" or last["grid"] != [2, 2]:
        raise AssertionError(f"sharded engine ran {last['kind']} on grid {last['grid']}")
    sc, ids, _ = engine._head.executor.execute(engine.last_plan, zq_np, wq_np, tq_np, qids)
    for row, resp in enumerate(sharded["responses"]):
        want = [(int(i), float(s)) for i, s in zip(ids[row], sc[row]) if np.isfinite(s)]
        if [(m.column_id, m.score) for m in resp.matches] != want[:len(resp.matches)] or \
                len(resp.matches) != min(K, len(want)):
            raise AssertionError(f"sharded engine: request {resp.name} differs from its executor")
    engine.close()
    qps = {kind: {"local": run["qps"][kind],
                  **{f"{g[0]}x{g[1]}": run["qps"][f"sharded_{kind}_{g[0]}x{g[1]}"]
                     for g in GRIDS}} for kind in ("all", "hybrid", "lsh")}
    log(f"check: sharded: every grid x kind equals the plain sharded pipeline (ids up to "
        f"exact ties, n_scored exactly); every grid's all ranks as the local all; int8 all "
        f"at (1, 4) equals the plain pipeline re-ranked, top-{K} overlap with float32 "
        f"{overlap:.4f}; rank_sharded at {rplan.grid} equals the plain pipeline; the engine "
        f"(grid (2, 2)) answered as its executor")
    return dict(overlap=overlap, qps=qps)


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
    pos, _ = plain_gather(prio, hybrid.budget)
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
                      minhash_bound(*v.shape, N_PERM), 20, 2))
    # ... at an upload's: the serve path signs one upload's columns, padded to
    # UPLOAD_COLUMNS, per launch
    vu, vu_b = v[:UPLOAD_COLUMNS].contiguous(), v_b[:UPLOAD_COLUMNS].contiguous()
    if not torch.equal(ops.minhash(vu, a, b), ref.minhash_ref(vu, a, b)):
        raise AssertionError("minhash (upload) differs from its plain version")
    u_ms = time_ms(lambda: minhash_cuda(vu_b, a_b, b_b), 50, flush)
    ub_ms, ub_by = minhash_bound(*vu.shape, N_PERM)
    # ... beside the card's rate for its loop: multiply-add chains alone, and
    # each followed by a min as minhash's hashes are
    blocks = INT_RATE_BLOCKS_PER_SM * _build.sm_count(dev)
    imad_s, loop_s = (int_rate_ops(blocks) / (time_ms(lambda: int_rate(dev, m, blocks), 5, flush)
                                              * 1e-3) for m in (False, True))
    loop_ms = v.shape[0] * v.shape[1] * N_PERM / loop_s * 1e3
    out[-1].update(upload_ms=u_ms, upload_bound_ms=ub_ms, loop_ceiling_ms=loop_ms)
    log(f"kernel minhash (upload {tuple(vu.shape)}): {u_ms:.4f} ms (bound {ub_ms:.6f} ms by "
        f"{ub_by}, {ub_ms / u_ms:.1%} of it{earlier('minhash upload')}); the card's "
        f"multiply-adds {imad_s / 1e12:.3f} T/s alone, {loop_s / 1e12:.3f} T/s each with a "
        f"min: minhash's loop at {tuple(v.shape)} x {N_PERM} needs {loop_ms:.4f} ms at that "
        f"rate ({out[-1]['bound_ms'] / loop_ms:.1%} of the bound)")

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
    excl = stages.exclusion_mask(cids, tids, tq, qid)
    out.append(measure_topk(launches, flush, dev, torch.where(excl, float("-inf"), got), prio,
                            reference_candidates("lsh", zq, qk, z, ck, excl)))
    # the tiered coarse pass's priority over this path's coarse hits and proxy
    fill = (2.0 * zq) @ z.T - (z * z).sum(1)[None]
    small = (ops.lsh_probe(qc, cc), fill, cids, tids, tq, qid)
    out.append(measure_coarse_priority(launches, flush, dev, small))
    del small, fill
    # the lsh and hybrid candidate priority over this path's band hits and proxy
    small = (ops.lsh_probe(qk, ck), (2.0 * zq) @ z.T, stages.column_norms(z), cids, tids, tq,
             qid)
    out.append(measure_candidate_priority(launches, flush, dev, small))
    return out


def coarse_priority_inputs(q: int, c: int, seed: int, dev):
    """(hit, proxy, cids, tids, tq, qid) of a tiered batch drawn on the card
    from ``seed``: 0/1 hits at 0.2%, a proxy of scale 100 (the fill's
    magnitude), tables of 8 columns, resident queries with their own
    tables."""
    g = torch.Generator(dev).manual_seed(seed)
    hit = (torch.rand((q, c), generator=g, device=dev) < 0.002).to(torch.int32)
    proxy = torch.randn((q, c), generator=g, device=dev) * 100
    cids = torch.arange(c, device=dev)
    tids = cids // 8
    qid = torch.randint(0, c, (q,), generator=g, device=dev)
    return hit, proxy, cids, tids, tids[qid], qid


def coarse_priority_case(args, block_c: int, flush, reps: int, plain_reps: int) -> dict:
    """The kernel against its plain version (bit-equal: the priorities and
    both counts) at ``args``, timed beside its bytes bound."""
    got = ops.coarse_priority(*args, block_c)
    want = ref.coarse_priority_ref(*args, block_c)
    for name, a, b in zip(("prio", "n_hits", "n_survivors"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"coarse_priority {name} differs from its plain version at "
                                 f"{tuple(args[0].shape)}")
    del got, want
    q, c = args[0].shape
    b_ms, b_by = coarse_priority_bound(q, c, args[1] is not None)
    before = _build.launch_counts["coarse_priority"]
    ms = time_ms(lambda: coarse_priority_cuda(*args, block_c), reps, flush)
    launched = _build.launch_counts["coarse_priority"] - before
    plain_ms = time_ms(lambda: ref.coarse_priority_ref(*args, block_c), plain_reps, flush)
    log(f"kernel coarse_priority {(q, c)} block_c={block_c}: {ms:.4f} ms (bound {b_ms:.4f} ms "
        f"by {b_by}, {b_ms / ms:.1%} of it; {launched} launches for {reps + 1} calls), plain "
        f"{plain_ms:.3f} ms, equal")
    return {"shape": [q, c], "block_c": block_c, "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": plain_ms, "launches_timed": launched, "calls_timed": reps + 1}


def measure_coarse_priority(launches: dict, flush, dev, small) -> dict:
    """Phase 4's coarse priority row: at the benchmark's tiered4m batch
    (COARSE_Q x COARSE_C, block_c 32, a proxy; inputs drawn on the card),
    and at the main path's (64, 100k) from ``small``, its coarse hits and
    proxy. The row is the first; the second stands in ``small``."""
    big = coarse_priority_case(coarse_priority_inputs(COARSE_Q, COARSE_C, DRY_SEED, dev),
                               COARSE_BLOCK, flush, 20, 3)
    torch.cuda.empty_cache()
    main_path_case = coarse_priority_case(small, COARSE_BLOCK, flush, 50, 5)
    return {"name": "coarse_priority", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/coarse_priority.cu",
            "replaces": TPU_KERNELS["coarse_priority"], "launches": launches["coarse_priority"],
            "max_abs_err": 0.0, "ms": big["ms"], "plain_ms": big["plain_ms"],
            "bound_ms": big["bound_ms"], "bound_by": big["bound_by"], "library_ms": None,
            "shape": big["shape"], "small": main_path_case}


def candidate_priority_inputs(q: int, c: int, seed: int, dev):
    """(hit, g, znorm, cids, tids, tq, qid) of a hybrid batch drawn on the
    card from ``seed``: 0/1 hits at 0.2%, g of scale 10 and norms in [0, 40)
    (z-scored profiles of 21 features), tables of 8 columns, resident queries
    with their own tables."""
    gen = torch.Generator(dev).manual_seed(seed)
    hit = (torch.rand((q, c), generator=gen, device=dev) < 0.002).to(torch.int32)
    g = torch.randn((q, c), generator=gen, device=dev) * 10
    zn = torch.rand((c,), generator=gen, device=dev) * 40
    cids = torch.arange(c, device=dev)
    tids = cids // 8
    qid = torch.randint(0, c, (q,), generator=gen, device=dev)
    return hit, g, zn, cids, tids, tids[qid], qid


def candidate_priority_case(args, flush, reps: int, plain_reps: int) -> dict:
    """The kernel against its plain version (bit-equal) at ``args`` (g and
    znorm None: the lsh kind), timed beside its bytes bound. The kernel
    writes over its g, so the check and the timed calls get a copy; the
    timed calls rewrite it in place, as the stage does (the priorities stay
    finite off the excluded columns, so each call runs the same arithmetic)."""
    hit, g, zn, *rest = args
    kind = "lsh" if g is None else "hybrid"
    want = ref.candidate_priority_ref(*args)
    got = ops.candidate_priority(hit, None if g is None else g.clone(), zn, *rest)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"candidate_priority ({kind}) differs from its plain version at "
                             f"{tuple(hit.shape)}")
    work = None if g is None else got.copy_(g)
    del got, want
    q, c = hit.shape
    b_ms, b_by = candidate_priority_bound(q, c, g is not None)
    before = _build.launch_counts["candidate_priority"]
    ms = time_ms(lambda: candidate_priority_cuda(hit, work, zn, *rest), reps, flush)
    launched = _build.launch_counts["candidate_priority"] - before
    del work
    plain_ms = time_ms(lambda: ref.candidate_priority_ref(*args), plain_reps, flush)
    log(f"kernel candidate_priority {kind} {(q, c)}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
        f"{b_by}, {b_ms / ms:.1%} of it; {launched} launches for {reps + 1} calls), plain "
        f"{plain_ms:.3f} ms, equal")
    return {"kind": kind, "shape": [q, c], "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
            "plain_ms": plain_ms, "launches_timed": launched, "calls_timed": reps + 1}


def measure_candidate_priority(launches: dict, flush, dev, small) -> dict:
    """Phase 4's candidate priority row: hybrid at the benchmark's hybrid4m
    batch (CAND_Q x CAND_C; inputs drawn on the card), lsh at the same
    shape, and hybrid at the main path's (64, 100k) from ``small``, its band
    hits and proxy. The row is the first; the others stand in ``lsh`` and
    ``small``."""
    big_args = candidate_priority_inputs(CAND_Q, CAND_C, DRY_SEED, dev)
    big = candidate_priority_case(big_args, flush, 20, 3)
    hit, _, _, *rest = big_args
    del big_args
    torch.cuda.empty_cache()
    lsh = candidate_priority_case((hit, None, None, *rest), flush, 20, 3)
    del hit, rest
    torch.cuda.empty_cache()
    main_path_case = candidate_priority_case(small, flush, 50, 5)
    return {"name": "candidate_priority", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/candidate_priority.cu",
            "replaces": TPU_KERNELS["candidate_priority"],
            "launches": launches["candidate_priority"], "max_abs_err": 0.0, "ms": big["ms"],
            "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
            "bound_by": big["bound_by"], "library_ms": None, "shape": big["shape"],
            "lsh": lsh, "small": main_path_case}


def topk_sites(s_all, prio_hybrid, prio_lsh, dev) -> list:
    """The top-k kernel's inputs at every site of the main path and the
    dry run's tile, from this run's scores and priorities where the path
    makes them, and two larger k on the hybrid priorities: (site, x, k)."""
    q = s_all.shape[0]
    pos, _ = plain_gather(prio_hybrid, 4096)
    s_g = s_all.gather(1, pos)                   # the hybrid plan's gathered scores
    gen = torch.Generator(dev).manual_seed(DRY_SEED)
    router = {e: torch.softmax(torch.randn((t, e), generator=gen, device=dev), -1)
              for t, e in ((4608, 8), (128, 16))}
    counts = torch.randint(0, 40, (catalog.CHUNK_COLUMNS, N_ROWS), generator=gen,
                           device=dev).to(torch.float32)
    return [
        ("merge_topk (all)", s_all, K),
        ("merge_topk (quantized over-fetch)", s_all, RESCORE_MULT * K),
        ("gather_candidates (hybrid budget)", prio_hybrid, 4096),
        ("gather_candidates (lsh budget)", prio_lsh, 4096),
        ("tiered survivors", prio_hybrid, 2048),
        ("tiered fine gather", prio_hybrid.gather(1, pos[:, :2048]), 2048),
        ("merge_topk (gathered)", s_g, K),
        ("merge_topk (tiered over-fetch)", s_g[:, :2048].contiguous(), RESCORE_MULT * K),
        ("_rescore_exact / merge_topk_sharded", s_g[:, :RESCORE_MULT * K].contiguous(), K),
        ("3j a) tile", torch.randn((q, FD.N_COLUMNS // DRY_SHARDS), generator=gen,
                                   device=dev), FD.TOP_K),
        ("MoE router (Mixtral)", router[8], 2),
        ("MoE router (phi3.5-moe)", router[16], 2),
        ("profiles top-10 words", counts, FT.N_FREQ_WORDS),
        # no main-path site: a budget above the default 4096 (a planner's
        # max_candidates raised), and the whole row
        ("gather_candidates (budget 8192)", prio_hybrid, 8192),
        ("gather_candidates (budget 32768)", prio_hybrid, 32768),
        ("the whole row (k = N)", prio_hybrid, prio_hybrid.shape[1]),
    ]


def measure_topk(launches: dict, flush, dev, s_all, prio_hybrid, prio_lsh) -> dict:
    """Phase 4's top-k row: at every site shape, the kernel against its plain
    version (bit-equal), timed beside its bound, the plain version, the
    stable sort it replaced and ``torch.topk`` (the same values in an order
    it does not promise: a yardstick the port never calls). The row is the
    ``all`` merge at (64, 100k), k = 10; every site stands in ``sites``."""
    sites = []
    for site, x, k in topk_sites(s_all, prio_hybrid, prio_lsh, dev):
        x = x.contiguous()
        _topk_equal(site, x, k)
        r, n = x.shape
        ms = time_ms(lambda: topk_cuda(x, k), 20, flush)
        plain_ms = time_ms(lambda: ref.topk_ref(x, k), 5, flush)
        sort_ms = time_ms(lambda: torch.sort(x, dim=1, descending=True, stable=True)
                          .indices[:, :k], 5, flush)
        lib_ms = time_ms(lambda: torch.topk(x, k, dim=1), 10, flush)
        b_ms, b_by = topk_bound(r, n, k)
        sites.append({"site": site, "shape": [r, n], "k": k, "ms": ms, "bound_ms": b_ms,
                      "plain_ms": plain_ms, "stable_sort_ms": sort_ms, "library_ms": lib_ms})
        log(f"kernel topk {site} {(r, n)} k={k}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}, {b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, the stable sort it "
            f"replaced {sort_ms:.4f} ms, torch.topk {lib_ms:.4f} ms")
    main = sites[0]
    return {"name": "topk", "route": "cuda", "source": "src/repro_torch/kernels/csrc/topk.cu",
            "replaces": TPU_KERNELS["topk"], "launches": launches["topk"], "max_abs_err": 0.0,
            "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": main["library_ms"],
            "stable_sort_ms": main["stable_sort_ms"], "sites": sites}


# ---------------------------------------------------------------------------
# phase 5: where a batch's device time goes
# ---------------------------------------------------------------------------

def plan_device_ms(fn) -> dict:
    """Device busy time a call of ``fn`` (a plan's batch), its top-k
    kernel's and its sort kernels' parts, and the kernels by self time:
    ``TRACE_CALLS`` calls under torch.profiler, recorded after one
    unrecorded window (a window can lose its first call's kernels), and
    divided by them. ``whole`` says whether the window holds every call:
    each kernel's count a multiple of the calls (a call runs the same
    kernels each time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=activities):
        fn()
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        for _ in range(TRACE_CALLS):
            fn()
        torch.cuda.synchronize()
    # device-side events only: a host op's own row repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    n = TRACE_CALLS

    def group(words):
        es = [e for e in events if any(w in e.key for w in words)]
        return (sum(e.self_device_time_total for e in es) / 1e3 / n,
                sum(e.count for e in es) / n)

    rows = sorted(((e.key[:48], e.self_device_time_total / 1e3 / n, e.count / n)
                   for e in events), key=lambda row: -row[1])
    (sort_ms, sorts), (topk_ms, topks) = group(("Sort", "sort")), group(TOPK_KERNEL_NAMES)
    return dict(busy=sum(ms for _, ms, _ in rows), whole=all(e.count % n == 0 for e in events),
                sort_ms=sort_ms, sorts=sorts, topk_ms=topk_ms, topks=topks, rows=rows)


def trace_plans(run) -> None:
    """Device time by operation a steady batch of each plan and a two-stage
    scorer call (``plan_device_ms``: ``TRACE_CALLS`` calls after an
    unrecorded window, divided by them), beside the
    unprofiled steady wall. The tiered plan is traced a second time through
    the earlier route of its fine probe (the survivors' keys gathered into a
    copy first)."""

    def trace(name, fn, steady):
        t = plan_device_ms(fn)
        busy = t["busy"]
        log(f"trace {name}: device busy {busy:.3f} ms of a {steady:.3f} ms steady call "
            f"(idle share {max(0.0, 1 - busy / steady):.1%}; whole calls {t['whole']}); "
            f"top-k kernel {t['topk_ms']:.3f} ms x{t['topks']:g}, sort kernels "
            f"{t['sort_ms']:.3f} ms x{t['sorts']:g}; by self device time: "
            + "; ".join(f"{key} {ms:.3f} ms x{n:g}" for key, ms, n in t["rows"][:8]))
        return busy, t["sorts"]

    busy = {}
    for name, (executor, plan, args) in run["runs"].items():
        busy[name], sorts = trace(name, lambda: executor.execute(plan, *args),
                                  run["steady_ms"][name])
        if sorts:
            raise AssertionError(f"trace {name}: {sorts} sort kernels in a plan's batch")
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
        before, _ = trace("tiered_int8 (earlier route: survivors' keys gathered first)",
                          lambda: executor.execute(plan, *args), steady)
    finally:
        stages.tiered_priorities = in_place
    log(f"tiered_int8 device busy: earlier route {before:.3f} ms, keys read in place "
        f"{busy['tiered_int8']:.3f} ms ({busy['tiered_int8'] - before:+.3f} ms)")


# ---------------------------------------------------------------------------
# phase 3g: the language-model serving path (no FREYJA kernel but the router's top-k)
# ---------------------------------------------------------------------------

def _lm_tokens(cfg, b: int, s: int, seed: int, dev) -> torch.Tensor:
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(1, cfg.vocab, (b, s))).long().to(dev)


def _chunk_padded(cfg, toks) -> torch.Tensor:
    """Pad tokens to a multiple of the attention chunk, as
    tests/test_models.py:72 pads them (causal: the first positions stay as
    they are)."""
    n, c = toks.shape[1], cfg.attn_chunk
    return torch.nn.functional.pad(toks, (0, -(-n // c) * c - n))


def _fits(name: str, got, want, rtol=DECODE_RTOL, atol=DECODE_ATOL) -> float:
    """The worst |got - want| / (atol + rtol |want|); raises above 1."""
    got, want = got.float().cpu(), want.float().cpu()
    ratio = float(((got - want).abs() / (atol + rtol * want.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |got - want| reaches {ratio:.3f}x of atol {atol} + "
                             f"rtol {rtol} (max |diff| {float((got - want).abs().max()):.3e})")
    return ratio


@torch.no_grad()
def decode_against_forward(params, cfg, toks, n_prompt: int, *, img=None, frames=None):
    """Prefill ``toks[:, :n_prompt]`` (an enc-dec: encode ``frames`` and
    project the cross K/V), decode the remaining tokens one at a time
    through the cache, and return each step's logits beside the
    teacher-forced forward pass over the same tokens (``_chunk_padded``)."""
    b, n = toks.shape
    batch = {"tokens": _chunk_padded(cfg, toks)}
    if img is not None:
        batch["img"] = img
    if frames is not None:
        batch["frames"] = frames
    want = lm_registry.forward(params, cfg, batch)[:, n_prompt:n]
    if lm_registry.is_encdec(cfg):
        caches = lm_encdec.init_decode_caches(cfg, b, n, frames.shape[1], toks.device)
        caches["cross"] = lm_encdec.precompute_cross_kv(
            params, cfg, lm_encdec.encode(params, cfg, frames))
    else:
        _, caches = lm_transformer.forward_with_caches(params, cfg, toks[:, :n_prompt], n,
                                                       img=img)
    steps = []
    for i in range(n_prompt, n):
        logits, caches = lm_registry.decode_step(params, cfg, {"tokens": toks[:, i:i + 1]},
                                                 caches)
        steps.append(logits[:, 0])
    return torch.stack(steps, 1), want


# kernel families in a profiled step, by words of their names: cuBLAS's
# GEMMs, the foreach kernels (the AdamW update and gradient sums), and copies
_KERNEL_GROUPS = {"GEMMs": ("gemm", "nvjet", "cutlass", "xmma", "sm90_"),
                  "foreach": ("multi_tensor_apply",), "copies": ("memcpy", "memset")}


def _trace_step(label: str, fn, steady_ms: float, smi: str) -> dict:
    """Device kernels, busy time and idle share of one call of ``fn``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    kernels = sum(e.count for e in rows)
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:6]
    idle = max(0.0, 1 - busy / steady_ms)
    groups = {group: [e for e in rows if any(w in e.key.lower() for w in words)]
              for group, words in _KERNEL_GROUPS.items()}
    log(f"trace {label} ({smi}): {kernels} device kernels, device busy {busy:.3f} ms "
        f"of a {steady_ms:.3f} ms steady step (idle share {idle:.1%}); "
        + "; ".join(f"{group} {sum(e.self_device_time_total for e in es) / 1e3:.3f} ms x"
                    f"{sum(e.count for e in es)}" for group, es in groups.items())
        + "; by self device time: " + "; ".join(
            f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return {"kernels": kernels, "busy_ms": busy, "idle": idle}


def _trace_decode_step(params, cfg, tok, caches, steady_ms: float, smi: str) -> dict:
    """Device kernels, busy time and idle share of one decode step."""
    return _trace_step("lm decode step", lambda: lm_registry.decode_step(
        params, cfg, {"tokens": tok}, caches), steady_ms, smi)


def lm_serve(dev, smi: str) -> dict:
    """3g a): smollm-360m as configured (bf16), launch/serve's defaults:
    ``launch.serve`` itself, then the same generation timed phase by phase."""
    cfg = lm_registry.get_config(LM_ARCH)
    log(f"3g a) {LM_ARCH} as configured: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv} KV heads of {cfg.d_head}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, {cfg.param_dtype}; batch {LM_BATCH}, prompt {LM_PROMPT}, "
        f"{LM_NEW} new tokens")
    t0 = time.perf_counter()
    launch_serve.main(["--device", str(dev), "--batch", str(LM_BATCH), "--prompt-len",
                       str(LM_PROMPT), "--max-new", str(LM_NEW)])
    serve_s = sync_wall(t0)
    # launch/serve's weights and prompts
    params = lm_registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                     device=dev)
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, size=(LM_BATCH, LM_PROMPT)).astype(np.int32)
    toks = torch.from_numpy(prompts).long().to(dev)
    size = LM_PROMPT + LM_NEW
    t0 = time.perf_counter()
    first = generate(params, cfg, prompts, max_new=LM_NEW, cache_size=size, device=dev)
    generate_s = time.perf_counter() - t0          # generate returns host tokens: synced
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()           # the weights, and earlier paths' state
    t0 = time.perf_counter()
    logits, caches = lm_transformer.forward_with_caches(params, cfg, toks, size)
    prefill_ms = sync_wall(t0) * 1e3
    t1 = time.perf_counter()
    tok = logits[:, -1:].argmax(-1)
    gen, step_logits = [tok], []
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    for _ in range(LM_NEW - 1):
        lg, caches = lm_registry.decode_step(params, cfg, {"tokens": tok}, caches)
        tok = lg[:, -1].argmax(-1)[:, None]
        step_logits.append(lg[:, 0])
        gen.append(tok)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    decode_s = sync_wall(t1)
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    steady = float(np.mean(step_ms[LM_STEADY_FROM:]))
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(gen, 1)
    tok_s = LM_BATCH * LM_NEW / (prefill_ms / 1e3 + decode_s)
    same = float((gen.cpu().numpy() == first).mean())
    trace = _trace_decode_step(params, cfg, tok, caches, steady, smi)
    log(f"3g a) ({smi}) weights {weight_bytes / 1e9:.3f} GB; launch/serve main {serve_s:.2f} s "
        f"(first call, weights drawn); generate {generate_s:.3f} s; prefill {prefill_ms:.3f} ms; "
        f"decode {steady:.3f} ms a step (mean of steps {LM_STEADY_FROM + 1}-{LM_NEW - 1}; "
        f"all steps {min(step_ms):.3f}-{max(step_ms):.3f} ms; host wall "
        f"{decode_s * 1e3 / (LM_NEW - 1):.3f} ms a step); {tok_s:.1f} tokens/s (prefill + "
        f"{LM_NEW - 1} steps, {LM_BATCH} sequences); {LM_BATCH / steady * 1e3:.1f} tokens/s "
        f"decoding; max_memory_allocated {peak / 2**20:.1f} MiB ({(peak - held) / 2**20:.1f} MiB "
        f"above the {held / 2**20:.1f} MiB held before the prefill); generate's tokens equal this "
        f"loop's at {same:.3f} of positions")
    return dict(cfg=cfg, params=params, prompts=toks, gen=gen, step_logits=step_logits,
                prefill_ms=prefill_ms, steady_ms=steady, step_ms=step_ms, tok_s=tok_s,
                peak=peak, held=held, generate_s=generate_s, trace=trace,
                weight_bytes=weight_bytes)


def lm_path(dev, smi: str) -> dict:
    """Phase 3g: a) smollm-360m served at full width and depth in bf16;
    b) the same weights in float32: decode against the forward pass, and the
    bf16 decode against the float32 forward; c) every other family at its
    published width, cut in depth only; d) host weights on the card against
    the host."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("3g compares float32 logits: TF32 matmuls must be off")
    out = {"serve": lm_serve(dev, smi)}
    a = out["serve"]

    # b) the same weights in float32
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(a["cfg"], param_dtype="float32", compute_dtype="float32")
    p32 = a.pop("params").float()                  # in place: the bf16 copy goes
    seq = torch.cat([a["prompts"], a["gen"][:, :LM_CHECK_NEW]], 1)
    dec, want = decode_against_forward(p32, cfg32, seq, LM_PROMPT)
    ratio = _fits("3g b) float32 decode vs forward", dec, want)
    with torch.no_grad():
        traj = torch.cat([a["prompts"], a["gen"][:, :-1]], 1)
        full = lm_registry.forward(p32, cfg32, {"tokens": _chunk_padded(cfg32, traj)})
        full = full[:, LM_PROMPT:traj.shape[1]]
    bf16 = torch.stack(a.pop("step_logits"), 1).float()
    rel = float((bf16 - full).abs().max() / full.abs().max())
    if not rel < BF16_REL:
        raise AssertionError(f"3g b) bf16 decode vs float32 forward: {rel:.4f} >= {BF16_REL}")
    log(f"3g b) ({smi}) float32, {cfg32.n_layers} layers: {LM_CHECK_NEW} decode steps after a "
        f"{LM_PROMPT}-token prefill against the teacher-forced forward: worst "
        f"{ratio:.3f} of (atol {DECODE_ATOL} + rtol {DECODE_RTOL}), max |diff| "
        f"{float((dec - want).abs().max()):.3e}; bf16 decode vs float32 forward "
        f"max|diff|/max|logit| {rel:.4f} (< {BF16_REL}) ({sync_wall(t0):.2f} s)")
    out["fp32"] = {"ratio": ratio, "bf16_rel": rel}
    del p32, dec, want, full, bf16

    # c) every other family at its published width, cut in depth only
    out["families"] = {}
    for arch, (layers, b, prompt) in LM_FAMILIES.items():
        t0 = time.perf_counter()
        base = lm_registry.get_config(arch)
        upd = dict(param_dtype="float32", compute_dtype="float32")
        if layers is not None:
            upd["n_layers"] = layers
        if base.family == "moe":
            # no token drops: prefill and the forward pass route different
            # token counts, so capacity dropping would make them incomparable
            upd["capacity_factor"] = 8.0
        cfg = dataclasses.replace(base, **upd)
        gen = torch.Generator(dev).manual_seed(0)
        params = lm_registry.init_params(cfg, generator=gen, device=dev)
        n_params = sum(p.numel() for p in params.parameters())
        img = frames = None
        if cfg.family == "encdec":
            toks = _lm_tokens(cfg, b, LM_FAMILY_NEW, 3, dev)
            frames = torch.randn((b, prompt, cfg.d_model), generator=gen, device=dev) * 0.02
            n_prompt = 0
            cut = (f"{cfg.enc_layers} + {cfg.dec_layers} layers as configured; "
                   f"{prompt} encoder frames")
        else:
            toks = _lm_tokens(cfg, b, prompt + LM_FAMILY_NEW, 3, dev)
            if cfg.family == "vlm":
                img = torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen,
                                  device=dev) * 0.02
            n_prompt = prompt
            cut = f"{base.n_layers} -> {cfg.n_layers} layers; prompt {prompt}"
        dec, want = decode_against_forward(params, cfg, toks, n_prompt, img=img, frames=frames)
        ratio = _fits(f"3g c) {arch}", dec, want)
        wall = sync_wall(t0)
        log(f"3g c) {arch} ({cut}, batch {b}, float32, {n_params / 1e6:.1f}M params"
            + (", capacity_factor 8" if base.family == "moe" else "") + f"): "
            f"{LM_FAMILY_NEW} decode steps against the forward pass: worst {ratio:.3f} of "
            f"(atol {DECODE_ATOL} + rtol {DECODE_RTOL}), max |diff| "
            f"{float((dec - want).abs().max()):.3e} ({wall:.2f} s, {smi})")
        out["families"][arch] = {"ratio": ratio, "wall": wall}
        del params, dec, want, img, frames
        torch.cuda.empty_cache()

    # d) the card against the host
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(lm_registry.get_config(LM_ARCH), n_layers=2,
                               param_dtype="float32", compute_dtype="float32")
    host = lm_registry.init_params(cfg2, generator=torch.Generator().manual_seed(0),
                                   device="cpu")
    card = copy.deepcopy(host).to(dev)
    toks = _lm_tokens(cfg2, LM_BATCH, LM_PROMPT, 5, "cpu")
    with torch.no_grad():
        want = lm_registry.forward(host, cfg2, {"tokens": toks})
        got = lm_registry.forward(card, cfg2, {"tokens": toks.to(dev)})
    ratio = _fits("3g d) card vs host forward", got, want, rtol=RTOL, atol=ATOL)
    half = LM_PROMPT // 2
    _, hc = lm_transformer.forward_with_caches(host, cfg2, toks[:, :half], LM_PROMPT)
    _, cc = lm_transformer.forward_with_caches(card, cfg2, toks[:, :half].to(dev), LM_PROMPT)
    for i in range(half, half + 4):
        hl, hc = lm_registry.decode_step(host, cfg2, {"tokens": toks[:, i:i + 1]}, hc)
        cl, cc = lm_registry.decode_step(card, cfg2, {"tokens": toks[:, i:i + 1].to(dev)}, cc)
        ratio = max(ratio, _fits(f"3g d) card vs host decode step {i}", cl, hl, rtol=RTOL,
                                 atol=ATOL))
    log(f"3g d) ({smi}) {LM_ARCH} at full width, 2 layers, float32, drawn on the host: card "
        f"against host, forward and 4 decode steps, worst {ratio:.3f} of (atol {ATOL} + "
        f"rtol {RTOL}) ({sync_wall(t0):.2f} s)")
    out["host"] = {"ratio": ratio}
    return out


# ---------------------------------------------------------------------------
# phase 3h: the language-model training path (no FREYJA kernel but the router's top-k)
# ---------------------------------------------------------------------------

def _launch_train(argv) -> tuple:
    """``launch.train.main(argv)``; its printed lines are logged after it
    returns. Returns (what it returned, its output)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = launch_train.main(argv)
    for line in out.getvalue().splitlines():
        log(f"    {line}")
    return result, out.getvalue()


def lm_train(dev, smi: str) -> dict:
    """3h a): smollm-360m as configured through ``launch.train`` with its
    defaults, a resume from its checkpoint, then the steady step timed."""
    cfg = lm_registry.get_config(LM_ARCH)
    log(f"3h a) {LM_ARCH} as configured: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_dtype} weights, float32 moments, remat {cfg.remat!r}; launch/train's "
        f"defaults: batch {TRAIN_BATCH}, seq {TRAIN_SEQ}, --mesh none; --steps {TRAIN_STEPS} "
        f"--ckpt-every {TRAIN_CKPT_EVERY}, then --steps {TRAIN_RESUME_TO} on the same directory")
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        argv = ["--device", str(dev), "--arch", LM_ARCH, "--ckpt-dir", root,
                "--ckpt-every", str(TRAIN_CKPT_EVERY)]
        t0 = time.perf_counter()
        (model, opt, hist), _ = _launch_train(argv + ["--steps", str(TRAIN_STEPS)])
        first_s = sync_wall(t0)
        if int(opt["step"]) != TRAIN_STEPS or not all(np.isfinite(h[1]) for h in hist):
            raise AssertionError(f"3h a) launch.train: step {int(opt['step'])}, losses {hist}")
        del model, opt
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        (model, opt, _), out = _launch_train(argv + ["--steps", str(TRAIN_RESUME_TO)])
        resume_s = sync_wall(t0)
        if f"[resume] restored checkpoint @ step {TRAIN_STEPS}" not in out \
                or int(opt["step"]) != TRAIN_RESUME_TO:
            raise AssertionError(f"3h a) the rerun did not resume at step {TRAIN_STEPS} and "
                                 f"end at {TRAIN_RESUME_TO} (step {int(opt['step'])})")
        ckpt_bytes = max(f.stat().st_size for f in Path(root).glob("ckpt_*.npz"))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    step = build_train_step(cfg, AdamWConfig(lr=3e-4))
    pipe = TokenPipeline(vocab=cfg.vocab, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batches = [batch_to_device(pipe.batch(TRAIN_RESUME_TO + i), dev)
               for i in range(TRAIN_TIMED + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    t0 = time.perf_counter()
    for batch in batches[:TRAIN_TIMED]:
        model, opt, metrics = step(model, opt, batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    wall_s = sync_wall(t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    steady = float(np.mean(step_ms[TRAIN_WARM:]))
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"3h a) timed steps: loss {loss}")
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tflops = 6 * n_params * tokens / (steady / 1e3) / 1e12
    trace = _trace_step("lm train step", lambda: step(model, opt, batches[-1]), steady, smi)
    log(f"3h a) ({smi}) {n_params / 1e6:.1f}M parameters, weights {weight_bytes / 1e9:.3f} GB; "
        f"launch.train {TRAIN_STEPS} steps {first_s:.2f} s (weights drawn, first calls, "
        f"checkpoints), resumed to {TRAIN_RESUME_TO} in {resume_s:.2f} s; a checkpoint file "
        f"{ckpt_bytes / 1e9:.3f} GB; steady step {steady:.3f} ms (CUDA events, mean of steps "
        f"{TRAIN_WARM + 1}-{TRAIN_TIMED}; all {min(step_ms):.3f}-{max(step_ms):.3f} ms; host "
        f"wall {wall_s * 1e3 / TRAIN_TIMED:.3f} ms a step); {tokens / steady * 1e3:.1f} tokens/s; "
        f"6·N·tokens {tflops:.2f} TFLOP/s = {tflops / H100_BF16_TFLOPS:.2%} of the H100 SXM's "
        f"{H100_BF16_TFLOPS:.0f} TFLOP/s dense bf16 (NVIDIA data sheet, 700 W); "
        f"max_memory_allocated {peak / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held before the "
        f"timed steps); loss {loss:.4f}")
    out = dict(steady_ms=steady, step_ms=step_ms, tok_s=tokens / steady * 1e3, tflops=tflops,
               peak=peak, held=held, trace=trace, n_params=n_params, first_s=first_s,
               resume_s=resume_s, ckpt_bytes=ckpt_bytes)
    del model, opt, batches, metrics
    torch.cuda.empty_cache()
    return out


def _leaves_fit(name: str, got: dict, want: dict, atol_frac: float, rtol: float) -> float:
    """Each leaf within atol_frac x its max |want| + rtol x |want|: the worst
    ratio of |got - want| to that bound; raises above 1."""
    worst = 0.0
    for key, w in want.items():
        w, g = w.detach().float().cpu(), got[key].detach().float().cpu()
        bound = atol_frac * float(w.abs().max()) + rtol * w.abs()
        ratio = float(((g - w).abs() / bound.clamp(min=1e-30)).max())
        if not ratio <= 1.0:
            raise AssertionError(f"{name} {key}: |got - want| reaches {ratio:.3f}x of atol "
                                 f"{atol_frac} x max + rtol {rtol}")
        worst = max(worst, ratio)
    return worst


def train_card_vs_host(dev, smi: str) -> dict:
    """3h b): a 2-layer float32 smollm-360m drawn on the host and copied to
    the card: gradients, 3 train steps, accum=2 against accum=1, one
    bfloat16 accum=2 step, and a checkpoint written on the card restored on
    the host."""
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(lm_registry.get_config(LM_ARCH), n_layers=2,
                              param_dtype="float32", compute_dtype="float32")
    host = lm_registry.init_params(cfg, generator=torch.Generator().manual_seed(0), device=cpu)
    card = copy.deepcopy(host).to(dev)
    start = copy.deepcopy(card)
    pipe = TokenPipeline(vocab=cfg.vocab, seq=TRAIN_CHECK_S, global_batch=TRAIN_CHECK_B)
    batches = [pipe.batch(i) for i in range(TRAIN_CHECK_STEPS)]
    grads = {}
    for side, model, d in (("host", host, cpu), ("card", card, dev)):
        model.requires_grad_(True)
        loss_fn(model, cfg, batch_to_device(batches[0], d)).backward()
        grads[side] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
    ratios = {"grad": _leaves_fit("3h b) gradients", grads["card"], grads["host"], ATOL, RTOL)}

    # the train step, on both: float32 sums in another order, as against
    # JAX on the host (tests/test_torch_train_parity.py's rules)
    step = build_train_step(cfg, TRAIN_CHECK_OPT)
    hopt, copt = init_opt_state(host), init_opt_state(card)
    masks, lr_sum, worst_metric = None, 0.0, 0.0
    for batch in batches:
        host, hopt, hm = step(host, hopt, batch_to_device(batch, cpu))
        card, copt, cm = step(card, copt, batch_to_device(batch, dev))
        for key, rtol in TRAIN_CHECK_RTOL.items():
            h, c = float(hm[key]), float(cm[key])
            worst_metric = max(worst_metric, abs(c - h) / abs(h) / rtol)
            if not abs(c - h) <= rtol * abs(h):
                raise AssertionError(f"3h b) {key}: card {c} host {h} (rtol {rtol})")
        # resolved second moments, after every step
        new = {k: v.sqrt() > 1e-3 * v.sqrt().max() for k, v in hopt["v"].items()}
        masks = new if masks is None else {k: masks[k] & new[k] for k in new}
        lr_sum += float(hm["lr"])
    n = TRAIN_CHECK_STEPS
    ratios["m"] = _leaves_fit("3h b) m", copt["m"], hopt["m"], n * ATOL, RTOL)
    ratios["v"] = _leaves_fit("3h b) v", copt["v"], hopt["v"], 2 * n * ATOL, 2 * RTOL)
    hp = dict(host.named_parameters())
    worst_param = 0.0
    for name, p in card.named_parameters():
        bound = torch.where(masks[name], 2e-3, 2.0) * lr_sum
        ratio = float(((p.detach().cpu() - hp[name].detach()).abs() / bound).max())
        if not ratio <= 1.0:
            raise AssertionError(f"3h b) parameter {name}: {ratio:.3f}x of its bound")
        worst_param = max(worst_param, ratio)
    ratios["param"] = worst_param

    # accum=2 against accum=1 on the card (tests/test_train.py:86's rule)
    batch = batch_to_device(batches[0], dev)
    results = []
    for accum in (1, 2):
        model = copy.deepcopy(start)
        model, _, met = build_train_step(cfg, AdamWConfig(lr=1e-3), accum=accum)(
            model, init_opt_state(model), batch)
        results.append((float(met["loss"]), model))
    (l1, m1), (l2, m2) = results
    accum_diff = max(float((a - b).abs().max()) for a, b in zip(m1.state_dict().values(),
                                                                m2.state_dict().values()))
    if not (abs(l1 - l2) <= 1e-4 * abs(l1) and accum_diff < 5e-3):
        raise AssertionError(f"3h b) accum=2 vs accum=1: loss {l2} vs {l1}, parameters "
                             f"{accum_diff:.3e} apart")

    bf16_ratio = _bf16_accum_fits(cfg, batch, dev)

    # a checkpoint written on the card, restored on the host
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        CheckpointManager(root).save_train_state(n, card, copt, cfg)
        back = lm_registry.init_params(cfg, generator=torch.Generator().manual_seed(1),
                                       device=cpu)
        bopt = init_opt_state(back)
        CheckpointManager(root).restore_train_state(n, back, bopt, cfg)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(card.state_dict().values(),
                                                       back.state_dict().values()))
    same &= all(torch.equal(copt[part][k].cpu(), bopt[part][k])
                for part in ("m", "v") for k in copt[part])
    if not (same and int(bopt["step"]) == n):
        raise AssertionError("3h b) the card's checkpoint did not come back bit for bit")
    log(f"3h b) ({smi}) {LM_ARCH} at full width, 2 layers, float32, drawn on the host, "
        f"batch {TRAIN_CHECK_B} x {TRAIN_CHECK_S}: card against host, worst fraction of the "
        f"bound: gradients {ratios['grad']:.3f} (atol {ATOL} x max + rtol {RTOL}), after "
        f"{n} steps m {ratios['m']:.3f}, v {ratios['v']:.3f}, parameters {ratios['param']:.3f}; "
        f"loss / grad_norm / lr at worst {worst_metric:.3f} of rtol {TRAIN_CHECK_RTOL}; "
        f"accum=2 vs accum=1 on the card: loss {l2:.6f} vs {l1:.6f}, parameters {accum_diff:.2e} apart (< 5e-3); "
        f"bfloat16 accum=2 on the card: m against the float32 sum of the step's own two "
        f"bfloat16 micro-gradients at worst {bf16_ratio:.3f} of rtol 1e-6 (a bfloat16 sum is up "
        f"to 2^-9 off); checkpoint card -> host bit for bit ({sync_wall(t0):.2f} s)")
    return {"ratios": ratios, "accum_diff": accum_diff, "bf16_accum": bf16_ratio}


def _bf16_accum_fits(cfg, batch: dict, dev) -> float:
    """One accum=2 step of ``cfg`` in bfloat16 on the card: the first moment
    must be (1 - b1)·scale·(g0 + g1)/2 summed in float32 from the step's own
    bfloat16 micro-gradients, caught as each backward leaves them, within
    rtol 1e-6. Returns the worst fraction of that bound."""
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    model = lm_registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    model.requires_grad_(True)
    micro = {}
    hooks = [p.register_post_accumulate_grad_hook(
        lambda p, n=n: micro.setdefault(n, []).append(p.grad.clone()))
        for n, p in model.named_parameters()]
    opt_cfg = AdamWConfig(lr=1e-3)
    model, opt, met = build_train_step(cfg, opt_cfg, accum=2)(model, init_opt_state(model),
                                                              batch)
    for hook in hooks:
        hook.remove()
    scale = torch.clamp(opt_cfg.grad_clip / torch.clamp(met["grad_norm"], min=1e-9), max=1.0)
    worst = 0.0
    for name, grads in micro.items():
        if len(grads) != 2 or grads[0].dtype != torch.bfloat16:
            raise AssertionError(f"3h b) bfloat16 accum=2: {name} got {len(grads)} "
                                 f"micro-gradients of {grads[0].dtype}")
        want = (grads[0].float() + grads[1].float()) / 2 * scale * (1 - opt_cfg.b1)
        got = opt["m"][name]
        ratio = float(((got - want).abs() / (1e-6 * want.abs()).clamp(min=1e-30)).max())
        if not (got.dtype == torch.float32 and ratio <= 1.0):
            raise AssertionError(f"3h b) bfloat16 accum=2: m {name} ({got.dtype}) is "
                                 f"{ratio:.3f}x of rtol 1e-6 from the float32 sum")
        worst = max(worst, ratio)
    if not np.isfinite(float(met["loss"])):
        raise AssertionError(f"3h b) bfloat16 accum=2: loss {float(met['loss'])}")
    del model, opt, micro
    torch.cuda.empty_cache()
    return worst


def train_families(dev, smi: str) -> dict:
    """3h c): every other family at its published width, cut in depth, one
    train step as configured (bf16 weights, float32 moments, block remat)."""
    out = {}
    for arch, (layers, _, seq) in LM_FAMILIES.items():
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        base = lm_registry.get_config(arch)
        layers = TRAIN_LAYERS.get(arch, layers)
        cfg = base if layers is None else dataclasses.replace(base, n_layers=layers)
        gen = torch.Generator(dev).manual_seed(0)
        model = lm_registry.init_params(cfg, generator=gen, device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        b = TRAIN_FAMILY_BATCH
        toks = _lm_tokens(cfg, b, TRAIN_WHISPER_TOKENS if cfg.family == "encdec" else seq, 4,
                          dev)
        labels = torch.roll(toks, -1, dims=1)
        labels[:, -1] = -1
        batch = {"tokens": toks, "labels": labels}
        if cfg.family == "vlm":
            batch["img"] = torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen,
                                       device=dev) * 0.02
        if cfg.family == "encdec":
            batch["frames"] = torch.randn((b, seq, cfg.d_model), generator=gen,
                                          device=dev) * 0.02
        with torch.no_grad():
            want = float(cross_entropy(lm_registry.forward(model, cfg, batch), labels))
        opt = init_opt_state(model)
        model, opt, met = build_train_step(cfg, AdamWConfig())(model, opt, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        finite = bool(torch.isfinite(torch.stack(torch._foreach_norm(
            list(model.parameters())))).all())
        wall = sync_wall(t0)
        peak = torch.cuda.max_memory_allocated()
        rel = abs(loss - want) / abs(want)
        if not (rel <= TRAIN_LOSS_RTOL and np.isfinite(gnorm) and gnorm > 0 and finite):
            raise AssertionError(f"3h c) {arch}: loss {loss} vs no-grad forward {want} (rel "
                                 f"{rel:.2e}), grad norm {gnorm}, parameters finite {finite}")
        if layers is not None:
            cut = f"{base.n_layers} -> {cfg.n_layers} layers"
        elif cfg.family == "encdec":
            cut = f"{cfg.enc_layers} + {cfg.dec_layers} layers as configured"
        else:
            cut = f"{cfg.n_layers} layers as configured"
        if arch in TRAIN_LAYERS:
            cut += " (2 layers' float32 training state, 80.6 GiB, exceeds the card)"
        shape = (f"{TRAIN_WHISPER_TOKENS} tokens, {seq} encoder frames"
                 if cfg.family == "encdec" else f"{seq} tokens"
                 + (f", the first {cfg.n_patches} image-stub positions"
                    if cfg.family == "vlm" else ""))
        log(f"3h c) {arch} ({cut}; batch {b} x {shape}; {cfg.param_dtype}, remat "
            f"{cfg.remat!r}; {n_params / 1e6:.1f}M params): one train step, loss {loss:.5f} vs "
            f"the no-grad forward's {want:.5f} (rel {rel:.2e} <= {TRAIN_LOSS_RTOL}), grad norm "
            f"{gnorm:.4f} (finite, so is every gradient), wall {wall:.2f} s, "
            f"max_memory_allocated {peak / 2**30:.2f} GiB ({smi})")
        out[arch] = {"rel": rel, "wall": wall, "peak": peak, "n_params": n_params}
        del model, opt, batch, met, toks, labels
        torch.cuda.empty_cache()
    return out


def train_example(dev, smi: str) -> dict:
    """3h d): examples/torch_train_lm.py at its defaults on the card."""
    root = tempfile.mkdtemp(prefix="chip_smoke_example_")
    try:
        example = runpy.run_path(str(Path(__file__).resolve().parent / "examples" /
                                     "torch_train_lm.py"))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            hist = example["main"](["--device", str(dev), "--ckpt-dir", root])
        wall = sync_wall(t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    first, last = hist[0][1], hist[-1][1]
    log(f"3h d) ({smi}) examples/torch_train_lm.py at its defaults: "
        f"{out.getvalue().splitlines()[0]}; loss {first:.4f} -> {last:.4f} (steps "
        f"{hist[0][0]} and {hist[-1][0]}), {wall:.2f} s")
    return {"first": first, "last": last, "wall": wall}


def lm_train_path(dev, smi: str) -> dict:
    """Phase 3h: a) smollm-360m trained at full width and depth through
    launch.train, with a resume; b) the card against the host in float32;
    c) every other family's train step at its published width; d) the
    example."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("3h compares float32 training: TF32 matmuls must be off")
    out = {"train": lm_train(dev, smi), "host": train_card_vs_host(dev, smi),
           "families": train_families(dev, smi), "example": train_example(dev, smi)}
    return out


# ---------------------------------------------------------------------------
# phase 3i: the sharded language-model path (no FREYJA kernel but the router's top-k)
# ---------------------------------------------------------------------------

def _placed(cfg, model, mesh, zero1: bool = True):
    """``launch.train``'s sequence: the weights placed by ``param_shardings``,
    moments by ``zero1_shardings`` (``zero1=False``: like the weights, as
    under fsdp, where the batch axes already split ``embed``). Returns
    (placed weights, AdamW state, moment specs or None)."""
    specs = lm_registry.param_specs(cfg)
    shapes = shd.jax_layout(model, cfg)
    placed = shd.place_params(model, shd.param_shardings(specs, mesh), cfg)
    moments = shd.zero1_shardings(specs, shapes, mesh) if zero1 else None
    opt = init_opt_state(placed, moments, cfg=cfg)
    return placed, opt, None if moments is None else shd.specs_of(moments)


def _whole(placed, opt) -> tuple[dict, dict]:
    """A sharded state gathered whole on the host."""
    cpu = torch.device("cpu")
    with torch.no_grad():
        return placed.full(cpu), {part: {n: gather(t, cpu) for n, t in opt[part].items()}
                                  for part in ("m", "v")}


def lm_sharded_train(dev, smi: str, unsharded: dict) -> dict:
    """3i a): smollm-360m as configured on a (2, 2) mesh over four copies of
    the card in tp mode with ZeRO-1 moments, the steady step timed as 3h
    a)'s; then launch.train --mesh local."""
    shd.set_mode("tp")
    cfg = lm_registry.get_config(LM_ARCH)
    mesh = make_local_mesh(model=SHARD_MODEL, devices=[dev] * SHARD_CARDS)
    model = lm_registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                    device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    placed, opt, moment_specs = _placed(cfg, model, mesh)
    del model
    torch.cuda.empty_cache()
    step = build_train_step(cfg, AdamWConfig(lr=3e-4), mesh=mesh, moment_specs=moment_specs)
    pipe = TokenPipeline(vocab=cfg.vocab, seq=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batches = [batch_to_device(pipe.batch(i), dev) for i in range(TRAIN_TIMED + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record()
    t0 = time.perf_counter()
    for batch in batches[:TRAIN_TIMED]:
        _, opt, metrics = step(placed, opt, batch)
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()
    wall_s = sync_wall(t0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    steady = float(np.mean(step_ms[TRAIN_WARM:]))
    loss = float(metrics["loss"])
    if not (np.isfinite(loss) and int(opt["step"]) == TRAIN_TIMED):
        raise AssertionError(f"3i a) sharded steps: loss {loss}, step {int(opt['step'])}")
    trace = _trace_step("lm sharded train step", lambda: step(placed, opt, batches[-1]),
                        steady, smi)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"3i a) ({smi}) {LM_ARCH} {n_params / 1e6:.1f}M params, bf16, batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, mesh {mesh.shape} over {SHARD_CARDS} copies of the card, tp, ZeRO-1: "
        f"steady step {steady:.3f} ms (CUDA events, mean of steps {TRAIN_WARM + 1}-"
        f"{TRAIN_TIMED}; all {min(step_ms):.3f}-{max(step_ms):.3f} ms; host wall "
        f"{wall_s * 1e3 / TRAIN_TIMED:.3f} ms a step), {tokens / steady * 1e3:.1f} tokens/s; "
        f"beside 3h's unsharded step {unsharded['steady_ms']:.3f} ms ({unsharded['tok_s']:.1f} "
        f"tokens/s, {unsharded['trace']['kernels']} kernels, idle "
        f"{unsharded['trace']['idle']:.1%}, max_memory_allocated "
        f"{unsharded['peak'] / 2**20:.1f} MiB); max_memory_allocated {peak / 2**20:.1f} MiB "
        f"({held / 2**20:.1f} MiB held before the timed steps); loss {loss:.4f}")
    out = dict(steady_ms=steady, step_ms=step_ms, tok_s=tokens / steady * 1e3, peak=peak,
               held=held, trace=trace, n_params=n_params)
    del placed, opt, batches, metrics, step
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        (model, opt, hist), _ = _launch_train(
            ["--device", str(dev), "--arch", LM_ARCH, "--ckpt-dir", root, "--mesh", "local",
             "--steps", str(SHARD_LAUNCH_STEPS), "--ckpt-every", str(SHARD_LAUNCH_STEPS)])
        launch_s = sync_wall(t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not (isinstance(model, shd.ShardedModel) and model.mesh.shape == {"data": 1, "model": 1}
            and int(opt["step"]) == SHARD_LAUNCH_STEPS
            and all(np.isfinite(h[1]) for h in hist)):
        raise AssertionError(f"3i a) launch.train --mesh local: {type(model).__name__}, "
                             f"step {int(opt['step'])}, losses {hist}")
    log(f"3i a) launch.train --mesh local: a {model.mesh.shape} mesh on the card, "
        f"{SHARD_LAUNCH_STEPS} steps in {launch_s:.2f} s (weights drawn, first calls, a "
        f"checkpoint), losses {[round(h[1], 4) for h in hist]}")
    out["launch_s"] = launch_s
    del model, opt
    torch.cuda.empty_cache()
    return out


def _fit_ratio(got: dict, want: dict, atol_frac: float, rtol: float) -> float:
    """The worst |got - want| / (atol_frac x the leaf's max |want| + rtol x
    |want|) over the leaves (``_leaves_fit``'s ratio, without raising)."""
    worst = 0.0
    for key, w in want.items():
        w, g = w.detach().float().cpu(), got[key].detach().float().cpu()
        bound = atol_frac * float(w.abs().max()) + rtol * w.abs()
        worst = max(worst, float(((g - w).abs() / bound.clamp(min=1e-30)).max()))
    return worst


def _one_device_steps(cfg, base, batches, accum: int) -> dict:
    """TRAIN_CHECK_STEPS single-device steps of a copy of ``base`` at
    ``accum``: the metrics, the final parameters and moments on the host,
    the resolved-moment masks, the summed learning rate, and the first
    step's gradients (caught by a hook that returns them as they are)."""
    model = copy.deepcopy(base)
    opt = init_opt_state(model)
    caught = {}

    def catch(grads, state):
        caught.setdefault("grads", {k: v.detach().clone() for k, v in grads.items()})
        return grads, state

    step = build_train_step(cfg, TRAIN_CHECK_OPT, accum=accum, compressor=catch)
    out = {"metrics": [], "masks": None, "lr_sum": 0.0}
    for batch in batches:
        model, opt, met = step(model, opt, batch)
        out["metrics"].append({k: float(met[k]) for k in TRAIN_CHECK_RTOL})
        new = {k: v.sqrt() > 1e-3 * v.sqrt().max() for k, v in opt["v"].items()}
        out["masks"] = new if out["masks"] is None else {k: out["masks"][k] & new[k]
                                                         for k in new}
        out["lr_sum"] += out["metrics"][-1]["lr"]
    out["params"] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    out["m"] = {n: t.cpu() for n, t in opt["m"].items()}
    out["v"] = {n: t.cpu() for n, t in opt["v"].items()}
    out["grads"] = caught["grads"]
    return out


def _state_ratios(metrics, params, moments, ref: dict) -> dict:
    """A run's metrics, parameters and moments against ``_one_device_steps``'
    by 3h b)'s rules, as worst fractions of each bound."""
    n = TRAIN_CHECK_STEPS
    metric = max(abs(got[k] - want[k]) / abs(want[k]) / rtol
                 for got, want in zip(metrics, ref["metrics"])
                 for k, rtol in TRAIN_CHECK_RTOL.items())
    param = max(float(((params[k] - w).abs()
                       / (torch.where(ref["masks"][k].cpu(), 2e-3, 2.0) * ref["lr_sum"])).max())
                for k, w in ref["params"].items())
    return {"metric": metric, "m": _fit_ratio(moments["m"], ref["m"], n * ATOL, RTOL),
            "v": _fit_ratio(moments["v"], ref["v"], 2 * n * ATOL, 2 * RTOL), "param": param}


def lm_sharded_check(dev, smi: str) -> dict:
    """3i b): 4 layers at full width, float32, on the (2, 2) mesh in tp,
    fsdp and dp, against the single-device step at the data ranks' split
    of the batch (``accum`` = the data ranks: the same float32 sums of
    per-rank gradients), with and without the int8 compressor; the
    distance of both to the accum=1 step is reported beside."""
    cfg = dataclasses.replace(lm_registry.get_config(LM_ARCH), n_layers=SHARD_CHECK_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    mesh = make_local_mesh(model=SHARD_MODEL, devices=[dev] * SHARD_CARDS)
    n_ranks = shd.n_data_ranks(mesh)
    base = lm_registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                   device=dev)
    pipe = TokenPipeline(vocab=cfg.vocab, seq=TRAIN_CHECK_S, global_batch=TRAIN_CHECK_B)
    batches = [batch_to_device(pipe.batch(i), dev) for i in range(TRAIN_CHECK_STEPS)]
    split = _one_device_steps(cfg, base, batches, n_ranks)
    whole = _one_device_steps(cfg, base, batches, 1)
    floor = _state_ratios(split["metrics"], split["params"], split, whole)
    floor["grad"] = _fit_ratio(split["grads"], whole["grads"], ATOL, RTOL)
    out = {"accum_vs_whole": floor}
    for mode in ("tp", "fsdp", "dp"):
        t0 = time.perf_counter()
        shd.set_mode(mode)
        placed, opt, moment_specs = _placed(cfg, base, mesh, zero1=mode != "fsdp")
        step = build_train_step(cfg, TRAIN_CHECK_OPT, mesh=mesh, moment_specs=moment_specs)
        metrics = []
        for batch in batches:
            _, opt, met = step(placed, opt, batch)
            metrics.append({k: float(met[k]) for k in TRAIN_CHECK_RTOL})
        params, moments = _whole(placed, opt)
        ratios = _state_ratios(metrics, params, moments, split)
        vs_whole = _state_ratios(metrics, params, moments, whole)
        del placed, opt, step, params, moments

        # one step with the int8 compressor between the gradients and the update
        placed, opt, moment_specs = _placed(cfg, base, mesh, zero1=mode != "fsdp")
        init, compress = make_int8_ef_allreduce(mesh, shd.batch_axes(mesh))
        opt["ef"] = init({k: torch.zeros(sh.shape, device=dev) for k, sh in placed.leaves.items()})
        seen = {}

        def hook(g, state):
            seen["in"] = {k: v.clone() for k, v in g.items()}
            seen["out"], state["ef"] = compress(g, state["ef"])
            return seen["out"], state

        _, opt, met = build_train_step(cfg, TRAIN_CHECK_OPT, mesh=mesh,
                                       moment_specs=moment_specs, compressor=hook)(
            placed, opt, batches[0])
        ratios["grad"] = _fit_ratio(seen["in"], split["grads"], ATOL, RTOL)
        vs_whole["grad"] = _fit_ratio(seen["in"], whole["grads"], ATOL, RTOL)
        ratios["loss"] = abs(float(met["loss"]) - split["metrics"][0]["loss"]) / abs(
            split["metrics"][0]["loss"]) / 1e-5
        mine = copy.deepcopy(base)
        mine_opt = init_opt_state(mine)
        adamw_update(TRAIN_CHECK_OPT, mine, seen["out"], mine_opt)
        params, moments = _whole(placed, opt)
        same = all(torch.equal(params[k], p.detach().cpu()) for k, p in mine.named_parameters())
        same &= all(torch.equal(moments[part][k], mine_opt[part][k].cpu())
                    for part in ("m", "v") for k in moments[part])
        bad = {k: round(v, 3) for k, v in ratios.items() if not v <= 1.0}
        if bad or not same:
            raise AssertionError(f"3i b) {mode}: against the single-device step at accum="
                                 f"{n_ranks}, fractions of the bound above 1: {bad}; the "
                                 f"compressed update a one-device adamw_update of its "
                                 f"gradients bit for bit: {same}")
        out[mode] = {"vs_split": ratios, "vs_whole": vs_whole}
        fmt = lambda r: ", ".join(f"{k} {v:.3f}" for k, v in r.items())  # noqa: E731
        log(f"3i b) ({smi}) {LM_ARCH} full width, {SHARD_CHECK_LAYERS} layers, float32, mesh "
            f"{mesh.shape}, {mode}{'' if moment_specs else ' (moments beside the weights)'}: "
            f"{TRAIN_CHECK_STEPS} steps (and one with the int8 compressor: the gradients it "
            f"receives, the loss at rtol 1e-5) against the single-device step at accum="
            f"{n_ranks}, worst fractions of 3h b)'s bounds: {fmt(ratios)}; the compressed "
            f"update bit for bit a one-device adamw_update of its gradients; against the "
            f"accum=1 step: {fmt(vs_whole)} (accum={n_ranks} itself: {fmt(floor)}) "
            f"({sync_wall(t0):.2f} s)")
        del placed, opt, params, moments, mine, mine_opt, seen
    shd.set_mode("tp")
    del base
    torch.cuda.empty_cache()
    return out


def lm_sharded_moe(dev, smi: str) -> dict:
    """3i c): the ep and tp MoEs at published width, 1 layer, float32, on a
    (2, 4) mesh of eight copies of the card against the same sharded
    forward on a (2, 4) mesh over the host."""
    shd.set_mode("tp")
    cpu = torch.device("cpu")
    model_axis = SHARD_MOE_MESH[1]
    card_mesh = make_local_mesh(model=model_axis, devices=[dev] * int(np.prod(SHARD_MOE_MESH)))
    host_mesh = make_local_mesh(model=model_axis, devices=[cpu] * int(np.prod(SHARD_MOE_MESH)))
    out = {}
    for arch in SHARD_MOES:
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(lm_registry.get_config(arch), n_layers=1,
                                  param_dtype="float32", compute_dtype="float32")
        model = lm_registry.init_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                                        device=dev)
        n_params = sum(p.numel() for p in model.parameters())
        shardings = {m: shd.param_shardings(lm_registry.param_specs(cfg), m)
                     for m in (card_mesh, host_mesh)}
        on_card = shd.place_params(model, shardings[card_mesh], cfg)
        on_host = shd.place_params(model, shardings[host_mesh], cfg)
        del model
        torch.cuda.empty_cache()
        toks = _lm_tokens(cfg, SHARD_MOE_B, SHARD_MOE_S, 5, dev)
        with torch.no_grad():
            t0 = time.perf_counter()
            got = lm_registry.forward(on_card, cfg, {"tokens": toks}, mesh=card_mesh)
            card_s = sync_wall(t0)
            t0 = time.perf_counter()
            want = lm_registry.forward(on_host, cfg, {"tokens": toks.cpu()}, mesh=host_mesh)
            host_s = time.perf_counter() - t0
        got = got.cpu()
        rel = float((got - want).abs().max()) / float(want.abs().max())
        if not rel < SHARD_MOE_REL:
            raise AssertionError(f"3i c) {arch}: max |diff| / max |logit| {rel:.3e} "
                                 f"(bound {SHARD_MOE_REL})")
        elementwise = float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())
        peak = torch.cuda.max_memory_allocated()
        log(f"3i c) ({smi}) {arch} ({cfg.moe_sharding}) at published width, 1 layer, float32, "
            f"{n_params / 1e6:.1f}M params, mesh {card_mesh.shape} over "
            f"{int(np.prod(SHARD_MOE_MESH))} copies of the card, batch {SHARD_MOE_B} x "
            f"{SHARD_MOE_S}: the card's sharded forward against the host's: max |diff| / max "
            f"|logit| {rel:.3e} (< {SHARD_MOE_REL}); {elementwise:.3f} of rtol {RTOL}, atol "
            f"{ATOL} elementwise; max |logit| {float(want.abs().max()):.4f}; card "
            f"{card_s:.2f} s (first call), host {host_s:.2f} s; max_memory_allocated "
            f"{peak / 2**30:.2f} GiB")
        out[arch] = {"rel": rel, "elementwise": elementwise, "card_s": card_s,
                     "host_s": host_s, "peak": peak}
        del on_card, on_host, got, want
        torch.cuda.empty_cache()
    return out


def lm_sharded_path(dev, smi: str, unsharded: dict) -> dict:
    """Phase 3i: a) smollm-360m trained on a (2, 2) mesh of copies of the
    card, and launch.train --mesh local; b) the float32 sharded steps
    against the single-device step; c) the sharded MoEs against the host."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("3i compares float32 training: TF32 matmuls must be off")
    return {"train": lm_sharded_train(dev, smi, unsharded), "check": lm_sharded_check(dev, smi),
            "moe": lm_sharded_moe(dev, smi)}


# ---------------------------------------------------------------------------
# phase 3j: the dry run beside the card
# ---------------------------------------------------------------------------

def _dry_cell(arch: str, shape: str, override: str | None, out_dir: str) -> dict:
    """One cell of the port's dry run (``launch.dryrun.run_cell``); it must
    end ``ok``."""
    r = dryrun.run_cell(arch, shape, "single", mesh_override=override, out_dir=out_dir)
    if r["status"] != "ok":
        raise AssertionError(f"dry run of {arch} {shape}: {r['status']} {r.get('error')}")
    return r


def _fits_placement(name: str, predicted: int, measured: int) -> float:
    """The dry run's argument bytes against the bytes the placement took on
    the card; fails beyond ``DRY_ARG_RTOL``."""
    rel = abs(measured - predicted) / predicted
    if rel > DRY_ARG_RTOL:
        raise AssertionError(f"{name}: the dry run's argument bytes {predicted} are "
                             f"{rel:.2%} from the placement's {measured}")
    return rel


def _held_bytes(tensors) -> int:
    """Bytes of the distinct storages behind ``tensors``: what holding them
    keeps on the card, each storage once however many views share it."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


def plain_discovery(z, w, cids, tids, zq, wq, tq, qid, g, k: int, chunk: int):
    """The ``all`` pipeline with the plain scorer over column chunks of at
    most ``chunk`` (the unchunked plain scorer would hold (Q, N, 23) float32
    features), each chunk's plain top-k merged by :func:`plain_topk`: the
    global top-k, ties to the lower column id."""
    scores, ids = [], []
    for lo in range(0, z.shape[0], chunk):
        sl = slice(lo, lo + chunk)
        s = ref.fused_score_ref(zq, wq, z[sl], w[sl], *g)
        s = torch.where(stages.exclusion_mask(cids[sl], tids[sl], tq, qid), float("-inf"), s)
        sc, i = plain_merge(s, cids[sl], k)
        scores.append(sc)
        ids.append(i)
    sc, pos = plain_topk(torch.cat(scores, 1), k)
    return sc, torch.gather(torch.cat(ids, 1), 1, pos)


def dry_discovery(dev, smi: str, out_dir: str) -> dict:
    """3j a): the paper's cell (16M columns, 64 queries, k=100) through the
    dry run with a 4 x 1 mesh, then for real: ``build_sharded_pipeline`` over
    ``make_grid_mesh(1, 4)`` of four copies of the card, the profiles drawn
    on the card from a seeded generator in the dtypes of the executor's
    ingest. What the placement holds must come within ``DRY_ARG_RTOL`` of
    four times the cell's argument bytes, and the ids must equal the
    chunked plain pipeline's up to exact ties."""
    r = _dry_cell("freyja-discovery", "query", f"{DRY_SHARDS}x1", out_dir)
    card = _card(dev)
    n, q, k = FD.N_COLUMNS, FD.N_QUERIES, FD.TOP_K
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(card)
    gen = torch.Generator(card).manual_seed(DRY_SEED)
    # the rows as ``Executor.__init__`` makes them: float32 profiles, the
    # word hashes widened from their int32 bit-views by ``from_bits``, int32
    # table ids widened to int64, the column ids of ``_live_ids``
    z = torch.randn((n, FT.F_NUM), generator=gen, device=card)
    w = from_bits(torch.randint(0, DRY_VOCAB, (n, FT.F_WORDS), generator=gen, device=card,
                                dtype=torch.int32))
    cids = _live_ids(n, n, card)
    tids = (torch.arange(n, dtype=torch.int32, device=card) // DRY_TABLE_WIDTH).to(torch.int64)
    qid = torch.randperm(n, generator=gen, device=card)[:q].clone()   # frees the permutation
    zq, wq, tq = z[qid], w[qid], tids[qid]
    g = _random_gbdt(np.random.default_rng(DRY_SEED), FREYJA_TREES, FREYJA_DEPTH, card)
    mesh = make_grid_mesh(1, DRY_SHARDS, devices=[card] * DRY_SHARDS)
    corpus = place_sharded_corpus(mesh, ("data",), dict(z=z, w=w, cids=cids, tids=tids))
    # what the placement holds: the storages behind its shards (on one card
    # views of the rows above, unless it padded or converted them), the
    # queries and the ensemble (once here; the dry run counts them on each
    # of the four devices, 0.002% of the total)
    placed = _held_bytes([t for shard in corpus["shards"].values() for t in shard.values()]
                         + [zq, wq, tq, qid] + [t for t in g if torch.is_tensor(t)])
    predicted = DRY_SHARDS * r["memory"]["argument_bytes"]
    rel = _fits_placement("3j a)", predicted, placed)
    fn = build_sharded_pipeline(mesh, candidates="all", k=k)
    torch.cuda.reset_peak_memory_stats(card)
    t0 = time.perf_counter()
    sc, ids, n_scored = fn(corpus, {card: g}, zq, wq, tq, qid)
    first = sync_wall(t0)
    t0 = time.perf_counter()
    sc, ids, n_scored = fn(corpus, {card: g}, zq, wq, tq, qid)
    wall = sync_wall(t0)
    peak = torch.cuda.max_memory_allocated(card) - before
    trace = _trace_step("3j a) discovery cell", lambda: fn(corpus, {card: g}, zq, wq, tq, qid),
                        wall * 1e3, smi)
    if not torch.equal(n_scored, torch.full_like(n_scored, n)):
        raise AssertionError(f"3j a): n_scored {n_scored.unique().tolist()}, want {n}")
    t0 = time.perf_counter()
    s_ref, i_ref = plain_discovery(z, w, cids, tids, zq, wq, tq, qid, g, k, DRY_PLAIN_CHUNK)
    plain = sync_wall(t0)
    _same_ranking("3j a) discovery cell", s_ref, i_ref, sc.cpu().numpy(), ids.cpu().numpy())
    # on one card the four shards and one tile's transient: the cell's peak
    # (one device's arguments and transient) plus the other three shards
    predicted_peak = (DRY_SHARDS - 1) * r["memory"]["argument_bytes"] + r["memory"]["peak_bytes"]
    log(f"3j a) ({smi}): {n} columns x {q} queries, k={k}, on {DRY_SHARDS} copies of the card: "
        f"argument bytes {predicted} predicted, {placed} placed ({rel:.3%}); pipeline "
        f"{wall * 1e3:.3f} ms (first call {first * 1e3:.3f} ms); max_memory_allocated "
        f"{peak} against the dry run's {predicted_peak} ({peak / predicted_peak:.3f}); plain "
        f"pipeline {plain:.2f} s; ids equal up to ties; dry run bound "
        f"{r['bound_s'] * 1e3:.3f} ms a device ({r['bottleneck']})")
    del corpus, z, w, cids, tids
    torch.cuda.empty_cache()
    return {"wall_ms": wall * 1e3, "first_ms": first * 1e3, "argument_bytes": predicted,
            "placed": placed, "max_memory_allocated": peak, "peak_bytes": predicted_peak,
            "bound_ms": r["bound_s"] * 1e3, "trace": trace}


def dry_long(arch: str, dev, smi: str, out_dir: str) -> dict:
    """3j b), c): a sub-quadratic model's ``long_500k`` cell through the dry
    run with a 1 x 1 mesh, then for real: the full-width model drawn on the
    card, ``init_caches(cfg, 1, 524288)`` with ``len`` 524,287 (the step
    reads the whole cache) and one ``decode_step`` timed by CUDA events
    after one warm-up. The placement must come within ``DRY_ARG_RTOL`` of the
    cell's argument bytes."""
    r = _dry_cell(arch, "long_500k", "1x1", out_dir)
    cfg = lm_registry.get_config(arch)
    seq = lm_registry.SHAPES["long_500k"]["seq"]
    card = _card(dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(card)
    params = lm_registry.init_params(cfg, generator=torch.Generator(card).manual_seed(0),
                                     device=card)
    caches = lm_registry.init_caches(cfg, 1, seq, device=card)
    caches["len"] = seq - 1
    tok = torch.randint(0, cfg.vocab, (1, 1), generator=torch.Generator(card).manual_seed(1),
                        device=card)
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated(card) - before
    rel = _fits_placement(f"3j {arch}", r["memory"]["argument_bytes"], placed)
    torch.cuda.reset_peak_memory_stats(card)
    logits, _ = lm_registry.decode_step(params, cfg, {"tokens": tok}, caches)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    logits, _ = lm_registry.decode_step(params, cfg, {"tokens": tok}, caches)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated(card) - before
    if logits.shape != (1, 1, cfg.vocab) or not torch.isfinite(logits.float()).all():
        raise AssertionError(f"3j {arch}: logits {tuple(logits.shape)} not finite")
    trace = _trace_step(f"3j {arch} long_500k decode step", lambda: lm_registry.decode_step(
        params, cfg, {"tokens": tok}, caches), ms, smi)
    bound_ms = r["bound_s"] * 1e3
    log(f"3j {arch} long_500k ({smi}): argument bytes {r['memory']['argument_bytes']} "
        f"predicted, {placed} placed ({rel:.3%}); decode step {ms:.3f} ms against the dry run's "
        f"bound {bound_ms:.4f} ms ({r['bottleneck']}; {bound_ms / ms:.2%} of the step); "
        f"max_memory_allocated {peak} against the dry run's peak {r['memory']['peak_bytes']} "
        f"({peak / r['memory']['peak_bytes']:.3f})")
    del params, caches, logits
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound_ms, "argument_bytes": r["memory"]["argument_bytes"],
            "placed": placed, "max_memory_allocated": peak,
            "peak_bytes": r["memory"]["peak_bytes"], "trace": trace}


def dry_test_cell(out_dir: str) -> dict:
    """3j d): the test cell (whisper-base, decode_32k, the single mesh)
    through the dry run on the card's host. It runs no kernel: this shows
    that the command works where the card is."""
    t0 = time.perf_counter()
    r = _dry_cell("whisper-base", "decode_32k", None, out_dir)
    wall = time.perf_counter() - t0
    if r["memory"]["argument_bytes"] != DRY_TEST_CELL_ARGUMENT_BYTES:
        raise AssertionError(f"3j d): argument bytes {r['memory']['argument_bytes']}")
    log(f"3j d) whisper-base decode_32k (single mesh) dry run on the host in {wall:.2f} s: "
        f"argument bytes {r['memory']['argument_bytes']}, traced flops a device "
        f"{r['traced_flops_per_device']:.6g} beside the analytic {r['flops_per_device']:.6g}")
    return {"wall_s": wall}


def dry_path(dev, smi: str) -> dict:
    """Phase 3j: the dry run's figures beside the card's for the cells that
    fit one H100."""
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    try:
        a, counts = counted("dry run discovery", ("fused_score", "topk"),
                            lambda: dry_discovery(dev, smi, out_dir))
        if any(v for name, v in counts.items() if name not in ("fused_score", "topk")):
            raise AssertionError(f"3j a) launched other kernels: {counts}")
        a["launches"] = counts["fused_score"]
        a["topk_launches"] = counts["topk"]
        long = {}
        for arch in DRY_LONG:
            long[arch], c = counted(f"dry run {arch}", (), lambda: dry_long(arch, dev, smi,
                                                                            out_dir))
            if any(c.values()):
                raise AssertionError(f"3j {arch} launched FREYJA kernels: {c}")
        d = dry_test_cell(out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return {"discovery": a, "long": long, "test_cell": d}


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


def router_only(path: str, counts: dict) -> None:
    """The LM paths launch no FREYJA kernel but the top-k of the MoE
    families' router."""
    other = {k: v for k, v in counts.items() if v and k != "topk"}
    if other:
        raise AssertionError(f"the {path} path launched FREYJA kernels other than the "
                             f"router's topk: {counts}")


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

    # phase 2: ragged shapes, and two threads with two ensembles
    t0 = time.perf_counter()
    check_ragged(dev)
    topk_cases = check_topk(dev)
    concurrent = check_concurrent(dev)
    log(f"phase 2: kernels equal their plain versions at ragged shapes ({topk_cases} top-k "
        f"cases), and under concurrent calls with two ensembles {concurrent} "
        f"({time.perf_counter() - t0:.2f} s)")

    # phase 3: each path counted on its own
    run, discovery = counted("discovery", ("fused_score", "minhash", "lsh_probe", "topk",
                                           "candidate_priority"), lambda: main_path(dev))
    _, scale = counted("scale", ("lsh_probe", "lsh_probe_gathered", "fused_score_q",
                                 "fused_score", "topk", "coarse_priority"),
                       lambda: scale_path(run, dev))
    _, model = counted("model", ("profile_distance", "gbdt_infer", "quality_cdf"),
                       lambda: model_path(run, dev))
    served, serve_counts = counted(
        "serve", ("fused_score", "fused_score_q", "minhash", "lsh_probe",
                  "lsh_probe_gathered", "topk", "coarse_priority"),
        lambda: serve_path(run, dev))
    fleet_run, fleet_counts = counted(
        "fleet", ("fused_score", "lsh_probe", "minhash", "topk"),
        lambda: fleet_path(run, served, dev))
    sharded, sharded_counts = counted(
        "sharded", ("fused_score", "lsh_probe", "topk"), lambda: sharded_path(run, dev))
    sharded_geometry = dict(_build.geometry_counts["fused_score"])
    if not all(sharded_geometry.values()):
        raise AssertionError(f"sharded path: fused_score launches by geometry {sharded_geometry}")
    counts = {"discovery": discovery, "scale": scale, "model": model}
    for kernel in ("topk", "candidate_priority"):
        log(f"{kernel} launches by path: " + ", ".join(
            f"{path} {c[kernel]}" for path, c in (*counts.items(), ("serve", serve_counts),
                                                 ("fleet", fleet_counts),
                                                 ("sharded", sharded_counts))))
    launches = {k: counts[PATH_OF[k]][k] for k in _build.KERNELS}
    t0 = time.perf_counter()
    check_main_path(run, dev)
    check_scale_path(run, dev)
    check_model_path(run, dev)
    check_serve_path(served, dev, smi)
    check_fleet_path(fleet_run, dev, smi)
    sharded_check = check_sharded_path(run, sharded, dev)
    shutil.rmtree(served["root"], ignore_errors=True)
    log(f"phase 3 check: {time.perf_counter() - t0:.2f} s")
    log(f"serve summary ({smi}): ingest {served['walls']['ingest']:.2f} s; "
        + "; ".join(f"{name} warmup {served['engines'][name].warmup_report['wall_ms']:.1f} ms, "
                    f"{rec['qps']:.1f} queries/s, p50 {rec['p50']:.2f} ms, "
                    f"p99 {rec['p99']:.2f} ms" for name, rec in served["served"].items())
        + f"; refresh {served['walls']['refresh'] * 1e3:.1f} ms, "
        f"{served['follow']['new'].executor.bytes_uploaded} bytes uploaded "
        f"(full placement {served['follow']['old'].executor.bytes_uploaded}); "
        f"launches {serve_counts}")
    b1, b2 = fleet_run["burst1"], fleet_run["burst2"]
    log(f"fleet summary ({smi}): {N_REPLICAS} replicas, open + warm "
        f"{fleet_run['walls']['open']:.2f} s; "
        + "; ".join(f"{tag} {b['qps']:.1f} queries/s, p50 {b['p50']:.2f} ms, p99 "
                    f"{b['p99']:.2f} ms, (requests, batches) by replica {b['split']}"
                    for tag, b in (("burst 1", b1), ("burst 2 (kill)", b2)))
        + f"; re-dispatches {b2['redispatches']}; roll refresh "
        f"{fleet_run['walls']['roll'] * 1e3:.1f} ms; launches {fleet_counts}")

    log(f"sharded summary ({smi}): queries/s by grid beside the local plan "
        f"{sharded_check['qps']}; launches {sharded_counts}, fused_score by geometry "
        f"{sharded_geometry}")

    # phase 3g: the language-model serving path, which has no FREYJA kernel
    # but the MoE router's top-k
    lm, lm_counts = counted("lm", ("topk",), lambda: lm_path(dev, smi))
    router_only("lm", lm_counts)
    a = lm["serve"]
    log(f"lm summary ({smi}): {LM_ARCH} bf16, batch {LM_BATCH}: prefill {a['prefill_ms']:.3f} "
        f"ms, decode {a['steady_ms']:.3f} ms a step, {a['tok_s']:.1f} tokens/s, "
        f"max_memory_allocated {a['peak'] / 2**20:.1f} MiB ({(a['peak'] - a['held']) / 2**20:.1f} "
        f"MiB above what was held), {a['trace']['kernels']} kernels a "
        f"decode step; decode vs forward (float32) within {lm['fp32']['ratio']:.3f} of the "
        f"tolerance, bf16 vs float32 {lm['fp32']['bf16_rel']:.4f}; families "
        + ", ".join(f"{k} {v['ratio']:.3f}" for k, v in lm["families"].items())
        + f"; card vs host {lm['host']['ratio']:.3f}; launches {lm_counts}")

    # phase 3h: the language-model training path, which has no FREYJA kernel
    # but the MoE router's top-k
    trained, train_counts = counted("train", ("topk",), lambda: lm_train_path(dev, smi))
    router_only("train", train_counts)
    t = trained["train"]
    log(f"train summary ({smi}): {LM_ARCH} {t['n_params'] / 1e6:.1f}M params, bf16, batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}: {t['steady_ms']:.3f} ms a step, {t['tok_s']:.1f} "
        f"tokens/s, {t['tflops']:.2f} TFLOP/s ({t['tflops'] / H100_BF16_TFLOPS:.2%} of dense "
        f"bf16 peak), {t['trace']['kernels']} kernels a step, idle share "
        f"{t['trace']['idle']:.1%}, max_memory_allocated {t['peak'] / 2**20:.1f} MiB; card vs "
        f"host {trained['host']['ratios']}; families' loss vs forward "
        + ", ".join(f"{k} {v['rel']:.1e}" for k, v in trained["families"].items())
        + f"; example loss {trained['example']['first']:.3f} -> "
        f"{trained['example']['last']:.3f}; launches {train_counts}")

    # phase 3i: the sharded language-model path, which has no FREYJA kernel
    # but the MoE router's top-k
    shard_run, shard_counts = counted("sharded lm", ("topk",),
                                      lambda: lm_sharded_path(dev, smi, trained["train"]))
    router_only("sharded lm", shard_counts)
    a = shard_run["train"]
    log(f"sharded lm summary ({smi}): {LM_ARCH} bf16, batch {TRAIN_BATCH} x {TRAIN_SEQ} on a "
        f"(2, 2) mesh of copies of the card (tp, ZeRO-1): {a['steady_ms']:.3f} ms a step, "
        f"{a['tok_s']:.1f} tokens/s, {a['trace']['kernels']} kernels a step, idle share "
        f"{a['trace']['idle']:.1%}, max_memory_allocated {a['peak'] / 2**20:.1f} MiB; unsharded "
        f"(3h) {t['steady_ms']:.3f} ms, {t['tok_s']:.1f} tokens/s, {t['trace']['kernels']} "
        f"kernels, idle {t['trace']['idle']:.1%}, {t['peak'] / 2**20:.1f} MiB; launch.train "
        f"--mesh local {a['launch_s']:.2f} s; float32 checks, worst fraction of the bound "
        f"against the accum=2 step (m against accum=1) "
        + ", ".join(f"{mode} {max(r['vs_split'].values()):.3f} ({r['vs_whole']['m']:.3f})"
                    for mode, r in shard_run["check"].items() if mode != "accum_vs_whole")
        + "; MoEs card vs host (max |diff| / max |logit|) " + ", ".join(
            f"{k} {v['rel']:.2e}" for k, v in shard_run["moe"].items())
        + f"; launches {shard_counts}")

    # phase 3j: the dry run beside the card
    t0 = time.perf_counter()
    dry = dry_path(dev, smi)
    a = dry["discovery"]
    log(f"dry run summary ({smi}): discovery cell {a['wall_ms']:.3f} ms, {a['launches']} "
        f"fused_score and {a['topk_launches']} topk launches, placed/predicted {a['placed'] / a['argument_bytes']:.4f}, "
        f"peak/predicted {a['max_memory_allocated'] / a['peak_bytes']:.3f}, idle share "
        f"{a['trace']['idle']:.1%}; "
        + "; ".join(f"{arch} long_500k decode {v['ms']:.3f} ms (bound {v['bound_ms']:.4f} ms, "
                    f"{v['bound_ms'] / v['ms']:.2%}), placed/predicted "
                    f"{v['placed'] / v['argument_bytes']:.4f}, peak/predicted "
                    f"{v['max_memory_allocated'] / v['peak_bytes']:.3f}, "
                    f"{v['trace']['kernels']} kernels, idle share {v['trace']['idle']:.1%}"
                    for arch, v in dry["long"].items())
        + f"; test cell on the host {dry['test_cell']['wall_s']:.2f} s; "
        f"phase 3j {time.perf_counter() - t0:.2f} s")

    # phase 4: kernels at the main path's shapes
    t0 = time.perf_counter()
    kernels = measure_kernels(run, dev, launches)
    for row in kernels:
        if row["name"] == "fused_score":
            row["dryrun_cell"] = {k: a[k] for k in ("launches", "wall_ms", "max_memory_allocated")}
        if row["name"] == "topk":
            row["dryrun_cell"] = {"launches": a["topk_launches"]}
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


def load_checkout(root: Path):
    """Another checkout's ``chip_smoke`` module, over that checkout's
    ``src``: this script's ``repro_torch`` modules are dropped from the
    import cache and its ``src`` from the path first, so the kernels,
    stages and executor the module drives are that checkout's."""
    import importlib.util
    own = str(Path(__file__).resolve().parent / "src")
    sys.path[:] = [p for p in sys.path if p != own]
    for mod in [m for m in sys.modules if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[mod]
    spec = importlib.util.spec_from_file_location("chip_smoke_checkout", root / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plans_main(root: str) -> int:
    """``--plans [ROOT]``: the six plans of phase 3 (a, b) and 3j a) of the
    checkout at ROOT (this one by default), built and driven by that
    checkout's own ``chip_smoke.py`` and measured by this one: each plan's
    steady wall (the mean of ``PLANS_REPS`` synchronized batches after a
    first) and its device busy time, top-k and sort parts a batch
    (``plan_device_ms``, phase 5's measure); 3j a)'s wall and
    ``max_memory_allocated``. Run it for a parent checkout and this one in
    one call on one card (parent, change, change, parent). Prints a line a
    plan and one JSON line."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke --plans: no CUDA device is available")
    root = Path(root).resolve()
    here = Path(__file__).resolve().parent
    cs = sys.modules[__name__] if root == here else load_checkout(root)
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    cs._build.build()
    run = cs.main_path(dev, reps=PLANS_REPS)
    cs.scale_path(run, dev, reps=PLANS_REPS)
    out = {}
    for name, (executor, plan, args) in run["runs"].items():
        t = plan_device_ms(lambda: executor.execute(plan, *args))
        out[name] = {"wall_ms": run["steady_ms"][name], "busy_ms": t["busy"],
                     "topk_ms": t["topk_ms"], "sort_ms": t["sort_ms"], "whole": t["whole"]}
        log(f"plans {root}: {name} steady {run['steady_ms'][name]:.3f} ms a batch, device busy "
            f"{t['busy']:.4f} ms (top-k kernel {t['topk_ms']:.4f}, sort kernels "
            f"{t['sort_ms']:.4f}; whole calls {t['whole']})")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plans_") as out_dir:
        cell = cs.dry_discovery(dev, smi, out_dir)
    out["3j a)"] = {k: cell[k] for k in ("wall_ms", "max_memory_allocated")}
    log(f"plans {root}: 3j a) {cell['wall_ms']:.3f} ms a call, max_memory_allocated "
        f"{cell['max_memory_allocated']} (the dry run's predicted peak {cell['peak_bytes']})")
    print(json.dumps({"root": str(root), "card": smi, "plans": out}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--plans"]:
        sys.exit(plans_main(sys.argv[2] if len(sys.argv) > 2 else "."))
    sys.exit(main())
