"""Analytic cost models: a language-model cell per device, and one
discovery micro-batch per pipeline stage.

The port of ``repro.launch.costmodel``, both halves:

* the LM half, which the dry run reads (``launch.dryrun``): ``cell_cost``
  (flops, HBM bytes and collective bytes per device and step of an
  (arch x shape x mesh) cell, the MaxText/PaLM accounting specialized per
  family: 6·N·D training matmuls, 4·T·W·h·dh attention, ring (n-1)/n
  collective factors; ``remat="block"`` adds a forward recompute, 8/6 of
  6·N·D), ``CellCost``, ``w_avg_decode`` and ``_cache_bytes_per_dev``,
  pure numpy over ``ArchConfig`` fields and copied verbatim, so the port's
  figures equal the JAX package's exactly. Conventions: T tokens a step
  (B·S train/prefill; B decode), dp the data-parallel shards (pod x
  data), mp the model shards, BF/F4 bf16/f32 byte sizes;
* the discovery half: ``discovery_stage_costs`` (the planner's default
  cost hook), ``plan_cost_per_query``, the calibration from measured
  service-bench timings (``calibrate_stage_costs``,
  ``make_calibrated_cost_fn``) and the bucket ladders derived from them
  (``derive_batch_buckets``, ``derive_column_buckets``). They read the JAX
  package's ``BENCH_service.json`` layout; the port writes no benchmark
  record of its own yet.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from repro_torch.core import features as FT

BF, F4 = 2, 4   # bytes of a bfloat16; of a float32 or a uint32


# ---------------------------------------------------------------------------
# language-model cells (the dry run's analytic terms)
# ---------------------------------------------------------------------------

def _dense_layer_matmul_params(cfg) -> float:
    d, f, nh, nk, dh = (cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.n_kv,
                        cfg.d_head)
    attn = d * nh * dh + 2 * d * nk * dh + nh * dh * d
    mlp = (3 if cfg.act == "silu" else 2) * d * f
    return attn + mlp


def _layer_active_params(cfg) -> float:
    """Matmul params touched per token per layer (MoE: top_k experts)."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.family == "moe":
        attn = d * cfg.n_heads * cfg.d_head + 2 * d * cfg.n_kv * cfg.d_head \
            + cfg.n_heads * cfg.d_head * d
        mlp = cfg.top_k * (3 if cfg.act == "silu" else 2) * d * f \
            + d * cfg.n_experts
        return attn + mlp
    if cfg.family == "ssm":        # rwkv6
        lora = 2 * d * 64
        return 5 * d * d + lora + 2 * d * f + d * d
    if cfg.family == "hybrid":     # mamba2 blocks (shared attn added apart)
        din = cfg.ssm_expand * d
        h = din // cfg.ssm_headdim
        return d * (2 * din + 2 * cfg.ssm_state + h) + din * d
    if cfg.family == "encdec":
        # averaged enc/dec layer (cross attn on decoder layers)
        base = _dense_layer_matmul_params(cfg)
        cross = (cfg.d_model * cfg.n_heads * cfg.d_head * 2
                 + 2 * cfg.d_model * cfg.n_kv * cfg.d_head)
        return base + cross * cfg.dec_layers / max(cfg.n_layers, 1)
    return _dense_layer_matmul_params(cfg)


def _layer_stored_params(cfg) -> float:
    """Matmul params stored per layer (MoE: all experts)."""
    if cfg.family == "moe":
        d, f = cfg.d_model, cfg.d_ff
        attn = d * cfg.n_heads * cfg.d_head + 2 * d * cfg.n_kv * cfg.d_head \
            + cfg.n_heads * cfg.d_head * d
        return attn + cfg.n_experts * (3 if cfg.act == "silu" else 2) * d * f
    return _layer_active_params(cfg)


def _n_layers(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return cfg.n_layers


def _attn_window(cfg, s: int) -> float:
    """Average keys attended per query token."""
    if cfg.family == "ssm":
        return 0.0                                  # attention-free
    w = cfg.sliding_window
    full = (s + 1) / 2                              # causal average
    per_layer = min(w, s) if w else full
    if cfg.family == "hybrid":
        # one shared attn block per attn_every mamba layers
        return per_layer / cfg.attn_every
    if cfg.family == "encdec":
        # enc: bidirect S keys; dec: causal + cross S keys
        return (s + (full + s)) / 2
    return per_layer


def _ssm_flops_per_token(cfg) -> float:
    """Recurrence flops per token per layer beyond projections."""
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_headdim
        return 4 * h * cfg.rwkv_headdim ** 2        # rank-1 state update
    if cfg.family == "hybrid":
        din = cfg.ssm_expand * cfg.d_model
        cs, n = cfg.ssm_chunk, cfg.ssm_state
        # SSD: intra-chunk (≈ windowed attention of width Cs) + state update
        return 4 * cs * din + 6 * n * din / cfg.ssm_headdim * cfg.ssm_headdim
    return 0.0


@dataclasses.dataclass
class CellCost:
    flops: float            # per device
    hbm_bytes: float        # per device
    coll_bytes: float       # per device
    detail: dict

    def as_dict(self):
        return {"flops_per_device": self.flops,
                "hbm_bytes_per_device": self.hbm_bytes,
                "collective_bytes_per_device": self.coll_bytes,
                "detail": self.detail}


def cell_cost(cfg, kind: str, batch: int, seq: int, mesh_shape: dict,
              *, zero1: bool = True, kv_cache_dtype_bytes: int = BF,
              mode: str = "tp") -> CellCost:
    mp = mesh_shape.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_shape.items() if k != "model"]))
    n_dev = mp * dp
    if mode == "dp":          # batch over every axis, weights replicated
        dp, mp = n_dev, 1
    l = _n_layers(cfg)
    d, v = cfg.d_model, cfg.vocab
    nh, nk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head

    p_layer_active = _layer_active_params(cfg)
    p_layer_stored = _layer_stored_params(cfg)
    p_matmul_active = l * p_layer_active + 2 * d * v  # embed + head
    p_stored = l * p_layer_stored + (1 if cfg.tie_embeddings else 2) * d * v

    t_global = batch * (seq if kind != "decode" else 1)
    t_dev = t_global / dp if kind != "decode" else max(batch / dp, 1)
    b_loc = max(batch / dp, 1)

    mult = {"train": 6, "prefill": 2, "decode": 2}[kind]
    remat_f = (8 / 6) if (kind == "train" and cfg.remat == "block") else 1.0

    # ---- flops ----
    matmul = mult * remat_f * t_dev * p_matmul_active / mp
    w_avg = _attn_window(cfg, seq)
    attn_mult = {"train": 3, "prefill": 1, "decode": 1}[kind] * remat_f
    if kind == "decode":
        attn = attn_mult * 4 * b_loc * w_avg_decode(cfg, seq) * nh * dh * l / mp
    else:
        attn = attn_mult * 4 * t_dev * w_avg * nh * dh * l / mp
    ssm = mult / 2 * remat_f * t_dev * _ssm_flops_per_token(cfg) * l / mp
    flops = matmul + attn + ssm

    # ---- HBM bytes ----
    p_shard = p_stored * BF / (mp if mp else 1)
    if mode == "fsdp":
        p_shard = p_shard / dp    # resident shard; AG'd slices stream through
    if kind == "train":
        # weights: fwd read + bwd read (+ remat extra read) + update write
        w_reads = (3 if cfg.remat == "block" else 2) + 1
        weight_traffic = p_shard * w_reads
        # optimizer: grads f32 r+w, m/v read+write, param f32 math
        opt_traffic = (p_stored / mp) * (F4 * 2 + F4 * 4 + F4 * 2) / \
            (dp if zero1 else 1) + p_shard  # AG'd params write
        # activations: residual stream + block internals (≈6 tensors/layer),
        # written fwd + read bwd; remat halves what is stored
        act_tensors = 2 if cfg.remat == "block" else 6
        acts = 2 * act_tensors * l * t_dev * d * BF
        logits = 2 * t_dev * (v / mp) * F4
        hbm = weight_traffic + opt_traffic + acts + logits
    elif kind == "prefill":
        acts = 2 * 2 * l * t_dev * d * BF
        hbm = p_shard + acts + t_dev * (v / mp) * F4
    else:  # decode
        cache = _cache_bytes_per_dev(cfg, batch, seq, mesh_shape,
                                     kv_cache_dtype_bytes)
        hbm = p_shard + 2 * cache + t_dev * (v / mp) * F4
    hbm = float(hbm)

    # ---- collective bytes (ring factors) ----
    ring_mp = 2 * (mp - 1) / mp if mp > 1 else 0.0
    ring_dp = (dp - 1) / dp if dp > 1 else 0.0
    tok_bytes = t_dev * d * BF
    if cfg.family == "moe" and cfg.moe_sharding == "ep" and mp > 1:
        a2a = 2 * t_dev * cfg.top_k * max(cfg.capacity_factor, 2.0) * d * BF \
            * (mp - 1) / mp
        tp_per_layer = 1 * tok_bytes * ring_mp + a2a   # attn psum + A2A pair
    else:
        psums = 2 if cfg.family in ("moe", "hybrid") else 2
        tp_per_layer = psums * tok_bytes * ring_mp
    fwd_bwd = {"train": 2, "prefill": 1, "decode": 1}[kind]
    coll = tp_per_layer * l * fwd_bwd
    if kind == "train":
        # ZeRO-1: reduce-scatter grads (f32) + all-gather params (bf16)
        coll += (p_stored / mp) * (F4 + BF) * ring_dp
    if mode == "fsdp":
        # per-layer param all-gathers: fwd + bwd (+ remat refetch)
        refetch = 3 if (kind == "train" and cfg.remat == "block") else \
            (2 if kind == "train" else 1)
        coll += refetch * (p_stored * BF / mp) * ring_dp
    if kind == "decode" and batch < dp and seq >= 2 ** 18:
        # sequence-sharded cache: per layer combine of partial attention
        coll += l * b_loc * nh * dh * F4 * ring_dp
    return CellCost(flops=float(flops), hbm_bytes=hbm, coll_bytes=float(coll),
                    detail={"matmul_flops": float(matmul),
                            "attn_flops": float(attn),
                            "ssm_flops": float(ssm),
                            "param_bytes_per_dev": float(p_shard),
                            "tokens_per_dev": float(t_dev),
                            "n_devices": n_dev})


def w_avg_decode(cfg, seq: int) -> float:
    if cfg.family == "ssm":
        return 0.0
    w = cfg.sliding_window
    per = min(w, seq) if w else seq
    if cfg.family == "hybrid":
        return per / cfg.attn_every
    if cfg.family == "encdec":
        return 2 * seq            # self cache + cross memory
    return per


def _cache_bytes_per_dev(cfg, batch, seq, mesh_shape, cache_b) -> float:
    mp = mesh_shape.get("model", 1)
    dp = int(np.prod([v for k, v in mesh_shape.items() if k != "model"]))
    l = _n_layers(cfg)
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_headdim
        st = batch * h * cfg.rwkv_headdim ** 2 * F4 * l
        return st / dp if batch >= dp else st
    size = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    # cache sharded over 'model' via kv heads when divisible, else via the
    # sequence axis (flash-decoding SPMD combine) — see dryrun.cache_shardings
    kv_shard = mp if (cfg.n_kv % mp == 0 or size % mp == 0) else 1
    per_layer = 2 * batch * size * cfg.n_kv * cfg.d_head * cache_b / kv_shard
    n_attn = l if cfg.family != "hybrid" else l // cfg.attn_every
    total = per_layer * n_attn
    if cfg.family == "hybrid":
        din = cfg.ssm_expand * cfg.d_model
        h = din // cfg.ssm_headdim
        total += batch * h * cfg.ssm_state * cfg.ssm_headdim * F4 * l
    shard = dp if batch >= dp else (dp if seq >= 2 ** 18 else 1)
    return total / shard


# ---------------------------------------------------------------------------
# discovery pipeline (candidate -> score -> merge) per-stage costs
# ---------------------------------------------------------------------------


def discovery_stage_costs(n_queries: int, n_columns: int, *, budget: int,
                          candidates: str = "hybrid", k: int = 10,
                          n_bands: int = 64, n_trees: int = 30,
                          tree_depth: int = 4, n_shards: int = 1,
                          q_shards: int = 1, survivor_budget: int = 0,
                          n_coarse_bands: int = 16) -> dict:
    """Analytic per-device cost of one discovery micro-batch, per stage.

    Flops, device-memory bytes and collective bytes of the
    candidate→score→merge pipeline over a (``q_shards`` × ``n_shards``)
    query×data grid: each device sees ``ceil(Q / q_shards)`` queries against
    ``ceil(C / n_shards)`` columns. A pruned plan pays the bucket probe
    (Ql·Cl·B compares) and, for ``hybrid``, one (Ql, F_NUM)×(F_NUM, Cl)
    proxy product over every local column to score only ``budget`` of them;
    ``tiered`` pays an S-band digest probe over every column and the fine
    probe, proxy and gathers over the C' survivors only. "auto" planning
    compares these totals.
    """
    qg = max(int(n_queries), 1)
    q_sh = max(int(q_shards), 1)
    q = -(-qg // q_sh)                                 # local queries/device
    shards = max(int(n_shards), 1)
    cl = -(-max(int(n_columns), 1) // shards)          # local columns/device
    # distance-feature work per scored pair: F_NUM |Δz| subs, the 10×10
    # frequent-word overlap compare, first-word equality + GBDT traversal
    feat_ops = FT.F_NUM + FT.N_FREQ_WORDS ** 2 + 2
    pair_ops = feat_ops + n_trees * tree_depth
    profile_bytes = (FT.F_NUM + FT.F_WORDS) * F4

    stg = {}
    if candidates == "all":
        m = cl
        stg["candidates"] = {"flops": 0.0, "hbm_bytes": 0.0}
    elif candidates == "tiered":
        m = min(-(-max(int(budget), 1) // shards), cl)
        surv = min(max(int(survivor_budget), 1), cl)
        s_bands = max(int(n_coarse_bands), 1)
        coarse = q * cl * s_bands + q * cl              # probe + selection
        fine = q * surv * (n_bands + 2.0 * FT.F_NUM + 1)
        gather = q * surv * (FT.F_NUM + n_bands)        # per-query gathers
        stg["candidates"] = {
            "flops": coarse + fine + gather,
            "hbm_bytes": (q + cl) * s_bands * 4 + q * cl * F4
            + q * surv * (n_bands * 4 + FT.F_NUM * F4),
        }
    else:
        m = min(-(-max(int(budget), 1) // shards), cl)
        probe = q * cl * n_bands                        # uint32 equality
        proxy = 2.0 * q * cl * FT.F_NUM if candidates == "hybrid" else 0.0
        stg["candidates"] = {
            "flops": probe + proxy + q * cl,            # + budget selection
            "hbm_bytes": (q + cl) * n_bands * 4 + q * cl * F4
            + (q + cl) * FT.F_NUM * F4,
        }
    stg["score"] = {
        "flops": float(q * m * pair_ops),
        "hbm_bytes": float((q + m) * profile_bytes + q * m * F4),
    }
    kl = min(k, m)
    # phase 1 gathers every data shard's (score, id) top-k within the query
    # shard; phase 2 reassembles the (Q, k) batch over the query axis
    data_coll = float(q * kl * shards * (F4 + 4)) if shards > 1 else 0.0
    query_coll = float(q * kl * q_sh * (F4 + 4)) if q_sh > 1 else 0.0
    stg["merge"] = {
        "flops": float(q * m),
        "hbm_bytes": float(q * m * F4),
        "collective_bytes": data_coll + query_coll,
    }
    return {
        "stages": stg,
        "total_flops": float(sum(s["flops"] for s in stg.values())),
        "total_hbm_bytes": float(sum(s["hbm_bytes"] for s in stg.values())),
        "total_collective_bytes": float(stg["merge"]["collective_bytes"]),
        "n_queries": qg,
        "queries_per_device": int(q),
        "n_shards": shards,
        "q_shards": q_sh,
        "grid": [q_sh, shards],
        "scored_per_device": int(m),
        "survivor_budget": int(min(max(int(survivor_budget), 1), cl))
        if candidates == "tiered" else 0,
    }


def calibrate_stage_costs(bench="BENCH_service.json", *, k: int = 10,
                          n_bands: int = 64):
    """Fit per-stage time constants from measured service-bench timings.

    Closes the ROADMAP "measured cost model" item: the analytic
    :func:`discovery_stage_costs` predicts *flops*, but the "auto" planner
    needs *time* crossovers that match the machine.  Each
    ``BENCH_service.json`` lake entry records the measured per-query
    latency of the plan each mode executed; regressing those against the
    analytic per-stage flop counts (candidates / score / merge, plus a
    fixed dispatch overhead) yields seconds-per-flop constants for this
    host.  The full-scan rows pin the score/merge constants (their
    candidate flops are zero); the pruned rows then identify the candidate
    constant.

    ``bench`` is a path or an already-loaded record.  Returns
    ``(constants, cost_fn)`` where ``cost_fn`` is a drop-in for the
    planner/engine hook (``Planner(cost_fn=...)`` /
    ``EngineConfig(cost_fn=...)``): it returns the analytic stage dict
    augmented with ``total_cost`` (predicted seconds for the batch), which
    "auto" mode prefers over raw flops when present.
    """
    import json
    if isinstance(bench, (str, os.PathLike)):
        with open(bench) as f:
            record = json.load(f)
    else:
        record = bench

    rows_x, rows_y = [], []
    for lake in record.get("lakes", []):
        c = int(lake["n_columns"])
        for stats in lake.get("modes", {}).values():
            kind = stats.get("plan") or ""
            cand = ("tiered" if kind.endswith("tiered") else
                    "hybrid" if kind.endswith("hybrid") else
                    "lsh" if kind.endswith("lsh") else "all")
            budget = int(stats.get("plan_budget") or c)
            surv = int(stats.get("plan_survivor_budget") or 4 * budget)
            stg = discovery_stage_costs(1, c, budget=budget, candidates=cand,
                                        k=k, n_bands=n_bands,
                                        survivor_budget=surv)["stages"]
            rows_x.append([stg["candidates"]["flops"], stg["score"]["flops"],
                           stg["merge"]["flops"], 1.0])
            rows_y.append(float(stats["batch_ms_per_query"]) * 1e-3)
    if len(rows_y) < 4:
        raise ValueError(
            f"need >= 4 timed (lake, mode) observations to fit 4 constants; "
            f"{bench!r} has {len(rows_y)} — run benchmarks/bench_service.py "
            f"first")

    x = np.asarray(rows_x, np.float64)
    y = np.asarray(rows_y, np.float64)
    coef, *_ = np.linalg.lstsq(x, y, rcond=None)
    coef = np.clip(coef, 0.0, None)     # a stage can't have negative cost
    pred = x @ coef
    ss_res = float(((y - pred) ** 2).sum())
    ss_tot = float(((y - y.mean()) ** 2).sum())
    constants = {
        "candidates_s_per_flop": float(coef[0]),
        "score_s_per_flop": float(coef[1]),
        "merge_s_per_flop": float(coef[2]),
        "fixed_s_per_query": float(coef[3]),
        "n_obs": len(rows_y),
        "r2": 1.0 - ss_res / max(ss_tot, 1e-30),
    }
    return constants, make_calibrated_cost_fn(constants)


def derive_batch_buckets(bench="BENCH_service.json"):
    """Batch-bucket ladder for the continuous-batching scheduler, derived
    from a measured ``BENCH_service.json``.

    When the record carries a ``--batch-sweep`` section, its measured
    batch sizes ARE the ladder: they are exactly the padded shapes whose
    grid choice (1-D vs each 2-D factorization, and the sustained
    crossover between them) was timed on this host, so snapping formed
    batches to them reuses both the compiled executables and the
    measured placement decisions.  Without a sweep (or without a
    readable file) the analytic default
    ``repro_torch.exec.plan.DEFAULT_BATCH_BUCKETS`` is returned.

    ``bench`` is a path or an already-loaded record.  Returns a sorted
    tuple of bucket sizes.
    """
    import json

    from repro_torch.exec.plan import DEFAULT_BATCH_BUCKETS
    record = bench
    if isinstance(bench, (str, os.PathLike)):
        try:
            with open(bench) as f:
                record = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return DEFAULT_BATCH_BUCKETS
    sweep = (record or {}).get("batch_sweep", {})
    sizes = sorted({int(e["batch"]) for e in sweep.get("batches", [])
                    if int(e["batch"]) >= 1})
    return tuple(sizes) if sizes else DEFAULT_BATCH_BUCKETS


def derive_column_buckets(bench="BENCH_service.json"):
    """Corpus-column bucket ladder for delta-proportional refresh, derived
    from a measured ``BENCH_service.json``.

    The scale sweep records which lake sizes this deployment actually
    serves; snapping the PLACED corpus dimension to those rungs (padded
    with inert sentinel rows) keeps every traced shape stable across
    ingest deltas, so an in-bucket refresh re-dispatches the compiled
    executables verbatim — zero steady-state recompiles.  The ladder is
    the measured lake sizes rounded UP to the analytic default rungs
    (a rung per measured point would make crossings too frequent to
    amortize).  Without a sweep (or without a readable file) the
    analytic default ``repro_torch.exec.plan.DEFAULT_COLUMN_BUCKETS`` is returned.

    ``bench`` is a path or an already-loaded record.  Returns a sorted
    tuple of bucket sizes.
    """
    import json

    from repro_torch.exec.plan import DEFAULT_COLUMN_BUCKETS
    record = bench
    if isinstance(bench, (str, os.PathLike)):
        try:
            with open(bench) as f:
                record = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return DEFAULT_COLUMN_BUCKETS
    sweep = (record or {}).get("scale_sweep", {})
    lakes = sorted({int(e["n_columns"]) for e in sweep.get("lakes", [])
                    if int(e.get("n_columns", 0)) >= 1})
    if not lakes:
        return DEFAULT_COLUMN_BUCKETS
    rungs = set()
    for n in lakes:
        snapped = next((b for b in DEFAULT_COLUMN_BUCKETS if n <= b),
                       -(-n // DEFAULT_COLUMN_BUCKETS[-1])
                       * DEFAULT_COLUMN_BUCKETS[-1])
        rungs.add(int(snapped))
        # one headroom rung above the largest measured lake, so steady
        # ingest has a pre-warmable bucket to grow into
    top = max(rungs)
    nxt = next((b for b in DEFAULT_COLUMN_BUCKETS if b > top),
               top + DEFAULT_COLUMN_BUCKETS[-1])
    rungs.add(int(nxt))
    return tuple(sorted(rungs))


def make_calibrated_cost_fn(constants: dict):
    """Wrap fitted per-stage constants into a planner ``cost_fn`` hook."""

    def cost_fn(n_queries: int, n_columns: int, *, budget: int,
                candidates: str = "hybrid", k: int = 10, n_bands: int = 64,
                n_trees: int = 30, tree_depth: int = 4,
                n_shards: int = 1, q_shards: int = 1,
                survivor_budget: int = 0, n_coarse_bands: int = 16) -> dict:
        c = discovery_stage_costs(n_queries, n_columns, budget=budget,
                                  candidates=candidates, k=k,
                                  n_bands=n_bands, n_trees=n_trees,
                                  tree_depth=tree_depth, n_shards=n_shards,
                                  q_shards=q_shards,
                                  survivor_budget=survivor_budget,
                                  n_coarse_bands=n_coarse_bands)
        stg = c["stages"]
        # per-device stage flops × fitted s/flop: the critical-path device
        # (dispatch overhead is per-batch, so the fixed term stays global)
        seconds = (constants["fixed_s_per_query"] * c["n_queries"]
                   + constants["candidates_s_per_flop"]
                   * stg["candidates"]["flops"]
                   + constants["score_s_per_flop"] * stg["score"]["flops"]
                   + constants["merge_s_per_flop"] * stg["merge"]["flops"])
        c["total_cost"] = float(seconds)
        c["calibrated"] = True
        return c

    return cost_fn


def plan_cost_per_query(cost: dict | None) -> float | None:
    """Per-request cost of an executed plan: the calibrated ``total_cost``
    (predicted seconds) when present, else ``total_flops`` scaled to
    pseudo-seconds; None when the cost carries neither. Only comparisons
    between plans use it, so any shared monotone scale serves."""
    if not cost:
        return None
    n = max(float(cost.get("n_queries", 1) or 1), 1.0)
    total = cost.get("total_cost")
    if total is None:
        flops = cost.get("total_flops")
        if flops is None:
            return None
        total = float(flops) * 1e-9
    return max(float(total) / n, 1e-9)
