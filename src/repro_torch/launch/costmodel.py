"""Analytic cost of one discovery micro-batch, per pipeline stage.

The port of ``repro.launch.costmodel``: ``discovery_stage_costs`` (the
planner's default cost hook), ``plan_cost_per_query``, the calibration from
measured service-bench timings (``calibrate_stage_costs``,
``make_calibrated_cost_fn``) and the bucket ladders derived from them
(``derive_batch_buckets``, ``derive_column_buckets``). They read the JAX
package's ``BENCH_service.json`` layout; the port writes no benchmark
record of its own yet.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.core import features as FT

F4 = 4          # bytes of a float32 or a uint32


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
