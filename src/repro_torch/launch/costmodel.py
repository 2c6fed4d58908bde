"""Analytic cost of one discovery micro-batch, per pipeline stage.

The port of ``repro.launch.costmodel.discovery_stage_costs`` (the planner's
default cost hook) and ``plan_cost_per_query``. The calibration from
measured timings and the bucket-ladder helpers wait for the benchmarks.
"""
from __future__ import annotations

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
