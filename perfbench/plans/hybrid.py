"""The hybrid pruned plan, ``EngineConfig(mode="lsh")``, the engine's
default: the 64-band LSH probe over the whole lake, every column ranked by
its hits and its profile-space proxy, the top ``budget`` of them scored by
the float32 fused scorer, the top k.

The budget is the planner's: ``max(k, int(n · candidate_frac))``, capped by
``max_candidates`` and the lake (``EngineConfig``'s defaults unless the
configuration's ``engine`` states them), so the check holds at any lake
size. The control is the same plan over bfloat16 profiles, one precision
below the float32 the configuration states."""
import torch

from perfbench import bounds
from perfbench.reference import hybrid

LABEL = "local-hybrid"
CANDIDATE_FRAC, MAX_CANDIDATES = 0.2, 4096       # EngineConfig's defaults
SIDE_BYTES = {"fp32": 4, "fp16": 2, "int8": 1}


def lake_kwargs(config: dict) -> dict:
    """The value blocks kept (``build_lake`` keeps them with a coarse
    digest), for the full signatures the band keys need."""
    return {"n_coarse": int(config["engine"]["lsh"]["n_coarse_bands"])}


def candidate_budget(n: int, config: dict) -> int:
    eng = config["engine"]
    return hybrid.budget(n, int(eng["k"]), float(eng.get("candidate_frac", CANDIDATE_FRAC)),
                         int(eng.get("max_candidates", MAX_CANDIDATES)))


def answer(lake, model, qids, k: int, config: dict, pad: int, *, control: bool = False):
    """(scores, ids) of ``qids``, each (Q, k), the queries padded to ``pad``
    (the scheduler's top bucket) as a formed batch is. The lake's band keys
    are worked out on the first call and kept on it."""
    if getattr(lake, "bands", None) is None:
        lake.bands = hybrid.lake_bands(lake, int(config["n_perm"]), int(config["minhash_seed"]),
                                       int(config["engine"]["lsh"]["n_bands"]))
    n = qids.shape[0]
    qp = torch.cat([qids, qids[-1:].expand(pad - n)]) if n < pad else qids
    zc = lake.z.to(torch.bfloat16).to(torch.float32) if control else None
    sc, ids = hybrid.answer_hybrid(lake, model, qp, k, bands=lake.bands,
                                   budget=candidate_budget(lake.z.shape[0], config), zc=zc)
    return sc[:n], ids[:n]


def stage_bounds(q: int, n: int, config: dict, trees: int, depth: int) -> dict:
    """Seconds each stage of a padded batch of ``q`` over ``n`` columns
    needs, by the program's stage names. ``prune`` counts only what any
    implementation must do: the (C, B) band keys, the (C, 21) profiles and
    the int64 table ids read once, the (Q, budget) int64 positions written,
    a compare and an or per (query, column, band) and the proxy's
    2·21 + 2 float32 operations per (query, column); no (Q, C)
    intermediate is counted, so a fused stage cannot read over its bound."""
    eng = config["engine"]
    k, b, m = int(eng["k"]), int(eng["lsh"]["n_bands"]), candidate_budget(n, config)
    side = SIDE_BYTES[eng["profile_dtype"]]
    prune = bounds.bound_s(n * (b * 4 + bounds.F_NUM * side + 8) + q * m * 8,
                           q * n * (2 * bounds.F_NUM + 2), 2.0 * q * n * b)
    return {"prune": prune,
            "score": bounds.fused_score(q, q * m, q * m, trees, depth, side),
            "merge": bounds.topk(q, m, min(k, m))}


def bound_s(q: int, n: int, config: dict, trees: int, depth: int) -> float:
    """The least seconds a padded batch of ``q`` over ``n`` columns needs,
    summed over the plan's stages."""
    return sum(stage_bounds(q, n, config, trees, depth).values())
