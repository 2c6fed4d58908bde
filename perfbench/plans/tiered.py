"""The tiered pruned plan, ``EngineConfig(mode="tiered")``: the coarse
digest probe over the whole lake, its hits expanded to blocks and the rest
of the ``plan.survivors`` budget filled by profile distance; the fine probe
and proxy over the survivors down to ``plan.budget``; the quantized scan;
an over-fetch of 4k and the float32 re-rank of those.

The control is the same plan over an int4 sidecar (one precision below the
configuration's int8) with a bfloat16 re-rank (below float32)."""
import torch

from perfbench import bounds
from perfbench.reference import plain

LABEL = "local-tiered"
SIDE_BYTES = {"fp32": 4, "fp16": 2, "int8": 1}


def lake_kwargs(config: dict) -> dict:
    return {"n_coarse": int(config["engine"]["lsh"]["n_coarse_bands"])}


def answer(lake, model, qids, k: int, config: dict, pad: int, *, control: bool = False):
    """(scores, ids) of ``qids``, each (Q, k), the queries padded to ``pad``
    (the scheduler's top bucket) as a formed batch is."""
    n = qids.shape[0]
    qp = torch.cat([qids, qids[-1:].expand(pad - n)]) if n < pad else qids
    kw = dict(n_perm=int(config["n_perm"]), minhash_seed=int(config["minhash_seed"]),
              n_bands=int(config["engine"]["lsh"]["n_bands"]),
              survivors=int(config["plan"]["survivors"]), budget=int(config["plan"]["budget"]))
    if control:
        kw.update(bits=4, rerank=torch.bfloat16)
    sc, ids = plain.answer_tiered(lake, model, qp, k, **kw)
    return sc[:n], ids[:n]


def bound_s(q: int, n: int, config: dict, trees: int, depth: int) -> float:
    """The least seconds a padded batch of ``q`` over ``n`` columns needs,
    summed over the plan's stages."""
    eng, plan = config["engine"], config["plan"]
    k, t, d = int(eng["k"]), trees, depth
    s, m, r = int(plan["survivors"]), int(plan["budget"]), plain.RESCORE_MULT * k
    side = SIDE_BYTES[eng["profile_dtype"]]
    return (bounds.lsh_probe(q, n, int(eng["lsh"]["n_coarse_bands"]))     # coarse digest
            + bounds.proxy(q, n, side)                 # the fill's proxy
            + bounds.elementwise(q * n, 4 + 4 + 4)     # hits and proxy read, priority written
            + bounds.topk(q, n, s)                     # survivors
            + bounds.lsh_probe_indexed(q, s, int(eng["lsh"]["n_bands"]), q * s)
            + bounds.proxy(q, q * s, side)             # fine proxy over gathered rows
            + bounds.topk(q, s, m)                     # fine budget
            + bounds.fused_score(q, q * m, q * m, t, d, side)
            + bounds.topk(q, m, r)                     # over-fetch
            + bounds.fused_score(q, q * r, q * r, t, d)    # float32 re-rank
            + bounds.topk(q, r, k))
