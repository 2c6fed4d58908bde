"""Composable pipeline stages: candidate generation, scoring, top-k merge.

The port of ``repro.exec.stages``. Every discovery query is
the same three-stage pipeline over the resident corpus:

1. **candidates** — ``all`` (every live column), ``lsh`` (banded-MinHash
   bucket probe, ``kernels/csrc/lsh_probe.cu``), ``hybrid`` (LSH hits
   ranked first, the remaining budget filled by profile-space proximity)
   or ``tiered`` (a coarse digest probe over the whole lake picks survivor
   blocks, then the fine probe ``kernels/csrc/lsh_probe_gathered.cu``,
   reading the survivors' band keys in place, and the proxy rank only the
   survivors);
2. **score** — distance features + GBDT over the surviving columns, in the
   fused kernel ``kernels/csrc/fused_score.cu`` (``fused_score_q.cu`` for
   an int8 or float16 sidecar);
3. **merge** — top-k; on a device grid (``exec/sharded.py``) the two-phase
   merge of :func:`merge_topk_sharded` and :func:`assemble_query_shards`.

Top-k order. ``jax.lax.top_k`` orders by the float32 total order (-0.0
below +0.0, NaNs by their bits at either end) and puts the lower index
first among equal values; the ``lsh`` stage gives every hit the same
priority, so tie order decides which columns fill the budget.
``torch.topk`` promises no tie order, so every top-k here goes through
:func:`topk_stable`, which keeps that order exactly: ``ops.topk``, the
exact top-k kernel ``kernels/csrc/topk.cu`` on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.exec import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.ref import LSH_PRIORITY_BOOST as _LSH_PRIORITY_BOOST
from repro_torch.kernels.ref import exclusion_mask

CANDIDATE_KINDS = ("all", "lsh", "hybrid", "tiered")

# The hybrid proxy is a float32 matrix product. TF32 would keep ~3 decimal
# digits and could change which columns fill the candidate budget, so the
# port keeps float32 products in full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False


def topk_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row of float32 ``x``
    (R, N) — ``jax.lax.top_k(x, k)``: the float32 total order, the lower
    index first among equal bit patterns. The values are ``x``'s own,
    gathered (their bits and their autograd kept)."""
    pos = ops.topk(x, k)
    return x.gather(1, pos), pos


def live_count(cids: torch.Tensor) -> torch.Tensor:
    """Number of live (non-padding) columns on the corpus axis."""
    return (cids >= 0).sum()


def candidate_priorities(kind: str, zq, qkeys, z, ckeys, cids, tids, tq, qid, *,
                         stage=tracing.NULL.stage):
    """(Q, C) float32 priorities; -inf means "never a candidate".

    ``lsh`` — bucket hits only; ``hybrid`` — hits first, then nearest
    columns in z-scored profile space via one matrix product (squared L2 up
    to a per-query constant). ``stage(name)`` opens each step's span:
    ``probe`` (the band probe) and ``priority`` (the proxy, its squash, the
    hits' boost and the exclusion).
    """
    if kind not in ("lsh", "hybrid"):
        raise ValueError(f"unknown candidate kind {kind!r}; want lsh or hybrid")
    with stage("probe"):
        hit = ops.lsh_probe(qkeys, ckeys)
    with stage("priority"):
        if kind == "lsh":
            prio = torch.where(hit > 0, 0.0, float("-inf"))
        else:
            # -||zq - z||² up to a per-query constant: 2·zq@zᵀ - ||z||²
            proxy = (2.0 * zq) @ z.T - (z * z).sum(1)[None]
            proxy = proxy / (1.0 + torch.abs(proxy))            # squash to (-1, 1)
            prio = hit.to(torch.float32) * _LSH_PRIORITY_BOOST + proxy
        return torch.where(exclusion_mask(cids, tids, tq, qid), float("-inf"), prio)


def budget_hits(kind: str, pval):
    """The budget slots an LSH hit filled, summed over the batch (a 0-d
    tensor), from the selected priorities ``pval`` (Q, M): a ``hybrid``
    hit's priority lies above the squashed proxy's ceiling of 1, and every
    finite ``lsh`` slot is a hit."""
    return (pval > 1.0 if kind == "hybrid" else torch.isfinite(pval)).sum()


def tiered_survivors(qcoarse, coarse, cids, tids, tq, qid, *,
                     survivor_budget: int, block_c: int = 32, proxy=None,
                     stage=tracing.NULL.stage):
    """Coarse pass of the tiered stage: pick survivor blocks.

    Probes the (C, S) super-band digest with the (Q, S) coarse query keys,
    expands column hits to blocks of ``block_c`` contiguous columns and keeps
    up to ``survivor_budget`` columns per query, direct hits above their
    block-mates. ``proxy`` (Q, C), when given, fills the slots the digest
    left empty with the proxy-nearest columns, strictly below every digest
    hit and its block.

    Returns ``(pos, valid, n_hits, n_survivors)``: gather positions (Q, M'),
    their validity, and per query the direct coarse hits and the
    digest-eligible survivor columns (proxy fill does not count).
    ``stage(name)`` opens each step's span (``probe``, ``priority``,
    ``select``; :meth:`repro_torch.exec.tracing.Record.stage`). The priority
    and both counts are one pass (``ops.coarse_priority``: the kernel
    ``kernels/csrc/coarse_priority.cu`` on the card).
    """
    with stage("probe"):
        hit = ops.lsh_probe(qcoarse, coarse)                          # (Q, C)
    with stage("priority"):
        prio, n_hits, n_survivors = ops.coarse_priority(hit, proxy, cids, tids, tq, qid,
                                                        block_c)
    with stage("select"):
        pos, valid = gather_candidates(prio, survivor_budget)
    return pos, valid, n_hits, n_survivors


def tiered_priorities(zq, qkeys, zg, keys, valid, pos=None):
    """Fine pass of the tiered stage over gathered survivors: ``zg``
    (Q, M', F_NUM) float32 profiles of each query's survivors, and their
    fine band keys, either gathered, ``keys`` (Q, M', B), or read in place
    from the resident (N, B) table ``keys`` through the survivors' positions
    ``pos`` (Q, M'). The gathered probe plus the per-query proxy rank them
    as the hybrid stage ranks the lake. Returns (Q, M') priorities, -inf on
    invalid slots."""
    hit = ops.lsh_probe_gathered(qkeys, keys, pos)
    proxy = 2.0 * torch.einsum("qf,qmf->qm", zq, zg) - (zg * zg).sum(-1)
    proxy = proxy / (1.0 + torch.abs(proxy))
    prio = hit.to(torch.float32) * _LSH_PRIORITY_BOOST + proxy
    return torch.where(valid, prio, float("-inf"))


def gather_candidates(prio, budget: int):
    """Top-``budget`` columns by priority -> (positions (Q, M), valid (Q, M));
    invalid slots (priority -inf) are budget the scorer must ignore."""
    pval, pos = topk_stable(prio, budget)
    return pos, torch.isfinite(pval)


def score_columns(zq, wq, zc, wc, gbdt_tuple, scale=None):
    """GBDT join-quality scores. zc/wc (C, F) -> (Q, C); (Q, M, F) gathered
    candidates score per-query sets. A float32 ``zc`` goes to the fused
    kernel, an int8 or float16 sidecar (with its ``scale``) to the quantized
    one, on the card (where the JAX executor scores with a jnp mirror of
    its Pallas kernel over the dequantized profiles)."""
    if zc.dtype == torch.float32:
        return ops.fused_score(zq, wq, zc, wc, gbdt_tuple)
    return ops.fused_score_q(zq, wq, zc, scale, wc, gbdt_tuple)


def merge_topk(scores, cids, k: int):
    """Local top-k -> (scores (Q, k'), global ids (Q, k')), k' = min(k, C).

    ``cids`` is (C,) for a shared corpus axis or (Q, C) for per-query
    gathered candidate sets. Non-finite slots come back with id -1."""
    kl = min(k, scores.shape[1])
    sc, pos = topk_stable(scores, kl)
    if cids.dim() == 1:
        cids = cids[None].expand(scores.shape[0], -1)
    ids = torch.gather(cids, 1, pos)
    return sc, torch.where(torch.isfinite(sc), ids, -1)


def gather_order(axis_sizes) -> list[int]:
    """Flat shard indices (row-major over mesh axes of ``axis_sizes``) in
    the order JAX's per-axis tiled ``all_gather``s concatenate them: the
    first axis gathers innermost, so over ("pod", "data") the order is
    data-major, not the flat shard index. Exact ties then resolve as
    ``jax.lax.top_k`` resolves them over the gathered union."""
    sizes = tuple(int(s) for s in axis_sizes)
    idx = np.arange(int(np.prod(sizes, dtype=np.int64))).reshape(sizes)
    return [int(i) for i in idx.transpose(tuple(reversed(range(len(sizes))))).reshape(-1)]


def merge_topk_sharded(tiles, k: int, axis_sizes, device):
    """Phase 1 of the grid merge: one query shard's per-data-shard results
    -> its global top-k on ``device``.

    ``tiles`` holds one ``(scores (Q_l, k_l), ids (Q_l, k_l), n_scored
    (Q_l,))`` per data shard, by flat shard index over the data axes of
    ``axis_sizes``. The (Q_l, k_l) pairs move to ``device`` (a peer copy
    between cards, O(Q_l·k·d_shards) bytes), concatenate in the gather
    order and are ranked once more. ``n_scored`` sums over the data shards
    only. Returns (scores (Q_l, k'), ids (Q_l, k'), n_scored (Q_l,))."""
    parts = [tiles[i] for i in gather_order(axis_sizes)]
    s = torch.cat([p[0].to(device, non_blocking=True) for p in parts], 1)
    i = torch.cat([p[1].to(device, non_blocking=True) for p in parts], 1)
    n = sum(p[2].to(device, non_blocking=True) for p in parts)
    gs, gp = topk_stable(s, min(k, s.shape[1]))
    gi = torch.gather(i, 1, gp)
    return gs, torch.where(torch.isfinite(gs), gi, -1), n


def assemble_query_shards(rows, axis_sizes, device):
    """Phase 2 of the grid merge: reassemble the query batch on ``device``.

    ``rows`` holds each query shard's finished ``(scores, ids, n_scored)``
    by flat shard index over the query axes of ``axis_sizes``; they
    concatenate along the batch axis in the gather order (batch order for
    one query axis), O(Q·k) bytes whatever the lake size."""
    parts = [rows[i] for i in gather_order(axis_sizes)]
    return tuple(torch.cat([p[j].to(device, non_blocking=True) for p in parts], 0)
                 for j in range(3))
