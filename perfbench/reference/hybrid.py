"""The plain hybrid plan, ``EngineConfig(mode="lsh")``: the engine's default
candidate stage, in plain PyTorch.

Every column's full MinHash signature and its band keys are worked out
again from the kept value blocks; a query's LSH hits are the columns that
share any band key with it; every column's priority is its profile-space
proxy ``2·zq@zᵀ - ||z||²`` squashed by ``x / (1 + |x|)`` plus ``BOOST`` for
a hit; the query itself and its table's columns are excluded; the
top-``budget`` columns by priority (the float32 total order, the lower
index first among equal values, as ``jax.lax.top_k``) are scored exactly in
float32 and the top k of those returned.

It imports nothing of the program, of JAX or of the JAX package, and keeps
float32 products in full float32 (no TF32).
"""
from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import plain

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SIGN_BLOCK = 1 << 16             # columns signed a step


def budget(n: int, k: int, candidate_frac: float, max_candidates: int) -> int:
    """The planner's candidate budget over ``n`` columns."""
    return max(1, min(max(k, int(n * candidate_frac)), max_candidates, n))


def lake_bands(lake: plain.Lake, n_perm: int, seed: int, n_bands: int,
               block: int = SIGN_BLOCK) -> torch.Tensor:
    """(C, B) band keys of every column, from full ``n_perm`` signatures of
    the kept value blocks, ``block`` columns at a time."""
    a, b = plain.permutations(n_perm, seed)
    dev = lake.z.device
    a = torch.from_numpy(a.astype(np.int64)).to(dev)
    b = torch.from_numpy(b.astype(np.int64)).to(dev)
    return torch.cat([plain.band_keys(plain.minhash(v[s:s + block], a, b), n_bands)
                      for _, _, v in lake.values for s in range(0, v.shape[0], block)])


def priorities(lake: plain.Lake, bands: torch.Tensor, qids: torch.Tensor, zc):
    """(Q, C) float32 priorities of every column for each query; -inf where
    a column may not answer."""
    qz = zc[qids]
    proxy = (2.0 * qz) @ zc.T - (zc * zc).sum(1)[None]
    prio = proxy / (1.0 + torch.abs(proxy)) \
        + plain.probe(bands[qids], bands).to(torch.float32) * plain.BOOST
    return torch.where(plain.excluded(lake.cols, lake.tables, lake.tables[qids], qids),
                       float("-inf"), prio)


def answer_hybrid(lake: plain.Lake, model: plain.Ensemble, qids: torch.Tensor, k: int, *,
                  bands: torch.Tensor, budget: int, zc=None):
    """The hybrid plan for ``qids`` over profiles ``zc`` (the lake's float32
    profiles, or one precision lower for the control). Returns (scores
    (Q, k), ids (Q, k)) with -inf / -1 where fewer than k may answer."""
    zc = lake.z if zc is None else zc
    pv, pos = plain.topk(priorities(lake, bands, qids, zc), budget)
    s = plain.score(model, zc[qids], lake.words[qids], zc[pos], lake.words[pos])
    s = torch.where(torch.isfinite(pv), s, float("-inf"))
    sc, p = plain.topk(s, min(k, budget))
    return sc, torch.where(torch.isfinite(sc), torch.gather(pos, 1, p), -1)
