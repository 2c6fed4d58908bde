"""Executor: runs a QueryPlan's candidate→score→merge pipeline on a corpus.

The port of ``repro.exec.executor.Executor`` for local plans over fp32
profiles. One ``Executor`` holds one immutable corpus view on its device —
z-scored profiles, word hashes, table ids and optional LSH band keys — plus
the GBDT parameters, and executes the ``all``, ``lsh`` and ``hybrid``
pipelines against it. Scoring always goes through the fused scorer
(``ops.fused_score``): the hand-written kernel on the card.

The returned contract is the JAX package's: numpy ``(scores (Q, k), global
ids (Q, k), n_scored (Q,))``, padded with -inf / -1 when fewer than k
columns are rankable, with ``n_scored`` the number of columns the GBDT
actually scored per query.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictor import gbdt_to_torch
from repro_torch.exec import stages
from repro_torch.exec.plan import QueryPlan
from repro_torch.device import hashes_to_torch, resolve_device


def pad_rows(arrays, multiple: int):
    """Pad every array's leading (query) axis up to a multiple of
    ``multiple`` by repeating the last row — the repeated rows carry their
    qid/tq along, so masking stays consistent, and the caller slices the
    duplicate results back off. Returns (padded_arrays, original_length)."""
    q = int(np.asarray(arrays[0]).shape[0])
    pad = -(-q // max(multiple, 1)) * max(multiple, 1)
    if pad == q:
        return [np.asarray(a) for a in arrays], q
    rep = lambda a: np.concatenate(
        [np.asarray(a), np.repeat(np.asarray(a)[-1:], pad - q, axis=0)])
    return [rep(a) for a in arrays], q


def pad_topk(scores: np.ndarray, ids: np.ndarray, k: int):
    """Pad (Q, k_eff) top-k results out to k columns (-inf scores, -1 ids)."""
    k_eff = scores.shape[1]
    if k_eff >= k:
        return scores[:, :k], ids[:, :k]
    pad = ((0, 0), (0, k - k_eff))
    return (np.pad(scores, pad, constant_values=-np.inf),
            np.pad(ids, pad, constant_values=-1))


class Executor:
    """Executes local query plans against one corpus view on ``device``."""

    def __init__(self, z: np.ndarray, w: np.ndarray, gbdt_tuple, *,
                 table_ids: np.ndarray | None = None,
                 band_keys: np.ndarray | None = None, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.n_columns = int(z.shape[0])
        self._gbdt = gbdt_to_torch(gbdt_tuple, dev)
        self._z = torch.from_numpy(np.asarray(z, np.float32)).to(dev)
        self._w = hashes_to_torch(w, dev)
        tids = (np.asarray(table_ids, np.int32) if table_ids is not None
                else np.zeros((self.n_columns,), np.int32))
        self._tids = torch.from_numpy(tids.astype(np.int64)).to(dev)
        self._cids = torch.arange(self.n_columns, device=dev)
        self._ckeys = (hashes_to_torch(band_keys, dev)
                       if band_keys is not None else None)

    def execute(self, plan: QueryPlan, zq, wq, tq, qid, qkeys=None):
        """Run ``plan`` for a query batch.

        ``zq`` (Q, F_NUM) float32, ``wq`` (Q, F_WORDS) uint32; ``tq`` (Q,)
        table ids to exclude (-1 disables); ``qid`` (Q,) global column id
        of resident queries (-1 for external); ``qkeys`` (Q, B) uint32 LSH
        band keys, required by pruned plans. Returns numpy
        ``(scores (Q, k), ids (Q, k), n_scored (Q,))``.
        """
        q = int(np.asarray(zq).shape[0])
        if self.n_columns == 0 or q == 0:
            return (np.full((q, plan.k), -np.inf, np.float32),
                    np.full((q, plan.k), -1, np.int32),
                    np.zeros((q,), np.int32))
        if plan.candidates != "all":
            if self._ckeys is None:
                raise ValueError(f"plan {plan.kind!r} needs LSH band keys, "
                                 f"but this executor has none")
            if qkeys is None:
                raise ValueError(f"plan {plan.kind!r} needs query band keys")
        dev = self.device
        zq = torch.from_numpy(np.asarray(zq, np.float32)).to(dev)
        wq = hashes_to_torch(wq, dev)
        tq = torch.from_numpy(np.asarray(tq, np.int64)).to(dev)
        qid = torch.from_numpy(np.asarray(qid, np.int64)).to(dev)
        if plan.candidates == "all":
            sc, ids, n = self._local_all(zq, wq, tq, qid, min(plan.k, self.n_columns))
        else:
            budget = min(plan.budget, self.n_columns)
            sc, ids, n = self._local_pruned(
                plan.candidates, zq, wq, hashes_to_torch(qkeys, dev), tq, qid,
                min(plan.k, budget), budget)
        sc, ids = pad_topk(sc.cpu().numpy(), ids.to(torch.int32).cpu().numpy(),
                           plan.k)
        return sc, ids, n.to(torch.int32).cpu().numpy()

    def _local_all(self, zq, wq, tq, qid, k: int):
        s = stages.score_columns(zq, wq, self._z, self._w, self._gbdt)
        s = torch.where(stages.exclusion_mask(self._cids, self._tids, tq, qid),
                        float("-inf"), s)
        sc, ids = stages.merge_topk(s, self._cids, k)
        return sc, ids, stages.live_count(self._cids).expand(zq.shape[0])

    def _local_pruned(self, kind, zq, wq, qkeys, tq, qid, k: int, budget: int):
        prio = stages.candidate_priorities(kind, zq, qkeys, self._z, self._ckeys,
                                           self._cids, self._tids, tq, qid)
        pos, valid = stages.gather_candidates(prio, budget)
        s = stages.score_columns(zq, wq, self._z[pos], self._w[pos], self._gbdt)
        s = torch.where(valid, s, float("-inf"))
        sc, ids = stages.merge_topk(s, self._cids[pos], k)
        return sc, ids, valid.sum(1)
