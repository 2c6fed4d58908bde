"""Executor: runs a QueryPlan's candidate→score→merge pipeline on a corpus.

The port of ``repro.exec.executor.Executor`` for local plans. One
``Executor`` holds one immutable corpus view on its device — the profile
matrix (float32, or an int8/float16 sidecar with its per-feature dequant
scale), word hashes, table ids, optional LSH band keys and an optional
coarse super-band digest — plus the GBDT parameters, and executes the
``all``, ``lsh``, ``hybrid`` and ``tiered`` pipelines against it. Scoring
always goes through the fused scorers (``ops.fused_score`` and, over a
sidecar, ``ops.fused_score_q``): the hand-written kernels on the card.

With a quantized ``profile_dtype`` only the sidecar and its scale live on
the device; the float32 source stays on the host. The scan over-fetches
``RESCORE_MULT × k`` candidates and an exact float32 re-rank of those few
gathered rows restores the float32 top-k ordering, so returned scores are
float32-exact whatever the resident dtype.

The returned contract is the JAX package's: numpy ``(scores (Q, k), global
ids (Q, k), n_scored (Q,))``, padded with -inf / -1 when fewer than k
columns are rankable, with ``n_scored`` the number of columns the GBDT
actually scored per query.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.predictor import gbdt_to_torch
from repro_torch.device import hashes_to_torch, resolve_device, to_bits
from repro_torch.exec import stages
from repro_torch.exec.plan import QueryPlan
from repro_torch.kernels.profile_distance import dequantize, quantize_profiles

# quantized scans over-fetch this multiple of k, then an exact float32
# re-rank of the over-fetched set restores the float32 top-k ordering: GBDT
# scores are threshold-discontinuous, so even fp16's ~5e-4 profile error
# flips near-boundary ranks
RESCORE_MULT = 4


def _rescore_exact(zq, wq, zg, wg, gbdt_tuple, sc_scan, ids, k: int):
    """Re-rank an over-fetched (Q, R) candidate set with its exact float32
    rows ``zg``/``wg`` (Q, R, F); slots the scan left invalid (non-finite
    score) stay excluded. Returns (scores (Q, k'), ids (Q, k'))."""
    s = stages.score_columns(zq, wq, zg, wg, gbdt_tuple)
    s = torch.where(torch.isfinite(sc_scan), s, float("-inf"))
    sc, pos = stages.topk_stable(s, min(k, s.shape[1]))
    return sc, torch.where(torch.isfinite(sc), torch.gather(ids, 1, pos), -1)


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
    """Executes local query plans against one corpus view on ``device``.

    ``profile_dtype`` ("fp32", "fp16" or "int8") quantizes ``z`` into the
    resident sidecar; a caller that already quantized passes the sidecar as
    ``z`` and its scale as ``z_scale``. ``fp32_rows`` (``ids -> (..., F)
    float32``) overrides the host float32 source of the exact re-rank.
    """

    def __init__(self, z: np.ndarray, w: np.ndarray, gbdt_tuple, *,
                 table_ids: np.ndarray | None = None,
                 band_keys: np.ndarray | None = None,
                 coarse_keys: np.ndarray | None = None,
                 profile_dtype: str = "fp32", z_scale=None, fp32_rows=None,
                 survivor_block: int = 32, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.n_columns = int(z.shape[0])
        self.profile_dtype = str(profile_dtype)
        self.survivor_block = int(survivor_block)
        if z_scale is not None:
            z_res, scale = np.asarray(z), np.asarray(z_scale, np.float32)
            zf_host = None                   # pre-quantized: no float32 source
        else:
            z_res, scale = quantize_profiles(z, self.profile_dtype)
            zf_host = None if self.profile_dtype == "fp32" else np.asarray(z, np.float32)
        # the exact re-rank's row source: an explicit callable, the host
        # float32 copy of a quantized corpus, or None (the scan is exact)
        if fp32_rows is not None:
            self._fp32_rows = fp32_rows
        elif zf_host is not None:
            self._fp32_rows = zf_host.__getitem__
        else:
            self._fp32_rows = None
        self._gbdt = gbdt_to_torch(gbdt_tuple, dev)
        self._z = torch.from_numpy(z_res).to(dev)
        self._zscale = torch.from_numpy(scale).to(dev)
        self._w = hashes_to_torch(w, dev)
        tids = (np.asarray(table_ids, np.int32) if table_ids is not None
                else np.zeros((self.n_columns,), np.int32))
        self._tids = torch.from_numpy(tids.astype(np.int64)).to(dev)
        self._cids = torch.arange(self.n_columns, device=dev)
        # the probes test key equality only: the resident keys are int32
        # bit-views, built once, so no probe call converts the lake's keys
        self._ckeys = (to_bits(hashes_to_torch(band_keys, dev))
                       if band_keys is not None else None)
        self._coarse = (to_bits(hashes_to_torch(coarse_keys, dev))
                        if coarse_keys is not None else None)
        self._tls = threading.local()

    def execute(self, plan: QueryPlan, zq, wq, tq, qid, qkeys=None, qcoarse=None):
        """Run ``plan`` for a query batch.

        ``zq`` (Q, F_NUM) float32, ``wq`` (Q, F_WORDS) uint32; ``tq`` (Q,)
        table ids to exclude (-1 disables); ``qid`` (Q,) global column id
        of resident queries (-1 for external); ``qkeys`` (Q, B) uint32 LSH
        band keys, required by pruned plans; ``qcoarse`` (Q, S) super-band
        digest keys, required by tiered plans. Returns numpy
        ``(scores (Q, k), ids (Q, k), n_scored (Q,))``.
        """
        q = int(np.asarray(zq).shape[0])
        self._tls.tier_stats = None
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
        if plan.candidates == "tiered":
            if self._coarse is None:
                raise ValueError("plan 'tiered' needs a coarse super-band "
                                 "digest, but this executor has none")
            if qcoarse is None:
                raise ValueError("plan 'tiered' needs coarse query keys")
        dev = self.device
        zq = torch.from_numpy(np.asarray(zq, np.float32)).to(dev)
        wq = hashes_to_torch(wq, dev)
        tq = torch.from_numpy(np.asarray(tq, np.int64)).to(dev)
        qid = torch.from_numpy(np.asarray(qid, np.int64)).to(dev)
        spec = self._local_spec(plan)
        tier = None
        if plan.candidates == "all":
            sc, ids, n = self._local_all(zq, wq, tq, qid, **spec)
        elif plan.candidates == "tiered":
            sc, ids, n, *tier = self._local_tiered(
                zq, wq, to_bits(hashes_to_torch(qkeys, dev)),
                to_bits(hashes_to_torch(qcoarse, dev)), tq, qid, **spec)
        else:
            sc, ids, n = self._local_pruned(
                plan.candidates, zq, wq, to_bits(hashes_to_torch(qkeys, dev)), tq, qid,
                **spec)
        if self._fp32_rows is not None:
            sc, ids = self._rescore(zq, wq, sc, ids, plan.k)
        sc, ids = pad_topk(sc.cpu().numpy(), ids.to(torch.int32).cpu().numpy(),
                           plan.k)
        if tier is not None:              # (n_hits, n_survivors), read after the scan
            self._tls.tier_stats = tuple(t.to(torch.int32).cpu().numpy() for t in tier)
        return sc, ids, n.to(torch.int32).cpu().numpy()

    def last_tier_stats(self):
        """``(n_hits (Q,), n_survivors (Q,))`` of this thread's most recent
        ``execute`` if it ran a tiered plan, else None."""
        return getattr(self._tls, "tier_stats", None)

    def _local_spec(self, plan: QueryPlan) -> dict:
        """The k/budget clamps of the JAX executor's ``_local_spec``:
        quantized scans hand an over-fetched top set to the exact re-rank."""
        c = self.n_columns
        k = (plan.k if self._fp32_rows is None
             else max(plan.k, RESCORE_MULT * plan.k))
        if plan.candidates == "all":
            return dict(k=min(k, c))
        budget = min(plan.budget, c)
        if plan.candidates == "tiered":
            surv = min(max(plan.survivor_budget, budget), c)
            return dict(k=min(k, budget, surv), budget=min(budget, surv),
                        survivor_budget=surv)
        return dict(k=min(k, budget), budget=budget)

    def _score(self, zq, wq, pos=None):
        """Scores against the resident corpus, or its rows at ``pos``."""
        if pos is None:
            return stages.score_columns(zq, wq, self._z, self._w, self._gbdt,
                                        self._zscale)
        return stages.score_columns(zq, wq, self._z[pos], self._w[pos],
                                    self._gbdt, self._zscale)

    def _local_all(self, zq, wq, tq, qid, k: int):
        s = self._score(zq, wq)
        s = torch.where(stages.exclusion_mask(self._cids, self._tids, tq, qid),
                        float("-inf"), s)
        sc, ids = stages.merge_topk(s, self._cids, k)
        return sc, ids, stages.live_count(self._cids).expand(zq.shape[0])

    def _local_pruned(self, kind, zq, wq, qkeys, tq, qid, k: int, budget: int):
        zf = dequantize(self._z, self._zscale)
        prio = stages.candidate_priorities(kind, zq, qkeys, zf, self._ckeys,
                                           self._cids, self._tids, tq, qid)
        pos, valid = stages.gather_candidates(prio, budget)
        s = torch.where(valid, self._score(zq, wq, pos), float("-inf"))
        sc, ids = stages.merge_topk(s, self._cids[pos], k)
        return sc, ids, valid.sum(1)

    def _local_tiered(self, zq, wq, qkeys, qcoarse, tq, qid, k: int, budget: int,
                      survivor_budget: int):
        """Coarse digest scan over the whole lake, then the fine probe, the
        proxy and the scorer over the gathered survivors only. The proxy
        over the (dequantized) resident sidecar fills survivor slots the
        digest left empty with profile-nearest columns."""
        zf = dequantize(self._z, self._zscale)
        # -||zq - z||² up to a per-query constant: 2·zq@zᵀ - ||z||²
        fill = (2.0 * zq) @ zf.T - (zf * zf).sum(1)[None]
        pos, valid, n_hits, n_surv = stages.tiered_survivors(
            qcoarse, self._coarse, self._cids, self._tids, tq, qid,
            survivor_budget=survivor_budget, block_c=self.survivor_block, proxy=fill)
        # the fine probe reads the survivors' band keys in place through pos
        prio = stages.tiered_priorities(zq, qkeys, dequantize(self._z[pos], self._zscale),
                                        self._ckeys, valid, pos=pos)
        pos2, valid2 = stages.gather_candidates(prio, budget)
        gpos = torch.gather(pos, 1, pos2)                 # (Q, M) lake columns
        s = torch.where(valid2, self._score(zq, wq, gpos), float("-inf"))
        sc, ids = stages.merge_topk(s, self._cids[gpos], k)
        return sc, ids, valid2.sum(1), n_hits, n_surv

    def _rescore(self, zq, wq, sc, ids, k: int):
        """Gather the scan's (Q, R) candidates' float32 rows from the host
        source and re-rank them exactly with the fused kernel. R is a small
        multiple of k, so the cost does not grow with the lake."""
        safe = np.clip(ids.cpu().numpy(), 0, self.n_columns - 1)  # -1 -> row 0, masked
        zg = torch.from_numpy(np.asarray(self._fp32_rows(safe), np.float32)).to(self.device)
        wg = self._w[torch.from_numpy(safe).to(self.device)]
        return _rescore_exact(zq, wq, zg, wg, self._gbdt, sc, ids, k)
