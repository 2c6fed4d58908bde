"""Exact multiset / set intersections from column sketches.

The exact path labels the synthetic ground truth and validates the
predictor. Two implementations, as in ``repro.core.sketches``:

* numpy — :func:`intersections_np`, :func:`pair_metrics_np` and
  :func:`pack_sketches`, verbatim copies;
* torch batched (folded uint32 hashes held in int64, padded distinct
  arrays) — :func:`batch_exact_metrics`, all-pairs by a batched
  ``searchsorted`` + count gather.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.core.ingest import ColumnSketch, fold32

# elements of the (queries, corpus, K) probe intermediate one step may hold
_PROBE_ELEMS = 1 << 24


def intersections_np(a: ColumnSketch, b: ColumnSketch) -> tuple[int, int]:
    """(multiset intersection, set intersection) of two sketches."""
    common, ia, ib = np.intersect1d(a.values, b.values, assume_unique=True,
                                    return_indices=True)
    multi = int(np.minimum(a.counts[ia], b.counts[ib]).sum())
    return multi, int(common.shape[0])


def pair_metrics_np(a: ColumnSketch, b: ColumnSketch) -> dict:
    multi, inter_set = intersections_np(a, b)
    ca, cb = a.cardinality, b.cardinality
    j = multi / max(a.n_rows + b.n_rows, 1)
    k = min(ca, cb) / max(max(ca, cb), 1)
    jac = inter_set / max(ca + cb - inter_set, 1)
    cont = inter_set / max(ca, 1)
    return {"j_multi": j, "k": k, "jaccard": jac, "containment": cont,
            "inter_multi": multi, "inter_set": inter_set}


@dataclasses.dataclass
class PackedSketches:
    """Padded distinct-value arrays for device-side exact metrics.

    values: (C, K) uint32 sorted ascending with SENTINEL padding
    counts: (C, K) float32 (0 padding)
    card:   (C,) int32
    n_rows: (C,) int32
    """

    values: np.ndarray
    counts: np.ndarray
    card: np.ndarray
    n_rows: np.ndarray

    def nbytes(self) -> int:
        return self.values.nbytes + self.counts.nbytes + self.card.nbytes + self.n_rows.nbytes


def pack_sketches(sketches: list[ColumnSketch], k_max: int | None = None) -> PackedSketches:
    kcap = max((s.cardinality for s in sketches), default=1)
    # k must stay >= 1 even for empty lists / all-empty sketches / k_max=0:
    # zero-width value arrays crash the searchsorted probe downstream.
    k = int(kcap if k_max is None else k_max)
    k = max(k, 1)
    c = len(sketches)
    values = np.full((c, k), FT.HASH_SENTINEL, dtype=np.uint32)
    counts = np.zeros((c, k), dtype=np.float32)
    card = np.zeros((c,), dtype=np.int32)
    n_rows = np.zeros((c,), dtype=np.int32)
    for i, s in enumerate(sketches):
        v32 = fold32(s.values)
        order = np.argsort(v32, kind="stable")
        sv, sc = v32[order], s.counts[order].astype(np.float32)
        # fold32 can (rarely) merge two uint64 values; merge their counts
        uv, start = np.unique(sv, return_index=True)
        csum = np.add.reduceat(sc, start) if sv.size else np.zeros((0,), np.float32)
        kk = min(uv.shape[0], k)
        values[i, :kk] = uv[:kk]
        counts[i, :kk] = csum[:kk]
        card[i] = kk
        n_rows[i] = s.n_rows
    return PackedSketches(values=values, counts=counts, card=card, n_rows=n_rows)


def batch_exact_metrics(q_values, q_counts, q_card, q_rows,
                        c_values, c_counts, c_card, c_rows):
    """All-pairs exact metrics: queries (Q, K) × corpus (N, K) -> (Q, N) each.

    ``*_values`` are int64 tensors holding sorted uint32 hashes (SENTINEL
    padded), ``*_counts`` float32, ``*_card``/``*_rows`` integer. Returns a
    dict of (Q, N) float32 tensors: j_multi, k, jaccard, containment. The
    query axis is walked in steps that keep the (q, N, K) probe bounded.
    """
    n, kc = c_values.shape
    kq = q_values.shape[1]
    step = max(1, _PROBE_ELEMS // max(n * kq, 1))
    inter_multi, inter_set = [], []
    for lo in range(0, q_values.shape[0], step):
        va = q_values[lo:lo + step]                          # (q, Kq)
        qn = va.shape[0]
        # searchsorted of every query row into every corpus row: (N, q*Kq)
        probe = va.reshape(1, -1).expand(n, -1).contiguous()
        pos = torch.searchsorted(c_values, probe).clamp_(0, kc - 1)
        hit_v = torch.gather(c_values, 1, pos)
        hit_c = torch.gather(c_counts, 1, pos)
        match = (hit_v == probe) & (probe != FT.HASH_SENTINEL)
        ca = q_counts[lo:lo + step].reshape(1, -1)
        multi = torch.where(match, torch.minimum(ca, hit_c), 0.0)
        inter_multi.append(multi.reshape(n, qn, kq).sum(-1).T)
        inter_set.append(match.reshape(n, qn, kq).sum(-1).T.to(torch.int32))
    inter_multi = torch.cat(inter_multi)                      # (Q, N) f32
    inter_set = torch.cat(inter_set)                          # (Q, N) i32
    rows = (q_rows[:, None] + c_rows[None, :]).to(torch.float32)
    j = inter_multi / torch.clamp(rows, min=1.0)
    cf_a = torch.clamp(q_card.to(torch.float32), min=1.0)[:, None]
    cf_b = torch.clamp(c_card.to(torch.float32), min=1.0)[None, :]
    k = torch.minimum(cf_a, cf_b) / torch.maximum(cf_a, cf_b)
    inter_f = inter_set.to(torch.float32)
    union = torch.clamp(cf_a + cf_b - inter_f, min=1.0)
    return {"j_multi": j, "k": k, "jaccard": inter_f / union,
            "containment": inter_f / cf_a.expand_as(inter_f)}
