"""Offline ingest: raw columns -> fixed-width tensors + exact sketches.

A numpy copy of ``repro.core.ingest`` (``hash64`` and ``fold32`` are
bit-identical). This is the analogue of the paper's "offline processing
phase" (DuckDB in the Java implementation). Device kernels cannot process
variable-length strings, so ingest converts every cell into

* a **64-bit stable hash** of its string form (equality-preserving — an
  equi-join only needs value identity),
* its **character length** and **word count** (the syntactic profile
  features of Table II),
* a validity bit (nulls / missing cells).

Per column we additionally build an exact **sketch**: the sorted distinct
64-bit hashes and their counts. Sketches power the exact multiset-Jaccard
path (ground-truth labels + the "exact metric" baseline the paper says is
infeasible at lake scale — we implement it anyway as the comparison point).

On the device we use the folded 32-bit hash (hi ^ lo); the exact/label path
keeps the full 64 bits in numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import features as FT

_FNV64_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV64_PRIME = np.uint64(0x100000001B3)
_MIX = np.uint64(0xBF58476D1CE4E5B9)


def hash64(s: str) -> np.uint64:
    """Stable FNV-1a 64-bit hash with a splitmix finalizer."""
    h = _FNV64_OFFSET
    for b in s.encode("utf-8"):
        h = np.uint64((int(h) ^ b) * int(_FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF)
    # splitmix-style avalanche
    z = int(h)
    z = (z ^ (z >> 30)) * int(_MIX) & 0xFFFFFFFFFFFFFFFF
    z = (z ^ (z >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
    return np.uint64(z ^ (z >> 31))


def fold32(h64: np.ndarray) -> np.ndarray:
    """Fold uint64 hashes to the uint32 space used on-device."""
    h = (h64 >> np.uint64(32)) ^ (h64 & np.uint64(0xFFFFFFFF))
    h = h.astype(np.uint32)
    # keep the sentinel exact: remap real 0xFFFFFFFF
    return np.where(h == np.uint32(FT.HASH_SENTINEL), np.uint32(FT.HASH_SENTINEL - 1), h)


@dataclasses.dataclass
class ColumnSketch:
    """Exact distinct-value sketch (numpy, offline only)."""

    values: np.ndarray   # (k,) uint64, sorted ascending
    counts: np.ndarray   # (k,) int64
    n_rows: int          # multiset size |A| (valid rows)

    @property
    def cardinality(self) -> int:
        return int(self.values.shape[0])


@dataclasses.dataclass
class ColumnBatch:
    """A batch of columns as fixed-width device-ready tensors.

    All arrays are padded to the same row budget ``R``; ``n_rows`` holds the
    true number of valid rows per column. Hash padding uses
    ``features.HASH_SENTINEL``.
    """

    values32: np.ndarray   # (C, R) uint32
    char_len: np.ndarray   # (C, R) float32
    word_cnt: np.ndarray   # (C, R) float32
    n_rows: np.ndarray     # (C,)  int32
    names: list[str]
    table_ids: np.ndarray  # (C,) int32 — owning dataset

    @property
    def n_columns(self) -> int:
        return int(self.values32.shape[0])

    @property
    def row_budget(self) -> int:
        return int(self.values32.shape[1])


def sketch_from_hashes(h64: np.ndarray) -> ColumnSketch:
    vals, counts = np.unique(h64, return_counts=True)
    return ColumnSketch(values=vals, counts=counts.astype(np.int64), n_rows=int(h64.shape[0]))


def ingest_string_columns(
    columns: Sequence[tuple[str, Iterable[str | None]]],
    *,
    row_budget: int | None = None,
    table_ids: Sequence[int] | None = None,
) -> tuple[ColumnBatch, list[ColumnSketch]]:
    """Ingest raw string columns (the quickstart / CSV path)."""
    names, all_h64, all_cl, all_wc = [], [], [], []
    for name, cells in columns:
        h64, cl, wc = [], [], []
        for cell in cells:
            if cell is None or (isinstance(cell, float) and np.isnan(cell)):
                continue
            s = str(cell).strip()
            if not s:
                continue
            h64.append(hash64(s))
            cl.append(len(s))
            wc.append(max(1, len(s.split())))
        names.append(name)
        all_h64.append(np.asarray(h64, dtype=np.uint64))
        all_cl.append(np.asarray(cl, dtype=np.float32))
        all_wc.append(np.asarray(wc, dtype=np.float32))
    return pack_columns(names, all_h64, all_cl, all_wc, row_budget=row_budget, table_ids=table_ids)


def pack_columns(
    names: list[str],
    h64_list: list[np.ndarray],
    char_len_list: list[np.ndarray],
    word_cnt_list: list[np.ndarray],
    *,
    row_budget: int | None = None,
    table_ids: Sequence[int] | None = None,
) -> tuple[ColumnBatch, list[ColumnSketch]]:
    """Pack per-column ragged arrays into a padded ColumnBatch + sketches."""
    c = len(names)
    max_rows = max((int(h.shape[0]) for h in h64_list), default=1)
    budget = int(row_budget or max_rows)
    budget = max(budget, 1)

    values32 = np.full((c, budget), FT.HASH_SENTINEL, dtype=np.uint32)
    char_len = np.zeros((c, budget), dtype=np.float32)
    word_cnt = np.zeros((c, budget), dtype=np.float32)
    n_rows = np.zeros((c,), dtype=np.int32)
    sketches: list[ColumnSketch] = []

    for i, h64 in enumerate(h64_list):
        n = min(int(h64.shape[0]), budget)
        if int(h64.shape[0]) > budget:
            # deterministic row subsample when a column exceeds the budget
            rng = np.random.default_rng(0xF0E1 + i)
            idx = np.sort(rng.choice(h64.shape[0], size=budget, replace=False))
            h64 = h64[idx]
            char_len_list[i] = char_len_list[i][idx]
            word_cnt_list[i] = word_cnt_list[i][idx]
        values32[i, :n] = fold32(h64[:n])
        char_len[i, :n] = char_len_list[i][:n]
        word_cnt[i, :n] = word_cnt_list[i][:n]
        n_rows[i] = n
        sketches.append(sketch_from_hashes(h64[:n]))

    tids = np.asarray(table_ids if table_ids is not None else np.zeros((c,)), dtype=np.int32)
    batch = ColumnBatch(values32=values32, char_len=char_len, word_cnt=word_cnt,
                        n_rows=n_rows, names=names, table_ids=tids)
    return batch, sketches


def concat_batches(batches: Sequence[ColumnBatch]) -> ColumnBatch:
    budget = max(b.row_budget for b in batches)

    def pad(a, fill):
        return np.pad(a, ((0, 0), (0, budget - a.shape[1])), constant_values=fill)

    return ColumnBatch(
        values32=np.concatenate([pad(b.values32, FT.HASH_SENTINEL) for b in batches]),
        char_len=np.concatenate([pad(b.char_len, 0) for b in batches]),
        word_cnt=np.concatenate([pad(b.word_cnt, 0) for b in batches]),
        n_rows=np.concatenate([b.n_rows for b in batches]),
        names=sum((b.names for b in batches), []),
        table_ids=np.concatenate([b.table_ids for b in batches]),
    )
