"""Banded-MinHash LSH candidate generation over catalog signatures.

Classic banding: split each (P,)-permutation MinHash signature into B bands
of r = P/B rows, hash every band to a 32-bit bucket key, and call a column a
*candidate* for a query iff they share a bucket in at least one band. Two
columns with set Jaccard J collide with probability ``1 - (1 - J^r)^B``.

The keys are numpy FNV-1a, byte-identical with ``repro.service.lsh``
(including the clearance of the probe's padding sentinels and the fold of
the ``P % B`` trailing rows into the last band). The probe is the device
kernel ``kernels/csrc/lsh_probe.cu``: (Q, B) query keys against the
resident (C, B) catalog keys in one pass.

Two tiers live side by side: the fine (C, B) band keys, and a small (C, S)
coarse *super-band* digest (S single-row bands sampled evenly across the
permutations) that the tiered candidate stage scans first over the whole
lake to pick survivor blocks.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from repro_torch.device import hashes_to_torch, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.lsh_probe import PAD_CORPUS

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)

# geometries already warned about (``(n_perm, n_bands)`` pairs where the
# signature width does not divide evenly into bands)
_REMAINDER_WARNED: set[tuple[int, int]] = set()


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    n_bands: int = 64          # fine bands; rows per band = n_perm // n_bands
    n_coarse_bands: int = 16   # single-row super-bands for the coarse tier

    def rows_per_band(self, n_perm: int) -> int:
        r = n_perm // self.n_bands
        if r < 1:
            raise ValueError(
                f"n_bands={self.n_bands} exceeds signature width {n_perm}")
        return r


def _fold32(h: np.ndarray) -> np.ndarray:
    k = ((h >> np.uint64(32)) ^ (h & np.uint64(0xFFFFFFFF))).astype(np.uint32)
    return np.where(k >= PAD_CORPUS, k - np.uint32(7), k)


def band_keys(signatures: np.ndarray, n_bands: int) -> np.ndarray:
    """(C, P) uint32 MinHash signatures -> (C, B) uint32 bucket keys.

    FNV-1a over the r rows of each band, folded to 32 bits; keys are kept
    clear of the probe-kernel padding sentinels. When ``P % B != 0`` the
    ``P - B*r`` trailing permutation rows are folded into the *last* band
    (with a one-time warning) rather than silently discarded.
    """
    c, p = signatures.shape
    r = LSHConfig(n_bands=n_bands).rows_per_band(p)
    used = n_bands * r
    s = signatures[:, :used].reshape(c, n_bands, r).astype(np.uint64)
    h = np.full((c, n_bands), _FNV_OFFSET, np.uint64)
    for i in range(r):
        h = (h ^ s[:, :, i]) * _FNV_PRIME
    if p != used:
        key = (p, n_bands)
        if key not in _REMAINDER_WARNED:
            _REMAINDER_WARNED.add(key)
            warnings.warn(
                f"band_keys: signature width {p} does not divide into "
                f"{n_bands} bands of {r} rows; folding the {p - used} "
                f"trailing permutation rows into the last band",
                RuntimeWarning, stacklevel=2)
        tail = signatures[:, used:].astype(np.uint64)    # (C, p-used)
        for i in range(p - used):
            h[:, -1] = (h[:, -1] ^ tail[:, i]) * _FNV_PRIME
    return _fold32(h)


def coarse_band_keys(signatures: np.ndarray, n_coarse_bands: int) -> np.ndarray:
    """(C, P) signatures -> (C, S) single-row super-band digest keys.

    S evenly spaced permutation rows, each hashed on its own: a single-row
    band collides with probability J (the raw Jaccard), far more permissive
    than a fine band's J^r, so a small S already catches the pairs the fine
    tier would keep.
    """
    c, p = signatures.shape
    if n_coarse_bands > p:
        raise ValueError(
            f"n_coarse_bands={n_coarse_bands} exceeds signature width {p}")
    rows = (np.arange(n_coarse_bands) * p) // n_coarse_bands
    s = signatures[:, rows].astype(np.uint64)            # (C, S)
    return _fold32((_FNV_OFFSET ^ s) * _FNV_PRIME)


@dataclasses.dataclass
class LSHIndex:
    """Bucket keys for the resident catalog + the device probe: the fine
    (C, B) band keys and, when ``0 < S <= P``, the (C, S) coarse digest."""

    config: LSHConfig
    keys: np.ndarray                   # (C, B) uint32 fine band keys
    coarse: np.ndarray | None = None   # (C, S) uint32 super-band digest

    @classmethod
    def build(cls, signatures: np.ndarray, config: LSHConfig = LSHConfig()):
        coarse = None
        if 0 < config.n_coarse_bands <= signatures.shape[1]:
            coarse = coarse_band_keys(signatures, config.n_coarse_bands)
        return cls(config=config, keys=band_keys(signatures, config.n_bands),
                   coarse=coarse)

    @property
    def n_columns(self) -> int:
        return int(self.keys.shape[0])

    def extend(self, new_signatures: np.ndarray) -> "LSHIndex":
        """Index with ``new_signatures``'s rows appended — byte-identical to
        a fresh :meth:`build` over the concatenated signature matrix. Both
        key functions are pure per row (the remainder fold touches only each
        row's own trailing permutations), so an append-only ingest delta
        hashes only the new rows."""
        new_signatures = np.asarray(new_signatures)
        if new_signatures.shape[0] == 0:
            return self
        new_keys = band_keys(new_signatures, self.config.n_bands)
        coarse = self.coarse
        if coarse is not None:
            coarse = np.concatenate(
                [coarse, coarse_band_keys(new_signatures, self.config.n_coarse_bands)])
        return LSHIndex(config=self.config, keys=np.concatenate([self.keys, new_keys]),
                        coarse=coarse)

    def retract(self, keep_mask: np.ndarray) -> "LSHIndex":
        """Index restricted to the rows where ``keep_mask`` is True —
        byte-identical to a fresh :meth:`build` over the kept signatures."""
        keep = np.asarray(keep_mask, bool)
        if keep.shape != (self.n_columns,):
            raise ValueError(f"keep_mask shape {keep.shape} != ({self.n_columns},)")
        return LSHIndex(config=self.config, keys=self.keys[keep],
                        coarse=None if self.coarse is None else self.coarse[keep])

    def query_keys(self, signatures_q: np.ndarray) -> np.ndarray:
        return band_keys(signatures_q, self.config.n_bands)

    def coarse_query_keys(self, signatures_q: np.ndarray) -> np.ndarray:
        """(Q, P) query signatures -> (Q, S) super-band digest keys."""
        if self.coarse is None:
            raise ValueError("index was built without a coarse digest")
        return coarse_band_keys(signatures_q, self.config.n_coarse_bands)

    def hit_mask(self, qkeys: np.ndarray, *, device=None) -> torch.Tensor:
        """(Q, B) query keys -> (Q, C) int32 candidate mask on ``device``."""
        dev = resolve_device(device)
        return ops.lsh_probe(hashes_to_torch(qkeys, dev),
                             hashes_to_torch(self.keys, dev))

    def coarse_hit_mask(self, qkeys_coarse: np.ndarray, *, device=None) -> torch.Tensor:
        """(Q, S) coarse keys -> (Q, C) int32 survivor mask on ``device``."""
        if self.coarse is None:
            raise ValueError("index was built without a coarse digest")
        dev = resolve_device(device)
        return ops.lsh_probe(hashes_to_torch(qkeys_coarse, dev),
                             hashes_to_torch(self.coarse, dev))

    def candidate_fraction(self, qkeys: np.ndarray, *, device=None) -> float:
        """Mean fraction of the lake a query's candidate set covers."""
        m = self.hit_mask(qkeys, device=device).cpu().numpy()
        return float(m.mean()) if m.size else 0.0

    def coarse_fraction(self, qkeys_coarse: np.ndarray, *, device=None) -> float:
        """Mean fraction of the lake surviving the coarse pass."""
        m = self.coarse_hit_mask(qkeys_coarse, device=device).cpu().numpy()
        return float(m.mean()) if m.size else 0.0


def measure_tradeoff(signatures: np.ndarray, full_topk_ids: np.ndarray,
                     query_rows: np.ndarray, band_choices=(16, 32, 64, 128), *,
                     device=None):
    """Recall-vs-pruning curve: for each band count, the fraction of the
    brute-force top-k retained in the candidate set vs the fraction of the
    lake probed. ``query_rows`` indexes the querying columns; entries of
    ``full_topk_ids`` < 0 are padding."""
    out = []
    for nb in band_choices:
        if nb > signatures.shape[1]:
            continue
        idx = LSHIndex.build(signatures, LSHConfig(n_bands=nb))
        mask = idx.hit_mask(idx.keys[query_rows], device=device).cpu().numpy()
        hit, tot = 0, 0
        for qi, row in enumerate(full_topk_ids):
            valid = row[row >= 0]
            hit += int(mask[qi, valid].sum())
            tot += int(valid.size)
        out.append({"n_bands": nb,
                    "rows_per_band": signatures.shape[1] // nb,
                    "recall": hit / max(tot, 1),
                    "candidate_fraction": float(mask.mean())})
    return out
