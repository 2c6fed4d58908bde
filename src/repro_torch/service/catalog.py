"""Catalog ingest: profile and MinHash-sign a batch of columns on the device.

The port of ``repro.service.catalog.profile_and_sign``. The persistent
segment catalog (``CatalogStore``/``CatalogReader``) waits for the serving
slice; this is the ingest half the discovery query needs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.core.ingest import ColumnBatch
from repro_torch.core.profiles import compute_profiles_batch
from repro_torch.device import hashes_to_numpy, hashes_to_torch, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.minhash import make_permutations

_PROFILE_PAD_C = 8     # pad column counts as the JAX package does
CHUNK_COLUMNS = 16384   # columns profiled and signed per device step


def profile_and_sign(batch: ColumnBatch, n_perm: int, seed: int,
                     pad_c: int = _PROFILE_PAD_C, *, device=None,
                     chunk: int = CHUNK_COLUMNS):
    """Profile + MinHash a batch on ``device`` -> (numeric, words, sigs) numpy.

    Columns are padded to a multiple of ``pad_c`` and rows to the next
    power of two (at least 16) with sentinel cells, exactly as the JAX
    package pads them, so signatures and profiles agree with it bit for bit
    (words, signatures) or to float32 rounding (numeric). The batch is
    walked ``chunk`` columns at a time, so a 100k-column lake fits.
    """
    dev = resolve_device(device)
    c, r = batch.values32.shape
    cp = -(-c // pad_c) * pad_c
    rp = max(1 << (max(r, 1) - 1).bit_length(), 16)
    a_np, b_np = make_permutations(n_perm, seed)
    a, b = hashes_to_torch(a_np, dev), hashes_to_torch(b_np, dev)
    chunk = max(pad_c, chunk // pad_c * pad_c)
    nums, words, sigs = [], [], []
    for lo in range(0, cp, chunk):
        hi = min(lo + chunk, cp)
        n_real = max(0, min(hi, c) - lo)
        v = np.full((hi - lo, rp), FT.HASH_SENTINEL, np.uint32)
        cl = np.zeros((hi - lo, rp), np.float32)
        wc = np.zeros((hi - lo, rp), np.float32)
        nr = np.zeros((hi - lo,), np.int32)
        v[:n_real, :r] = batch.values32[lo:lo + n_real]
        cl[:n_real, :r] = batch.char_len[lo:lo + n_real]
        wc[:n_real, :r] = batch.word_cnt[lo:lo + n_real]
        nr[:n_real] = batch.n_rows[lo:lo + n_real]
        vt = hashes_to_torch(v, dev)
        num, wd = compute_profiles_batch(vt, torch.from_numpy(cl).to(dev),
                                         torch.from_numpy(wc).to(dev),
                                         torch.from_numpy(nr).to(dev))
        sg = ops.minhash(vt, a, b)
        nums.append(num[:n_real].cpu().numpy())
        words.append(hashes_to_numpy(wd[:n_real]))
        sigs.append(hashes_to_numpy(sg[:n_real]))
    if not nums:
        return (np.zeros((0, FT.F_NUM), np.float32),
                np.zeros((0, FT.F_WORDS), np.uint32),
                np.zeros((0, n_perm), np.uint32))
    return (np.concatenate(nums).astype(np.float32), np.concatenate(words),
            np.concatenate(sigs))
