"""Batched column profiling in torch — the paper's "preparation phase".

The counterpart of ``repro.core.profiles``: where the JAX package vmaps a
per-column sort + run-length encoding + ``segment_sum`` + ``top_k``, this
module sorts every row of a (C, R) batch at once and scatter-adds the run
counts. Words match the JAX package exactly, including the top-10 slot
order: ``jax.lax.top_k`` breaks count ties by the lower run index (the
smaller hash), which a stable descending sort reproduces.

Input:  ``ColumnBatch`` arrays   (C, R) — see ``ingest.py``
Output: ``numeric`` (C, F_NUM) float32 and ``words`` (C, F_WORDS) hashes
        laid out per ``features.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.device import hashes_to_numpy, hashes_to_torch, resolve_device

_BIG = 3.4e38


@dataclasses.dataclass
class LakeProfiles:
    """Profiles for a set of columns + lake-wide normalization stats (numpy,
    the same layout as ``repro.core.profiles.LakeProfiles``)."""

    numeric: np.ndarray      # (C, F_NUM) float32 (raw, un-normalized)
    words: np.ndarray        # (C, F_WORDS) uint32
    n_rows: np.ndarray       # (C,) int32
    mean: np.ndarray         # (F_NUM,) float32 — lake-wide z-score stats
    std: np.ndarray          # (F_NUM,) float32

    @property
    def n_columns(self) -> int:
        return int(self.numeric.shape[0])

    @property
    def zscored(self) -> np.ndarray:
        return (self.numeric - self.mean) / self.std

    def zscored_view(self) -> "ZscoreView":
        """Lazy row-gather view of :attr:`zscored` — z-scores only the
        rows actually indexed, so a memmapped lake never materializes a
        lake-sized float32 matrix (the engine's quantized-sidecar path)."""
        return ZscoreView(self.numeric, self.mean, self.std)

    def nbytes(self) -> int:
        return self.numeric.nbytes + self.words.nbytes + self.n_rows.nbytes


class ZscoreView:
    """``(numeric[idx] - mean) / std`` computed per access.

    Indexing accepts anything ``numeric`` does — an int row, a slice, or a
    (possibly 2-D) fancy-index array — and always returns fresh float32; the
    backing ``numeric`` may be a read-only segment memmap, so reads page in
    only the touched rows. Duck-compatible with the float32 matrix the
    engine's eager path keeps (``shape`` / ``len`` / ``__getitem__``).
    """

    def __init__(self, numeric, mean, std):
        self.numeric = numeric
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    @property
    def shape(self) -> tuple:
        return tuple(self.numeric.shape)

    @property
    def dtype(self):
        return np.dtype(np.float32)

    def __len__(self) -> int:
        return int(self.numeric.shape[0])

    def __getitem__(self, idx) -> np.ndarray:
        return (np.asarray(self.numeric[idx], np.float32) - self.mean) / self.std


def _masked_stats(x, valid, nf):
    """Per-row (min, max, mean, sd) of ``x`` over ``valid`` positions."""
    mn = torch.where(valid, x, _BIG).amin(1)
    mx = torch.where(valid, x, -_BIG).amax(1)
    s = torch.where(valid, x, 0.0).sum(1)
    s2 = torch.where(valid, x * x, 0.0).sum(1)
    mean = s / nf
    var = torch.clamp(s2 / nf - mean * mean, min=0.0)
    return mn, mx, mean, torch.sqrt(var)


def compute_profiles_batch(values, char_len, word_cnt, n_rows):
    """(C, R) tensors -> ((C, F_NUM) float32, (C, F_WORDS) int64 hashes).

    ``values`` holds uint32 hashes in int64 with SENTINEL padding; all
    inputs lie on one device, which does the work.
    """
    c, r = values.shape
    dev = values.device
    idx = torch.arange(r, device=dev)
    n = n_rows.to(torch.int64)
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    has_rows = n > 0

    # ---- frequency distribution via sort + run-length encoding ----
    sv = torch.sort(values, dim=1).values       # sentinel sorts to the end
    is_valid = sv != FT.HASH_SENTINEL
    prev_differs = torch.ones_like(is_valid)
    prev_differs[:, 1:] = sv[:, 1:] != sv[:, :-1]
    is_start = is_valid & prev_differs
    run_id = torch.cumsum(is_start.to(torch.int64), dim=1) - 1
    card = is_start.sum(1)
    counts = torch.zeros((c, r), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, run_id.clamp(0, r - 1), is_valid.to(torch.float32))

    # value of each run (aligned with ``counts``)
    start_pos = torch.sort(torch.where(is_start, idx, r), dim=1).values
    kmask = idx[None, :] < card[:, None]
    run_vals = torch.where(kmask, torch.gather(sv, 1, start_pos.clamp(max=r - 1)),
                           FT.HASH_SENTINEL)

    cardf = torch.clamp(card.to(torch.float32), min=1.0)
    min_freq = torch.where(kmask, counts, _BIG).amin(1)
    max_freq = counts.amax(1)
    perc = counts / nf[:, None]
    max_perc = max_freq / nf
    mean_perc = torch.where(kmask, perc, 0.0).sum(1) / cardf
    dev2 = torch.where(kmask, (perc - mean_perc[:, None]) ** 2, 0.0)
    sd_perc = torch.sqrt(torch.clamp(dev2.sum(1) / cardf, min=0.0))
    plogp = torch.where(kmask & (counts > 0), perc * torch.log(perc), 0.0)
    entropy = -plogp.sum(1)

    # octiles of the frequency distribution (in fractions of rows): counts
    # sorted ascending has (r - card) padding zeros first
    scounts = torch.sort(counts, dim=1).values
    base = (r - card).to(torch.float32)
    octs = []
    for q in range(1, 8):
        pos = base + torch.tensor(q / 8.0, dtype=torch.float32) * (cardf - 1.0)
        lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, r - 1)
        hi = torch.clamp(lo + 1, 0, r - 1)
        w = pos - lo.to(torch.float32)
        s_lo = torch.gather(scounts, 1, lo[:, None])[:, 0]
        s_hi = torch.gather(scounts, 1, hi[:, None])[:, 0]
        octs.append(((1.0 - w) * s_lo + w * s_hi) / nf)

    # ---- top-10 frequent values + first-word proxy ----
    kk = min(FT.N_FREQ_WORDS, r)
    order = torch.sort(counts, dim=1, descending=True, stable=True)
    topc, topi = order.values[:, :kk], order.indices[:, :kk]
    freq_words = torch.where(topc > 0, torch.gather(run_vals, 1, topi),
                             FT.HASH_SENTINEL)
    if kk < FT.N_FREQ_WORDS:
        pad = torch.full((c, FT.N_FREQ_WORDS - kk), FT.HASH_SENTINEL,
                         dtype=torch.int64, device=dev)
        freq_words = torch.cat([freq_words, pad], dim=1)
    first_word = torch.where(has_rows, sv[:, 0], FT.HASH_SENTINEL)

    # ---- syntactic string stats ----
    valid_row = idx[None, :] < n[:, None]
    mn_c, mx_c, mean_c, _ = _masked_stats(char_len, valid_row, nf)
    mn_w, mx_w, mean_w, sd_w = _masked_stats(word_cnt, valid_row, nf)

    # heavy-tailed counts are stored log1p-transformed, as in the JAX package
    cardf_raw = card.to(torch.float32)
    cols = [
        torch.log1p(cardf_raw),            # CARDINALITY (log)
        cardf_raw / nf,                    # UNIQUENESS
        entropy,                           # ENTROPY
        torch.log1p(min_freq),             # MIN_FREQ (log)
        torch.log1p(max_freq),             # MAX_FREQ (log)
        max_perc,                          # MAX_PERC_FREQ
        sd_perc,                           # SD_PERC_FREQ
        *octs,                             # OCTILES
        mx_c, mn_c, mean_c,                # LONGEST / SHORTEST / AVG_STR
        mean_w, mn_w, mx_w, sd_w,          # AVG / MIN / MAX / SD_WORDS
    ]
    numeric = torch.where(has_rows[:, None], torch.stack(cols, dim=1), 0.0)
    words = torch.cat([freq_words, first_word[:, None]], dim=1)
    return numeric, words


def profile_lake(batch, *, chunk: int = 4096, device=None) -> LakeProfiles:
    """Profile a ColumnBatch on ``device`` (chunked over columns)."""
    dev = resolve_device(device)
    nums, words = [], []
    c = batch.n_columns
    for i in range(0, c, chunk):
        nb, wb = compute_profiles_batch(
            hashes_to_torch(batch.values32[i:i + chunk], dev),
            torch.from_numpy(batch.char_len[i:i + chunk]).to(dev),
            torch.from_numpy(batch.word_cnt[i:i + chunk]).to(dev),
            torch.from_numpy(batch.n_rows[i:i + chunk]).to(dev))
        nums.append(nb.cpu().numpy())
        words.append(hashes_to_numpy(wb))
    return lake_profiles(np.concatenate(nums) if nums else np.zeros((0, FT.F_NUM), np.float32),
                         np.concatenate(words) if words else np.zeros((0, FT.F_WORDS), np.uint32),
                         batch.n_rows)


def lake_profiles(numeric: np.ndarray, words: np.ndarray,
                  n_rows: np.ndarray) -> LakeProfiles:
    """LakeProfiles with lake-wide z-score stats over ``numeric``."""
    c = numeric.shape[0]
    mean = numeric.mean(axis=0) if c else np.zeros((FT.F_NUM,), np.float32)
    std = numeric.std(axis=0) if c else np.ones((FT.F_NUM,), np.float32)
    std = np.where(std < 1e-6, 1.0, std).astype(np.float32)
    return LakeProfiles(numeric=numeric.astype(np.float32), words=words,
                        n_rows=np.asarray(n_rows).copy(),
                        mean=mean.astype(np.float32), std=std)
