"""The plain reference: FREYJA's query path in plain PyTorch and NumPy.

It works out again everything the program's set-up derives from the
generated lake and the frozen model: the column profiles (numeric and the
top-10 / first-word hashes), the lake-wide z-score statistics, the MinHash
signatures, the fine band and coarse digest keys, the int8 sidecar; and then
answers a set of query columns by the plan the configuration states:

* ``all`` (``mode="full"``): every live column scored in float32,
  same-table and self columns excluded, the top k;
* ``tiered``: the coarse digest probe over the whole lake, its hits
  expanded to blocks of 32 columns and the rest of the survivor budget
  filled by profile distance, the fine probe and proxy over the survivors,
  the quantized scan, an over-fetch of 4k and the float32 re-rank of those.

Its arithmetic follows the published method and, where a float32 result
depends on the order, the order the paper's kernels state (the ensemble
summed from its base in tree order, word overlap ``count / 10``). It imports
nothing of the program, of JAX or of the JAX package. Hashes are int64
tensors holding uint32 values.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SENTINEL = 0xFFFFFFFF
M32 = 0xFFFFFFFF
F_NUM, N_WORDS, F_WORDS = 21, 10, 11
FIRST_WORD = 10
PAD_CORPUS = 0xFFFFFFFE
PROFILE_CHUNK = 16384            # columns profiled a step
RESCORE_MULT = 4                 # quantized scans over-fetch 4k for the re-rank
BOOST = 4.0                      # LSH hits outrank any squashed proxy
_BIG = 3.4e38
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def _i64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def _shr(x, k):
    return (x >> k) & ((1 << (64 - k)) - 1)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ensemble:
    """An oblivious GBDT: per tree D feature indices and thresholds and
    2^D leaves, summed from ``base``."""

    feats: torch.Tensor      # (T, D) int64
    thrs: torch.Tensor       # (T, D) float32
    leaves: torch.Tensor     # (T, 2^D) float32
    base: float

    @staticmethod
    def load(path: str, device) -> "Ensemble":
        z = np.load(path)
        return Ensemble(torch.from_numpy(np.asarray(z["feats"], np.int64)).to(device),
                        torch.from_numpy(np.asarray(z["thrs"], np.float32)).to(device),
                        torch.from_numpy(np.asarray(z["leaves"], np.float32)).to(device),
                        float(np.float32(z["base"])))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., F) float32 -> (...) float32."""
        t, d = self.feats.shape
        pw2 = 2 ** torch.arange(d, device=x.device)
        acc = torch.full(x.shape[:-1], self.base, dtype=torch.float32, device=x.device)
        for ti in range(t):
            idx = ((x[..., self.feats[ti]] >= self.thrs[ti]).to(torch.int64) * pw2).sum(-1)
            acc = acc + self.leaves[ti][idx]
        return acc


def distances(zq, wq, zc, wc):
    """(Q, F_NUM) / (Q, F_WORDS) queries against a shared (N, .) or gathered
    (Q, M, .) corpus -> (Q, N|M, 23): |Δz| per numeric slot, the top-10 word
    overlap over 10, first-word equality."""
    if zc.dim() == 2:
        zc, wc = zc[None], wc[None]
    d_num = torch.abs(zq[:, None, :] - zc)
    ta = wq[:, None, :N_WORDS, None]
    tb = wc[:, :, None, :N_WORDS]
    count = ((ta == tb) & (ta != SENTINEL)).any(-1).sum(-1)
    overlap = count.to(torch.float32) / torch.tensor(float(N_WORDS), device=count.device)
    fa, fb = wq[:, None, FIRST_WORD], wc[:, :, FIRST_WORD]
    first = ((fa == fb) & (fa != SENTINEL)).to(torch.float32)
    return torch.cat([d_num, overlap[..., None], first[..., None]], -1)


def score(model: Ensemble, zq, wq, zc, wc, block: int = 1 << 16):
    """Join-quality scores (Q, N|M), in blocks of corpus columns."""
    n = zc.shape[-2]
    parts = [model(distances(zq, wq, zc[..., lo:lo + block, :], wc[..., lo:lo + block, :]))
             for lo in range(0, n, block)]
    return torch.cat(parts, -1) if parts else torch.zeros(zq.shape[0], 0, device=zq.device)


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------

def topk(x: torch.Tensor, k: int):
    """(values, positions) of the k largest of each row in the float32 total
    order, the lower index first among equal bit patterns."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    pos = torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]
    return x.gather(1, pos), pos


def excluded(cols, tables, tq, qid):
    """(Q, N) True where a column may not answer a query: itself or its
    table's columns."""
    return (cols[None, :] == qid[:, None]) | (tables[None, :] == tq[:, None])


# ---------------------------------------------------------------------------
# profiles and signatures
# ---------------------------------------------------------------------------

def profile(values, char_len, word_cnt):
    """(C, R) full columns -> (numeric (C, 21) float32, words (C, 11) int64):
    cardinality, uniqueness, entropy, min/max frequency (log1p), max and sd of
    the frequency shares, its seven interior octiles, the longest, shortest
    and mean string length, mean/min/max/sd word counts; the ten most
    frequent values (ties to the smaller hash) and the smallest value."""
    c, r = values.shape
    dev = values.device
    idx = torch.arange(r, device=dev)
    nf = torch.full((c,), float(r), device=dev)
    sv = torch.sort(values, dim=1).values
    is_valid = sv != SENTINEL
    prev = torch.ones_like(is_valid)
    prev[:, 1:] = sv[:, 1:] != sv[:, :-1]
    start = is_valid & prev
    run = torch.cumsum(start.to(torch.int64), 1) - 1
    card = start.sum(1)
    counts = torch.zeros((c, r), dtype=torch.float32, device=dev)
    counts.scatter_add_(1, run.clamp(0, r - 1), is_valid.to(torch.float32))
    spos = torch.sort(torch.where(start, idx, r), dim=1).values
    kmask = idx[None, :] < card[:, None]
    run_vals = torch.where(kmask, torch.gather(sv, 1, spos.clamp(max=r - 1)), SENTINEL)
    cardf = torch.clamp(card.to(torch.float32), min=1.0)
    min_freq = torch.where(kmask, counts, _BIG).amin(1)
    max_freq = counts.amax(1)
    perc = counts / nf[:, None]
    mean_perc = torch.where(kmask, perc, 0.0).sum(1) / cardf
    sd_perc = torch.sqrt(torch.clamp(
        torch.where(kmask, (perc - mean_perc[:, None]) ** 2, 0.0).sum(1) / cardf, min=0.0))
    entropy = -torch.where(kmask & (counts > 0), perc * torch.log(perc), 0.0).sum(1)
    scounts = torch.sort(counts, dim=1).values
    base = (r - card).to(torch.float32)
    octs = []
    for q in range(1, 8):
        p = base + torch.tensor(q / 8.0, dtype=torch.float32) * (cardf - 1.0)
        lo = torch.clamp(torch.floor(p).to(torch.int64), 0, r - 1)
        hi = torch.clamp(lo + 1, 0, r - 1)
        w = p - lo.to(torch.float32)
        octs.append(((1.0 - w) * scounts.gather(1, lo[:, None])[:, 0]
                     + w * scounts.gather(1, hi[:, None])[:, 0]) / nf)
    _, top = topk(counts, min(N_WORDS, r))
    words = torch.where(counts.gather(1, top) > 0, run_vals.gather(1, top), SENTINEL)

    def stats(x):
        s, s2 = x.sum(1), (x * x).sum(1)
        mean = s / nf
        return x.amin(1), x.amax(1), mean, torch.sqrt(torch.clamp(s2 / nf - mean * mean, min=0.0))

    mn_c, mx_c, mean_c, _ = stats(char_len)
    mn_w, mx_w, mean_w, sd_w = stats(word_cnt)
    cr = card.to(torch.float32)
    numeric = torch.stack([torch.log1p(cr), cr / nf, entropy, torch.log1p(min_freq),
                           torch.log1p(max_freq), max_freq / nf, sd_perc, *octs,
                           mx_c, mn_c, mean_c, mean_w, mn_w, mx_w, sd_w], 1)
    return numeric, torch.cat([words, sv[:, :1]], 1)


def permutations(n_perm: int, seed: int):
    """Odd multipliers and offsets of the universal hashes (uint32 numpy)."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(1, 2 ** 32, size=n_perm, dtype=np.uint64) | 1).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, size=n_perm, dtype=np.uint64).astype(np.uint32)
    return a, b


def minhash(values, a, b, step: int = 16, block: int = 16384):
    """(C, R) hashes -> (C, P) minima of (a·v + b) mod 2^32 over the rows,
    ``block`` columns and ``step`` rows at a time."""
    c, r = values.shape
    out = torch.full((c, a.shape[0]), M32, dtype=torch.int64, device=values.device)
    a_lo, a_hi = a & 0xFFFF, a >> 16
    for c0 in range(0, c, block):
        for lo in range(0, r, step):
            v = values[c0:c0 + block, lo:lo + step, None]
            h = (((a_lo * v + (((a_hi * v) & 0xFFFF) << 16)) & M32) + b) & M32
            out[c0:c0 + block] = torch.minimum(
                out[c0:c0 + block], torch.where(v == SENTINEL, M32, h).amin(1))
    return out


def _fold_key(h):
    k = _shr(h, 32) ^ (h & M32)
    return torch.where(k >= PAD_CORPUS, k - 7, k)


def band_keys(sig, n_bands: int):
    """(C, P) signatures -> (C, B) FNV-1a keys of P/B rows a band."""
    c, p = sig.shape
    r = p // n_bands
    s = sig[:, :n_bands * r].reshape(c, n_bands, r)
    h = torch.full((c, n_bands), _i64(_FNV_OFFSET), dtype=torch.int64, device=sig.device)
    for i in range(r):
        h = (h ^ s[:, :, i]) * _FNV_PRIME
    for i in range(p - n_bands * r):     # trailing rows fold into the last band
        h[:, -1] = (h[:, -1] ^ sig[:, n_bands * r + i]) * _FNV_PRIME
    return _fold_key(h)


def coarse_rows(n_perm: int, n_coarse: int):
    return [(i * n_perm) // n_coarse for i in range(n_coarse)]


def coarse_keys(sig_rows):
    """(C, S) signature rows at :func:`coarse_rows` -> (C, S) digest keys."""
    return _fold_key((_i64(_FNV_OFFSET) ^ sig_rows) * _FNV_PRIME)


def quantize(z, bits: int):
    """Symmetric per-feature quantization of (C, F) float32 to ``bits``
    (8: int8 at abs-max / 127; 4: sixteen levels at abs-max / 7) -> (levels
    int8, scale (F,) float32)."""
    top = (1 << (bits - 1)) - 1
    amax = torch.abs(z).amax(0)
    scale = torch.clamp(amax, min=1e-12) / top
    q = torch.clamp(torch.round(z / scale[None, :]), -top, top).to(torch.int8)
    return q, scale


def probe(qkeys, ckeys, block: int = 1 << 16):
    """(Q, B) against (C, B) or (Q, C, B) -> (Q, C) bool: any band equal,
    ``block`` columns at a time."""
    if ckeys.dim() == 2:
        ckeys = ckeys[None]
    return torch.cat([(qkeys[:, None, :] == ckeys[:, lo:lo + block]).any(-1)
                      for lo in range(0, ckeys.shape[1], block)], 1)


# ---------------------------------------------------------------------------
# the lake, worked out again
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Lake:
    """What the reference derives from the generated columns."""

    z: torch.Tensor                  # (C, 21) float32 z-scored profiles
    words: torch.Tensor              # (C, 11) int64
    tables: torch.Tensor             # (C,) int64
    cols: torch.Tensor               # (C,) int64
    coarse: torch.Tensor | None      # (C, S) digest keys (tiered)
    values: list | None              # device value blocks kept for signatures


def z_stats(numeric: np.ndarray):
    """Lake-wide float32 mean and population std of each numeric slot (a
    constant slot takes std 1)."""
    mean = numeric.mean(axis=0)
    std = numeric.std(axis=0)
    return mean.astype(np.float32), np.where(std < 1e-6, 1.0, std).astype(np.float32)


def build_lake(blocks, cols_per_table: int, device, *, n_perm: int = 128,
               minhash_seed: int = 0, n_coarse: int = 0) -> Lake:
    """Profiles (and, with ``n_coarse``, the coarse digest) of every column
    from ``blocks`` of ``(lo, hi, values, char_len, word_cnt)``."""
    nums, words, coarse, kept = [], [], [], []
    a, b = permutations(n_perm, minhash_seed)
    rows = coarse_rows(n_perm, n_coarse) if n_coarse else []
    a_c = torch.from_numpy(a[rows].astype(np.int64)).to(device)
    b_c = torch.from_numpy(b[rows].astype(np.int64)).to(device)
    for lo, hi, v, cl, wc in blocks:
        for s in range(0, hi - lo, PROFILE_CHUNK):
            e = min(s + PROFILE_CHUNK, hi - lo)
            n, w = profile(v[s:e], cl[s:e], wc[s:e])
            nums.append(n.cpu().numpy())
            words.append(w)
            if n_coarse:
                coarse.append(coarse_keys(minhash(v[s:e], a_c, b_c)))
        if n_coarse:
            kept.append((lo, hi, v))
    numeric = np.concatenate(nums).astype(np.float32)
    mean, std = z_stats(numeric)
    z = torch.from_numpy((numeric - mean) / std).to(device)
    c = z.shape[0]
    cols = torch.arange(c, device=device)
    return Lake(z=z, words=torch.cat(words), tables=cols // cols_per_table, cols=cols,
                coarse=torch.cat(coarse) if n_coarse else None,
                values=kept if n_coarse else None)


def signatures_of(lake: Lake, ids: torch.Tensor, n_perm: int, seed: int):
    """Full (n, P) signatures of the columns ``ids`` (any shape), from the
    kept value blocks."""
    a, b = permutations(n_perm, seed)
    a = torch.from_numpy(a.astype(np.int64)).to(ids.device)
    b = torch.from_numpy(b.astype(np.int64)).to(ids.device)
    flat, back = torch.unique(ids.reshape(-1), return_inverse=True)   # each column once
    out = torch.empty((flat.numel(), n_perm), dtype=torch.int64, device=ids.device)
    for lo, hi, v in lake.values:
        m = (flat >= lo) & (flat < hi)
        if m.any():
            sel = torch.nonzero(m).flatten()
            out[sel] = minhash(v[flat[sel] - lo], a, b)
    return out[back].reshape(*ids.shape, n_perm)


# ---------------------------------------------------------------------------
# the plans
# ---------------------------------------------------------------------------

def answer_all(lake: Lake, model: Ensemble, qids: torch.Tensor, k: int, *,
               zc=None):
    """The exact plan: every column scored, the top k. ``zc`` replaces the
    corpus profiles (the control's lower precision). Returns (scores (Q, k),
    ids (Q, k)) with -inf / -1 where fewer than k may answer."""
    zc = lake.z if zc is None else zc
    s = score(model, zc[qids], lake.words[qids], zc, lake.words)
    s = torch.where(excluded(lake.cols, lake.tables, lake.tables[qids], qids),
                    float("-inf"), s)
    sc, pos = topk(s, min(k, s.shape[1]))
    return sc, torch.where(torch.isfinite(sc), pos, -1)


def exact_scores(lake: Lake, model: Ensemble, qids: torch.Tensor, ids: torch.Tensor):
    """float32 scores of each query against its own columns ``ids`` (Q, M);
    -inf where the id is -1 or may not answer the query."""
    safe = ids.clamp(min=0)
    s = score(model, lake.z[qids], lake.words[qids], lake.z[safe], lake.words[safe])
    bad = (ids < 0) | (ids == qids[:, None]) | (lake.tables[safe] == lake.tables[qids][:, None])
    return torch.where(bad, float("-inf"), s)


def answer_tiered(lake: Lake, model: Ensemble, qids: torch.Tensor, k: int, *,
                  n_perm: int, minhash_seed: int, n_bands: int, survivors: int,
                  budget: int, block_c: int = 32, bits: int = 8, rerank=torch.float32):
    """The tiered plan over a ``bits``-bit sidecar, then the re-rank of the
    over-fetched 4k on profiles in ``rerank`` (float32, or one precision
    lower for the control). Returns (scores (Q, k), ids (Q, k))."""
    c = lake.z.shape[0]
    qz, qw = lake.z[qids], lake.words[qids]
    zi, scale = quantize(lake.z, bits)
    zf = zi.to(torch.float32) * scale
    qsig = signatures_of(lake, qids, n_perm, minhash_seed)
    qcoarse = coarse_keys(qsig[:, coarse_rows(n_perm, lake.coarse.shape[1])])
    # coarse pass: digest hits, their blocks, the proxy fill below them
    hit = probe(qcoarse, lake.coarse)
    nb = -(-c // block_c)
    bh = torch.nn.functional.pad(hit, (0, nb * block_c - c)).reshape(-1, nb, block_c).any(-1)
    bh = bh.repeat_interleave(block_c, 1)[:, :c]
    proxy = (2.0 * qz) @ zf.T - (zf * zf).sum(1)[None]
    prio = torch.where(bh, BOOST, 0.0) + hit.to(torch.float32) + proxy / (1.0 + torch.abs(proxy))
    prio = torch.where(excluded(lake.cols, lake.tables, lake.tables[qids], qids),
                       float("-inf"), prio)
    del hit, bh, proxy
    pv, pos = topk(prio, survivors)
    valid = torch.isfinite(pv)
    del prio
    # fine pass over the survivors: their band keys, the proxy among them
    fkeys = band_keys(signatures_of(lake, pos, n_perm, minhash_seed).reshape(-1, n_perm),
                      n_bands).reshape(*pos.shape, n_bands)
    qkeys = band_keys(qsig, n_bands)
    zg = zf[pos]
    p2 = 2.0 * torch.einsum("qf,qmf->qm", qz, zg) - (zg * zg).sum(-1)
    p2 = probe(qkeys, fkeys).to(torch.float32) * BOOST + p2 / (1.0 + torch.abs(p2))
    pv2, pos2 = topk(torch.where(valid, p2, float("-inf")), min(budget, survivors))
    gpos = torch.gather(pos, 1, pos2)
    s = score(model, qz, qw, zf[gpos], lake.words[gpos])
    s = torch.where(torch.isfinite(pv2), s, float("-inf"))
    sc, p3 = topk(s, min(RESCORE_MULT * k, s.shape[1]))
    ids = torch.where(torch.isfinite(sc), torch.gather(gpos, 1, p3), -1)
    # the re-rank of the over-fetched set
    low = lambda z: z.to(rerank).to(torch.float32)
    ex = score(model, low(qz), qw, low(lake.z[ids.clamp(min=0)]), lake.words[ids.clamp(min=0)])
    ex = torch.where(torch.isfinite(sc), ex, float("-inf"))
    sc2, p4 = topk(ex, min(k, ex.shape[1]))
    return sc2, torch.where(torch.isfinite(sc2), torch.gather(ids, 1, p4), -1)
