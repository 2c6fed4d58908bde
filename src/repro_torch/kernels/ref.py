"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, with the same float32
arithmetic in the same order where the result depends on it (the GBDT sum
runs from ``base`` in tree order; word overlap is ``float(count) / 10``
with IEEE division). They serve three callers: the CPU tests (held against
``repro.kernels.ref``), the CPU path of ``ops`` (``device="cpu"``), and the
kernel-vs-plain phases of ``chip_smoke.py``. Hashes are int64 tensors
holding uint32 values (see ``repro_torch.device``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.device import U32_MASK

# LSH hits outrank every profile-proximity score: the proxy is squashed
# into (-1, 1), so any offset > 2 keeps the two bands disjoint.
LSH_PRIORITY_BOOST = 4.0

# elements of the (C, rows, P) hash intermediate one minhash step may hold
_MINHASH_ELEMS = 1 << 24
_SQRT2 = float(np.float32(math.sqrt(2.0)))


def gbdt_infer_ref(x, feats, thrs, leaves, base):
    """Oblivious-GBDT inference. x (..., F) f32 -> (...) f32, summed from
    ``base`` in tree order."""
    t, d = feats.shape
    pw2 = 2 ** torch.arange(d, device=x.device)
    acc = torch.full(x.shape[:-1], float(base), dtype=torch.float32,
                     device=x.device)
    for ti in range(t):
        sel = x[..., feats[ti]]                                   # (..., D)
        idx = ((sel >= thrs[ti]).to(torch.int64) * pw2).sum(-1)
        acc = acc + leaves[ti][idx]
    return acc


def profile_distance_ref(z_q, w_q, z_c, w_c):
    """Distance features for (query, corpus) pairs -> (Q, N, F_DIST) f32.

    ``z_q`` (Q, F_NUM) f32, ``w_q`` (Q, F_WORDS) hashes; the corpus is
    shared, ``z_c`` (N, F_NUM) / ``w_c`` (N, F_WORDS), or gathered per
    query, (Q, M, F_NUM) / (Q, M, F_WORDS).
    """
    if z_c.dim() == 2:
        z_c, w_c = z_c[None], w_c[None]
    d_num = torch.abs(z_q[:, None, :] - z_c)
    ta = w_q[:, None, :FT.N_FREQ_WORDS, None]                      # (Q,1,10,1)
    tb = w_c[:, :, None, :FT.N_FREQ_WORDS]                         # (.,N,1,10)
    eq = (ta == tb) & (ta != FT.HASH_SENTINEL)
    count = eq.any(-1).sum(-1)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by its
    # reciprocal, and 9 * fl(1/10) is not fl(9/10)
    ten = torch.tensor(float(FT.N_FREQ_WORDS), device=count.device)
    overlap = count.to(torch.float32) / ten
    fa = w_q[:, None, FT.FIRST_WORD]
    fb = w_c[:, :, FT.FIRST_WORD]
    first = ((fa == fb) & (fa != FT.HASH_SENTINEL)).to(torch.float32)
    return torch.cat([d_num, overlap[..., None], first[..., None]], dim=-1)


def fused_score_ref(z_q, w_q, z_c, w_c, feats, thrs, leaves, base):
    """profile_distance ∘ gbdt_infer -> (Q, N) f32 (or (Q, M) gathered)."""
    return gbdt_infer_ref(profile_distance_ref(z_q, w_q, z_c, w_c),
                          feats, thrs, leaves, base)


def fused_score_q_ref(z_q, w_q, z_c, scale, w_c, feats, thrs, leaves, base):
    """The quantized scorer: :func:`fused_score_ref` on the dequantized
    sidecar ``z_c.to(float32) * scale`` (one IEEE multiply per element)."""
    return fused_score_ref(z_q, w_q, z_c.to(torch.float32) * scale, w_c,
                           feats, thrs, leaves, base)


def _mul_u32(a, v):
    """(a · v) mod 2^32 for int64 tensors holding uint32 values, without
    leaving the int64 range: a = a_hi·2^16 + a_lo."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    return (a_lo * v + (((a_hi * v) & 0xFFFF) << 16)) & U32_MASK


def minhash_ref(values, a, b):
    """MinHash signatures. values (C, R) hashes (SENTINEL padded), a/b (P,)
    -> (C, P) via h_p(v) = a_p · v + b_p (mod 2^32); sentinel cells count
    as 0xFFFFFFFF. Rows are reduced in steps that bound the (C, rows, P)
    intermediate."""
    c, r = values.shape
    p = a.shape[0]
    step = max(1, _MINHASH_ELEMS // max(c * p, 1))
    out = torch.full((c, p), U32_MASK, dtype=torch.int64, device=values.device)
    for lo in range(0, r, step):
        v = values[:, lo:lo + step, None]
        h = (_mul_u32(a, v) + b) & U32_MASK
        h = torch.where(v == FT.HASH_SENTINEL, U32_MASK, h)
        out = torch.minimum(out, h.amin(1))
    return out


def lsh_probe_ref(qkeys, ckeys):
    """Banded-LSH bucket probe. qkeys (Q, B), ckeys (C, B) -> (Q, C) int32:
    1 iff the pair shares a bucket key in any band."""
    return (qkeys[:, None, :] == ckeys[None, :, :]).any(-1).to(torch.int32)


def lsh_probe_gathered_ref(qkeys, ckeys):
    """Probe against per-query gathered key rows. qkeys (Q, B), ckeys
    (Q, C', B) -> (Q, C') int32: 1 iff row c' of query q shares a key with
    the query in any band."""
    return (qkeys[:, None, :] == ckeys).any(-1).to(torch.int32)


def exclusion_mask(cids, tids, tq, qid):
    """(Q, C) bool — True where a column must NOT be returned for a query:
    padding columns (cid < 0), the query itself (qid = -1 matches nothing)
    and same-table columns (tq = -1 disables the table mask for that row)."""
    pad = (cids < 0)[None, :]
    self_hit = cids[None, :] == qid[:, None]
    same_table = (tq[:, None] >= 0) & (tids[None, :] == tq[:, None])
    return pad | self_hit | same_table


def candidate_priority_ref(hit, g, znorm, cids, tids, tq, qid):
    """The ``lsh``/``hybrid`` candidate priority over the whole lake. ``hit``
    (Q, C) int32 band hits. ``lsh`` (``g`` None): 0 on a hit, -inf off it.
    ``hybrid``: ``g`` (Q, C) float32 is ``(2·zq) @ zᵀ`` and ``znorm`` (C,)
    float32 is ``(z * z).sum(1)``; their difference, -||zq - z||² up to a
    per-query constant, squashed into (-1, 1), plus ``hit·LSH_PRIORITY_BOOST``.
    Then -inf wherever :func:`exclusion_mask` holds. Returns (Q, C) float32."""
    if g is None:
        prio = torch.where(hit > 0, 0.0, float("-inf"))
    else:
        proxy = g - znorm[None]
        proxy = proxy / (1.0 + torch.abs(proxy))            # squash to (-1, 1)
        prio = hit.to(torch.float32) * LSH_PRIORITY_BOOST + proxy
    return torch.where(exclusion_mask(cids, tids, tq, qid), float("-inf"), prio)


def coarse_priority_ref(hit, proxy, cids, tids, tq, qid, block_c: int):
    """The tiered coarse pass's survivor priority and counts. ``hit`` (Q, C)
    int32 coarse hits; column hits expand to blocks of ``block_c`` contiguous
    columns (a ragged last block holds the columns that exist). Priority:
    block hits first, the direct hit added, then ``proxy`` (Q, C) squashed
    into (-1, 1) below every block hit; without a proxy, -inf off the hit
    blocks; -inf wherever :func:`exclusion_mask` holds. Returns
    ``(prio (Q, C) float32, n_hits (Q,), n_survivors (Q,))``: per query the
    direct hits and the block-hit columns not excluded."""
    c = hit.shape[1]
    nb = -(-c // block_c)
    hp = torch.nn.functional.pad(hit, (0, nb * block_c - c))
    block_hit = (hp.reshape(hit.shape[0], nb, block_c) > 0).any(-1)
    block_hit = block_hit.repeat_interleave(block_c, dim=1)[:, :c]  # (Q, C)
    excl = exclusion_mask(cids, tids, tq, qid)
    if proxy is None:
        prio = torch.where(block_hit, 1.0, float("-inf")) + hit.to(torch.float32)
    else:
        prio = (torch.where(block_hit, LSH_PRIORITY_BOOST, 0.0)
                + hit.to(torch.float32)
                + proxy / (1.0 + torch.abs(proxy)))
    prio = torch.where(excl, float("-inf"), prio)
    n_hits = ((hit > 0) & ~excl).sum(1)
    n_survivors = (block_hit & ~excl).sum(1)
    return prio, n_hits, n_survivors


def minhash_jaccard_ref(sig_a, sig_b):
    """Estimated *set* Jaccard from signatures (the MinHash baseline):
    the float32 fraction of equal permutation minima along the last axis."""
    return (sig_a == sig_b).to(torch.float32).mean(-1)


def topk_ref(x, k: int):
    """(R, k) int64 positions of the k largest entries of each row of float32
    ``x`` (R, N), in the order of ``jax.lax.top_k``: the float32 total order
    (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN, NaNs by their
    bits), the lower index first among equal bit patterns. A stable
    descending sort of the order-preserving int32 key (the bits when
    non-negative, the bits ^ 0x7FFFFFFF when negative), sliced."""
    bits = x.detach().contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=1, descending=True, stable=True).indices[:, :k]


def standardized_bounds(mu: float, sigma: float, lo: float, hi: float):
    """(lo − μ)/σ and (hi − μ)/σ, computed in double and rounded to float32:
    the points where the truncated CDF evaluates Φ at its bounds."""
    return float(np.float32((lo - mu) / sigma)), float(np.float32((hi - mu) / sigma))


def _phi(x):
    """Standard normal CDF 0.5·(1 + erf(x/√2)) in float32. Every constant is
    a tensor on ``x``'s device: a Python scalar divisor would make the CUDA
    division a multiply by its reciprocal, which the kernel does not do."""
    return 0.5 * (1.0 + torch.erf(x / torch.tensor(_SQRT2, device=x.device)))


def truncated_cdf_ref(x, mu: float, sigma: float, lo: float = 0.0, hi: float = 1.0):
    """CDF of N(μ, σ²) truncated to [lo, hi] at float32 ``x``, clamped to
    [0, 1] (NaN passes through)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    a, b = standardized_bounds(mu, sigma, lo, hi)
    phi_lo = _phi(f32(a))
    num = _phi((x - f32(mu)) / f32(sigma)) - phi_lo
    return torch.clamp(num / (_phi(f32(b)) - phi_lo), 0.0, 1.0)


def quality_cdf_ref(j, k, mu_j: float, sigma_j: float, mu_k: float, sigma_k: float,
                    lo: float = 0.0, hi: float = 1.0):
    """Continuous join quality, element-wise: trunc-CDF(J; μ_J, σ_J) ·
    trunc-CDF(K; μ_K, σ_K) on [lo, hi] (μ_J carries the strictness)."""
    return truncated_cdf_ref(j, mu_j, sigma_j, lo, hi) * truncated_cdf_ref(k, mu_k, sigma_k, lo, hi)
