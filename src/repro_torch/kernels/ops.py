"""Public entry points of the port's kernels, dispatched by tensor device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel, or the call raises — there is no fallback
from a kernel to a plain version. Hash inputs and outputs are int64 tensors
holding uint32 values; the CUDA path hands the kernels int32 bit-views. The
two probes also take int32 bit-views as they are (the executor keeps its
resident band keys in that form), on either device.
"""
from __future__ import annotations

import torch

from repro_torch.device import from_bits, to_bits
from repro_torch.kernels import ref
from repro_torch.kernels.candidate_priority import check_args as _candidate_priority_args
from repro_torch.kernels.candidate_priority import candidate_priority_cuda
from repro_torch.kernels.coarse_priority import check_args as _coarse_priority_args
from repro_torch.kernels.coarse_priority import coarse_priority_cuda
from repro_torch.kernels.gbdt_infer import gbdt_infer_cuda
from repro_torch.kernels.lsh_probe import lsh_probe_cuda, lsh_probe_gathered_cuda
from repro_torch.kernels.minhash import minhash_cuda
from repro_torch.kernels.profile_distance import (fused_score_cuda, fused_score_q_cuda,
                                                  profile_distance_cuda)
from repro_torch.kernels.quality_cdf import quality_cdf_cuda
from repro_torch.kernels.topk import topk_cuda, topk_meta

__all__ = ["fused_score", "fused_score_q", "minhash", "lsh_probe", "lsh_probe_gathered",
           "profile_distance", "gbdt_infer", "quality_cdf", "topk", "coarse_priority",
           "candidate_priority"]


def _on_cuda(t: torch.Tensor, op: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{op}: no kernel or plain version for device {t.device}")


def fused_score(zq, wq, zc, wc, gbdt_tuple):
    """(Q, N) f32 GBDT scores of queries against a shared corpus (N, F), or
    (Q, M) against per-query gathered corpora (Q, M, F). ``gbdt_tuple`` is
    (feats, thrs, leaves, base) with the arrays on the inputs' device."""
    feats, thrs, leaves, base = gbdt_tuple
    if not _on_cuda(zq, "fused_score"):
        return ref.fused_score_ref(zq, wq, zc, wc, feats, thrs, leaves, base)
    return fused_score_cuda(zq.contiguous(), to_bits(wq), zc.contiguous(),
                            to_bits(wc), feats.to(torch.int32).contiguous(),
                            thrs.contiguous(), leaves.contiguous(), float(base))


def fused_score_q(zq, wq, zc, scale, wc, gbdt_tuple):
    """:func:`fused_score` over an int8 or float16 sidecar ``zc``, shared
    (N, F_NUM) or gathered (Q, M, F_NUM), dequantized in the kernel with
    its (F_NUM,) float32 ``scale``."""
    feats, thrs, leaves, base = gbdt_tuple
    if not _on_cuda(zq, "fused_score_q"):
        return ref.fused_score_q_ref(zq, wq, zc, scale, wc, feats, thrs, leaves, base)
    return fused_score_q_cuda(zq.contiguous(), to_bits(wq), zc.contiguous(),
                              scale.to(torch.float32).contiguous(), to_bits(wc),
                              feats.to(torch.int32).contiguous(), thrs.contiguous(),
                              leaves.contiguous(), float(base))


def minhash(values, a, b):
    """(C, P) MinHash signatures of (C, R) values under permutations a, b."""
    if not _on_cuda(values, "minhash"):
        return ref.minhash_ref(values, a, b)
    return from_bits(minhash_cuda(to_bits(values), to_bits(a), to_bits(b)))


def _key_bits(t: torch.Tensor) -> torch.Tensor:
    """Probe keys in one form on both devices: an int64 tensor holding uint32
    values becomes its int32 bit-view, an int32 bit-view passes through. The
    probes test equality only, and bit-views are equal exactly where the
    uint32 values are; an int64 0xFFFFFFFF and an int32 -1 would not be after
    promotion (and ``to_bits`` of an int32 tensor would be wrong: its mask
    does not fit in int32)."""
    return t.contiguous() if t.dtype == torch.int32 else to_bits(t)


def lsh_probe(qkeys, ckeys):
    """(Q, C) int32 hit mask of (Q, B) query keys against (C, B) corpus keys,
    each int64 holding uint32 or an int32 bit-view."""
    if not _on_cuda(qkeys, "lsh_probe"):
        return ref.lsh_probe_ref(_key_bits(qkeys), _key_bits(ckeys))
    return lsh_probe_cuda(_key_bits(qkeys), _key_bits(ckeys))


def lsh_probe_gathered(qkeys, ckeys, pos=None):
    """(Q, C') int32 hit mask of (Q, B) query keys against each query's own
    C' key rows (int64 holding uint32, or int32 bit-views): ``ckeys``
    (Q, C', B) gathered rows, or, with ``pos`` (Q, C') integer positions,
    the resident (N, B) table whose rows ``ckeys[pos]`` the kernel reads in
    place without a gathered copy. An out-of-range position raises, as the
    indexing ``ckeys[pos]`` does (on the card at the next synchronization)."""
    if not _on_cuda(qkeys, "lsh_probe_gathered"):
        keys = _key_bits(ckeys)
        return ref.lsh_probe_gathered_ref(_key_bits(qkeys), keys if pos is None else keys[pos])
    if pos is not None:
        pos = pos.to(torch.int64).contiguous()
    return lsh_probe_gathered_cuda(_key_bits(qkeys), _key_bits(ckeys), pos)


def profile_distance(zq, wq, zc, wc):
    """(Q, N, F_DIST) f32 distance features of (Q, F) queries against a
    shared (N, F) corpus."""
    if not _on_cuda(zq, "profile_distance"):
        return ref.profile_distance_ref(zq, wq, zc, wc)
    return profile_distance_cuda(zq.contiguous(), to_bits(wq), zc.contiguous(), to_bits(wc))


def gbdt_infer(x, gbdt_tuple):
    """(...) f32 predictions of the ensemble ``gbdt_tuple`` = (feats, thrs,
    leaves, base) for (..., F) f32 feature rows."""
    feats, thrs, leaves, base = gbdt_tuple
    if not _on_cuda(x, "gbdt_infer"):
        return ref.gbdt_infer_ref(x, feats, thrs, leaves, base)
    f = x.shape[-1]
    if feats.numel():
        lo, hi = (int(v) for v in torch.aminmax(feats))
        if lo < 0 or hi >= f:
            raise ValueError(f"gbdt_infer: feature ids must lie in [0, {f}), got [{lo}, {hi}]")
    out = gbdt_infer_cuda(x.reshape(-1, f).contiguous(), feats.to(torch.int32).contiguous(),
                          thrs.contiguous(), leaves.contiguous(), float(base))
    return out.reshape(x.shape[:-1])


def quality_cdf(j, k, mu_j, sigma_j, mu_k, sigma_k, lo=0.0, hi=1.0):
    """Element-wise continuous join quality of float32 ``j`` and ``k``:
    trunc-CDF(J; μ_J, σ_J) · trunc-CDF(K; μ_K, σ_K) on [lo, hi]."""
    if not _on_cuda(j, "quality_cdf"):
        return ref.quality_cdf_ref(j, k, mu_j, sigma_j, mu_k, sigma_k, lo, hi)
    return quality_cdf_cuda(j.contiguous(), k.contiguous(), mu_j, sigma_j, mu_k, sigma_k,
                            lo, hi)


def topk(x, k: int):
    """(R, k) int64 positions of the k largest entries of each row of float32
    ``x`` (R, N), 0 <= k <= N, in ``jax.lax.top_k``'s order (see
    ``ref.topk_ref``). The positions carry no autograd; gather the values
    with them. On ``meta`` (the dry run's traces) the call allocates what
    the kernel allocates and computes nothing."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"topk: want a float32 (R, N) tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not 0 <= k <= x.shape[1]:
        raise ValueError(f"topk: want 0 <= k <= {x.shape[1]}, got {k}")
    if x.device.type == "meta":
        return topk_meta(x, k)
    if not _on_cuda(x, "topk"):
        return ref.topk_ref(x, k)
    return topk_cuda(x.detach().contiguous(), k)


def coarse_priority(hit, proxy, cids, tids, tq, qid, block_c: int):
    """The tiered coarse pass's survivor priority and counts (see
    ``ref.coarse_priority_ref``): ``hit`` (Q, C) int32 from :func:`lsh_probe`,
    ``proxy`` (Q, C) float32 or None, ``cids``/``tids`` (C,) and ``tq``/``qid``
    (Q,) int64, all contiguous on one device -> (prio (Q, C) float32,
    n_hits (Q,) int64, n_survivors (Q,) int64)."""
    if not _on_cuda(hit, "coarse_priority"):
        _coarse_priority_args(hit, proxy, cids, tids, tq, qid, block_c)
        return ref.coarse_priority_ref(hit, proxy, cids, tids, tq, qid, block_c)
    return coarse_priority_cuda(hit, proxy, cids, tids, tq, qid, block_c)


def candidate_priority(hit, g, znorm, cids, tids, tq, qid):
    """The ``lsh``/``hybrid`` candidate priority over the whole lake (see
    ``ref.candidate_priority_ref``): ``hit`` (Q, C) int32 from
    :func:`lsh_probe`; ``g`` (Q, C) float32, ``(2·zq) @ zᵀ``, and ``znorm``
    (C,) float32, the columns' squared norms, for ``hybrid`` (both None for
    ``lsh``); ``cids``/``tids`` (C,) and ``tq``/``qid`` (Q,) int64, all
    contiguous on one device -> (Q, C) float32. On the card the priorities
    overwrite ``g``."""
    if not _on_cuda(hit, "candidate_priority"):
        _candidate_priority_args(hit, g, znorm, cids, tids, tq, qid)
        return ref.candidate_priority_ref(hit, g, znorm, cids, tids, tq, qid)
    return candidate_priority_cuda(hit, g, znorm, cids, tids, tq, qid)
