"""Public entry points of the port's kernels, dispatched by tensor device.

A CPU tensor goes to the plain PyTorch version in ``ref.py``; a CUDA tensor
goes to the hand-written kernel, or the call raises — there is no fallback
from a kernel to a plain version. Hash inputs and outputs are int64 tensors
holding uint32 values; the CUDA path hands the kernels int32 bit-views.
"""
from __future__ import annotations

import torch

from repro_torch.device import from_bits, to_bits
from repro_torch.kernels import ref
from repro_torch.kernels.lsh_probe import lsh_probe_cuda, lsh_probe_gathered_cuda
from repro_torch.kernels.minhash import minhash_cuda
from repro_torch.kernels.profile_distance import fused_score_cuda, fused_score_q_cuda

__all__ = ["fused_score", "fused_score_q", "minhash", "lsh_probe", "lsh_probe_gathered"]


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


def lsh_probe(qkeys, ckeys):
    """(Q, C) int32 hit mask of (Q, B) query keys against (C, B) corpus keys."""
    if not _on_cuda(qkeys, "lsh_probe"):
        return ref.lsh_probe_ref(qkeys, ckeys)
    return lsh_probe_cuda(to_bits(qkeys), to_bits(ckeys))


def lsh_probe_gathered(qkeys, ckeys):
    """(Q, C') int32 hit mask of (Q, B) query keys against each query's own
    (Q, C', B) gathered key rows."""
    if not _on_cuda(qkeys, "lsh_probe_gathered"):
        return ref.lsh_probe_gathered_ref(qkeys, ckeys)
    return lsh_probe_gathered_cuda(to_bits(qkeys), to_bits(ckeys))
