"""Fused distance + GBDT scoring: the wrapper of ``csrc/fused_score.cu``.

The port of ``repro.kernels.profile_distance.fused_score_pallas``: distance
features (|Δz| per numeric slot, top-10 word overlap, first-word equality)
are consumed by the oblivious-GBDT ensemble inside the kernel, so the
(Q, N, F_DIST) tensor never reaches device memory. One kernel serves both
geometries: a shared corpus (N, F) with query stride 0, and a per-query
gathered corpus (Q, M, F) with query stride M, which the pruned plans score.
"""
from __future__ import annotations

import torch

from repro_torch.core import features as FT
from repro_torch.kernels import _build

# dynamic shared memory a block may hold on sm_90 (227 KB)
_MAX_SMEM = 232_448


def _expect(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"fused_score: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"fused_score: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_score: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_score: {name} must be contiguous")


def fused_score_cuda(zq, wq_bits, zc, wc_bits, feats, thrs, leaves, base: float):
    """Launch the fused scorer. ``zq`` (Q, F_NUM) f32, ``wq_bits`` (Q,
    F_WORDS) int32 bit-views; ``zc``/``wc_bits`` (N, F) shared or (Q, M, F)
    gathered; ``feats`` (T, D) int32, ``thrs`` (T, D) f32, ``leaves``
    (T, 2^D) f32 -> (Q, N) or (Q, M) f32."""
    q = zq.shape[0]
    gathered = zc.dim() == 3
    n = zc.shape[1] if gathered else zc.shape[0]
    lead = (q, n) if gathered else (n,)
    t, d = feats.shape
    _expect(zq, "zq", torch.float32, (q, FT.F_NUM))
    _expect(wq_bits, "wq", torch.int32, (q, FT.F_WORDS))
    _expect(zc, "zc", torch.float32, (*lead, FT.F_NUM))
    _expect(wc_bits, "wc", torch.int32, (*lead, FT.F_WORDS))
    _expect(feats, "feats", torch.int32, (t, d))
    _expect(thrs, "thrs", torch.float32, (t, d))
    _expect(leaves, "leaves", torch.float32, (t, 1 << d))
    lib = _build.library("fused_score")
    if lib.freyja_fused_score_smem(t, d) > _MAX_SMEM:
        raise ValueError(f"fused_score: a {t}x{d} ensemble does not fit in "
                         f"shared memory")
    out = torch.empty((q, n), dtype=torch.float32, device=zq.device)
    if q == 0 or n == 0:
        return out
    stream = torch.cuda.current_stream(zq.device).cuda_stream
    err = lib.freyja_fused_score(
        zq.data_ptr(), wq_bits.data_ptr(), zc.data_ptr(), wc_bits.data_ptr(),
        feats.data_ptr(), thrs.data_ptr(), leaves.data_ptr(), float(base),
        out.data_ptr(), q, n, n if gathered else 0, t, d, stream)
    _build.check("fused_score", err)
    _build.count_launch("fused_score")
    return out
