"""Profile distances and fused scoring: the wrappers of
``csrc/profile_distance.cu``, ``csrc/fused_score.cu`` and
``csrc/fused_score_q.cu``.

:func:`profile_distance_cuda` (the port of
``repro.kernels.profile_distance.profile_distance_pallas``) writes the
materialized (Q, N, F_DIST) distance tensor that the model path trains on
and the two-stage scorer feeds to ``gbdt_infer``.

The port of ``repro.kernels.profile_distance.fused_score_pallas``: distance
features (|Δz| per numeric slot, top-10 word overlap, first-word equality)
are consumed by the oblivious-GBDT ensemble inside the kernel, so the
(Q, N, F_DIST) tensor never reaches device memory. One kernel serves both
geometries: a shared corpus (N, F) with query stride 0, and a per-query
gathered corpus (Q, M, F) with query stride M, which the pruned plans score.

Quantized corpus sidecars: :func:`quantize_profiles` stores the z-scored
profiles as int8 (symmetric per-feature scale, abs-max/127) or fp16, and
``csrc/fused_score_q.cu`` (the port of ``fused_score_q_pallas``) scores them
with the same body, dequantizing each element in the kernel as
``float(v) * scale[f]``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.kernels import _build

PROFILE_DTYPES = ("fp32", "fp16", "int8")
# sidecar element type -> the kernel's dtype code
_Q_DTYPES = {torch.int8: 0, torch.float16: 1}


def quantize_profiles(z: np.ndarray, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """Quantize a z-scored (C, F) profile matrix to a compact sidecar.

    Returns ``(sidecar, scale)`` with ``scale`` the per-feature float32
    multiplier that dequantizes the sidecar (``sidecar.astype(f32) * scale``):
    ``int8`` symmetric per feature with scale = abs-max/127; ``fp16`` a
    half-precision copy, scale 1; ``fp32`` the identity, scale 1.
    """
    z = np.asarray(z, np.float32)
    f = z.shape[1] if z.ndim == 2 else 0
    ones = np.ones((f,), np.float32)
    if dtype == "fp32":
        return z, ones
    if dtype == "fp16":
        return z.astype(np.float16), ones
    if dtype == "int8":
        amax = np.abs(z).max(axis=0) if z.shape[0] else ones
        scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
        q = np.clip(np.rint(z / scale[None, :]), -127, 127).astype(np.int8)
        return q, scale
    raise ValueError(f"unknown profile dtype {dtype!r}; want one of {PROFILE_DTYPES}")


def quantize_profiles_streamed(numeric, mean, std, dtype: str, *,
                               block: int = 8192) -> tuple[np.ndarray, np.ndarray]:
    """:func:`quantize_profiles` of ``(numeric - mean) / std`` in blocks of
    ``block`` rows, never holding the z-scored float32 matrix. int8's
    per-feature abs-max does not depend on the order of the blocks, so the
    two passes (abs-max, then quantize) give the eager quantizer's bytes."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    c = int(numeric.shape[0])
    f = int(numeric.shape[1]) if getattr(numeric, "ndim", 2) == 2 else 0
    block = max(int(block), 1)
    ones = np.ones((f,), np.float32)
    zblock = lambda lo: (np.asarray(numeric[lo:lo + block], np.float32) - mean) / std
    if dtype in ("fp32", "fp16"):
        out = np.empty((c, f), np.float32 if dtype == "fp32" else np.float16)
        for lo in range(0, c, block):
            out[lo:lo + block] = zblock(lo).astype(out.dtype)
        return out, ones
    if dtype == "int8":
        amax = np.zeros((f,), np.float32)
        for lo in range(0, c, block):
            z = zblock(lo)
            if z.shape[0]:
                np.maximum(amax, np.abs(z).max(axis=0), out=amax)
        if c == 0:
            amax = ones
        scale = np.maximum(amax, 1e-12).astype(np.float32) / 127.0
        out = np.empty((c, f), np.int8)
        for lo in range(0, c, block):
            out[lo:lo + block] = np.clip(np.rint(zblock(lo) / scale[None, :]),
                                         -127, 127).astype(np.int8)
        return out, scale
    raise ValueError(f"unknown profile dtype {dtype!r}; want one of {PROFILE_DTYPES}")


def dequantize(zc, scale):
    """Sidecar (..., F) of any dtype + (F,) scale -> float32: one IEEE
    multiply per element (fp16 -> fp32 is exact and its scale is 1). Takes
    numpy arrays or tensors (``scale`` on the sidecar's device)."""
    if isinstance(zc, torch.Tensor):
        return zc if zc.dtype == torch.float32 else zc.to(torch.float32) * scale
    return zc if zc.dtype == np.float32 else zc.astype(np.float32) * scale


def _launch(op: str, zq, wq_bits, zc, scale, wc_bits, feats, thrs, leaves, base: float):
    """Check the inputs of scorer ``op`` and launch it on the current stream;
    ``scale`` is None for the float32 scorer."""
    q = zq.shape[0]
    gathered = zc.dim() == 3
    n = zc.shape[1] if gathered else zc.shape[0]
    lead = (q, n) if gathered else (n,)
    t, d = feats.shape
    _build.expect(op, zq, "zq", torch.float32, (q, FT.F_NUM))
    _build.expect(op, wq_bits, "wq", torch.int32, (q, FT.F_WORDS))
    _build.expect(op, zc, "zc", torch.float32 if scale is None else zc.dtype, (*lead, FT.F_NUM))
    if scale is not None:
        _build.expect(op, scale, "scale", torch.float32, (FT.F_NUM,))
    _build.expect(op, wc_bits, "wc", torch.int32, (*lead, FT.F_WORDS))
    _build.expect(op, feats, "feats", torch.int32, (t, d))
    _build.expect(op, thrs, "thrs", torch.float32, (t, d))
    _build.expect(op, leaves, "leaves", torch.float32, (t, 1 << d))
    lib = _build.library(op)
    if getattr(lib, f"freyja_{op}_smem")(t, d) > _build.MAX_SMEM:
        raise ValueError(f"{op}: a {t}x{d} ensemble does not fit in shared memory")
    out = torch.empty((q, n), dtype=torch.float32, device=zq.device)
    if q == 0 or n == 0:
        return out
    n_sms = _build.sm_count(zq.device)
    trees = (feats.data_ptr(), thrs.data_ptr(), leaves.data_ptr(), float(base),
             out.data_ptr(), q, n, n if gathered else 0, t, d)
    with _build.on_device(zq) as stream, _build.staging_locks[op]:
        if scale is None:
            err = lib.freyja_fused_score(zq.data_ptr(), wq_bits.data_ptr(), zc.data_ptr(),
                                         wc_bits.data_ptr(), *trees, n_sms, stream)
        else:
            err = lib.freyja_fused_score_q(zq.data_ptr(), wq_bits.data_ptr(), zc.data_ptr(),
                                           scale.data_ptr(), wc_bits.data_ptr(), *trees,
                                           _Q_DTYPES[zc.dtype], n_sms, stream)
    _build.check(op, err)
    _build.count_launch(op, "gathered" if gathered else "shared")
    return out


def fused_score_cuda(zq, wq_bits, zc, wc_bits, feats, thrs, leaves, base: float):
    """Launch the fused scorer. ``zq`` (Q, F_NUM) f32, ``wq_bits`` (Q,
    F_WORDS) int32 bit-views; ``zc``/``wc_bits`` (N, F) shared or (Q, M, F)
    gathered; ``feats`` (T, D) int32, ``thrs`` (T, D) f32, ``leaves``
    (T, 2^D) f32 -> (Q, N) or (Q, M) f32."""
    return _launch("fused_score", zq, wq_bits, zc, None, wc_bits, feats, thrs, leaves, base)


def fused_score_q_cuda(zq, wq_bits, zc, scale, wc_bits, feats, thrs, leaves,
                       base: float):
    """Launch the quantized scorer: as :func:`fused_score_cuda`, with ``zc``
    an int8 or float16 sidecar, (N, F_NUM) shared or (Q, M, F_NUM) gathered,
    and ``scale`` its (F_NUM,) float32 dequantization multiplier."""
    if zc.dtype not in _Q_DTYPES:
        raise ValueError(f"fused_score_q: zc must be int8 or float16, got {zc.dtype}")
    return _launch("fused_score_q", zq, wq_bits, zc, scale, wc_bits, feats, thrs,
                   leaves, base)


def profile_distance_cuda(zq, wq_bits, zc, wc_bits):
    """Launch the distance kernel. ``zq`` (Q, F_NUM) f32 and ``wq_bits``
    (Q, F_WORDS) int32 bit-views against a shared corpus ``zc`` (N, F_NUM)
    / ``wc_bits`` (N, F_WORDS) -> (Q, N, F_DIST) f32."""
    op = "profile_distance"
    q, n = zq.shape[0], zc.shape[0]
    _build.expect(op, zq, "zq", torch.float32, (q, FT.F_NUM))
    _build.expect(op, wq_bits, "wq", torch.int32, (q, FT.F_WORDS))
    _build.expect(op, zc, "zc", torch.float32, (n, FT.F_NUM))
    _build.expect(op, wc_bits, "wc", torch.int32, (n, FT.F_WORDS))
    out = torch.empty((q, n, FT.F_DIST), dtype=torch.float32, device=zq.device)
    if q == 0 or n == 0:
        return out
    lib = _build.library(op)
    with _build.on_device(zq) as stream:
        err = lib.freyja_profile_distance(zq.data_ptr(), wq_bits.data_ptr(), zc.data_ptr(),
                                          wc_bits.data_ptr(), out.data_ptr(), q, n, stream)
    _build.check(op, err)
    _build.count_launch(op)
    return out
