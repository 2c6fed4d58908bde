"""Continuous join quality: the wrapper of ``csrc/quality_cdf.cu``.

The port of ``repro.kernels.quality_cdf.quality_cdf_pallas``: element-wise
Q(J, K) = clip(trunc-CDF(J; μ_J, σ_J)) · clip(trunc-CDF(K; μ_K, σ_K)) on
[lo, hi], the labels of the model path and the exact metric it is held
against. The parameters are arguments: μ_J already carries the strictness.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import standardized_bounds


def quality_cdf_cuda(j, k, mu_j: float, sigma_j: float, mu_k: float, sigma_k: float,
                     lo: float, hi: float):
    """Launch the kernel. ``j`` and ``k``: float32 CUDA tensors of one shape
    -> Q of that shape."""
    op = "quality_cdf"
    _build.expect(op, j, "j", torch.float32, j.shape)
    _build.expect(op, k, "k", torch.float32, j.shape)
    out = torch.empty_like(j)
    if j.numel() == 0:
        return out
    lib = _build.library(op)
    stream = torch.cuda.current_stream(j.device).cuda_stream
    err = lib.freyja_quality_cdf(j.data_ptr(), k.data_ptr(), out.data_ptr(), j.numel(),
                                 mu_j, sigma_j, *standardized_bounds(mu_j, sigma_j, lo, hi),
                                 mu_k, sigma_k, *standardized_bounds(mu_k, sigma_k, lo, hi),
                                 stream)
    _build.check(op, err)
    _build.count_launch(op)
    return out
