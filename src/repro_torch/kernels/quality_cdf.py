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
    n = j.numel()
    # out at j's offset mod 16 bytes, so that a view of j and k at one
    # offset still takes the kernel's 16-byte loads and stores
    phase = (j.data_ptr() // 4) % 4
    out = torch.empty(n + phase, dtype=torch.float32, device=j.device)[phase:].view(j.shape)
    if n == 0:
        return out
    lib = _build.library(op)
    n_sms = _build.sm_count(j.device)
    with _build.on_device(j) as stream:
        err = lib.freyja_quality_cdf(j.data_ptr(), k.data_ptr(), out.data_ptr(), n,
                                     mu_j, sigma_j, *standardized_bounds(mu_j, sigma_j, lo, hi),
                                     mu_k, sigma_k, *standardized_bounds(mu_k, sigma_k, lo, hi),
                                     n_sms, stream)
    _build.check(op, err)
    _build.count_launch(op)
    return out

