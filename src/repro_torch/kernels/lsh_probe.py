"""Banded-LSH bucket probe: the wrapper of ``csrc/lsh_probe.cu``.

The port of ``repro.kernels.lsh_probe.lsh_probe_pallas``: column c is a
candidate for query q iff the two share a bucket key in at least one band,
``hit[q, c] = any_b(qkeys[q, b] == ckeys[c, b])``. The gathered probe
(``csrc/lsh_probe_gathered.cu``, the port of ``lsh_probe_gathered_pallas``)
holds each query against its own (C', B) key rows, the survivors of the
tiered stage's coarse pass.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# Padding keys: queries and corpus pad with *different* sentinels so padded
# rows never match anything (including each other).
PAD_QUERY = np.uint32(0xFFFFFFFF)
PAD_CORPUS = np.uint32(0xFFFFFFFE)


def _expect_keys(op: str, name: str, t: torch.Tensor, dim: int) -> None:
    if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be a contiguous CUDA int32 "
                         f"tensor, got {t.dtype} on {t.device}")
    if t.dim() != dim:
        raise ValueError(f"{op}: {name} must be {dim}-D, got {tuple(t.shape)}")


def _check_bands(op: str, b: int, max_bands: int) -> None:
    if b > max_bands:
        raise ValueError(f"{op}: {b} bands exceed the kernel's {max_bands}")


def lsh_probe_cuda(qkeys_bits, ckeys_bits):
    """Launch the probe. ``qkeys_bits`` (Q, B) and ``ckeys_bits`` (C, B):
    int32 bit-views of uint32 keys on one CUDA device -> (Q, C) int32."""
    _expect_keys("lsh_probe", "qkeys", qkeys_bits, 2)
    _expect_keys("lsh_probe", "ckeys", ckeys_bits, 2)
    q, b = qkeys_bits.shape
    c = ckeys_bits.shape[0]
    if ckeys_bits.shape[1] != b:
        raise ValueError(f"lsh_probe: {b} query bands vs {ckeys_bits.shape[1]} "
                         f"corpus bands")
    if q == 0 or c == 0 or b == 0:          # no band to share: no hit
        return torch.zeros((q, c), dtype=torch.int32, device=qkeys_bits.device)
    out = torch.empty((q, c), dtype=torch.int32, device=qkeys_bits.device)
    lib = _build.library("lsh_probe")
    _check_bands("lsh_probe", b, lib.freyja_lsh_probe_max_bands())
    stream = torch.cuda.current_stream(qkeys_bits.device).cuda_stream
    err = lib.freyja_lsh_probe(qkeys_bits.data_ptr(), ckeys_bits.data_ptr(),
                               out.data_ptr(), q, c, b, stream)
    _build.check("lsh_probe", err)
    _build.count_launch("lsh_probe")
    return out


def lsh_probe_gathered_cuda(qkeys_bits, ckeys_bits):
    """Launch the gathered probe. ``qkeys_bits`` (Q, B) and ``ckeys_bits``
    (Q, C', B): int32 bit-views of uint32 keys on one CUDA device ->
    (Q, C') int32."""
    _expect_keys("lsh_probe_gathered", "qkeys", qkeys_bits, 2)
    _expect_keys("lsh_probe_gathered", "ckeys", ckeys_bits, 3)
    q, b = qkeys_bits.shape
    if ckeys_bits.shape[0] != q or ckeys_bits.shape[2] != b:
        raise ValueError(f"lsh_probe_gathered: ckeys {tuple(ckeys_bits.shape)} "
                         f"do not match qkeys {(q, b)}")
    c = ckeys_bits.shape[1]
    if q == 0 or c == 0 or b == 0:          # no band to share: no hit
        return torch.zeros((q, c), dtype=torch.int32, device=qkeys_bits.device)
    out = torch.empty((q, c), dtype=torch.int32, device=qkeys_bits.device)
    lib = _build.library("lsh_probe_gathered")
    _check_bands("lsh_probe_gathered", b, lib.freyja_lsh_probe_gathered_max_bands())
    stream = torch.cuda.current_stream(qkeys_bits.device).cuda_stream
    err = lib.freyja_lsh_probe_gathered(qkeys_bits.data_ptr(), ckeys_bits.data_ptr(),
                                        out.data_ptr(), q, c, b, stream)
    _build.check("lsh_probe_gathered", err)
    _build.count_launch("lsh_probe_gathered")
    return out
