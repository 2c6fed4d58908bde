"""Banded-LSH bucket probe: the wrapper of ``csrc/lsh_probe.cu``.

The port of ``repro.kernels.lsh_probe.lsh_probe_pallas``: column c is a
candidate for query q iff the two share a bucket key in at least one band,
``hit[q, c] = any_b(qkeys[q, b] == ckeys[c, b])``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build

# Padding keys: queries and corpus pad with *different* sentinels so padded
# rows never match anything (including each other).
PAD_QUERY = np.uint32(0xFFFFFFFF)
PAD_CORPUS = np.uint32(0xFFFFFFFE)


def lsh_probe_cuda(qkeys_bits, ckeys_bits):
    """Launch the probe. ``qkeys_bits`` (Q, B) and ``ckeys_bits`` (C, B):
    int32 bit-views of uint32 keys on one CUDA device -> (Q, C) int32."""
    for name, t in (("qkeys", qkeys_bits), ("ckeys", ckeys_bits)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"lsh_probe: {name} must be a contiguous CUDA int32 "
                             f"tensor, got {t.dtype} on {t.device}")
        if t.dim() != 2:
            raise ValueError(f"lsh_probe: {name} must be 2-D, got {tuple(t.shape)}")
    q, b = qkeys_bits.shape
    c = ckeys_bits.shape[0]
    if ckeys_bits.shape[1] != b:
        raise ValueError(f"lsh_probe: {b} query bands vs {ckeys_bits.shape[1]} "
                         f"corpus bands")
    out = torch.empty((q, c), dtype=torch.int32, device=qkeys_bits.device)
    if q == 0 or c == 0:
        return out
    lib = _build.library("lsh_probe")
    if b > lib.freyja_lsh_probe_max_bands():
        raise ValueError(f"lsh_probe: {b} bands exceed the kernel's "
                         f"{lib.freyja_lsh_probe_max_bands()}")
    stream = torch.cuda.current_stream(qkeys_bits.device).cuda_stream
    err = lib.freyja_lsh_probe(qkeys_bits.data_ptr(), ckeys_bits.data_ptr(),
                               out.data_ptr(), q, c, b, stream)
    _build.check("lsh_probe", err)
    _build.count_launch("lsh_probe")
    return out
