"""MinHash signatures: the wrapper of ``csrc/minhash.cu``.

The port of ``repro.kernels.minhash.minhash_pallas``: for every column and
permutation p, the minimum over the column's rows of the universal hash
``h_p(v) = a_p · v + b_p (mod 2^32)``, sentinel cells counting as
0xFFFFFFFF. :func:`make_permutations` is bit-exact with the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build


def make_permutations(n_perm: int = 128, seed: int = 0):
    """Odd multipliers + offsets for multiply-shift universal hashing, as
    uint32 numpy arrays (the same draws as ``repro.kernels.minhash``)."""
    rng = np.random.default_rng(seed)
    a = (rng.integers(1, 2 ** 32, size=n_perm, dtype=np.uint64) | 1).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, size=n_perm, dtype=np.uint64).astype(np.uint32)
    return a, b


def minhash_cuda(values_bits, a_bits, b_bits):
    """Launch the MinHash kernel. ``values_bits`` (C, R), ``a_bits``/``b_bits``
    (P,): int32 bit-views of uint32 hashes on one CUDA device -> (C, P) int32
    bit-views of the signatures."""
    for name, t in (("values", values_bits), ("a", a_bits), ("b", b_bits)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"minhash: {name} must be a contiguous CUDA int32 "
                             f"tensor, got {t.dtype} on {t.device}")
    if values_bits.dim() != 2 or a_bits.dim() != 1 or a_bits.shape != b_bits.shape:
        raise ValueError(f"minhash: want values (C, R) and a, b (P,), got "
                         f"{tuple(values_bits.shape)}, {tuple(a_bits.shape)}, "
                         f"{tuple(b_bits.shape)}")
    c, r = values_bits.shape
    p = a_bits.shape[0]
    out = torch.empty((c, p), dtype=torch.int32, device=values_bits.device)
    if c == 0 or p == 0:
        return out
    lib = _build.library("minhash")
    stream = torch.cuda.current_stream(values_bits.device).cuda_stream
    err = lib.freyja_minhash(values_bits.data_ptr(), a_bits.data_ptr(),
                             b_bits.data_ptr(), out.data_ptr(), c, r, p, stream)
    _build.check("minhash", err)
    _build.count_launch("minhash")
    return out
