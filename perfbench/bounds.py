"""The least time an H100 needs for a query batch's work, from its shapes.

A frozen copy of ``chip_smoke.py``'s bound arithmetic, with the peaks of one
NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): 3.35 TB/s of HBM,
67 Tflop/s of float32 outside the tensor cores and 33.5 Tops/s of int32. A
kernel's bound is the larger of its bytes over the bandwidth and its
operations over the rates; every input byte is counted read once and every
output byte written once; an FMA counts as two operations.

Each plan (``perfbench/plans/<kind>.py``) sums the bounds of the stages it
runs for one padded batch from the batch, the lake and the budgets, never
from kernel names, so it reads the same work whichever kernels do it.
"""
from __future__ import annotations

HBM_BPS, F32_OPS, I32_OPS = 3.35e12, 67e12, 33.5e12
F_NUM, F_WORDS, N_WORDS, F_DIST = 21, 11, 10, 23


def bound_s(n_bytes: float, f32_ops: float = 0.0, i32_ops: float = 0.0) -> float:
    return max(n_bytes / HBM_BPS, f32_ops / F32_OPS + i32_ops / I32_OPS)


def fused_score(q: int, corpus_rows: int, pairs: int, t: int, d: int,
                num_bytes: int = 4) -> float:
    """Query and corpus profiles and the trees read once, one score a pair
    written; per pair 21 subs and abs, T·D compares, T adds and a divide
    (float32), the 10x10 word compare-or, its sentinel tests and count, the
    first-word test and T·D index shifts/ors (int32). A sidecar of
    ``num_bytes`` a slot adds its scales and a dequantizing multiply a slot."""
    n_bytes = q * (F_NUM + F_WORDS) * 4 + corpus_rows * (F_NUM * num_bytes + F_WORDS * 4) \
        + t * d * 8 + t * (1 << d) * 4 + pairs * 4 + (F_NUM * 4 if num_bytes != 4 else 0)
    f32 = pairs * (2 * F_NUM + t * d + t + 1 + (F_NUM if num_bytes != 4 else 0))
    i32 = pairs * (2 * N_WORDS ** 2 + 2 * N_WORDS + 2 + 2 * t * d)
    return bound_s(n_bytes, f32, i32)


def lsh_probe(q: int, c: int, b: int) -> float:
    """Keys read once, the (Q, C) hit mask written; a compare and an or per
    (query, column, band)."""
    return bound_s((q + c) * b * 4 + q * c * 4, 0.0, 2.0 * q * c * b)


def lsh_probe_indexed(q: int, c: int, b: int, rows: int) -> float:
    """The ``rows`` distinct table rows the (Q, C') positions name, the
    positions and query keys read once, the hit mask written."""
    return bound_s(rows * b * 4 + q * c * 8 + q * b * 4 + q * c * 4, 0.0, 2.0 * q * c * b)


def topk(r: int, n: int, k: int) -> float:
    """The scores read once, the (R, k) int64 positions written."""
    return bound_s(r * n * 4 + r * k * 8)


def elementwise(n_elems: float, bytes_per_elem: float) -> float:
    """A pass over ``n_elems`` that moves ``bytes_per_elem`` each."""
    return bound_s(n_elems * bytes_per_elem)


def proxy(q: int, n: int, num_bytes: int) -> float:
    """-||zq - z||² up to a constant for (Q, N) pairs: the corpus read once
    (``num_bytes`` a slot), (Q, N) float32 written; 2·21 + 2 flops a pair."""
    return bound_s(n * F_NUM * num_bytes + q * n * 4, q * n * (2 * F_NUM + 2))
