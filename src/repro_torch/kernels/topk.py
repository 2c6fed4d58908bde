"""Exact top-k in ``jax.lax.top_k``'s order: the wrapper of ``csrc/topk.cu``.

The counterpart of ``jax.lax.top_k`` (XLA's ``TopK``, not a Pallas kernel)
for every top-k of the port: the candidate gathers, the merges, the exact
re-rank, the MoE router and the profiles' top-10 words. The order is the
float32 total order (-NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN,
NaNs by their bits), the lower index first among equal bit patterns.

:func:`topk_plan` decides, from the shape alone, how the kernel runs and
every tensor one call allocates (its positions and its scratch). The
wrapper allocates from it, and so does :func:`topk_meta`, which stands in
for the kernel on ``meta`` tensors, where the dry run (``launch/dryrun.py``)
traces the merges and the MoE router: the bytes it counts are the kernel's.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

SORT_MAX = 4096          # words one block sorts in shared memory (32 KB)
MIN_SLICE = 8192         # scores a block of the select regime reads at least
MAX_SLICES = 64          # blocks a row of the select regime is split over
BINS = 256               # a radix round's bins (8 bits)
STATE_WORDS = 8          # per-row state of the select regime
WARP_K_MAX = 128         # the warp regime's largest k (4 words a lane)
# a warp regime's slice (one warp's share of a row): at least WARP_MIN_SLICE
# words and WARP_SLICE_PER_K a kept word (the words a slice passes grow
# with k · log(slice / k)), enough slices for WARP_TARGET warps (132 SMs x 32)
# over the rows, in whole steps of 32 lanes x 8 loads
WARP_MIN_SLICE, WARP_SLICE_PER_K, WARP_TARGET, WARP_STEP = 1024, 64, 132 * 32, 256
_REGIMES = {"sort": 0, "select": 1, "warp": 2}


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    """How the kernel runs on an (R, N) input at k, and what one call
    allocates: ``buffers`` maps a name to (shape, dtype, zeroed), its output
    ``pos`` first."""
    regime: str          # "none" (nothing to launch), "warp", "sort", "select"
    passes: tuple        # (slices a row, slice length) a pass: the select's one, the warp's
    p: int               # the power of two a row (sort) or k (select) is sorted at
    buffers: dict


def _warp_pass(n: int, r: int, k: int) -> tuple[int, int]:
    m = max(WARP_MIN_SLICE, WARP_SLICE_PER_K * k, -(-n // -(-WARP_TARGET // max(r, 1))))
    m = -(-m // WARP_STEP) * WARP_STEP
    return -(-n // m), m


def topk_plan(r: int, n: int, k: int) -> TopkPlan:
    """The plan of one top-k of ``k`` over ``r`` rows of ``n`` float32.
    ``k <= WARP_K_MAX``: warps keep each slice's k largest in registers,
    then again over the slices' words until one slice a row is left. A
    larger ``k``: a row of at most ``SORT_MAX`` is sorted whole in shared
    memory; a longer row goes through the radix select, split over up to
    ``MAX_SLICES`` blocks, and its k words are sorted, in shared memory up
    to ``SORT_MAX`` and past it through a (R, 2^ceil(log2 k)) scratch."""
    if not 0 <= k <= n:
        raise ValueError(f"topk: want 0 <= k <= {n}, got {k}")
    buffers = {"pos": ((r, k), torch.int64, False)}
    if r == 0 or k == 0:
        return TopkPlan("none", (), 0, buffers)
    if k <= WARP_K_MAX:
        passes = [_warp_pass(n, r, k)]
        while passes[-1][0] > 1:
            passes.append(_warp_pass(passes[-1][0] * k, r, k))
        for name, (slices, _) in zip(("cand", "cand2"), passes[:-1]):
            buffers[name] = ((r, slices * k), torch.int64, False)
        return TopkPlan("warp", tuple(passes), 0, buffers)
    if n <= SORT_MAX:
        return TopkPlan("sort", (), _pow2(n), buffers)
    slices = min(MAX_SLICES, -(-n // MIN_SLICE))
    slice_len = -(-n // slices)
    slices = -(-n // slice_len)
    p = _pow2(k)
    buffers.update(state=((r, STATE_WORDS), torch.int32, True),
                   hist=((r, slices, BINS), torch.int32, False),
                   cand=((r, k), torch.int64, False))
    if p > SORT_MAX:
        buffers["cand2"] = ((r, p), torch.int64, False)
    return TopkPlan("select", ((slices, slice_len),), p, buffers)


def _allocate(plan: TopkPlan, device) -> dict:
    return {name: (torch.zeros if zeroed else torch.empty)(shape, dtype=dtype, device=device)
            for name, (shape, dtype, zeroed) in plan.buffers.items()}


def topk_meta(x: torch.Tensor, k: int) -> torch.Tensor:
    """The kernel's allocations for a ``meta`` (R, N) tensor: its (R, k)
    positions, which it returns (meta tensors hold no values), and its
    scratch, freed on return as the kernel's is."""
    return _allocate(topk_plan(*x.shape, k), x.device)["pos"]


def topk_cuda(x: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the kernel. ``x``: a contiguous float32 (R, N) CUDA tensor ->
    (R, k) int64 positions of each row's k largest entries, in descending
    order, the lower index first among equal bit patterns."""
    op = "topk"
    if x.dim() != 2:
        raise ValueError(f"topk: want a (R, N) tensor, got shape {tuple(x.shape)}")
    _build.expect(op, x, "x", torch.float32, x.shape)
    r, n = x.shape
    plan = topk_plan(r, n, k)
    bufs = _allocate(plan, x.device)
    pos = bufs["pos"]
    if plan.regime == "none":
        return pos
    ptr = lambda name: bufs[name].data_ptr() if name in bufs else None
    flat = [v for pass_ in plan.passes for v in pass_]
    passes = (ctypes.c_longlong * max(len(flat), 1))(*flat)
    lib = _build.library(op)
    with _build.on_device(x) as stream:
        err = lib.freyja_topk(x.data_ptr(), pos.data_ptr(), ptr("state"), ptr("hist"),
                              ptr("cand"), ptr("cand2"), r, n, k, _REGIMES[plan.regime],
                              passes, len(plan.passes), plan.p, stream)
    _build.check(op, err)
    _build.count_launch(op)
    return pos
