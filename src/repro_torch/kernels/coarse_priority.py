"""Survivor priority of the tiered coarse pass: the wrapper of
``csrc/coarse_priority.cu``.

No Pallas kernel: the JAX package leaves this step of
``repro.exec.stages.tiered_survivors`` to XLA. From the coarse probe's hit
mask, the proxy and the columns' ids and tables, one pass gives each
(query, column) its survivor priority (block hits first, then the squashed
proxy, -inf where the column is excluded) and each query its direct hits and
digest-eligible survivors (``ref.coarse_priority_ref`` is the plain
version).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_OP = "coarse_priority"
_INT32_MAX = 2 ** 31 - 1


def check_args(hit, proxy, cids, tids, tq, qid, block_c: int) -> None:
    """Raise unless ``hit`` is (Q, C) int32, ``proxy`` None or (Q, C)
    float32, ``cids`` and ``tids`` (C,) int64, ``tq`` and ``qid`` (Q,) int64,
    all contiguous and on ``hit``'s device, and ``block_c`` >= 1."""
    if hit.dim() != 2:
        raise ValueError(f"{_OP}: hit must be 2-D, got {tuple(hit.shape)}")
    q, c = hit.shape
    if q > _INT32_MAX or c > _INT32_MAX:
        raise ValueError(f"{_OP}: {(q, c)} exceeds the kernel's int32 extents")
    for name, t, dtype, shape in (("hit", hit, torch.int32, (q, c)),
                                  ("proxy", proxy, torch.float32, (q, c)),
                                  ("cids", cids, torch.int64, (c,)),
                                  ("tids", tids, torch.int64, (c,)),
                                  ("tq", tq, torch.int64, (q,)),
                                  ("qid", qid, torch.int64, (q,))):
        if t is None and name == "proxy":
            continue
        if t.device != hit.device:
            raise ValueError(f"{_OP}: {name} is on {t.device}, hit on {hit.device}")
        if t.dtype != dtype:
            raise ValueError(f"{_OP}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{_OP}: {name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{_OP}: {name} must be contiguous")
    if block_c < 1:
        raise ValueError(f"{_OP}: block_c must be >= 1, got {block_c}")


def coarse_priority_cuda(hit, proxy, cids, tids, tq, qid, block_c: int):
    """Launch the kernel on CUDA tensors (see :func:`check_args`) ->
    (prio (Q, C) float32, n_hits (Q,) int64, n_survivors (Q,) int64)."""
    check_args(hit, proxy, cids, tids, tq, qid, block_c)
    _build.expect(_OP, hit, "hit", torch.int32, hit.shape)
    q, c = hit.shape
    prio = torch.empty((q, c), dtype=torch.float32, device=hit.device)
    counts = torch.zeros((2, q), dtype=torch.int64, device=hit.device)
    if q and c:
        lib = _build.library(_OP)
        n_sms = _build.sm_count(hit.device)
        with _build.on_device(hit) as stream:
            err = lib.freyja_coarse_priority(
                hit.data_ptr(), None if proxy is None else proxy.data_ptr(), cids.data_ptr(),
                tids.data_ptr(), tq.data_ptr(), qid.data_ptr(), prio.data_ptr(),
                counts.data_ptr(), q, c, int(block_c), n_sms, stream)
        _build.check(_OP, err)
        _build.count_launch(_OP)
    return prio, counts[0], counts[1]
