"""Candidate priority of the ``lsh`` and ``hybrid`` plans: the wrapper of
``csrc/candidate_priority.cu``.

No Pallas kernel: the JAX package leaves this step of
``repro.exec.stages.candidate_priorities`` to XLA. From the band probe's hit
mask, the proxy's matrix product ``g = (2·zq) @ zᵀ`` with the columns' squared
norms (``hybrid``; neither for ``lsh``) and the columns' ids and tables, one
pass gives each (query, column) its candidate priority: hits first, then the
squashed proxy, -inf where the column is excluded
(``ref.candidate_priority_ref`` is the plain version). With ``g`` the
priorities overwrite it in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_OP = "candidate_priority"
_INT32_MAX = 2 ** 31 - 1


def check_args(hit, g, znorm, cids, tids, tq, qid) -> None:
    """Raise unless ``hit`` is (Q, C) int32, ``g`` and ``znorm`` both None or
    (Q, C) and (C,) float32, ``cids`` and ``tids`` (C,) int64, ``tq`` and
    ``qid`` (Q,) int64, all contiguous and on ``hit``'s device."""
    if hit.dim() != 2:
        raise ValueError(f"{_OP}: hit must be 2-D, got {tuple(hit.shape)}")
    q, c = hit.shape
    if q > _INT32_MAX or c > _INT32_MAX:
        raise ValueError(f"{_OP}: {(q, c)} exceeds the kernel's int32 extents")
    if (g is None) != (znorm is None):
        raise ValueError(f"{_OP}: g and znorm come together (hybrid) or not at all (lsh)")
    for name, t, dtype, shape in (("hit", hit, torch.int32, (q, c)),
                                  ("g", g, torch.float32, (q, c)),
                                  ("znorm", znorm, torch.float32, (c,)),
                                  ("cids", cids, torch.int64, (c,)),
                                  ("tids", tids, torch.int64, (c,)),
                                  ("tq", tq, torch.int64, (q,)),
                                  ("qid", qid, torch.int64, (q,))):
        if t is None:
            continue
        if t.device != hit.device:
            raise ValueError(f"{_OP}: {name} is on {t.device}, hit on {hit.device}")
        if t.dtype != dtype:
            raise ValueError(f"{_OP}: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{_OP}: {name} has shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{_OP}: {name} must be contiguous")


def candidate_priority_cuda(hit, g, znorm, cids, tids, tq, qid):
    """Launch the kernel on CUDA tensors (see :func:`check_args`) -> the
    (Q, C) float32 priorities: ``g`` itself, overwritten, or a new tensor
    when ``g`` is None."""
    check_args(hit, g, znorm, cids, tids, tq, qid)
    _build.expect(_OP, hit, "hit", torch.int32, hit.shape)
    q, c = hit.shape
    prio = g if g is not None else torch.empty((q, c), dtype=torch.float32, device=hit.device)
    if q and c:
        lib = _build.library(_OP)
        n_sms = _build.sm_count(hit.device)
        ptr = lambda t: None if t is None else t.data_ptr()
        with _build.on_device(hit) as stream:
            err = lib.freyja_candidate_priority(
                hit.data_ptr(), ptr(g), ptr(znorm), cids.data_ptr(), tids.data_ptr(),
                tq.data_ptr(), qid.data_ptr(), prio.data_ptr(), q, c, n_sms, stream)
        _build.check(_OP, err)
        _build.count_launch(_OP)
    return prio
