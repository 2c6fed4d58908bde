"""Oblivious-GBDT inference: the wrapper of ``csrc/gbdt_infer.cu``.

The port of ``repro.kernels.gbdt_infer.gbdt_infer_pallas``: (N, F) feature
rows -> (N,) predictions ``base + Σ_t leaves[t][Σ_l (x[feats[t,l]] >=
thrs[t,l]) << l]``, summed in tree order. The two-stage scorer
(``core.predictor.predict_scores``) runs it over the (Q·N, F_DIST) rows of
the materialized distance tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def gbdt_infer_cuda(x, feats, thrs, leaves, base: float):
    """Launch the ensemble. ``x`` (N, F) f32, ``feats`` (T, D) int32 feature
    ids in [0, F), ``thrs`` (T, D) f32, ``leaves`` (T, 2^D) f32, all on one
    CUDA device -> (N,) f32."""
    op = "gbdt_infer"
    if x.dim() != 2:
        raise ValueError(f"{op}: x must be (N, F), got {tuple(x.shape)}")
    n, f = x.shape
    t, d = feats.shape
    _build.expect(op, x, "x", torch.float32, (n, f))
    _build.expect(op, feats, "feats", torch.int32, (t, d))
    _build.expect(op, thrs, "thrs", torch.float32, (t, d))
    _build.expect(op, leaves, "leaves", torch.float32, (t, 1 << d))
    lib = _build.library(op)
    if lib.freyja_gbdt_infer_smem(f, t, d) > _build.MAX_SMEM:
        raise ValueError(f"{op}: a {t}x{d} ensemble over {f} features does not fit "
                         f"in shared memory")
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.freyja_gbdt_infer(x.data_ptr(), feats.data_ptr(), thrs.data_ptr(),
                                leaves.data_ptr(), float(base), out.data_ptr(), n, f,
                                t, d, stream)
    _build.check(op, err)
    _build.count_launch(op)
    return out
