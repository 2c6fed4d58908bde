"""Join-quality prediction from profiles (paper Section IV-B), in torch.

Pipeline: z-score numeric profiles lake-wide → per-pair distance vector
(|Δz| per numeric feature + frequent-word overlap + first-word equality) →
oblivious GBDT → predicted continuous quality Q(A,B,s).

The counterpart of ``repro.core.predictor``. The model file is the same
``.npz``, so a model saved by either package loads in the other; training
labels come from the exact sketches (:func:`exact_jk`) and the trees from
the numpy ``fit_gbdt`` shared by both packages.

The model path runs on the card through three kernels: the (Q, N, F_DIST)
distance tensor (``ops.profile_distance``), the labels
(``quality.continuous_quality`` -> ``ops.quality_cdf``) and the two-stage
scorer :func:`predict_scores` (distances, then ``ops.gbdt_infer``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.core import quality
from repro_torch.core.gbdt import GBDTConfig, GBDTParams, fit_gbdt, predict_np
from repro_torch.core.lakegen import Lake
from repro_torch.core.profiles import LakeProfiles, profile_lake
from repro_torch.core.sketches import batch_exact_metrics
from repro_torch.device import hashes_to_torch, resolve_device
from repro_torch.kernels import ops, ref

# training pairs whose label exceeds this count as positives; the zero-quality
# mass below it is subsampled to three negatives per positive
POSITIVE_LABEL = 0.02


def gbdt_predict_ref(gbdt_tuple, x: torch.Tensor) -> torch.Tensor:
    """Plain oblivious-GBDT inference. x: (..., F) -> (...)."""
    feats, thrs, leaves, base = gbdt_tuple
    return ref.gbdt_infer_ref(x, feats, thrs, leaves, base)


def gbdt_to_torch(gbdt_tuple, device) -> tuple:
    """``GBDTParams.astuple()`` -> (feats, thrs, leaves) tensors on ``device``
    and ``base`` as the float32 value both packages sum from."""
    feats, thrs, leaves, base = gbdt_tuple
    return (torch.from_numpy(np.asarray(feats, np.int32)).to(device),
            torch.from_numpy(np.asarray(thrs, np.float32)).to(device),
            torch.from_numpy(np.asarray(leaves, np.float32)).to(device),
            float(np.float32(base)))


def pairwise_distances(profiles: LakeProfiles, query_ids: np.ndarray,
                       device) -> torch.Tensor:
    """(Q, N, F_DIST) distance tensor for query columns vs the whole lake."""
    z = torch.from_numpy(profiles.zscored.astype(np.float32)).to(device)
    w = hashes_to_torch(profiles.words, device)
    qi = torch.from_numpy(np.asarray(query_ids, np.int64)).to(device)
    return ops.profile_distance(z[qi], w[qi], z, w)


@dataclasses.dataclass
class JoinQualityModel:
    gbdt: GBDTParams
    strictness: float = quality.DEFAULT_STRICTNESS
    train_r2: float = float("nan")

    def save(self, path: str) -> None:
        np.savez(path, feats=self.gbdt.feats, thrs=self.gbdt.thrs,
                 leaves=self.gbdt.leaves, base=np.float32(self.gbdt.base),
                 strictness=np.float32(self.strictness),
                 train_r2=np.float32(self.train_r2))

    @staticmethod
    def load(path: str) -> "JoinQualityModel":
        z = np.load(path)
        return JoinQualityModel(
            gbdt=GBDTParams(feats=z["feats"], thrs=z["thrs"], leaves=z["leaves"],
                            base=float(z["base"])),
            strictness=float(z["strictness"]), train_r2=float(z["train_r2"]))


def exact_jk(lake: Lake, query_ids: np.ndarray,
             corpus_ids: np.ndarray | None = None, *, device=None):
    """Exact (J, K) for query×corpus pairs from packed sketches -> numpy."""
    j, k = _exact_jk(lake, query_ids, corpus_ids, resolve_device(device))
    return j.cpu().numpy(), k.cpu().numpy()


def _exact_jk(lake: Lake, query_ids, corpus_ids, dev):
    """:func:`exact_jk` as (Q, N) float32 tensors on ``dev``."""
    p = lake.packed
    cids = np.arange(lake.n_columns) if corpus_ids is None else corpus_ids
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    i64 = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    q = np.asarray(query_ids)
    m = batch_exact_metrics(
        hashes_to_torch(p.values[q], dev), f32(p.counts[q]), i64(p.card[q]),
        i64(p.n_rows[q]), hashes_to_torch(p.values[cids], dev),
        f32(p.counts[cids]), i64(p.card[cids]), i64(p.n_rows[cids]))
    return m["j_multi"], m["k"]


def label_pairs(lake: Lake, profiles: LakeProfiles, query_ids: np.ndarray,
                strictness: float = quality.DEFAULT_STRICTNESS, *, device=None):
    """The training pairs of ``query_ids`` against the whole lake, on the
    device: the (Q, N, F_DIST) distance tensor and the (Q, N) continuous
    quality labels from the exact sketches."""
    dev = resolve_device(device)
    j, k = _exact_jk(lake, query_ids, None, dev)
    return (pairwise_distances(profiles, query_ids, dev),
            quality.continuous_quality(j, k, strictness))


def build_training_set(lake: Lake, profiles: LakeProfiles | None = None,
                       n_query: int = 192,
                       strictness: float = quality.DEFAULT_STRICTNESS,
                       seed: int = 0, *, device=None):
    """(X, y) training pairs: distance features -> continuous quality label."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    profiles = profiles if profiles is not None else profile_lake(lake.batch, device=dev)
    c = lake.n_columns
    qids = rng.choice(c, size=min(n_query, c), replace=False)
    d, y = label_pairs(lake, profiles, qids, strictness, device=dev)
    d, y = d.cpu().numpy(), y.cpu().numpy()                  # (Q, N, F_DIST), (Q, N)

    # drop self pairs; subsample the huge zero-quality mass for balance
    qi = np.repeat(qids, c)
    ci = np.tile(np.arange(c), len(qids))
    keep = qi != ci
    x = d.reshape(-1, FT.F_DIST)[keep]
    yy = y.reshape(-1)[keep]
    pos = yy > POSITIVE_LABEL
    neg = np.flatnonzero(~pos)
    n_neg = min(len(neg), max(1, 3 * int(pos.sum())))
    sel = np.concatenate([np.flatnonzero(pos), rng.choice(neg, size=n_neg, replace=False)])
    rng.shuffle(sel)
    return x[sel].astype(np.float32), yy[sel].astype(np.float32)


def train_quality_model(lakes: list[Lake], cfg: GBDTConfig = GBDTConfig(),
                        strictness: float = quality.DEFAULT_STRICTNESS,
                        n_query: int = 192, seed: int = 0, *,
                        device=None) -> JoinQualityModel:
    dev = resolve_device(device)
    xs, ys = [], []
    for i, lake in enumerate(lakes):
        x, y = build_training_set(lake, n_query=n_query, strictness=strictness,
                                  seed=seed + i, device=dev)
        xs.append(x)
        ys.append(y)
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    params = fit_gbdt(x, y, cfg)
    pred = predict_np(params, x)
    ss_res = float(np.sum((pred - y) ** 2))
    ss_tot = float(np.sum((y - y.mean()) ** 2)) or 1.0
    return JoinQualityModel(gbdt=params, strictness=strictness,
                            train_r2=1.0 - ss_res / ss_tot)


def predict_scores(model: JoinQualityModel, profiles: LakeProfiles,
                   query_ids: np.ndarray, *, device=None) -> np.ndarray:
    """(Q, N) predicted join quality for query columns vs the lake, in two
    stages: the materialized distance tensor, then the ensemble over its
    (Q·N, F_DIST) rows. The counterpart of ``predict_scores_ref``."""
    dev = resolve_device(device)
    d = pairwise_distances(profiles, query_ids, dev)
    return ops.gbdt_infer(d, gbdt_to_torch(model.gbdt.astuple(), dev)).cpu().numpy()
