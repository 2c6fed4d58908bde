"""Oblivious-tree gradient boosting — the paper's GBM.

A numpy copy of ``repro.core.gbdt``: the same ``(X, y)`` gives identical
trees in both packages. **Oblivious (symmetric) trees** use one
(feature, threshold) pair per *level*, so inference is

    leaf_index = Σ_level  (x[feat_l] ≥ thr_l) << l
    prediction += leaves[leaf_index]

which is branch-free and batchable. Training (histogram-based greedy,
second-order boosting) runs offline in numpy; only inference must scale to
lake size, and the port does it inside the fused scoring kernel
(``kernels/csrc/fused_score.cu``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GBDTParams:
    """Dense parameterization of an oblivious-tree ensemble."""

    feats: np.ndarray    # (T, D) int32   — feature index per (tree, level)
    thrs: np.ndarray     # (T, D) float32 — threshold per (tree, level)
    leaves: np.ndarray   # (T, 2^D) float32
    base: float          # initial prediction (mean of targets)

    @property
    def n_trees(self) -> int:
        return int(self.feats.shape[0])

    @property
    def depth(self) -> int:
        return int(self.feats.shape[1])

    def astuple(self):
        return self.feats, self.thrs, self.leaves, np.float32(self.base)

    def save(self, path: str) -> None:
        np.savez(path, feats=self.feats, thrs=self.thrs, leaves=self.leaves,
                 base=np.float32(self.base))

    @staticmethod
    def load(path: str) -> "GBDTParams":
        z = np.load(path)
        return GBDTParams(feats=z["feats"], thrs=z["thrs"], leaves=z["leaves"],
                          base=float(z["base"]))


@dataclasses.dataclass
class GBDTConfig:
    n_trees: int = 50          # paper: estimators reduced 100 -> 50
    depth: int = 5
    learning_rate: float = 0.1
    n_bins: int = 32
    l2: float = 1.0
    min_child_weight: float = 4.0
    seed: int = 0


def _quantile_bins(x: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature candidate thresholds from quantiles (unique-ified)."""
    qs = np.quantile(x, np.linspace(0.02, 0.98, n_bins), axis=0)
    return qs  # (n_bins, F)


def fit_gbdt(x: np.ndarray, y: np.ndarray, cfg: GBDTConfig = GBDTConfig()) -> GBDTParams:
    """Second-order (hessian = 1 for L2 loss) oblivious-tree boosting.

    Histogram-based: features are digitized into ``n_bins`` quantile bins
    once; per (tree, level) a single scatter-add builds the (node, bin)
    gradient/hessian histograms and suffix sums score every threshold of
    every feature at once.
    """
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float64)
    n, f = x.shape
    t, d = cfg.n_trees, cfg.depth
    b = cfg.n_bins
    thr_cand = _quantile_bins(x, b)                        # (B, F)
    # digitize: bin[i, fi] = #thresholds <= x[i, fi]  ∈ [0, B]
    binidx = np.empty((n, f), np.int32)
    for fi in range(f):
        thr_sorted = np.sort(thr_cand[:, fi])
        thr_cand[:, fi] = thr_sorted
        binidx[:, fi] = np.searchsorted(thr_sorted, x[:, fi], side="right")

    base = float(np.mean(y))
    pred = np.full((n,), base, dtype=np.float64)

    feats = np.zeros((t, d), np.int32)
    thrs = np.zeros((t, d), np.float32)
    leaves = np.zeros((t, 2 ** d), np.float32)

    for ti in range(t):
        grad = pred - y                                    # dL/dpred, L2 loss
        node = np.zeros((n,), np.int64)                    # current leaf index
        for lvl in range(d):
            n_nodes = 2 ** lvl
            g_tot = np.bincount(node, weights=grad, minlength=n_nodes)
            h_tot = np.bincount(node, minlength=n_nodes).astype(np.float64)
            parent_score = np.sum(g_tot ** 2 / (h_tot + cfg.l2))

            best = (1e-12, -1, 0.0)
            for fi in range(f):
                key = node * (b + 1) + binidx[:, fi]
                g_hist = np.bincount(key, weights=grad, minlength=n_nodes * (b + 1))
                h_hist = np.bincount(key, minlength=n_nodes * (b + 1)).astype(np.float64)
                g_hist = g_hist.reshape(n_nodes, b + 1)
                h_hist = h_hist.reshape(n_nodes, b + 1)
                # right side of threshold bi = bins >= bi + 1 (suffix sums)
                g_sfx = np.cumsum(g_hist[:, ::-1], axis=1)[:, ::-1]
                h_sfx = np.cumsum(h_hist[:, ::-1], axis=1)[:, ::-1]
                g_r = g_sfx[:, 1:b + 1].T                  # (B, n_nodes)
                h_r = h_sfx[:, 1:b + 1].T
                g_l, h_l = g_tot[None] - g_r, h_tot[None] - h_r
                score = (g_l ** 2 / (h_l + cfg.l2) + g_r ** 2 / (h_r + cfg.l2)).sum(axis=1)
                valid = ((h_l >= cfg.min_child_weight) & (h_r >= cfg.min_child_weight)).any(axis=1)
                score = np.where(valid, score - parent_score, -np.inf)
                bi = int(np.argmax(score))
                if score[bi] > best[0]:
                    best = (float(score[bi]), fi, float(thr_cand[bi, fi]))
            _, fi, thr = best
            if fi < 0:        # no useful split at this level: constant level
                fi, thr = 0, np.float32(np.inf)
            feats[ti, lvl] = fi
            thrs[ti, lvl] = thr
            node = node | ((x[:, fi] >= thr).astype(np.int64) << lvl)

        g_leaf = np.bincount(node, weights=grad, minlength=2 ** d)
        h_leaf = np.bincount(node, minlength=2 ** d).astype(np.float64)
        w = -g_leaf / (h_leaf + cfg.l2) * cfg.learning_rate
        leaves[ti] = w.astype(np.float32)
        pred = pred + w[node]

    return GBDTParams(feats=feats, thrs=thrs, leaves=leaves, base=base)


def predict_np(params: GBDTParams, x: np.ndarray) -> np.ndarray:
    """Reference numpy inference (used in training-side validation)."""
    n = x.shape[0]
    out = np.full((n,), params.base, dtype=np.float64)
    for ti in range(params.n_trees):
        node = np.zeros((n,), np.int64)
        for lvl in range(params.depth):
            node |= (x[:, params.feats[ti, lvl]] >= params.thrs[ti, lvl]).astype(np.int64) << lvl
        out += params.leaves[ti][node]
    return out.astype(np.float32)
