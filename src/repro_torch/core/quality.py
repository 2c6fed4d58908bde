"""The paper's join-quality metric (Section III-B / IV-A), in torch.

* multiset Jaccard      J(A,B) = |A ∩ B|_multiset / (|A| + |B|)   ∈ [0, 0.5]
* cardinality proportion K(A,B) = min(|A|,|B|) / max(|A|,|B|)     over
  distinct cardinalities ∈ (0, 1]
* discrete buckets      Q(A,B,L)
* continuous quality    Q(A,B,s) = product of truncated-Gaussian CDFs with
  the paper's fitted parameters (μ_J = 0 + strictness, μ_K = 0.44,
  σ_J = 0.19, σ_K = 0.28, truncation [0, 1]).

The counterpart of ``repro.core.quality``; as there, Φ is the standard
normal CDF ``0.5·(1 + erf(x/√2))`` and the discrete metric is the monotone
reading of the paper's formula (verified against its Example 3):

    Q(A,B,L) = max{ i ∈ [1..L] : J ≥ 2^{-(L-i+1)}  ∧  K ≥ (i-1)/L }, else 0.

:func:`continuous_quality` runs through ``kernels.ops.quality_cdf``: the
``quality_cdf`` kernel for a CUDA tensor, its plain version for a CPU one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops, ref

# Paper-fitted parameters (Section IV-A).
MU_J = 0.0
MU_K = 0.44
SIGMA_J = 0.19
SIGMA_K = 0.28
STRICTNESS = {"relaxed": 0.0, "balanced": 0.25, "strict": 0.5}
DEFAULT_STRICTNESS = 0.25   # the released model is trained at s = 0.25


@dataclasses.dataclass(frozen=True)
class QualityParams:
    mu_j: float = MU_J
    mu_k: float = MU_K
    sigma_j: float = SIGMA_J
    sigma_k: float = SIGMA_K
    lo: float = 0.0
    hi: float = 1.0


def multiset_jaccard(inter: torch.Tensor, n_a: torch.Tensor, n_b: torch.Tensor) -> torch.Tensor:
    """J from a precomputed multiset intersection size and multiset sizes."""
    denom = torch.clamp(n_a + n_b, min=1).to(torch.float32)
    return inter.to(torch.float32) / denom


def cardinality_proportion(card_a: torch.Tensor, card_b: torch.Tensor) -> torch.Tensor:
    a = torch.clamp(card_a.to(torch.float32), min=1.0)
    b = torch.clamp(card_b.to(torch.float32), min=1.0)
    return torch.minimum(a, b) / torch.maximum(a, b)


def containment(inter_set: torch.Tensor, card_a: torch.Tensor) -> torch.Tensor:
    """Set containment of A in B (baseline metric, Fig. 2)."""
    return inter_set.to(torch.float32) / torch.clamp(card_a.to(torch.float32), min=1.0)


def set_jaccard(inter_set: torch.Tensor, card_a: torch.Tensor,
                card_b: torch.Tensor) -> torch.Tensor:
    """Classical set Jaccard (baseline metric, Fig. 2)."""
    union = card_a + card_b - inter_set
    return inter_set.to(torch.float32) / torch.clamp(union.to(torch.float32), min=1.0)


def discrete_quality(j: torch.Tensor, k: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Q(A,B,L) as int32 — see the module docstring for the monotone reading."""
    q = torch.zeros(torch.broadcast_shapes(j.shape, k.shape), dtype=torch.int32,
                    device=j.device)
    for i in range(1, levels + 1):
        ok = (j >= 2.0 ** -(levels - i + 1)) & (k >= (i - 1) / levels)
        q = torch.where(ok, i, q)
    return q


# CDF of N(μ, σ²) truncated to [lo, hi] at float32 x, clamped to [0, 1]
truncated_cdf = ref.truncated_cdf_ref


def continuous_quality(j: torch.Tensor, k: torch.Tensor,
                       strictness: float = DEFAULT_STRICTNESS,
                       params: QualityParams = QualityParams()) -> torch.Tensor:
    """Q(A,B,s): the paper's continuous join-quality metric."""
    return ops.quality_cdf(j, k, params.mu_j + strictness, params.sigma_j, params.mu_k,
                           params.sigma_k, params.lo, params.hi)


# ---------------------------------------------------------------------------
# Wasserstein re-fit (the paper's Fig. 6 procedure): grid-search (μ, σ) per
# dimension to minimize the W1 distance between the truncated-Gaussian CDF and
# the empirical distribution of the discrete metric's marginals. A host-sized
# grid: the CDF is the plain version.
# ---------------------------------------------------------------------------

def _w1_to_edf(samples, mu, sigma, grid):
    edf = np.searchsorted(np.sort(samples), grid, side="right") / max(len(samples), 1)
    cdf = truncated_cdf(torch.from_numpy(grid.astype(np.float32)), float(mu),
                        float(sigma)).numpy()
    return float(np.trapezoid(np.abs(edf - cdf), grid))


def fit_truncated_gaussian(samples, mus, sigmas, n_grid: int = 256):
    """Exhaustive (μ, σ) grid search minimizing W1 to the empirical dist."""
    grid = np.linspace(0.0, 1.0, n_grid)
    best = (float("inf"), None, None)
    for mu in mus:
        for sg in sigmas:
            d = _w1_to_edf(samples, mu, sg, grid)
            if d < best[0]:
                best = (d, float(mu), float(sg))
    return {"w1": best[0], "mu": best[1], "sigma": best[2]}
