"""The paper's join-quality metric (Section III-B / IV-A), in torch.

* multiset Jaccard      J(A,B) = |A ∩ B|_multiset / (|A| + |B|)   ∈ [0, 0.5]
* cardinality proportion K(A,B) = min(|A|,|B|) / max(|A|,|B|)
* continuous quality    Q(A,B,s) = product of truncated-Gaussian CDFs with
  the paper's fitted parameters (μ_J = 0 + strictness, μ_K = 0.44,
  σ_J = 0.19, σ_K = 0.28, truncation [0, 1]).

The counterpart of ``repro.core.quality``'s label path; as there, Φ is the
standard normal CDF ``0.5·(1 + erf(x/√2))``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

MU_J = 0.0
MU_K = 0.44
SIGMA_J = 0.19
SIGMA_K = 0.28
DEFAULT_STRICTNESS = 0.25   # the released model is trained at s = 0.25

_SQRT2 = torch.tensor(math.sqrt(2.0), dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class QualityParams:
    mu_j: float = MU_J
    mu_k: float = MU_K
    sigma_j: float = SIGMA_J
    sigma_k: float = SIGMA_K
    lo: float = 0.0
    hi: float = 1.0


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF (float32)."""
    return 0.5 * (1.0 + torch.erf(x / _SQRT2.to(x.device)))


def truncated_cdf(x: torch.Tensor, mu: float, sigma: float,
                  lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """CDF of N(mu, sigma²) truncated to [lo, hi], evaluated at x."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)
    num = _phi((x - mu) / sigma) - _phi(f32((lo - mu) / sigma))
    den = _phi(f32((hi - mu) / sigma)) - _phi(f32((lo - mu) / sigma))
    return torch.clamp(num / den, 0.0, 1.0)


def continuous_quality(j: torch.Tensor, k: torch.Tensor,
                       strictness: float = DEFAULT_STRICTNESS,
                       params: QualityParams = QualityParams()) -> torch.Tensor:
    """Q(A,B,s): the paper's continuous join-quality metric."""
    cj = truncated_cdf(j, params.mu_j + strictness, params.sigma_j, params.lo, params.hi)
    ck = truncated_cdf(k, params.mu_k, params.sigma_k, params.lo, params.hi)
    return cj * ck
