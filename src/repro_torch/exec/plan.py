"""Query planner for local plans: lake size × batch size -> QueryPlan.

The port of ``repro.exec.plan`` for the local ``full`` and ``lsh`` modes. A
:class:`QueryPlan` names the candidate stage (``all``, ``lsh`` or
``hybrid``), the candidate budget and k. As in the JAX package,
``mode="lsh"`` resolves to the **hybrid** candidate stage (LSH hits first,
then profile-space proximity); the bare ``lsh`` stage is reached by building
a :class:`QueryPlan` directly. Sharded and tiered plans and the cost-model
``auto`` mode wait for later slices.
"""
from __future__ import annotations

import dataclasses

from repro_torch.exec.stages import CANDIDATE_KINDS

MODES = ("lsh", "full")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One fully-resolved execution plan for a query micro-batch."""

    candidates: str                 # "all" | "lsh" | "hybrid"
    budget: int                     # candidate budget (n for "all")
    k: int

    def __post_init__(self):
        if self.candidates not in CANDIDATE_KINDS:
            raise ValueError(f"unknown candidate stage {self.candidates!r}")

    @property
    def kind(self) -> str:
        """Compact label for stats, e.g. ``local-hybrid``."""
        return f"local-{self.candidates}"


@dataclasses.dataclass
class PlannerConfig:
    k: int = 10
    candidate_frac: float = 0.2     # pruned budget as a fraction of the lake
    max_candidates: int = 4096      # absolute cap on that budget


class Planner:
    """Resolves (mode, lake size) into a local :class:`QueryPlan`."""

    def __init__(self, config: PlannerConfig | None = None):
        self.config = config or PlannerConfig()

    def candidate_budget(self, n_columns: int) -> int:
        cfg = self.config
        want = max(cfg.k, int(n_columns * cfg.candidate_frac))
        return max(1, min(want, cfg.max_candidates, n_columns))

    def plan(self, *, n_columns: int, mode: str = "full") -> QueryPlan:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
        if mode == "full":
            return QueryPlan(candidates="all", budget=n_columns, k=self.config.k)
        return QueryPlan(candidates="hybrid",
                         budget=self.candidate_budget(n_columns),
                         k=self.config.k)
