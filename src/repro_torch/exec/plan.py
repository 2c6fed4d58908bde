"""Query planner for local plans: lake size × batch size × cost -> QueryPlan.

The port of ``repro.exec.plan`` for local plans. A :class:`QueryPlan` names
the candidate stage (``all``, ``lsh``, ``hybrid`` or ``tiered``), the
candidate budget, the tiered stage's survivor budget and k. As in the JAX
package, ``mode="lsh"`` resolves to the **hybrid** candidate stage (LSH hits
first, then profile-space proximity); the bare ``lsh`` stage is reached by
building a :class:`QueryPlan` directly. ``mode="tiered"`` is the two-tier
stage (coarse digest scan → survivor gather → fine probe), and
``mode="auto"`` picks among ``all``, ``hybrid`` and ``tiered`` by the cost
hook (``launch.costmodel.discovery_stage_costs`` unless the caller injects
another).

The serving engine pads micro-batches up a batch-bucket ladder
(:meth:`Planner.snap_batch`) and the resident corpus up a column-bucket
ladder (:meth:`Planner.snap_columns`), and warms every plan of
:meth:`Planner.plan_set` before it admits traffic. Every plan is local:
sharded plans (``mode="sharded"``, a mesh or a device grid) wait for the
multi-device slice (``ROADMAP.md`` queue 7) and raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.exec.stages import CANDIDATE_KINDS
from repro_torch.launch.costmodel import discovery_stage_costs

MODES = ("auto", "lsh", "full", "tiered")

# Padded-batch bucket ladder the continuous-batching runtime snaps formed
# micro-batches to, so only a handful of batch shapes are ever planned and
# warmed (the JAX package's ladder; ``launch.costmodel.derive_batch_buckets``
# replaces it with the sizes a measured batch sweep timed).
DEFAULT_BATCH_BUCKETS = (8, 16, 32, 64, 128, 256)

# The same idea on the corpus axis: engines taking live ingest pad the
# resident column count up this ladder with sentinel rows the exclusion mask
# scores -inf, so an ingest delta inside its bucket keeps every plan's
# budgets and the resident tensors' shapes (``Executor.extended`` copies the
# delta rows into the successor's tensors in place of a re-placement).
DEFAULT_COLUMN_BUCKETS = (1024, 2048, 4096, 8192, 16384, 32768,
                          65536, 131072)

_SHARDED_LATER = ("sharded plans (mode='sharded', a mesh or a device grid) "
                  "are not ported yet; they wait for the multi-device slice "
                  "(ROADMAP.md queue 7)")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One fully-resolved execution plan for a query micro-batch."""

    candidates: str                 # "all" | "lsh" | "hybrid" | "tiered"
    budget: int                     # candidate budget (n for "all")
    k: int
    survivor_budget: int = 0        # tiered only: coarse-pass gather width C'
    cost: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.candidates not in CANDIDATE_KINDS:
            raise ValueError(f"unknown candidate stage {self.candidates!r}")

    @property
    def kind(self) -> str:
        """Compact label for stats, e.g. ``local-hybrid``."""
        return f"local-{self.candidates}"

    # the placement fields of the JAX package's plans, fixed for local plans
    sharded = False
    grid = (1, 1)
    n_shards = 1


@dataclasses.dataclass
class PlannerConfig:
    k: int = 10
    candidate_frac: float = 0.2     # pruned budget as a fraction of the lake
    max_candidates: int = 4096      # absolute cap on that budget
    n_bands: int = 64
    # padded-batch bucket ladder (sorted ascending); empty = no snapping,
    # callers pad by their own multiple
    batch_buckets: tuple = ()
    # column-count bucket ladder (sorted ascending); empty = no snapping
    column_buckets: tuple = ()
    # ---- tiered candidate stage ----
    n_coarse_bands: int = 16        # super-band digest width S
    survivor_block: int = 32        # coarse survivor-block granularity
    survivor_frac: float = 0.05     # survivor budget as a fraction of the lake
    min_survivors: int = 512        # survivor budget floor
    # the survivor width is also the scoring width (tiered plans cap their
    # budget at it), so the cap guards the scorer's cost
    max_survivors: int = 2048       # survivor budget cap


class Planner:
    """Resolves (mode, lake size, batch size) into a local :class:`QueryPlan`.

    ``cost_fn(n_queries, n_columns, budget=..., candidates=..., k=...,
    n_bands=..., n_shards=..., q_shards=...)`` (plus ``survivor_budget`` and
    ``n_coarse_bands`` for the tiered stage) returns a dict with at least
    ``total_flops``; a measured ``total_cost`` takes precedence in "auto".
    """

    def __init__(self, config: PlannerConfig | None = None,
                 cost_fn: Callable | None = None):
        self.config = config or PlannerConfig()
        self.cost_fn = cost_fn or discovery_stage_costs

    def candidate_budget(self, n_columns: int) -> int:
        cfg = self.config
        want = max(cfg.k, int(n_columns * cfg.candidate_frac))
        return max(1, min(want, cfg.max_candidates, n_columns))

    def survivor_budget(self, n_columns: int, budget: int) -> int:
        """Coarse-pass gather width C' of a tiered plan: a fraction of the
        lake, floored by ``min_survivors``, capped by ``max_survivors`` and
        the lake, rounded up to the survivor block."""
        cfg = self.config
        want = max(int(n_columns * cfg.survivor_frac), cfg.min_survivors)
        want = min(want, cfg.max_survivors, max(n_columns, 1))
        blk = max(int(cfg.survivor_block), 1)
        return min(max(n_columns, 1), -(-want // blk) * blk)

    @staticmethod
    def _snap(n: int, ladder) -> int:
        """The smallest rung of ``ladder`` that fits ``n``, the next
        multiple of the top rung beyond it, or ``n`` without a ladder."""
        n = max(int(n), 1)
        buckets = tuple(sorted(ladder))
        if not buckets:
            return n
        for b in buckets:
            if n <= b:
                return int(b)
        top = int(buckets[-1])
        return -(-n // top) * top

    def snap_batch(self, n_queries: int) -> int:
        """Padded batch size for ``n_queries`` on the batch-bucket ladder."""
        return self._snap(n_queries, self.config.batch_buckets)

    def snap_columns(self, n_columns: int) -> int:
        """Padded corpus size for ``n_columns`` on the column-bucket ladder.
        The pad rows are inert sentinels (column id -1, masked to -inf by
        the exclusion stage)."""
        return self._snap(n_columns, self.config.column_buckets)

    def next_column_bucket(self, n_columns: int) -> int | None:
        """The bucket one rung above ``n_columns``'s (what a background
        pre-warm runs ahead of a crossing), or None without a ladder."""
        if not self.config.column_buckets:
            return None
        return self.snap_columns(self.snap_columns(n_columns) + 1)

    def _cost(self, candidates: str, n_queries: int, n_columns: int,
              budget: int, survivor_budget: int = 0) -> dict:
        kw = {}
        if candidates == "tiered":
            # only the tiered stage carries the extra geometry
            kw = dict(survivor_budget=survivor_budget or
                      self.survivor_budget(n_columns, budget),
                      n_coarse_bands=self.config.n_coarse_bands)
        return self.cost_fn(n_queries, n_columns, budget=budget,
                            candidates=candidates, k=self.config.k,
                            n_bands=self.config.n_bands, n_shards=1,
                            q_shards=1, **kw)

    def plan(self, *, n_columns: int, n_queries: int = 1, mode: str = "auto",
             mesh=None, grid: tuple | None = None) -> QueryPlan:
        _local_only(mode, mesh, grid)
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
        cfg = self.config
        budget = self.candidate_budget(n_columns)
        if mode == "full":
            cand = "all"
        elif mode == "tiered":
            cand = "tiered"
        elif mode == "lsh":
            cand = "hybrid"
        else:
            # auto: a pruned plan pays its probe and proxy over every column
            # to score only `budget` of them, so it wins when the budget is
            # small against the lake; tiered must win strictly
            pick = lambda c: c.get("total_cost", c["total_flops"])
            c_full = self._cost("all", n_queries, n_columns, n_columns)
            c_pruned = self._cost("hybrid", n_queries, n_columns, budget)
            cand = "hybrid" if pick(c_pruned) < pick(c_full) else "all"
            if cfg.n_coarse_bands > 0:
                c_tier = self._cost("tiered", n_queries, n_columns, budget)
                if pick(c_tier) < min(pick(c_pruned), pick(c_full)):
                    cand = "tiered"
        if cand == "all":
            budget = n_columns
        surv = self.survivor_budget(n_columns, budget) if cand == "tiered" else 0
        if cand == "tiered":
            # the fine tier scores no more columns than the coarse pass gathered
            budget = min(budget, surv)
        cost = self._cost(cand, n_queries, max(n_columns, 1), max(budget, 1),
                          survivor_budget=surv)
        return QueryPlan(candidates=cand, budget=budget, k=cfg.k,
                         survivor_budget=surv, cost=cost)

    def _make_plan(self, cand: str, n_columns: int, n_queries: int) -> QueryPlan:
        """A resolved local plan for an explicitly chosen candidate kind:
        the budget and survivor resolution of :meth:`plan` without its mode
        logic, so warmup can enumerate kinds the mode would not pick."""
        budget = n_columns if cand == "all" else self.candidate_budget(n_columns)
        surv = self.survivor_budget(n_columns, budget) if cand == "tiered" else 0
        if cand == "tiered":
            budget = min(budget, surv)
        cost = self._cost(cand, n_queries, max(n_columns, 1), max(budget, 1),
                          survivor_budget=surv)
        return QueryPlan(candidates=cand, budget=budget, k=self.config.k,
                         survivor_budget=surv, cost=cost)

    def plan_set(self, *, n_columns: int, n_queries: int = 1, mode: str = "auto",
                 mesh=None, grid: tuple | None = None,
                 scope: str = "serve") -> list[QueryPlan]:
        """The plans warmup runs for one padded batch size.

        ``scope="serve"``: the plan this mode executes plus the full-scan
        recall baseline ``measure_recall`` runs beside it. ``scope="full"``:
        also every candidate kind (``tiered`` only with a coarse digest).
        Deduplicated on the plan's identity fields; the executor skips any
        plan its corpus cannot serve."""
        if scope not in ("serve", "full"):
            raise ValueError(f"unknown warmup scope {scope!r}; want 'serve' or 'full'")
        served = self.plan(n_columns=n_columns, n_queries=n_queries, mode=mode,
                           mesh=mesh, grid=grid)
        plans = [served, self.plan(n_columns=n_columns, n_queries=n_queries, mode="full")]
        if scope == "full":
            for cand in CANDIDATE_KINDS:
                if cand == "tiered" and self.config.n_coarse_bands <= 0:
                    continue                # no coarse digest to scan
                plans.append(self._make_plan(cand, n_columns, n_queries))
        out, seen = [], set()
        for p in plans:
            key = (p.candidates, p.budget, p.k, p.survivor_budget)
            if key not in seen:
                seen.add(key)
                out.append(p)
        return out


def _local_only(mode: str, mesh, grid) -> None:
    """Raise for what only a sharded plan could serve."""
    if mode == "sharded" or mesh is not None or (
            grid is not None and tuple(int(x) for x in grid) != (1, 1)):
        raise NotImplementedError(_SHARDED_LATER)
