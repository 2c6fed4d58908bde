"""Query planner: lake size × batch size × mesh × cost -> QueryPlan.

The port of ``repro.exec.plan``. A :class:`QueryPlan` names the candidate
stage (``all``, ``lsh``, ``hybrid`` or ``tiered``), the candidate budget,
the tiered stage's survivor budget, k, and the placement: local, or a 2-D
**(query × data) device grid** ``grid=(q_shards, d_shards)`` whose tiles
each score one (Q-shard, C-shard) of the problem (``exec/sharded.py``). As
in the JAX
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
:meth:`Planner.plan_set` before it admits traffic.

Placement, as in the JAX package: ``mode="sharded"`` is the full scan over
a mesh, ``mode="lsh"`` over a mesh shards whenever the mesh holds more than
one grid device, and ``auto`` shards only when some factorization with
d_shards > 1 is admissible (the lake, not the batch, must justify the
mesh), costing each candidate kind at its own best grid.
:meth:`Planner.choose_grid` picks the factorization: q_shards never exceeds
the padded batch, a d_shards > 1 column shard must clear
``min_columns_per_shard``, and the cheapest by the cost hook wins. The
``tiered`` stage is local only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.exec.stages import CANDIDATE_KINDS
from repro_torch.launch.costmodel import discovery_stage_costs

MODES = ("auto", "lsh", "full", "sharded", "tiered")

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

# The tiered stage's survivor-block granularity: the coarse pass expands a
# digest hit to its block of this many contiguous columns, and the planner
# rounds the survivor budget up to a whole number of blocks.
SURVIVOR_BLOCK = 32


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """One fully-resolved execution plan for a query micro-batch."""

    candidates: str                 # "all" | "lsh" | "hybrid" | "tiered"
    budget: int                     # GLOBAL candidate budget (n for "all")
    k: int
    sharded: bool = False           # score per grid tile, 2-phase merge
    n_shards: int = 1               # data-axis shards (= grid[1])
    grid: tuple = (1, 1)            # (q_shards, d_shards) device grid
    shard_axes: tuple = ("data",)
    survivor_budget: int = 0        # tiered only: coarse-pass gather width C'
    cost: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        if self.candidates not in CANDIDATE_KINDS:
            raise ValueError(f"unknown candidate stage {self.candidates!r}")
        g = tuple(int(x) for x in self.grid)
        if len(g) != 2 or g[0] < 1 or g[1] < 1:
            raise ValueError(f"grid must be (q_shards, d_shards) >= (1, 1); "
                             f"got {self.grid!r}")
        if g == (1, 1) and self.n_shards > 1:
            g = (1, int(self.n_shards))     # 1-D construction
        object.__setattr__(self, "grid", g)
        object.__setattr__(self, "n_shards", g[1])

    @property
    def kind(self) -> str:
        """Compact label for stats, e.g. ``sharded-hybrid``."""
        return f"{'sharded' if self.sharded else 'local'}-{self.candidates}"

    @property
    def q_shards(self) -> int:
        """Query-axis shard count of the placement grid."""
        return self.grid[0]

    @property
    def n_grid_devices(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def budget_per_shard(self) -> int:
        """Per-tile slice of the global budget: a ceil split over the data
        axis only (every query shard sees the full per-query budget)."""
        return max(1, -(-self.budget // max(self.n_shards, 1)))


@dataclasses.dataclass
class PlannerConfig:
    k: int = 10
    candidate_frac: float = 0.2     # pruned budget as a fraction of the lake
    max_candidates: int = 4096      # absolute cap on that budget
    n_bands: int = 64
    shard_axes: tuple = ("data",)
    # below this many columns per data shard, column sharding costs more
    # than it saves; gates d_shards > 1 factorizations (and "auto" sharding)
    min_columns_per_shard: int = 64
    # padded-batch bucket ladder (sorted ascending); empty = no snapping,
    # callers pad by their own multiple
    batch_buckets: tuple = ()
    # column-count bucket ladder (sorted ascending); empty = no snapping
    column_buckets: tuple = ()
    # ---- tiered candidate stage ----
    n_coarse_bands: int = 16        # super-band digest width S
    survivor_frac: float = 0.05     # survivor budget as a fraction of the lake
    min_survivors: int = 512        # survivor budget floor
    # the survivor width is also the scoring width (tiered plans cap their
    # budget at it), so the cap guards the scorer's cost
    max_survivors: int = 2048       # survivor budget cap


class Planner:
    """Resolves (mode, lake size, batch size, mesh) into a :class:`QueryPlan`.

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
        return min(max(n_columns, 1), -(-want // SURVIVOR_BLOCK) * SURVIVOR_BLOCK)

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

    def _n_shards(self, mesh) -> int:
        """Grid capacity of ``mesh``: its data-shardable devices, times a
        ``query`` axis when the caller built one."""
        if mesh is None:
            return 1
        n = 1
        for ax in self.config.shard_axes:
            n *= int(mesh.shape[ax])
        try:
            n *= int(mesh.shape["query"])
        except (KeyError, TypeError):
            pass
        return n

    def _cost(self, candidates: str, n_queries: int, n_columns: int,
              budget: int, n_shards: int = 1, q_shards: int = 1,
              survivor_budget: int = 0) -> dict:
        kw = {}
        if candidates == "tiered":
            # only the tiered stage carries the extra geometry
            kw = dict(survivor_budget=survivor_budget or
                      self.survivor_budget(n_columns, budget),
                      n_coarse_bands=self.config.n_coarse_bands)
        return self.cost_fn(n_queries, n_columns, budget=budget,
                            candidates=candidates, k=self.config.k,
                            n_bands=self.config.n_bands, n_shards=n_shards,
                            q_shards=q_shards, **kw)

    # -- grid placement -----------------------------------------------------

    def grid_options(self, n_devices: int, n_queries: int,
                     n_columns: int) -> list[tuple[int, int]]:
        """Admissible (q_shards, d_shards) factorizations of ``n_devices``:
        q·d uses every grid device, q never exceeds the (padded) batch, and
        a d > 1 column shard clears ``min_columns_per_shard``. Sorted by q."""
        cfg = self.config
        q_cap = max(int(n_queries), 1)
        out = []
        for q in range(1, n_devices + 1):
            if n_devices % q or q > q_cap:
                continue
            d = n_devices // q
            if d > 1 and -(-n_columns // d) < cfg.min_columns_per_shard:
                continue
            out.append((q, d))
        return out

    def choose_grid(self, n_devices: int, *, n_queries: int, n_columns: int,
                    candidates: str, budget: int) -> tuple[int, int] | None:
        """The cheapest admissible grid by the cost hook, or None when no
        factorization is admissible. A measured ``total_cost`` wins; the
        analytic flop + HBM + collective-byte composite breaks ties, then
        the smaller q."""
        options = self.grid_options(n_devices, n_queries, n_columns)
        if not options:
            return None

        def key(g):
            q, d = g
            c = self._cost(candidates, n_queries, max(n_columns, 1),
                           max(budget, 1), d, q)
            composite = (c.get("total_flops", 0.0)
                         + c.get("total_hbm_bytes", 0.0)
                         + c.get("total_collective_bytes", 0.0))
            return (c.get("total_cost", composite), composite, q)

        return min(options, key=key)

    def _resolve_grid(self, grid, n_devices: int, n_queries: int,
                      n_columns: int, candidates: str,
                      budget: int) -> tuple[int, int]:
        if grid is not None:
            q, d = (int(grid[0]), int(grid[1]))
            if q < 1 or d < 1 or q * d != n_devices:
                raise ValueError(
                    f"grid {grid!r} does not factorize the mesh's "
                    f"{n_devices} grid devices (want q*d == {n_devices})")
            if q > max(n_queries, 1):
                raise ValueError(
                    f"grid {grid!r}: q_shards={q} exceeds the padded batch "
                    f"of {n_queries} — idle query shards are pure waste")
            return (q, d)
        return (self.choose_grid(n_devices, n_queries=n_queries,
                                 n_columns=n_columns, candidates=candidates,
                                 budget=budget)
                or (1, n_devices))

    # -- entry point --------------------------------------------------------

    def plan(self, *, n_columns: int, n_queries: int = 1, mode: str = "auto",
             mesh=None, grid: tuple | None = None) -> QueryPlan:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; want one of {MODES}")
        cfg = self.config
        n_dev = self._n_shards(mesh)
        budget = self.candidate_budget(n_columns)
        if mode == "sharded":
            if mesh is None:
                raise ValueError("mode='sharded' needs a mesh")
            cand, sharded = "all", True
        elif mode == "full":
            cand, sharded = "all", False
        elif mode == "tiered":
            cand, sharded = "tiered", False
        elif mode == "lsh":
            # an explicit mesh is operator intent: shard whenever one exists
            cand, sharded = "hybrid", n_dev > 1
        else:
            # auto: shard only when an admissible d > 1 factorization exists;
            # a pruned plan pays its probe and proxy over every column to
            # score only `budget` of them, so it wins when the budget is
            # small against the lake; each kind is costed at its own grid,
            # and tiered (local only) must win strictly
            sharded = (n_dev > 1 and
                       any(d > 1 for _, d in
                           self.grid_options(n_dev, n_queries, n_columns)))
            if sharded:
                g_all = self._resolve_grid(grid, n_dev, n_queries,
                                           n_columns, "all", n_columns)
                g_pruned = self._resolve_grid(grid, n_dev, n_queries,
                                              n_columns, "hybrid", budget)
            else:
                g_all = g_pruned = (1, 1)
            pick = lambda c: c.get("total_cost", c["total_flops"])
            c_full = self._cost("all", n_queries, n_columns, n_columns,
                                g_all[1], g_all[0])
            c_pruned = self._cost("hybrid", n_queries, n_columns, budget,
                                  g_pruned[1], g_pruned[0])
            cand = "hybrid" if pick(c_pruned) < pick(c_full) else "all"
            if not sharded and cfg.n_coarse_bands > 0:
                c_tier = self._cost("tiered", n_queries, n_columns, budget)
                if pick(c_tier) < min(pick(c_pruned), pick(c_full)):
                    cand = "tiered"
        if cand == "all":
            budget = n_columns
        surv = self.survivor_budget(n_columns, budget) if cand == "tiered" else 0
        if cand == "tiered":
            # the fine tier scores no more columns than the coarse pass gathered
            budget = min(budget, surv)
        g = (self._resolve_grid(grid, n_dev, n_queries, n_columns, cand, budget)
             if sharded else (1, 1))
        return self._resolved(cand, sharded, g, budget, surv, n_columns, n_queries)

    def _resolved(self, cand: str, sharded: bool, g: tuple, budget: int,
                  surv: int, n_columns: int, n_queries: int) -> QueryPlan:
        cost = self._cost(cand, n_queries, max(n_columns, 1), max(budget, 1),
                          max(g[1], 1), g[0], survivor_budget=surv)
        return QueryPlan(candidates=cand, sharded=sharded, budget=budget,
                         k=self.config.k, n_shards=g[1], grid=g,
                         shard_axes=tuple(self.config.shard_axes),
                         survivor_budget=surv, cost=cost)

    def _make_plan(self, cand: str, sharded: bool, grid: tuple,
                   n_columns: int, n_queries: int) -> QueryPlan:
        """A resolved plan for an explicitly chosen (kind, placement): the
        budget and survivor resolution of :meth:`plan` without its mode
        logic, so warmup can enumerate kinds the mode would not pick."""
        budget = n_columns if cand == "all" else self.candidate_budget(n_columns)
        surv = self.survivor_budget(n_columns, budget) if cand == "tiered" else 0
        if cand == "tiered":
            budget = min(budget, surv)
        return self._resolved(cand, sharded, (int(grid[0]), int(grid[1])), budget,
                              surv, n_columns, n_queries)

    def plan_set(self, *, n_columns: int, n_queries: int = 1, mode: str = "auto",
                 mesh=None, grid: tuple | None = None,
                 scope: str = "serve") -> list[QueryPlan]:
        """The plans warmup runs for one padded batch size.

        ``scope="serve"``: the plan this mode executes plus the full-scan
        recall baseline ``measure_recall`` runs beside it (on the served
        plan's grid when it is sharded). ``scope="full"``: also every
        candidate kind (``tiered`` only with a coarse digest, and only
        local) on the local placement and on every admissible grid of the
        mesh (or the pinned ``grid`` alone). Deduplicated on the plan's
        identity fields; the executor skips any plan its corpus cannot
        serve."""
        if scope not in ("serve", "full"):
            raise ValueError(f"unknown warmup scope {scope!r}; want 'serve' or 'full'")
        served = self.plan(n_columns=n_columns, n_queries=n_queries, mode=mode,
                           mesh=mesh, grid=grid)
        base = self.plan(n_columns=n_columns, n_queries=n_queries,
                         mode="sharded" if served.sharded else "full",
                         mesh=mesh if served.sharded else None,
                         grid=served.grid if served.sharded else None)
        plans = [served, base]
        if scope == "full":
            n_dev = self._n_shards(mesh)
            if grid is not None:
                grids = [(int(grid[0]), int(grid[1]))]
            elif mesh is not None and n_dev > 1:
                grids = self.grid_options(n_dev, n_queries, n_columns)
            else:
                grids = []
            for cand in CANDIDATE_KINDS:
                if cand == "tiered" and self.config.n_coarse_bands <= 0:
                    continue                # no coarse digest to scan
                plans.append(self._make_plan(cand, False, (1, 1), n_columns, n_queries))
                if cand == "tiered":
                    continue                # tiered plans are local only
                for g in grids:
                    plans.append(self._make_plan(cand, True, g, n_columns, n_queries))
        out, seen = [], set()
        for p in plans:
            key = (p.candidates, p.sharded, p.budget, p.k, p.grid, p.survivor_budget)
            if key not in seen:
                seen.add(key)
                out.append(p)
        return out
