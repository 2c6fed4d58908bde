"""Synthetic data-lake generator with join ground truth *by construction*.

A numpy copy of ``repro.core.lakegen``: the same spec gives byte-identical
lakes in both packages.

The paper hand-labels 4,318 candidate joins from 160 open datasets (plus the
SANTOS/TUS/D3L benchmark lakes). Offline we cannot fetch those, so this
module synthesizes lakes that reproduce the *generating process* the paper
describes for real lakes:

* **domains** — independent semantic concepts, each with its own vocabulary
  of values, value-frequency skew (Zipf), and string format;
* **granularity chains** — a domain can exist at several granularity levels
  (cities-of-a-country ⊂ cities-of-a-continent): coarser levels are subsets
  of finer ones, so cross-level pairs overlap heavily yet are *not* semantic
  joins (the paper's central observation about cardinality proportion);
* **surface-form collisions** — collision groups of domains share a fraction
  of raw values ("pol, jap, chn" = countries *or* languages): high overlap,
  different semantics → syntactic joins;
* **heterogeneity** — per-column row counts, vocabulary coverage, skew and
  null rates vary widely (data-lake syntactic variability).

Labels: a pair is **semantic** iff same domain and same granularity level;
**syntactic** iff it intersects but is not semantic (cross-granularity or
collision-group or chance overlap). Pairs with empty intersection are not
join candidates (the paper filters those out too).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.ingest import ColumnBatch, ColumnSketch, fold32, pack_columns
from repro_torch.core.sketches import PackedSketches, pack_sketches


def splitmix64(x: np.ndarray) -> np.ndarray:
    z = (x.astype(np.uint64) + np.uint64(0x9E3779B97F4A7C15))
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclasses.dataclass
class LakeSpec:
    n_domains: int = 24
    n_tables: int = 60
    cols_per_table: tuple[int, int] = (3, 10)
    # granularity: probability a domain has 2 / 3 levels; size ratio per level
    p_multi_gran: float = 0.5
    gran_ratio: tuple[int, int] = (3, 6)
    # vocabulary sizes (lognormal over base level)
    vocab_log_mean: float = 6.0       # ~400 values
    vocab_log_sigma: float = 1.0
    # per-column sampling
    rows_log_mean: float = 7.0        # ~1100 rows
    rows_log_sigma: float = 0.9
    # within-(domain, granularity) row-count spread. The paper's central
    # assumption is that columns describing the same concept at the same
    # granularity have comparable scales; rows_within_sigma ≪ rows_log_sigma
    # encodes that (per-concept base size × small per-column jitter).
    rows_within_sigma: float = 0.35
    row_budget: int = 4096
    zipf_range: tuple[float, float] = (0.01, 1.4)
    coverage_range: tuple[float, float] = (0.35, 1.0)
    null_range: tuple[float, float] = (0.0, 0.1)
    # surface-form collisions
    n_collision_groups: int = 4
    collision_frac: float = 0.5
    seed: int = 0


@dataclasses.dataclass
class Lake:
    spec: LakeSpec
    batch: ColumnBatch
    sketches: list[ColumnSketch]
    packed: PackedSketches
    domain: np.ndarray      # (C,) int32 domain id per column
    gran: np.ndarray        # (C,) int32 granularity level per column
    table: np.ndarray       # (C,) int32
    raw_bytes: int          # nominal "CSV" size: sum of char_len + separators

    @property
    def n_columns(self) -> int:
        return self.batch.n_columns

    def is_semantic(self, i: int | np.ndarray, j: int | np.ndarray) -> np.ndarray:
        return (self.domain[i] == self.domain[j]) & (self.gran[i] == self.gran[j])


def _build_domain_vocabs(spec: LakeSpec, rng: np.random.Generator):
    """Global value-id vocabularies per (domain, granularity level)."""
    vocabs: list[list[np.ndarray]] = []
    next_id = 1
    for d in range(spec.n_domains):
        base = int(np.clip(rng.lognormal(spec.vocab_log_mean, spec.vocab_log_sigma), 24, 200_000))
        levels = [np.arange(next_id, next_id + base, dtype=np.uint64)]
        next_id += base
        n_levels = 1
        if rng.random() < spec.p_multi_gran:
            n_levels = int(rng.integers(2, 4))
        for _ in range(1, n_levels):
            ratio = int(rng.integers(spec.gran_ratio[0], spec.gran_ratio[1] + 1))
            extra = levels[-1].shape[0] * (ratio - 1)
            finer = np.concatenate([levels[-1], np.arange(next_id, next_id + extra, dtype=np.uint64)])
            next_id += extra
            levels.append(finer)
        vocabs.append(levels)

    # collision groups: domains in a group alias a fraction of their *base*
    # values to shared ids (same surface form, different semantics)
    dom_ids = rng.permutation(spec.n_domains)
    gsize = max(2, spec.n_domains // max(spec.n_collision_groups, 1)) if spec.n_collision_groups else 0
    for g in range(spec.n_collision_groups):
        members = dom_ids[g * gsize:(g + 1) * gsize]
        if len(members) < 2:
            continue
        share = int(min(min(vocabs[m][0].shape[0] for m in members) * spec.collision_frac, 4096))
        if share < 1:
            continue
        shared = np.arange(next_id, next_id + share, dtype=np.uint64)
        next_id += share
        for m in members:
            for lv in range(len(vocabs[m])):
                v = vocabs[m][lv].copy()
                pos = rng.choice(v.shape[0], size=share, replace=False)
                v[pos] = shared
                vocabs[m][lv] = v
    return vocabs


def _string_format(domain: int):
    """Deterministic per-domain string format (drives syntactic features)."""
    r = np.random.default_rng(0xD0 + domain)
    base_len = int(r.integers(3, 24))
    spread = int(r.integers(1, 12))
    max_words = int(r.integers(1, 5))
    return base_len, spread, max_words


def _value_strings(vids: np.ndarray, domain: int):
    base_len, spread, max_words = _string_format(domain)
    h = splitmix64(vids)
    char_len = (base_len + (h % np.uint64(spread)).astype(np.int64)).astype(np.float32)
    word_cnt = (1 + (h >> np.uint64(17)) % np.uint64(max_words)).astype(np.float32)
    return char_len, word_cnt


def generate_lake(spec: LakeSpec) -> Lake:
    rng = np.random.default_rng(spec.seed)
    vocabs = _build_domain_vocabs(spec, rng)

    # per-(domain, granularity) base row scale — concepts have a size
    base_rows = {
        (d, lv): float(np.clip(rng.lognormal(spec.rows_log_mean + 0.5 * lv,
                                             spec.rows_log_sigma),
                               16, spec.row_budget))
        for d in range(spec.n_domains) for lv in range(len(vocabs[d]))
    }

    names, h64s, cls, wcs = [], [], [], []
    dom_l, gran_l, tab_l = [], [], []
    raw_bytes = 0

    col_id = 0
    for t in range(spec.n_tables):
        n_cols = int(rng.integers(spec.cols_per_table[0], spec.cols_per_table[1] + 1))
        for _ in range(n_cols):
            d = int(rng.integers(0, spec.n_domains))
            lv = int(rng.integers(0, len(vocabs[d])))
            vocab = vocabs[d][lv]
            n_rows = int(np.clip(
                base_rows[(d, lv)] * rng.lognormal(0.0, spec.rows_within_sigma),
                16, spec.row_budget))
            cov = rng.uniform(*spec.coverage_range)
            support_n = max(2, min(int(vocab.shape[0] * cov), vocab.shape[0], n_rows * 4))
            support = rng.choice(vocab, size=support_n, replace=False)
            a = rng.uniform(*spec.zipf_range)
            p = (np.arange(1, support_n + 1, dtype=np.float64)) ** (-a)
            p /= p.sum()
            vids = rng.choice(support, size=n_rows, p=p)
            null_frac = rng.uniform(*spec.null_range)
            keep = rng.random(n_rows) >= null_frac
            vids = vids[keep]
            if vids.shape[0] < 4:
                vids = support[:4].astype(np.uint64)
            h64 = splitmix64(vids)
            cl, wc = _value_strings(vids, d)
            raw_bytes += int(cl.sum()) + vids.shape[0]

            names.append(f"t{t}_c{col_id}_d{d}g{lv}")
            h64s.append(h64)
            cls.append(cl)
            wcs.append(wc)
            dom_l.append(d)
            gran_l.append(lv)
            tab_l.append(t)
            col_id += 1

    batch, sketches = pack_columns(names, h64s, cls, wcs, row_budget=spec.row_budget,
                                   table_ids=tab_l)
    packed = pack_sketches(sketches)
    return Lake(spec=spec, batch=batch, sketches=sketches, packed=packed,
                domain=np.asarray(dom_l, np.int32), gran=np.asarray(gran_l, np.int32),
                table=np.asarray(tab_l, np.int32), raw_bytes=raw_bytes)


# ---------------------------------------------------------------------------
# scaled lakes (10^5+ columns)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScaledLakeSpec:
    """Generator spec for very large lakes with *planted* joinability.

    The per-row sampling of :func:`generate_lake` is a faithful model but
    tops out around 10^3-10^4 columns (a Python loop per column).  Scale
    benchmarks need 10^5-10^6, so this spec drives a fully vectorized
    generator that builds the :class:`~repro_torch.core.ingest.ColumnBatch`
    arrays directly: a ``joinable_frac`` of the columns is organized into
    join groups of ``group_size`` members whose pairwise Jaccard is
    controlled per group by cycling through ``jaccard_tiers`` (high =
    easy candidates, low = the tail a coarse pass must not lose); the
    rest are pairwise-disjoint noise.  Group members are striped across
    tables so same-table exclusion never hides a planted partner.
    """

    n_columns: int = 100_000
    row_budget: int = 256          # rows per column (small: profiles+sigs
    group_size: int = 16           # only ever see the value *set*)
    cols_per_table: int = 8
    joinable_frac: float = 0.12
    jaccard_tiers: tuple[float, ...] = (0.8, 0.4, 0.2)
    vocab_size: int = 160          # shared value pool per join group
    seed: int = 0


@dataclasses.dataclass
class ScaledLake:
    """A generated scale lake: the packed batch plus planted ground truth
    (``group``/``tier`` are -1 for noise columns)."""

    spec: ScaledLakeSpec
    batch: ColumnBatch
    group: np.ndarray       # (C,) int32 join-group id, -1 = noise
    tier: np.ndarray        # (C,) int32 index into spec.jaccard_tiers
    table: np.ndarray       # (C,) int32

    @property
    def n_columns(self) -> int:
        return self.batch.n_columns

    def partners(self, q: int) -> np.ndarray:
        """Planted join partners of column ``q`` (empty for noise)."""
        g = int(self.group[q])
        if g < 0:
            return np.zeros((0,), np.int64)
        out = np.flatnonzero(self.group == g)
        return out[out != q]


def generate_scaled_lake(spec: ScaledLakeSpec) -> ScaledLake:
    """Vectorized 10^5+-column lake with controlled joinability tiers.

    Each join group owns a ``vocab_size`` value pool; a member's support
    is a uniform ``s``-subset with ``s/V = 2J/(1+J)``, which makes the
    expected pairwise Jaccard of two members exactly ``J`` (the group's
    tier).  Every support value appears in at least one row, so the
    realized value *set* is the support itself and the tier holds for
    the MinHash signatures, not just in expectation over sampling.
    """
    rng = np.random.default_rng(spec.seed)
    c, r, v = spec.n_columns, spec.row_budget, spec.vocab_size
    if r < v:
        raise ValueError(f"row_budget ({r}) must be >= vocab_size ({v}) "
                         f"so a support always fits its rows")
    tiers = tuple(float(j) for j in spec.jaccard_tiers)
    n_groups = (int(c * spec.joinable_frac) // max(spec.group_size, 2)
                if tiers else 0)
    n_planted = n_groups * spec.group_size

    # planted columns occupy indices [0, n_planted) in a strided layout:
    # column p belongs to group p % n_groups (member p // n_groups), so
    # members sit n_groups columns apart — different tables whenever
    # n_groups >= cols_per_table
    group = np.full((c,), -1, np.int32)
    tier = np.full((c,), -1, np.int32)
    if n_groups:
        p = np.arange(n_planted)
        group[:n_planted] = (p % n_groups).astype(np.int32)
        tier[:n_planted] = (group[:n_planted] % len(tiers)).astype(np.int32)

    vids = np.empty((c, r), np.uint64)
    for t, j in enumerate(tiers):
        idx = np.flatnonzero(tier == t)
        if idx.size == 0:
            continue
        q = 2.0 * j / (1.0 + j)            # support fraction for Jaccard j
        s = int(np.clip(round(q * v), 2, v))
        perms = rng.permuted(
            np.broadcast_to(np.arange(v, dtype=np.uint64),
                            (idx.size, v)).copy(), axis=1)
        sup = perms[:, :s] + group[idx, None].astype(np.uint64) * v + 1
        extra = np.take_along_axis(
            sup, rng.integers(0, s, size=(idx.size, r - s)), axis=1)
        vids[idx] = np.concatenate([sup, extra], axis=1)

    # noise columns: private disjoint id ranges — no cross-column overlap
    noise = np.flatnonzero(group < 0)
    base = np.uint64(n_groups) * np.uint64(v) + np.uint64(1)
    for i in range(0, noise.size, 8192):
        blk = noise[i:i + 8192]
        vids[blk] = (base + blk[:, None].astype(np.uint64) * np.uint64(r)
                     + np.arange(r, dtype=np.uint64)[None, :])

    h = splitmix64(vids)
    values32 = fold32(h)
    # per-OWNER string style (owner = join group for planted columns, the
    # column itself for noise): every value belongs to exactly one owner,
    # so the style is consistent wherever a value appears — group members
    # share syntactic profiles while unrelated columns differ, which is
    # what lets a profile-distance model separate them
    owner = np.where(group >= 0, group.astype(np.int64),
                     np.int64(n_groups) + np.arange(c))
    st = splitmix64(owner.astype(np.uint64) + np.uint64(0x51AB))
    base_len = (4 + st % np.uint64(13))[:, None]
    spread = (2 + (st >> np.uint64(8)) % np.uint64(9))[:, None]
    wmax = (1 + (st >> np.uint64(16)) % np.uint64(4))[:, None]
    char_len = (base_len + h % spread).astype(np.float32)
    word_cnt = (1 + h % wmax).astype(np.float32)
    table = (np.arange(c) // spec.cols_per_table).astype(np.int32)
    batch = ColumnBatch(values32=values32, char_len=char_len,
                        word_cnt=word_cnt,
                        n_rows=np.full((c,), r, np.int32),
                        names=[f"c{i}" for i in range(c)],
                        table_ids=table)
    return ScaledLake(spec=spec, batch=batch, group=group, tier=tier,
                      table=table)


def select_scaled_queries(lake: ScaledLake, n_queries: int,
                          seed: int = 1) -> np.ndarray:
    """Planted columns to query, balanced across joinability tiers (every
    query has ``group_size - 1`` genuine partners in the lake)."""
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    tiers = np.unique(lake.tier[lake.tier >= 0])
    if tiers.size == 0:
        raise ValueError("lake has no planted join groups to query")
    per = -(-n_queries // tiers.size)
    for t in tiers:
        idx = np.flatnonzero(lake.tier == t)
        out.append(rng.choice(idx, size=min(per, idx.size), replace=False))
    sel = np.concatenate(out)
    rng.shuffle(sel)
    return np.sort(sel[:n_queries]).astype(np.int32)


def select_queries(lake: Lake, n_queries: int, min_semantic: int = 3,
                   seed: int = 1) -> np.ndarray:
    """Query columns having at least ``min_semantic`` semantic partners
    outside their own table (mirrors the paper's query selection)."""
    rng = np.random.default_rng(seed)
    c = lake.n_columns
    counts = np.zeros((c,), np.int32)
    for d in np.unique(lake.domain):
        for g in np.unique(lake.gran):
            m = np.flatnonzero((lake.domain == d) & (lake.gran == g))
            if m.size < 2:
                continue
            # partners outside own table
            for i in m:
                counts[i] = np.sum(lake.table[m] != lake.table[i])
    cand = np.flatnonzero(counts >= min_semantic)
    if cand.size == 0:
        cand = np.argsort(-counts)[:n_queries]
    rng.shuffle(cand)
    return np.sort(cand[:n_queries]).astype(np.int32)
