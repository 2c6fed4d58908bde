"""The benchmark's lake generator: planted join groups, drawn on the device.

A torch copy of the planted-join process of the port's
``core.lakegen.generate_scaled_lake`` (the shapes of ``ScaledLakeSpec``):
a ``joinable_frac`` of the columns forms join groups of ``group_size``
members striped across tables; a member's support is a uniform ``s``-subset
of its group's ``vocab_size`` pool with ``s/V = 2J/(1+J)``, so two members
have expected Jaccard ``J`` (the group's tier, cycling through
``jaccard_tiers``); every support value appears in at least one row. The
other columns are pairwise-disjoint noise. Value hashes are splitmix64 of
the value ids folded to 32 bits; string lengths and word counts follow a
per-owner style. The draws come from a ``torch.Generator`` seeded with the
run's seed, in blocks of columns on the device, so a 4M-column lake takes a
second, where the numpy original takes minutes. The same seed gives the
same lake; the draws differ from the numpy original's.

Hashes are int64 tensors holding uint32 values, as in the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SENTINEL = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
BLOCK = 1 << 16          # columns drawn per device step (< 1 GiB of temporaries)


def _i64(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (wrapping arithmetic)."""
    z = x + _i64(0x9E3779B97F4A7C15)
    z = (z ^ _shr(z, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    return z ^ _shr(z, 31)


def umod(x: torch.Tensor, m) -> torch.Tensor:
    """``x mod m`` with ``x`` read as unsigned 64 bits, ``m`` positive."""
    return ((_shr(x, 1) % m) * 2 + (x & 1)) % m


def fold32(h: torch.Tensor) -> torch.Tensor:
    """64-bit hashes -> the uint32 space, keeping the sentinel exact."""
    f = _shr(h, 32) ^ (h & _M32)
    return torch.where(f == SENTINEL, SENTINEL - 1, f)


@dataclasses.dataclass(frozen=True)
class LakeShape:
    n_columns: int
    row_budget: int = 256
    group_size: int = 16
    cols_per_table: int = 8
    joinable_frac: float = 0.12
    jaccard_tiers: tuple = (0.8, 0.4, 0.2)
    vocab_size: int = 160

    @classmethod
    def from_dict(cls, d: dict) -> "LakeShape":
        d = dict(d)
        d["jaccard_tiers"] = tuple(float(j) for j in d.get("jaccard_tiers",
                                                          cls.jaccard_tiers))
        return cls(**d)

    @property
    def n_groups(self) -> int:
        return int(self.n_columns * self.joinable_frac) // max(self.group_size, 2)

    def group(self, cols: torch.Tensor) -> torch.Tensor:
        """Join group of each column (-1 for noise): column p < n_groups ·
        group_size belongs to group p % n_groups."""
        ng = self.n_groups
        return torch.where(cols < ng * self.group_size, cols % max(ng, 1), -1)

    def tier(self, cols: torch.Tensor) -> torch.Tensor:
        g = self.group(cols)
        return torch.where(g >= 0, g % len(self.jaccard_tiers), -1)


def support_size(j: float, v: int) -> int:
    return int(np.clip(round(2.0 * j / (1.0 + j) * v), 2, v))


def generate_block(shape: LakeShape, lo: int, hi: int, gen: torch.Generator,
                   device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Columns [lo, hi): (values (n, R) int64 hashes, char_len (n, R)
    float32, word_cnt (n, R) float32). Draws from ``gen`` in a fixed order."""
    r, v = shape.row_budget, shape.vocab_size
    if r < v:
        raise ValueError(f"row_budget ({r}) must be >= vocab_size ({v})")
    cols = torch.arange(lo, hi, device=device)
    group, tier = shape.group(cols), shape.tier(cols)
    n_groups = shape.n_groups
    base = n_groups * v + 1
    vids = base + cols[:, None] * r + torch.arange(r, device=device)[None, :]
    for t, j in enumerate(shape.jaccard_tiers):
        idx = torch.nonzero(tier == t).flatten()
        if idx.numel() == 0:
            continue
        s = support_size(j, v)
        perm = torch.rand((idx.numel(), v), generator=gen, device=device).argsort(1)
        sup = perm[:, :s] + group[idx, None] * v + 1
        extra = torch.gather(sup, 1, torch.randint(0, s, (idx.numel(), r - s),
                                                   generator=gen, device=device))
        vids[idx] = torch.cat([sup, extra], 1)
    h = splitmix64(vids)
    owner = torch.where(group >= 0, group, n_groups + cols)
    st = splitmix64(owner + 0x51AB)
    base_len = (4 + umod(st, 13))[:, None]
    spread = (2 + umod(_shr(st, 8), 9))[:, None]
    wmax = (1 + umod(_shr(st, 16), 4))[:, None]
    char_len = (base_len + umod(h, spread)).to(torch.float32)
    word_cnt = (1 + umod(h, wmax)).to(torch.float32)
    return fold32(h), char_len, word_cnt


def to_bits(t: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> int32 with the same 32 bits."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


class StreamedLake:
    """The lake's three (C, R) host arrays, drawn block by block on demand:
    ``values32``, ``char_len`` and ``word_cnt`` answer ``shape`` and row
    slices (as ingest walks its chunks: each chunk's three fields in turn,
    the chunks in order). Only the last two blocks are on the host; the
    whole lake never is."""

    def __init__(self, shape: LakeShape, seed: int, device, block: int = BLOCK):
        self.shape, self.block, self.device = shape, block, device
        self._gen = generator(seed, device)
        self._next = 0                       # first column not drawn yet
        self._blocks: dict[int, tuple] = {}  # first column -> host arrays
        self.values32 = _Field(self, 0, np.uint32)
        self.char_len = _Field(self, 1, np.float32)
        self.word_cnt = _Field(self, 2, np.float32)

    def _block(self, lo: int) -> tuple:
        start = lo - lo % self.block
        while start not in self._blocks:
            if self._next > start:
                raise ValueError(f"rows {lo}... were dropped; take the chunks in order")
            hi = min(self._next + self.block, self.shape.n_columns)
            v, cl, wc = generate_block(self.shape, self._next, hi, self._gen, self.device)
            self._blocks[self._next] = (to_bits(v).cpu().numpy().view(np.uint32),
                                        cl.cpu().numpy(), wc.cpu().numpy())
            for old in sorted(self._blocks)[:-2]:
                del self._blocks[old]
            self._next = hi
        return start, self._blocks[start]

    def _rows(self, field: int, lo: int, hi: int) -> np.ndarray:
        out = []
        while lo < hi:
            start, parts = self._block(lo)
            end = min(hi, start + parts[0].shape[0])
            out.append(parts[field][lo - start:end - start])
            lo = end
        return out[0] if len(out) == 1 else np.concatenate(out)


class _Field:
    def __init__(self, lake: StreamedLake, field: int, dtype):
        self.lake, self.field, self.dtype = lake, field, np.dtype(dtype)
        self.shape = (lake.shape.n_columns, lake.shape.row_budget)

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, sl):
        if not isinstance(sl, slice) or sl.step not in (None, 1):
            raise TypeError("a streamed lake answers row slices only")
        lo, hi, _ = sl.indices(self.shape[0])
        return self.lake._rows(self.field, lo, max(lo, hi))


def generate_blocks(shape: LakeShape, seed: int, device, block: int):
    """Yield ``(lo, hi, values, char_len, word_cnt)`` device blocks of the
    same lake as :class:`StreamedLake` with the same ``block``: the
    reference walks the lake this way, on the device."""
    c = shape.n_columns
    gen = generator(seed, device)
    for lo in range(0, c, block):
        hi = min(lo + block, c)
        yield (lo, hi, *generate_block(shape, lo, hi, gen, device))
