"""Single-controller collectives over a ``DeviceMesh``.

One process drives every shard, as the JAX package's single controller
does; the collectives below are what ``jax.device_put`` and ``shard_map``'s
``psum`` / ``all_to_all`` are to the JAX code, done with peer copies
(``Tensor.to``) and sums in a fixed (mesh) order, so a result never
depends on thread timing. Every one of them is differentiable: autograd
carries a gradient back through the copies onto the shards.

* :func:`place` — a full tensor -> the shards its spec says, each a copy on
  its mesh position's device (:class:`Sharded`);
* :func:`gather` — the shards -> one tensor (the whole, or a region) on one
  device, each block read from one replica;
* :func:`psum` — tensors, one a rank, summed in rank order on one device;
* :func:`all_to_all` — the tiled block transpose across an axis.

A mesh may name one device several times: its shards are then separate
tensors on that device, as XLA's forced host-device count gives JAX.

:func:`count_collectives` is a ledger of what these move: inside it, each
call records under its XLA collective's name the bytes one device sends,
by :func:`collective_bytes`' ring factors (a gather is an
all-gather of the region, over the blocks it joins; a psum an all-reduce
of one rank's part; an all-to-all one rank's part; a place a scatter,
priced as a reduce-scatter of the whole tensor over its distinct blocks).
A call that joins or splits fewer than two blocks moves nothing and is not
recorded. The ledger counts what this single-controller program moves,
e.g. tensor parallelism gathers every leaf where it is read, so its total
differs from XLA's figure for the same cell. It is off by default; when
it is off a call tests one thread-local and computes nothing for it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading

import numpy as np
import torch


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: dict
    count_by_op: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_bytes(op: str, operand_bytes: float, result_bytes: float, n: int) -> float:
    """Bytes one device sends for collective ``op`` over a group of ``n``
    (the ring factors of ``launch.hlo_analysis``, which re-exports this)."""
    n = max(int(n), 2)
    ring = (n - 1) / n
    if op == "all-gather":
        return result_bytes * ring
    if op == "reduce-scatter":
        return operand_bytes * ring
    if op == "all-reduce":
        return 2 * operand_bytes * ring
    if op == "all-to-all":
        return operand_bytes * ring
    if op == "collective-permute":
        return operand_bytes
    raise ValueError(f"unknown collective {op!r}")


_LEDGER = threading.local()


@contextlib.contextmanager
def count_collectives():
    """Record the collectives called inside the block (this thread's):
    yields a :class:`CollectiveStats` that fills as they run."""
    stats = CollectiveStats(bytes_by_op={}, count_by_op={})
    outer = getattr(_LEDGER, "stats", None)
    _LEDGER.stats = stats
    try:
        yield stats
    finally:
        _LEDGER.stats = outer


def _counting() -> bool:
    return getattr(_LEDGER, "stats", None) is not None


def _record(op: str, operand_bytes: float, result_bytes: float, n: int) -> None:
    """Add one call to the active ledger; callers test :func:`_counting`
    first, so nothing is computed while the ledger is off."""
    stats = _LEDGER.stats
    if n < 2:
        return
    stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0.0) + collective_bytes(
        op, operand_bytes, result_bytes, n)
    stats.count_by_op[op] = stats.count_by_op.get(op, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def axis_size(mesh, phys) -> int:
    """The number of mesh positions along ``phys`` (a name, names or None)."""
    if phys is None:
        return 1
    axes = phys if isinstance(phys, tuple) else (phys,)
    return int(np.prod([mesh.shape[a] for a in axes]))


def _block_index(mesh, phys, pos: tuple) -> int:
    """The linear index of mesh position ``pos`` along ``phys`` (major first)."""
    if phys is None:
        return 0
    axes = phys if isinstance(phys, tuple) else (phys,)
    idx = 0
    for a in axes:
        i = mesh.axis_names.index(a)
        idx = idx * mesh.devices.shape[i] + pos[i]
    return idx


def region_of(mesh, spec, shape, pos) -> tuple[slice, ...]:
    """The block of a ``shape`` tensor that mesh position ``pos`` holds under
    ``spec``; a dimension that does not divide over its axes raises
    (``sharding._fit_spec`` is where replication replaces a split)."""
    out = []
    for phys, dim in zip(tuple(spec) + (None,) * (len(shape) - len(spec)), shape):
        n = axis_size(mesh, phys)
        if dim % n or dim < n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not split over "
                             f"{phys!r} ({n} positions)")
        size = dim // n
        k = _block_index(mesh, phys, pos)
        out.append(slice(k * size, (k + 1) * size))
    return tuple(out)


def intersect(a: tuple[slice, ...], b: tuple[slice, ...]):
    """The common region of two regions, or None."""
    out = tuple(slice(max(x.start, y.start), min(x.stop, y.stop)) for x, y in zip(a, b))
    return None if any(s.start >= s.stop for s in out) else out


def relative(r: tuple[slice, ...], within: tuple[slice, ...]) -> tuple[slice, ...]:
    """Region ``r`` in the coordinates of a tensor holding ``within``."""
    return tuple(slice(x.start - w.start, x.stop - w.start) for x, w in zip(r, within))


class Sharded:
    """One tensor of ``shape`` over ``mesh`` as ``spec`` splits it: per mesh
    position that holds a part of it (every position, unless the leaf is one
    layer of a stack whose layers are split over an axis) the block its
    coordinates select, a tensor on that position's device."""

    def __init__(self, mesh, spec, shape, dtype, shards: dict):
        self.mesh, self.spec = mesh, tuple(spec)
        self.shape, self.dtype = tuple(shape), dtype
        self.shards = shards

    def region(self, pos) -> tuple[slice, ...]:
        return region_of(self.mesh, self.spec, self.shape, pos)

    def device(self, pos) -> torch.device:
        return self.mesh.devices[pos]

    def write_(self, full: torch.Tensor) -> None:
        """Overwrite every shard with its block of ``full``."""
        for pos, t in self.shards.items():
            t.copy_(full[self.region(pos)].to(t.device))

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, {self.spec}, {len(self.shards)} shards)"


def _positions(mesh):
    return list(itertools.product(*(range(n) for n in mesh.devices.shape)))


def _layout(mesh, spec, ndim: int, layer):
    """(the leaf's own spec, the positions holding it) for :func:`place`."""
    spec = tuple(spec)
    positions = _positions(mesh)
    if layer is not None:
        l, depth = layer
        lead, spec = spec[0], spec[1:]
        n = axis_size(mesh, lead)
        if depth % n:
            raise ValueError(f"{depth} layers do not split over {lead!r} ({n})")
        positions = [p for p in positions if _block_index(mesh, lead, p) == l // (depth // n)]
    return spec + (None,) * (ndim - len(spec)), positions


def place(t: torch.Tensor, mesh, spec, *, layer: tuple[int, int] | None = None) -> Sharded:
    """``t`` split over ``mesh`` as ``spec`` says, each shard a contiguous
    copy on its position's device. ``layer = (l, depth)`` places layer ``l``
    of a stack of ``depth`` by the stack's spec (its first entry splits the
    layers, the rest is ``t``'s): only the positions whose block of layers
    holds ``l`` get it. A dimension that does not divide over its axes
    raises."""
    spec, positions = _layout(mesh, spec, t.dim(), layer)
    regions = {p: region_of(mesh, spec, t.shape, p) for p in positions}
    shards = {p: t[r].to(mesh.devices[p], copy=True).contiguous() for p, r in regions.items()}
    if _counting():
        _record("reduce-scatter", _nbytes(t), 0, len(set(regions.values())))
    return Sharded(mesh, spec, t.shape, t.dtype, shards)


def zeros(shape, dtype, mesh, spec, *, layer: tuple[int, int] | None = None) -> Sharded:
    """``place(torch.zeros(shape, dtype), mesh, spec, layer=layer)``, each
    shard made on its device."""
    spec, positions = _layout(mesh, spec, len(shape), layer)
    shards = {}
    for p in positions:
        r = region_of(mesh, spec, shape, p)
        shards[p] = torch.zeros([s.stop - s.start for s in r], dtype=dtype,
                                device=mesh.devices[p])
    return Sharded(mesh, spec, shape, dtype, shards)


def _choose(sh: Sharded, block_pos: list, device, prefer: dict | None):
    """The replica to read a block from: one in the preferred coordinates,
    then one on ``device``, then the first in mesh order."""
    names = sh.mesh.axis_names

    def key(p):
        off_row = prefer is not None and any(p[names.index(a)] != i for a, i in prefer.items())
        return (off_row, sh.device(p) != device, p)

    return min(block_pos, key=key)


def gather(sh: Sharded, device, region: tuple[slice, ...] | None = None, *,
           prefer: dict | None = None) -> torch.Tensor:
    """The ``region`` of ``sh`` (default: all of it) as one tensor on
    ``device``, each block read from one replica (those at the coordinates
    ``prefer`` names first, e.g. ``{"data": 1}``); differentiable. A region
    inside one shard on ``device`` comes back as a view of it."""
    device = torch.device(device)
    full = tuple(slice(0, n) for n in sh.shape)
    region = full if region is None else region
    by_block: dict = {}
    for p in sh.shards:
        by_block.setdefault(sh.region(p), []).append(p)
    # per dimension, the cuts between the blocks inside the region
    cuts = []
    for d, (r, n) in enumerate(zip(region, sh.shape)):
        size = n // axis_size(sh.mesh, sh.spec[d])
        inner = range((r.start // size + 1) * size, r.stop, size)
        edges = [r.start, *inner, r.stop]
        cuts.append(list(zip(edges, edges[1:])))

    def piece(cell) -> torch.Tensor:
        want = tuple(slice(a, b) for a, b in cell)
        for block, holders in by_block.items():
            if intersect(block, want) == want:
                pos = _choose(sh, holders, device, prefer)
                t = sh.shards[pos][relative(want, block)]
                return t.to(device)
        raise ValueError(f"no shard of {sh} holds {want}")

    def assemble(dim: int, prefix: tuple) -> torch.Tensor:
        if dim == len(cuts):
            return piece(prefix)
        parts = [assemble(dim + 1, prefix + (c,)) for c in cuts[dim]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)

    out = assemble(0, ())
    if _counting():
        _record("all-gather", 0, _nbytes(out), int(np.prod([len(c) for c in cuts])))
    return out


def psum(parts, device) -> torch.Tensor:
    """The sum of ``parts`` (one tensor a rank, on the ranks' devices) on
    ``device``, added in rank order."""
    device = torch.device(device)
    total = parts[0].to(device)
    for t in parts[1:]:
        total = total + t.to(device)
    if _counting():
        _record("all-reduce", _nbytes(parts[0]), 0, len(parts))
    return total


def all_to_all(parts, devices) -> list[torch.Tensor]:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=True)`` across ``len(parts)`` ranks: rank ``m`` receives, in rank
    order, block ``m`` of every rank's leading dimension, on ``devices[m]``."""
    n = len(parts)
    blocks = [torch.chunk(t, n, dim=0) for t in parts]
    if _counting():
        _record("all-to-all", _nbytes(parts[0]), 0, n)
    return [torch.cat([blocks[src][dst].to(devices[dst]) for src in range(n)], dim=0)
            for dst in range(n)]
