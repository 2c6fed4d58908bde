"""Grid-sharded pipelines: per-tile stages + a two-phase merge.

The port of ``repro.exec.sharded``. The mesh is a 2-D **(query × data)
device grid** (:class:`~repro_torch.launch.mesh.DeviceMesh`): the column
axis tensors (profiles, word features, global column ids, table ids, LSH
band keys) shard over the ``data``-like axes and the query batch over the
``query`` axes. Each tile runs the local stages (``stages.py``) on its
(Q-shard, C-shard) on its device:

* ``all``    — the fused scorer over the local columns (the full scan);
* ``lsh`` / ``hybrid`` — the ``lsh_probe`` kernel over the local
  (Q/q_shards, B) × (C/d_shards, B) key tile, the hybrid priority fill, and
  the gathered fused scorer over at most ``budget_per_shard`` local
  candidates per query.

The merge is two-phase: :func:`~repro_torch.exec.stages.merge_topk_sharded`
reduces each query shard's tiles over the DATA axes (a peer copy of (Q_l, k)
tiles, O(Q_l·k·d_shards) bytes), then
:func:`~repro_torch.exec.stages.assemble_query_shards` reassembles the batch
over the QUERY axes (O(Q·k) bytes, whatever the lake size). ``n_scored`` is
the global count of columns scored per query, summed over the data axes
only, so a query-sharded grid does not count a query once per query shard.

One process drives every tile, as the JAX package's single controller does:
each tile's kernels are enqueued on its device's current stream, and nothing
reads a result back between tiles, so tiles on different cards overlap.
Where a device appears more than once in the mesh its tiles run in turn.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import features as FT
from repro_torch.exec import stages
from repro_torch.kernels.lsh_probe import PAD_CORPUS

# pad-row fills of the resident tensors, by tensor (the int32 bit-views of
# the band keys hold PAD_CORPUS as its signed 32-bit pattern): profile 0,
# words HASH_SENTINEL, table id -2 (matches no table and no disabled-query
# sentinel), column id -1 (the exclusion mask scores it -inf)
PAD_BITS = int(np.uint32(PAD_CORPUS).view(np.int32))
PAD_FILL = {"z": 0, "w": FT.HASH_SENTINEL, "tids": -2, "cids": -1,
            "ckeys": PAD_BITS, "coarse": PAD_BITS}


def grid_tiles(mesh, shard_axes, query_axes=()) -> list[tuple[int, int, torch.device]]:
    """The tiles of a grid: ``(query shard, data shard, device)``, both
    shard indices flat and row-major over their axes. A tile runs on the
    mesh's device at index 0 of every other (replicated) axis."""
    shape = mesh.shape
    q_sizes = [int(shape[a]) for a in query_axes]
    d_sizes = [int(shape[a]) for a in shard_axes]
    tiles = []
    for qi, qidx in enumerate(np.ndindex(*q_sizes)):
        for di, didx in enumerate(np.ndindex(*d_sizes)):
            at = dict(zip(query_axes, qidx))
            at.update(zip(shard_axes, didx))
            tiles.append((qi, di, mesh.devices[tuple(at.get(a, 0) for a in mesh.axis_names)]))
    return tiles


def _padded(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    if t.shape[0] == n:
        return t
    pad = torch.full((n - t.shape[0],) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad])


def place_sharded_corpus(mesh, shard_axes, rows: dict, query_axes=()) -> dict:
    """Pad the column axis to a multiple of the data-shard count with the
    sentinel fills of :data:`PAD_FILL` and put one copy of each column
    shard on each distinct device of the tiles that read it.

    ``rows`` maps ``z`` (float32), ``w``, ``cids`` (the caller's bucket-padded
    column ids, -1 on its pad rows), ``tids`` and optionally ``ckeys`` to
    tensors on any device. Returns ``{"n_pad", "shards": {(data shard,
    device): {name: tensor}}}``."""
    n_shards = int(np.prod([mesh.shape[a] for a in shard_axes]))
    n = int(rows["z"].shape[0])
    n_pad = -(-n // n_shards) * n_shards
    per = n_pad // n_shards
    full = {k: _padded(v, n_pad, PAD_FILL[k]) for k, v in rows.items() if v is not None}
    shards = {}
    for _, di, dev in grid_tiles(mesh, shard_axes, query_axes):
        if (di, dev) not in shards:
            shards[di, dev] = {k: v[di * per:(di + 1) * per].to(dev).contiguous()
                               for k, v in full.items()}
    return {"n_pad": n_pad, "shards": shards}


def build_sharded_pipeline(mesh, *, candidates: str = "all", k: int,
                           budget_per_shard: int | None = None,
                           shard_axes=("data",), query_axes=()):
    """The grid-sharded candidate -> score -> merge pipeline over ``mesh``.

    Returns ``fn(corpus, gbdt, zq, wq, tq, qid, qkeys=None, out=device)``:
    ``corpus`` from :func:`place_sharded_corpus`, ``gbdt`` a device ->
    GBDT-tuple mapping, the query tensors (Q, ...) on any device (Q a
    multiple of the query-axis size; the executor pads), ``qkeys`` the
    int32 bit-views of the query band keys for the pruned kinds. Returns
    (scores (Q, k'), global ids (Q, k'), n_scored (Q,)) on ``out``, with
    k' = min(k, columns visible to the merge)."""
    if candidates != "all" and budget_per_shard is None:
        raise ValueError("pruned sharded pipeline needs budget_per_shard")
    axes, qaxes = tuple(shard_axes), tuple(query_axes)
    d_sizes = [int(mesh.shape[a]) for a in axes]
    q_sizes = [int(mesh.shape[a]) for a in qaxes]
    tiles = grid_tiles(mesh, axes, qaxes)
    n_q = int(np.prod(q_sizes, dtype=np.int64))
    n_d = int(np.prod(d_sizes, dtype=np.int64))

    def tile(shard, gbdt, zq, wq, tq, qid, qkeys):
        z, w, cids, tids = shard["z"], shard["w"], shard["cids"], shard["tids"]
        if candidates == "all":
            s = stages.score_columns(zq, wq, z, w, gbdt)
            s = torch.where(stages.exclusion_mask(cids, tids, tq, qid), float("-inf"), s)
            sc, ids = stages.merge_topk(s, cids, k)
            return sc, ids, stages.live_count(cids).expand(zq.shape[0])
        prio = stages.candidate_priorities(candidates, zq, qkeys, z, shard["ckeys"],
                                           cids, tids, tq, qid)
        pos, valid = stages.gather_candidates(prio, min(budget_per_shard, z.shape[0]))
        s = torch.where(valid, stages.score_columns(zq, wq, z[pos], w[pos], gbdt),
                        float("-inf"))
        sc, ids = stages.merge_topk(s, cids[pos], k)
        return sc, ids, valid.sum(1)

    def fn(corpus, gbdt, zq, wq, tq, qid, qkeys=None, out=None):
        ql = zq.shape[0] // n_q
        batch = (zq, wq, tq, qid, qkeys)
        local, per_q = {}, [[None] * n_d for _ in range(n_q)]
        # enqueue every tile before anything waits
        for qi, di, dev in tiles:
            if (qi, dev) not in local:
                local[qi, dev] = [None if a is None else
                                  a[qi * ql:(qi + 1) * ql].to(dev, non_blocking=True)
                                  for a in batch]
            per_q[qi][di] = tile(corpus["shards"][di, dev], gbdt[dev], *local[qi, dev])
        # phase 1 on each query shard's first tile's device, phase 2 on `out`
        rows = [stages.merge_topk_sharded(per_q[qi], k, d_sizes, tiles[qi * n_d][2])
                for qi in range(n_q)]
        return stages.assemble_query_shards(rows, q_sizes, out if out is not None else tiles[0][2])

    return fn
