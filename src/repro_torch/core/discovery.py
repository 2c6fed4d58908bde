"""Discovery-by-attribute (paper Definition 1) — a thin adapter over
``repro_torch.exec``.

The lake index holds profiles only (a few KB per column). :func:`rank` runs
the local full-scan plan through the executor, on the card unless the
caller asks for the host; :func:`rank_sharded` runs the sharded full scan
over a :class:`~repro_torch.launch.mesh.DeviceMesh`: every tile scores its
column shard, takes a local top-k, and one small merge of k × shards
(score, id) pairs ranks them, O(Q · k · shards) bytes whatever the lake.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.predictor import JoinQualityModel
from repro_torch.core.profiles import LakeProfiles
from repro_torch.exec.executor import Executor
from repro_torch.exec.plan import Planner, PlannerConfig


@dataclasses.dataclass
class DiscoveryIndex:
    profiles: LakeProfiles
    model: JoinQualityModel
    names: list[str] | None = None
    table_ids: np.ndarray | None = None

    @property
    def n_columns(self) -> int:
        return self.profiles.n_columns


def _executor(index: DiscoveryIndex, device=None, mesh=None) -> Executor:
    return Executor(index.profiles.zscored, index.profiles.words,
                    index.model.gbdt.astuple(), table_ids=index.table_ids,
                    device=device, mesh=mesh)


def _query_rows(index: DiscoveryIndex, query_ids: np.ndarray,
                exclude_same_table: bool):
    qid = np.asarray(query_ids, np.int32)
    zq = index.profiles.zscored[qid].astype(np.float32)
    wq = index.profiles.words[qid]
    if exclude_same_table and index.table_ids is not None:
        tq = np.asarray(index.table_ids, np.int32)[qid]
    else:
        tq = np.full((len(qid),), -1, np.int32)
    return zq, wq, tq, qid


def _empty(q: int, k: int):
    return (np.full((q, k), -np.inf, np.float32),
            np.full((q, k), -1, np.int32))


def rank(index: DiscoveryIndex, query_ids: np.ndarray, k: int = 10,
         exclude_same_table: bool = True, *, device=None):
    """Single-device ranking. Returns (scores (Q, k), column ids (Q, k)).

    ``k`` may exceed the lake size; the tail is padded with -inf / -1, and
    an empty index gives all -inf / -1.
    """
    if index.n_columns == 0:
        return _empty(len(query_ids), k)
    plan = Planner(PlannerConfig(k=k)).plan(n_columns=index.n_columns,
                                            n_queries=len(query_ids), mode="full")
    zq, wq, tq, qid = _query_rows(index, query_ids, exclude_same_table)
    scores, ids, _ = _executor(index, device=device).execute(plan, zq, wq, tq, qid)
    return scores, ids


def rank_sharded(index: DiscoveryIndex, query_ids: np.ndarray, mesh,
                 k: int = 10, shard_axes=("data",)):
    """Multi-device ranking over ``mesh`` (profiles sharded over columns).

    Like :func:`rank`, ``k`` may exceed the lake (or shard) size; results
    are padded out to k with -inf / -1. Same-table exclusion is off, as in
    the JAX package's entry point (the service engine masks sharded
    queries by table).
    """
    if index.n_columns == 0:
        return _empty(len(query_ids), k)
    plan = Planner(PlannerConfig(k=k, shard_axes=tuple(shard_axes))).plan(
        n_columns=index.n_columns, n_queries=len(query_ids), mode="sharded",
        mesh=mesh)
    zq, wq, tq, qid = _query_rows(index, query_ids, exclude_same_table=False)
    scores, ids, _ = _executor(index, mesh=mesh).execute(plan, zq, wq, tq, qid)
    return scores, ids
