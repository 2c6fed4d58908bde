"""Discovery-by-attribute (paper Definition 1) — a thin adapter over
``repro_torch.exec``.

The lake index holds profiles only (a few KB per column). :func:`rank` runs
the local full-scan plan through the executor, on the card unless the
caller asks for the host. The mesh-sharded ``rank_sharded`` of the JAX
package waits for the multi-device slice.
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


def rank(index: DiscoveryIndex, query_ids: np.ndarray, k: int = 10,
         exclude_same_table: bool = True, *, device=None):
    """Single-device ranking. Returns (scores (Q, k), column ids (Q, k)).

    ``k`` may exceed the lake size; the tail is padded with -inf / -1, and
    an empty index gives all -inf / -1.
    """
    qid = np.asarray(query_ids, np.int32)
    if index.n_columns == 0:
        return (np.full((len(qid), k), -np.inf, np.float32),
                np.full((len(qid), k), -1, np.int32))
    executor = Executor(index.profiles.zscored, index.profiles.words,
                        index.model.gbdt.astuple(), table_ids=index.table_ids,
                        device=device)
    plan = Planner(PlannerConfig(k=k)).plan(n_columns=index.n_columns,
                                            n_queries=len(qid), mode="full")
    zq = index.profiles.zscored[qid].astype(np.float32)
    wq = index.profiles.words[qid]
    if exclude_same_table and index.table_ids is not None:
        tq = np.asarray(index.table_ids, np.int32)[qid]
    else:
        tq = np.full((len(qid),), -1, np.int32)
    scores, ids, _ = executor.execute(plan, zq, wq, tq, qid)
    return scores, ids
