"""Deterministic token pipeline + FREYJA-augmented tabular path.

The port of ``repro.data.pipeline``:

* ``TokenPipeline`` — synthetic corpus (mixture of Zipf-distributed n-gram
  "documents") with deterministic, restart-safe batching: batch ``i`` is a
  pure function of (seed, step), so a restarted job resumes mid-epoch
  byte-identically, and each data shard reads only its slice. It is numpy,
  and its batches are byte-identical to the JAX package's.
* ``augmented_table_pipeline`` — FREYJA discovers joinable columns for a
  base table, and the pipeline hands them on as the join partners that
  widen its rows for training (``examples/torch_discover_augment.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.discovery import DiscoveryIndex, rank


@dataclasses.dataclass
class TokenPipeline:
    vocab: int
    seq: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        b, s = self.global_batch, self.seq
        # zipfian unigrams + a short-range bigram structure so loss can fall
        base = rng.zipf(1.3, size=(b, s)).astype(np.int64)
        toks = (base + np.roll(base, 1, axis=1) * 7) % (self.vocab - 2) + 1
        labels = np.roll(toks, -1, axis=1)
        labels[:, -1] = -1                      # mask the wrap position
        return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}

    def shard_batch(self, step: int, shard: int, n_shards: int):
        full = self.batch(step)
        lo = shard * self.global_batch // n_shards
        hi = (shard + 1) * self.global_batch // n_shards
        return {k: v[lo:hi] for k, v in full.items()}


def augmented_table_pipeline(lake, index: DiscoveryIndex, query_col: int, k: int = 3, *,
                             device=None):
    """The top-``k`` join partners of column ``query_col`` under the index's
    quality model: (ids (k,), scores (k,)), ranked on ``device`` (default:
    the card). ``lake`` is the lake the index was built from."""
    scores, ids = rank(index, np.asarray([query_col]), k=k, device=device)
    return ids[0], scores[0]
