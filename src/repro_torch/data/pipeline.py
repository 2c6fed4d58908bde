"""The FREYJA-augmented tabular path, the port of
``repro.data.pipeline.augmented_table_pipeline``.

FREYJA discovers joinable columns for a base table, and the pipeline hands
them on as the join partners that widen its rows for training
(``examples/torch_discover_augment.py``). The JAX module's synthetic token
pipeline belongs to the language-model scaffolding, which is not ported.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.discovery import DiscoveryIndex, rank


def augmented_table_pipeline(lake, index: DiscoveryIndex, query_col: int, k: int = 3, *,
                             device=None):
    """The top-``k`` join partners of column ``query_col`` under the index's
    quality model: (ids (k,), scores (k,)), ranked on ``device`` (default:
    the card). ``lake`` is the lake the index was built from."""
    scores, ids = rank(index, np.asarray([query_col]), k=k, device=device)
    return ids[0], scores[0]
