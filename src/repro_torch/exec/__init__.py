"""Query execution: planner, candidate/score/merge stages and the executor.

The JAX package's ``ExecutableCache`` and ``environment_signature`` have no
counterpart: the port compiles no XLA executables, and its kernel libraries
persist in ``build/repro_torch/`` (``kernels/_build.py``).
"""
from repro_torch.exec.executor import Executor, pad_rows, pad_topk
from repro_torch.exec.plan import (DEFAULT_BATCH_BUCKETS, MODES, Planner, PlannerConfig,
                                   QueryPlan)
from repro_torch.exec.sharded import build_sharded_pipeline, place_sharded_corpus
from repro_torch.exec.stages import CANDIDATE_KINDS

__all__ = [
    "Executor", "pad_rows", "pad_topk",
    "DEFAULT_BATCH_BUCKETS", "MODES", "Planner", "PlannerConfig", "QueryPlan",
    "build_sharded_pipeline", "place_sharded_corpus",
    "CANDIDATE_KINDS",
]
