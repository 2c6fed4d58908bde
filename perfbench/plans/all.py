"""The exact plan, ``EngineConfig(mode="full")``: every live column scored
in float32 by the fused profile-distance and GBDT scorer, same-table and
self columns excluded, the top k.

The control is the same plan over bfloat16 profiles, one precision below
the float32 the configuration states."""
import torch

from perfbench import bounds
from perfbench.reference import plain

LABEL = "local-all"              # the engine's name for the plan in stats()["plans"]


def lake_kwargs(config: dict) -> dict:
    return {}


def answer(lake, model, qids, k: int, config: dict, pad: int, *, control: bool = False):
    """(scores, ids) of ``qids``, each (Q, k); each query's answer does not
    depend on its batch, so ``pad`` is not used."""
    if not control:
        return plain.answer_all(lake, model, qids, k)
    return plain.answer_all(lake, model, qids, k,
                            zc=lake.z.to(torch.bfloat16).to(torch.float32))


def bound_s(q: int, n: int, config: dict, trees: int, depth: int) -> float:
    """The least seconds a padded batch of ``q`` over ``n`` columns needs."""
    k = int(config["engine"]["k"])
    return (bounds.fused_score(q, n, q * n, trees, depth)
            + bounds.elementwise(q * n, 8)           # exclusion: scores read, written
            + bounds.topk(q, n, k))
