"""The least time an H100 needs for each stage of a padded batch, by the
names the program's tracer gives its stages (``stats()["trace"]``).

Each plan's stages are the terms of its ``plans/<kind>.py`` ``bound_s``,
grouped as the executor runs them, so a kind's stages sum to that bound:

* ``all``: ``score`` (the fused scorer over every column), ``mask`` (the
  exclusion pass), ``merge`` (the top k);
* ``tiered``: ``coarse`` (the digest probe, the proxy fill, the priority
  pass and the survivors' top), ``fine`` (the indexed probe, the proxy over
  the survivors and the budget's top), ``score`` (the quantized scorer over
  the budget), ``merge`` (the over-fetch's top) and ``rerank`` (the float32
  scorer over the over-fetch and the top k).
"""
from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np

from perfbench import bounds
from perfbench.reference.plain import RESCORE_MULT

PB = Path(__file__).resolve().parent
SIDE_BYTES = {"fp32": 4, "fp16": 2, "int8": 1}       # a resident profile slot


def stage_bounds(kind: str, q: int, n: int, config: dict, trees: int, depth: int) -> dict:
    """Seconds each stage of a padded batch of ``q`` over ``n`` columns
    needs, by stage name; ``{}`` for a plan kind with no stages here."""
    eng = config["engine"]
    k = int(eng["k"])
    if kind == "all":
        return {"score": bounds.fused_score(q, n, q * n, trees, depth),
                "mask": bounds.elementwise(q * n, 8),
                "merge": bounds.topk(q, n, k)}
    if kind != "tiered":
        return {}
    plan = config["plan"]
    s, m, r = int(plan["survivors"]), int(plan["budget"]), RESCORE_MULT * k
    side = SIDE_BYTES[eng["profile_dtype"]]
    return {
        "coarse": (bounds.lsh_probe(q, n, int(eng["lsh"]["n_coarse_bands"]))
                   + bounds.proxy(q, n, side)
                   + bounds.elementwise(q * n, 4 + 4 + 4)
                   + bounds.topk(q, n, s)),
        "fine": (bounds.lsh_probe_indexed(q, s, int(eng["lsh"]["n_bands"]), q * s)
                 + bounds.proxy(q, q * s, side)
                 + bounds.topk(q, s, m)),
        "score": bounds.fused_score(q, q * m, q * m, trees, depth, side),
        "merge": bounds.topk(q, m, r),
        "rerank": bounds.fused_score(q, q * r, q * r, trees, depth) + bounds.topk(q, r, k),
    }


@lru_cache(maxsize=None)
def _model_shape(path: str) -> tuple[int, int]:
    trees, depth = np.load(path)["feats"].shape
    return int(trees), int(depth)


def for_run(run, stage: str) -> float | None:
    """Seconds the run's batches need in ``stage``, summed over its formed
    batches at their padded sizes; None where the plan has no such stage."""
    config = run.config
    trees, depth = _model_shape(str(PB / config["model"]))
    n = int(config["lake"]["n_columns"])
    need = 0.0
    for size, count in run.batch_sizes().items():
        b = stage_bounds(config["plan"]["kind"], run.snap_batch(size), n, config, trees, depth)
        if stage not in b:
            return None
        need += count * b[stage]
    return need


def trace_delta(before: dict, after: dict) -> dict | None:
    """``after["trace"]`` less ``before["trace"]``: span totals, device ms
    and the batches they were timed in, idle ms, by name, and the batches
    whose device times were read; None where either holds no trace
    section."""
    a, b = before.get("trace"), after.get("trace")
    if a is None or b is None:
        return None
    out = {"device_batches": b.get("device_batches", 0) - a.get("device_batches", 0)}
    for key, field, name_out in (("spans", "total_ms", "spans"), ("device_ms", "ms", "device_ms"),
                                 ("device_ms", "count", "device_count")):
        if key in b:
            out[name_out] = {name: v[field] - a.get(key, {}).get(name, {}).get(field, 0)
                             for name, v in b[key].items()}
    if "idle_ms" in b:
        out["idle_ms"] = {name: v - a.get("idle_ms", {}).get(name, 0.0)
                          for name, v in b["idle_ms"].items()}
    return out


def roofline_pct(run, stage: str) -> float | None:
    """The stage's least time over its device time in the window, in
    percent; the need is scaled to the batches whose stage was timed. None
    where the run timed no such stage on the device."""
    d = trace_delta(run.engine_before, run.engine_after)
    n = run.n_batches()
    if d is None or not n:
        return None
    dev_ms = d.get("device_ms", {}).get(stage, 0.0)
    timed = d.get("device_count", {}).get(stage, 0)
    need = for_run(run, stage)
    if dev_ms <= 0 or not timed or not need:
        return None
    return 100.0 * need * 1e3 * (timed / n) / dev_ms
