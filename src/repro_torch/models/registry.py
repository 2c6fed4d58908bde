"""Architecture registry: ``--arch <id>`` -> config + model functions +
per-shape input specs (``meta`` tensors, no allocation).

The port of ``repro.models.registry``. ``input_specs`` gives the dry run's
stand-ins for a cell's inputs, as ``meta`` tensors where the JAX package
gives ``ShapeDtypeStruct``s; ``init_params(cfg, device="meta")`` and
``init_caches(..., device="meta")`` give its parameters and caches the
same way. ``param_specs`` gives the logical-axis spec tree the JAX
package's ``init_params`` returns beside its parameters.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig

ARCHS: dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "stablelm-3b": "stablelm_3b",
    "qwen3-4b": "qwen3_4b",
    "qwen1.5-32b": "qwen15_32b",
    "mixtral-8x22b": "mixtral_8x22b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "zamba2-2.7b": "zamba2_27b",
    "whisper-base": "whisper_base",
    "phi-3-vision-4.2b": "phi3_vision",
    "rwkv6-3b": "rwkv6_3b",
}

SHAPES: dict[str, dict[str, int]] = {
    "train_4k":    {"seq": 4096,    "batch": 256, "kind": "train"},
    "prefill_32k": {"seq": 32768,   "batch": 32,  "kind": "prefill"},
    "decode_32k":  {"seq": 32768,   "batch": 128, "kind": "decode"},
    "long_500k":   {"seq": 524288,  "batch": 1,   "kind": "decode"},
}


def get_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)


def cell_supported(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """Is (arch × shape) a runnable cell? (False, reason) if skipped."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    return True, ""


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.family == "encdec"


def init_params(cfg: ArchConfig, *, generator: torch.Generator | None = None, device=None):
    """The model's parameters as an ``nn.Module`` on ``device`` (default:
    the card), drawn from ``generator`` (default: a generator on that device
    seeded with 0). The draws run on the generator's device, so a host
    generator builds host-seeded weights on any device. On ``meta`` nothing
    is drawn (the generator is ignored): every weight is an empty ``meta``
    tensor."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = None
    else:
        gen = generator if generator is not None else torch.Generator(dev).manual_seed(0)
    if is_encdec(cfg):
        return encdec.init_encdec(cfg, gen, dev)
    return transformer.init_lm(cfg, gen, dev)


def param_specs(cfg: ArchConfig) -> dict:
    """The logical spec tree of ``cfg``'s parameters, in the nested layout
    of ``convert.lm_params_to_jax`` (stacked ``layers`` axis first)."""
    if is_encdec(cfg):
        return encdec.encdec_specs(cfg)
    return transformer.lm_specs(cfg)


def forward(params, cfg: ArchConfig, batch: dict, *, mesh=None):
    if is_encdec(cfg):
        return encdec.forward(params, cfg, batch["tokens"], batch["frames"], mesh=mesh)
    return transformer.forward(params, cfg, batch["tokens"], img=batch.get("img"), mesh=mesh)


def decode_step(params, cfg: ArchConfig, batch: dict, caches, *, mesh=None):
    if is_encdec(cfg):
        return encdec.decode_step(params, cfg, batch["tokens"], caches, mesh=mesh)
    return transformer.decode_step(params, cfg, batch["tokens"], caches, mesh=mesh)


def init_caches(cfg: ArchConfig, batch: int, seq: int, *, device=None):
    dev = resolve_device(device)
    if is_encdec(cfg):
        return encdec.init_decode_caches(cfg, batch, seq, enc_len=seq, device=dev)
    return transformer.init_caches(cfg, batch, seq, dev)


# ---------------------------------------------------------------------------
# input specs (dry-run stand-ins)
# ---------------------------------------------------------------------------

def input_specs(cfg: ArchConfig, shape_name: str) -> dict[str, Any]:
    """``meta`` stand-ins for every model input of this cell (the JAX
    package's ``ShapeDtypeStruct``s). ``tokens`` and ``labels`` are int64,
    the dtype the port's model functions index with; the dry run counts them
    at 4 bytes an element, as the JAX package's int32 (``launch.dryrun``).
    A decode cell's ``caches`` are ``init_caches(..., device="meta")``, whose
    ``len`` and ``offset`` (and whisper's ``enc_len``) are host ints where
    JAX holds int32 scalars."""
    sh = SHAPES[shape_name]
    b, s, kind = sh["batch"], sh["seq"], sh["kind"]

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if kind in ("train", "prefill"):
        specs = {"tokens": meta((b, s), torch.int64)}
        if kind == "train":
            specs["labels"] = meta((b, s), torch.int64)
        if cfg.family == "vlm":
            specs["img"] = meta((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if is_encdec(cfg):
            specs["frames"] = meta((b, s, cfg.d_model), torch.bfloat16)
        return specs
    # decode: one token + caches of length s
    return {"tokens": meta((b, 1), torch.int64),
            "caches": init_caches(cfg, b, s, device="meta")}


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    updates = dict(
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=128, n_heads=4, n_kv=max(1, min(4, cfg.n_kv)),
        d_head=32, d_ff=256, vocab=512,
        param_dtype="float32", compute_dtype="float32",
        attn_chunk=64, ssm_chunk=32, rwkv_chunk=16,
        sliding_window=None if cfg.sliding_window is None else 64,
        n_patches=8, ssm_headdim=32, ssm_expand=2, ssm_state=16,
        rwkv_headdim=32, remat="none",
    )
    if cfg.family == "moe":
        updates["n_experts"] = 4
        updates["moe_sharding"] = cfg.moe_sharding
    if cfg.family == "hybrid":
        updates["n_layers"] = 4
        updates["attn_every"] = 2
        updates["n_kv"] = 4
    if cfg.family == "encdec":
        updates["enc_layers"] = 2
        updates["dec_layers"] = 2
        updates["n_layers"] = 2
    if cfg.family == "ssm":
        updates["n_heads"] = 4
        updates["n_kv"] = 4
    return dataclasses.replace(cfg, **updates)
