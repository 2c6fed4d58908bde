"""Shared model primitives: norms, MLPs, embeddings, the LM head, RoPE and
the init helpers.

The port of ``repro.models.layers``. Parameters live in ``nn.Module``s under
the JAX package's leaf names (``embedding``, ``lm_head``, ``scale``,
``w_gate`` ...), so a JAX parameter tree maps onto a ``state_dict`` key for
key (``convert.lm_params_from_jax``). The modules only hold parameters;
the computation is plain functions on tensors, as in JAX. The logical-axis
specs the JAX init functions return beside their parameters come from the
``*_specs(cfg)`` functions (``registry.param_specs`` assembles them). The
model functions read a parameter by attribute and test for an optional
one with ``getattr(p, name, None)``, so a sharded model's view
(``dist.sharding.ShardedModel.view``) stands in for a module.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def param(t: torch.Tensor) -> nn.Parameter:
    """A serving weight: the serving path runs no backward pass (a trainer
    turns gradients on with ``requires_grad_()``)."""
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen: torch.Generator, shape, dtype, device, scale: float | None = None):
    """Normal(0, 1/sqrt(shape[0])) weights, drawn in float32 on the
    generator's device from ``gen``, then cast and moved. ``shape[0]`` is the
    fan-in as in JAX (for an (E, d, f) expert stack that is E). On the
    ``meta`` device nothing is drawn: the weight is an empty ``meta``
    tensor of the shape and dtype (the dry run's stand-in)."""
    if torch.device(device).type == "meta":
        return param(torch.empty(tuple(shape), dtype=dtype, device="meta"))
    fan_in = shape[0] if len(shape) >= 2 else max(shape[0], 1)
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return param((w * scale).to(device=device, dtype=dtype))


def full(shape, value: float, dtype, device) -> nn.Parameter:
    return param(torch.full(tuple(shape), value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (and ``bias`` for a LayerNorm) over d_model."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        self.scale = full((cfg.d_model,), 1.0, dtype, device)
        if cfg.norm == "layernorm":
            self.bias = full((cfg.d_model,), 0.0, dtype, device)


def norm_specs(cfg) -> dict:
    s = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        s["bias"] = ("embed",)
    return s


def apply_norm(p: Norm, x, kind: str, eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        out = xf * inv * p.scale.float()
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p.scale.float()
        out = out + p.bias.float()
    return out.to(x.dtype)


def rms_norm_vec(x, scale, eps: float = 1e-6):
    """RMS-norm over the last axis with a learned scale (qk-norm etc.)."""
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation (torch's default,
    the exact erf form, differs by a few 1e-4)."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.act == "silu":  # gated
            self.w_gate = dense_init(gen, (d, f), dtype, device)
            self.w_up = dense_init(gen, (d, f), dtype, device)
            self.w_down = dense_init(gen, (f, d), dtype, device)
        else:
            self.w_up = dense_init(gen, (d, f), dtype, device)
            self.w_down = dense_init(gen, (f, d), dtype, device)


def mlp_specs(cfg) -> dict:
    if cfg.act == "silu":
        return {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
                "w_down": ("mlp", "embed")}
    return {"w_up": ("embed", "mlp"), "w_down": ("mlp", "embed")}


def apply_mlp(p: MLP, x, act: str):
    w_gate = getattr(p, "w_gate", None)
    if w_gate is not None:
        h = F.silu(x @ w_gate) * (x @ p.w_up)
    else:
        h = gelu(x @ p.w_up)
    return h @ p.w_down


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.embedding = dense_init(gen, (cfg.vocab, cfg.d_model), dtype, device, scale=0.02)
        if not cfg.tie_embeddings:
            self.lm_head = dense_init(gen, (cfg.d_model, cfg.vocab), dtype, device)


def embed_specs(cfg) -> dict:
    s = {"embedding": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        s["lm_head"] = ("embed", "vocab")
    return s


def embed_tokens(p: Embed, tokens, compute_dtype):
    return p.embedding[tokens].to(compute_dtype)


def lm_logits(p: Embed, x):
    w = getattr(p, "lm_head", None)
    w = p.embedding.T if w is None else w
    return (x @ w).float()


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device):
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x (..., S, H, Dh), positions (..., S) integer. The split-half layout:
    the first Dh/2 channels rotate against the last Dh/2."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                      # (Dh/2,)
    ang = positions[..., None].float() * freqs                   # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]                           # (..., S, 1, Dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
