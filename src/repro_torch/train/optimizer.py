"""AdamW with global-norm clipping, on one device.

The port of ``repro.train.optimizer``, held to its arithmetic: float32
moments whatever the parameter dtype, the learning rate read at the step
before the update and the bias corrections at the step after it, the
clip scale ``min(1, grad_clip / max(norm, 1e-9))`` over every leaf's
float32 norm, weight decay on every leaf, and the new parameter computed
in float32 and cast back. A parameter with no gradient (``.grad`` is
None: zamba2's unused ``shared.ln1``) counts as a zero gradient, so it
still decays and its moments still move, as in JAX. ``torch.optim.AdamW``
keeps moments in the parameter's dtype, skips parameters without a
gradient and decays before the step, so it computes other numbers.

The state is ``{"m": {name: float32}, "v": {name: float32}, "step": int32
0-d}`` on the parameters' device, keyed by ``named_parameters`` names.
Nothing here reads a value back to the host, so a step never waits for the
card. The update runs ``torch._foreach_*`` over groups of leaves of at most
``GROUP_NUMEL`` elements (one larger leaf alone), which bounds its float32
temporaries. The ZeRO-1 moment sharding of the JAX package belongs to the
dist slice.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch import nn

# elements of one foreach group: each float32 temporary of the update is at
# most this many elements (or one leaf, where a leaf is larger)
GROUP_NUMEL = 1 << 27


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _no_sharding(what: str, value) -> None:
    if value is not None:
        raise NotImplementedError(f"{what} shard the moments over a mesh, which comes with "
                                  "the port's dist slice; on one device pass None")


def named_params(params) -> dict[str, torch.Tensor]:
    """A model's ``named_parameters``, or a mapping of name -> tensor as is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, moment_shardings=None) -> dict:
    """Zero float32 moments for every parameter, and step 0, on the
    parameters' device."""
    _no_sharding("moment_shardings", moment_shardings)
    named = named_params(params)
    device = next(iter(named.values())).device

    def zeros() -> dict[str, torch.Tensor]:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup from ``lr / warmup_steps`` at step 0, then a cosine decay
    to ``min_lr_frac · lr`` at ``total_steps``; float32 from the step tensor."""
    s = torch.as_tensor(step).float()
    if cfg.warmup_steps <= 0:
        warm = 1.0
    else:
        warm = torch.clamp((s + 1.0) / cfg.warmup_steps, max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _f32(ts):
    return [t if t.dtype == torch.float32 else t.float() for t in ts]


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32. ``tree`` is a
    mapping or a sequence of tensors; None leaves are skipped."""
    leaves = [t for t in (tree.values() if isinstance(tree, Mapping) else tree)
              if t is not None]
    total = None
    for sel in _groups(leaves):
        sq = torch.stack(torch._foreach_norm(_f32(leaves[sel]))).square().sum()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def _groups(leaves) -> list[slice]:
    """Consecutive runs of leaves of at most ``GROUP_NUMEL`` elements (a
    larger leaf alone), as slices of ``leaves``."""
    out, lo, n = [], 0, 0
    for i, t in enumerate(leaves):
        if i > lo and n + t.numel() > GROUP_NUMEL:
            out.append(slice(lo, i))
            lo, n = i, 0
        n += t.numel()
    return out + [slice(lo, len(leaves))] if leaves else out


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads: Mapping, state: dict, *,
                 moment_specs=None, mesh=None):
    """One AdamW step, **in place**: the parameters, ``state["m"]``,
    ``state["v"]`` and ``state["step"]`` are updated where they lie.
    ``params`` is a model or a mapping of name -> tensor, ``grads`` a
    mapping of the same names (a missing or None gradient counts as zeros).
    Returns (params, state, {"grad_norm", "lr"}), the metrics 0-d float32
    tensors on the device."""
    _no_sharding("moment_specs", moment_specs)
    _no_sharding("mesh", mesh)
    named = named_params(params)
    names = list(named)
    gs = [grads.get(n) for n in names]
    gs = [torch.zeros(named[n].shape, dtype=torch.float32, device=named[n].device)
          if g is None else g for n, g in zip(names, gs)]

    gnorm = global_norm(gs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, state["step"])
    step = state["step"].add_(1)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())

    ps = [named[n] for n in names]
    ms = [state["m"][n] for n in names]
    vs = [state["v"][n] for n in names]
    for sel in _groups(ps):
        p, m, v = ps[sel], ms[sel], vs[sel]
        g = torch._foreach_mul(_f32(gs[sel]), scale)
        # m = b1·m + (1 - b1)·g;  v = b2·v + (1 - b2)·g·g
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
        gg = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(gg, g)
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, gg)
        del g, gg
        # delta = m̂ / (sqrt(v̂) + eps) + wd·p;  p = p - lr·delta, in float32
        delta = torch._foreach_div(m, b1c)
        den = torch._foreach_div(v, b2c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, cfg.eps)
        torch._foreach_div_(delta, den)
        del den
        p32 = _f32(p)
        torch._foreach_add_(delta, torch._foreach_mul(p32, cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        torch._foreach_neg_(delta)
        torch._foreach_add_(delta, p32)
        torch._foreach_copy_(p, delta)
    return params, state, {"grad_norm": gnorm, "lr": lr}
