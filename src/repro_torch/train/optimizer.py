"""AdamW with global-norm clipping, on one device or with ZeRO-1 moments.

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
temporaries.

**On a mesh** (parameters placed by ``dist.sharding.place_params``) the
moments are ZeRO-1 shards (``dist.sharding.zero1_shardings``: the
parameter's split plus the largest still-replicated dimension over the
batch axes), each on its mesh position's device, as ``init_opt_state(
moment_shardings=)`` places them. ``adamw_update`` takes the reduced full
gradients (one device), computes the global norm over them in the
single-device order, updates each moment shard on its device from the
matching slice of the gradient together with that region of the parameter
(in place where the position's own parameter shard holds it), then writes
the updated region into every other replica of the parameter.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
from torch import nn

from repro_torch.dist.collectives import Sharded, gather, intersect, relative, zeros
from repro_torch.dist.sharding import ShardedModel, jax_leaf, per_leaf, rank_device

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


def named_params(params) -> dict[str, torch.Tensor]:
    """A model's ``named_parameters``, or a mapping of name -> tensor as is."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_opt_state(params, moment_shardings=None, *, cfg=None) -> dict:
    """Zero float32 moments for every parameter, and step 0, on the
    parameters' device. For a ``ShardedModel`` the moments are placed by
    ``moment_shardings`` (``zero1_shardings``' tree, in the JAX layout:
    ``cfg`` names the stacked depths), or like the parameters without it;
    the step lies on the first data rank's device."""
    if isinstance(params, ShardedModel):
        return _init_sharded(params, moment_shardings, cfg)
    if moment_shardings is not None:
        raise ValueError("moment_shardings place the moments of parameters placed on a "
                         "mesh (dist.sharding.place_params)")
    named = named_params(params)
    device = next(iter(named.values())).device

    def zeros() -> dict[str, torch.Tensor]:
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in named.items()}

    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _init_sharded(params: ShardedModel, moment_shardings, cfg) -> dict:
    mesh = params.mesh
    if moment_shardings is not None:
        if cfg is None:
            raise ValueError("moment_shardings in the JAX layout need cfg= (the stacked depths)")
        by_name = per_leaf(moment_shardings, params.leaves, cfg)

    def moments():
        out = {}
        for name, sh in params.leaves.items():
            if moment_shardings is None:
                made = Sharded(mesh, sh.spec, sh.shape, torch.float32,
                               {p: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                                for p, t in sh.shards.items()})
            else:
                sharding, layer = by_name[name]
                made = zeros(sh.shape, torch.float32, mesh, sharding.spec, layer=layer)
            out[name] = made
        return out

    return {"m": moments(), "v": moments(),
            "step": torch.zeros((), dtype=torch.int32, device=rank_device(mesh, 0))}


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
    tensors on the device.

    For a ``ShardedModel`` (``mesh`` its mesh), ``grads`` are the reduced
    full gradients on one device and ``state`` the ZeRO-1 moments of
    ``init_opt_state``; ``moment_specs`` (``zero1_shardings``' specs, JAX
    layout), when given, must be the moments' own."""
    sharded = isinstance(params, ShardedModel)
    if not sharded and (moment_specs is not None or mesh is not None):
        raise ValueError("moment_specs and mesh go with parameters placed on a mesh")
    shapes = ({n: sh.shape for n, sh in params.leaves.items()} if sharded
              else {n: p.shape for n, p in named_params(params).items()})
    names = list(shapes)
    if sharded and moment_specs is not None:
        _check_moment_specs(state, moment_specs, names)
    dev = state["step"].device
    gs = [grads.get(n) for n in names]
    gs = [torch.zeros(shapes[n], dtype=torch.float32, device=dev) if g is None else g
          for n, g in zip(names, gs)]

    gnorm = global_norm(gs)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_schedule(cfg, state["step"])
    step = state["step"].add_(1)
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    consts = (scale, lr, b1c, b2c)
    if sharded:
        _sharded_update(cfg, params, dict(zip(names, gs)), state, consts)
    else:
        named = named_params(params)
        _update(cfg, [named[n] for n in names], gs, [state["m"][n] for n in names],
                [state["v"][n] for n in names], consts)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update(cfg: AdamWConfig, ps, gs, ms, vs, consts) -> None:
    """The AdamW arithmetic over lists of parameters (or regions of them),
    gradients and moments on one device, all written in place."""
    scale, lr, b1c, b2c = consts
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


def _check_moment_specs(state, moment_specs, names) -> None:
    for name in names:
        node, layer = jax_leaf(moment_specs, name)
        want = tuple(node)[1:] if layer is not None else tuple(node)
        got = state["m"][name].spec
        if tuple(got) != want + (None,) * (len(got) - len(want)):
            raise ValueError(f"moment of {name} lies as {got}, moment_specs say {tuple(node)}")


def _sharded_update(cfg: AdamWConfig, params: ShardedModel, grads: dict, state: dict,
                    consts) -> None:
    """Each moment shard's update on its device, batched by device, then the
    updated parameter regions written into the replicas that did not update
    them themselves."""
    groups: dict = {}                    # device -> ([p], [g], [m], [v])
    owners = []                          # (leaf, region, updated tensor, in place at)
    for name, psh in params.leaves.items():
        m_sh, v_sh = state["m"][name], state["v"][name]
        seen = set()
        for pos, m in m_sh.shards.items():
            r = m_sh.region(pos)
            own = psh.shards.get(pos)
            if own is not None and intersect(psh.region(pos), r) == r:
                target, at = own[relative(r, psh.region(pos))], pos
            else:
                target, at = gather(psh, m.device, r).clone(), None
            lists = groups.setdefault(m.device, ([], [], [], []))
            for lst, t in zip(lists, (target, grads[name][r].to(m.device), m,
                                      v_sh.shards[pos])):
                lst.append(t)
            owners.append((name, r, target, at, r not in seen))
            seen.add(r)
    for device, (ps, gs, ms, vs) in groups.items():
        _update(cfg, ps, gs, ms, vs, tuple(c.to(device) for c in consts))
    # each region once, from its first moment shard in mesh order, into
    # every parameter replica whose own moment shard did not update it
    updated_at = {(name, r, at) for name, r, _, at, _ in owners if at is not None}
    for name, r, target, _, first in owners:
        if not first:
            continue
        psh = params.leaves[name]
        for q, pt in psh.shards.items():
            common = intersect(psh.region(q), r)
            if common is None or (name, r, q) in updated_at:
                continue
            pt[relative(common, psh.region(q))].copy_(
                target[relative(common, r)].to(pt.device))
