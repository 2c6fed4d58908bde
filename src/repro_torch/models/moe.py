"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch.

The port of ``repro.models.moe``'s local path: tokens are sorted by expert
id (a stable sort, as ``jnp.argsort``), gathered into (E, C, d) blocks with
capacity C = ceil8(T·k/E · capacity_factor) and dropped beyond C
(GShard-style token dropping), run through an E-batched FFN, and combined
with the router weights. Top-k takes the lower expert first on ties, as
``jax.lax.top_k`` does.

The combine adds each kept copy into its token's row with ``index_add_``
(atomic on the card). A token receives k = 2 copies plus exact zeros from
padded slots, and two terms add the same in either order, so the result
does not depend on the order of the atomics.

Over a ``model`` mesh axis (``moe_ffn_local(..., model_axis="model")``,
what the JAX package runs inside ``shard_map``), ``cfg.moe_sharding``
picks the collective, as in JAX:

* ``tp`` — every expert's d_ff is split over the model ranks; each rank's
  f-shard gives a partial (E, C, d) output and one ``psum`` adds them;
* ``ep`` — the experts are split over the model ranks; tokens travel to
  their expert's rank and back with two ``all_to_all``s (send capacity
  ``max(8, round(T·k/mp · max(cf, 2)))``, dropped beyond it), and each
  rank runs its ``E/mp`` experts masked over everything it received.

The single controller passes the model ranks' shards as a list, each on
its rank's device (``dist.collectives``: peer copies, sums in rank order).
With no mesh both take the local path, in JAX too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.collectives import all_to_all, psum
from repro_torch.exec.stages import topk_stable
from repro_torch.models.layers import dense_init, gelu


class MoE(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = dense_init(gen, (d, e), torch.float32, device)
        self.w_gate = dense_init(gen, (e, d, f), dtype, device)
        self.w_up = dense_init(gen, (e, d, f), dtype, device)
        self.w_down = dense_init(gen, (e, f, d), dtype, device)


def moe_specs(cfg) -> dict:
    if cfg.moe_sharding == "ep":
        return {"router": ("none", "none"), "w_gate": ("expert", "none", "none"),
                "w_up": ("expert", "none", "none"), "w_down": ("expert", "none", "none")}
    return {"router": ("none", "none"), "w_gate": ("none", "none", "mlp"),
            "w_up": ("none", "none", "mlp"), "w_down": ("none", "mlp", "none")}


def _dispatch(eids, weights, tokens, n_buckets: int, capacity: int):
    """Sort-based capacity dispatch (static shapes, GShard-style dropping).

    Returns per (bucket, slot): token row (-1 pad), router weight, copy id.
    """
    tk = eids.shape[0]
    dev = eids.device
    order = torch.argsort(eids, stable=True)
    es = eids[order]
    # a static-shape count (bincount's size depends on the data, so it has
    # no meta kernel and the dry run could not trace it)
    counts = torch.zeros(n_buckets, dtype=torch.int64, device=dev).scatter_add_(
        0, es.long(), torch.ones_like(es, dtype=torch.int64))
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(tk, device=dev) - start[es]
    keep = pos < capacity
    # dropped copies all land in one spare slot past the end, cut off below
    slot = torch.where(keep, es * capacity + pos, n_buckets * capacity)

    def scatter(vals, fill, dt):
        out = torch.full((n_buckets * capacity + 1,), fill, dtype=dt, device=dev)
        out[slot] = vals.to(dt)
        return out[:-1]

    return (scatter(tokens[order], -1, torch.int32),
            scatter(weights[order], 0.0, torch.float32),
            scatter(order, -1, torch.int32))


def _expert_ffn(xe, w_gate, w_up, w_down, act: str):
    """(E, C, d) × (E, d, f) -> (E, C, d)."""
    g = torch.einsum("ecd,edf->ecf", xe, w_gate)
    u = torch.einsum("ecd,edf->ecf", xe, w_up)
    h = (F.silu(g) if act == "silu" else gelu(g)) * u
    return torch.einsum("ecf,efd->ecd", h, w_down)


def moe_ffn_local(p, cfg, x, *, model_axis: str | None = None):
    """MoE FFN over this data shard's tokens. x (T, d) -> (T, d).

    With ``model_axis`` set, ``p`` is the list of the model ranks' MoE
    parameters (``router``, ``w_gate``, ``w_up``, ``w_down`` attributes:
    each rank's shard by ``moe_specs`` under ``spec_of``, on the rank's
    device) and ``x`` the tokens every rank of the axis holds; the result
    lies on ``x``'s device."""
    ranks = p if model_axis is not None else None
    p0 = ranks[0] if ranks is not None else p
    tl, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ p0.router.float().to(x.device)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = topk_stable(probs, k)                    # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    copies_e = top_e.reshape(-1)                            # (T·k,)
    copies_w = top_w.reshape(-1)
    copies_t = torch.arange(tl, device=x.device).repeat_interleave(k)

    if cfg.moe_sharding == "ep" and ranks is not None:
        return _moe_ep(ranks, cfg, x, copies_e, copies_w, copies_t)

    # ---- tp (or single-device) path: local dispatch ----
    cap = int(max(8, -(-round(tl * k / e * cfg.capacity_factor) // 8) * 8))
    slot_token, slot_weight, _ = _dispatch(copies_e, copies_w, copies_t, e, cap)
    filled = (slot_token >= 0)[:, None]
    rows = torch.clamp(slot_token, min=0).long()
    xe = torch.where(filled, x[rows], 0.0).reshape(e, cap, d)
    if ranks is None:
        ye = _expert_ffn(xe, p.w_gate, p.w_up, p.w_down, cfg.act)
    else:                                                   # combine the f-shards
        ye = psum([_expert_ffn(xe.to(r.w_gate.device), r.w_gate, r.w_up, r.w_down, cfg.act)
                   for r in ranks], x.device)
    ye = ye.reshape(e * cap, d) * slot_weight[:, None].to(x.dtype)
    out = torch.zeros((tl, d), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, torch.where(filled, ye, 0.0).to(x.dtype))


def _moe_ep(ranks, cfg, x, copies_e, copies_w, copies_t):
    """The ``ep`` path: dispatch to the experts' ranks, two all_to_alls."""
    tl, d = x.shape
    mp = len(ranks)
    devices = [r.w_gate.device for r in ranks]
    e_local = cfg.n_experts // mp
    send_cf = max(cfg.capacity_factor, 2.0)                 # A2A send buffer
    cap_send = int(max(8, round(tl * cfg.top_k / mp * send_cf)))
    dest = torch.div(copies_e, e_local, rounding_mode="floor")
    slot_token, slot_weight, slot_copy = _dispatch(dest, copies_w, copies_t, mp, cap_send)
    local_e = torch.where(slot_copy >= 0,
                          copies_e[torch.clamp(slot_copy, min=0).long()] % e_local, -1)
    filled = (slot_token >= 0)[:, None]
    rows = torch.clamp(slot_token, min=0).long()
    xe = torch.where(filled, x[rows], 0.0).reshape(mp, cap_send, d)
    meta = local_e.float().reshape(mp, cap_send, 1)
    # every model rank holds the same tokens, so each sends the same buffer
    xr = all_to_all([xe.to(dv) for dv in devices], devices)
    mr = all_to_all([meta.to(dv) for dv in devices], devices)
    yr = []
    for r, xs, ms in zip(ranks, xr, mr):
        xs = xs.reshape(mp * cap_send, d)
        ms = ms.reshape(-1).to(torch.int32)
        y = torch.zeros_like(xs)
        for le_i in range(e_local):
            h = _expert_ffn(xs[None], r.w_gate[le_i][None], r.w_up[le_i][None],
                            r.w_down[le_i][None], cfg.act)[0]
            y = y + h * (ms == le_i)[:, None].to(xs.dtype)
        yr.append(y.reshape(mp, cap_send, d))
    yb = all_to_all(yr, devices)[0].reshape(mp * cap_send, d).to(x.device)
    out = torch.zeros((tl, d), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, torch.where(filled, yb * slot_weight[:, None],
                                               0.0).to(x.dtype))
