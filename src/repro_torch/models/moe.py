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

``cfg.moe_sharding`` (``tp``/``ep``) only changes how the JAX package
shards the experts over a ``model`` mesh axis (a ``psum`` or two
``all_to_all``s); with no mesh both take this local path, in JAX too. The
sharded paths come with the ``dist`` slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

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


def _dispatch(eids, weights, tokens, n_buckets: int, capacity: int):
    """Sort-based capacity dispatch (static shapes, GShard-style dropping).

    Returns per (bucket, slot): token row (-1 pad), router weight, copy id.
    """
    tk = eids.shape[0]
    dev = eids.device
    order = torch.argsort(eids, stable=True)
    es = eids[order]
    counts = torch.bincount(es, minlength=n_buckets)
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


def moe_ffn_local(p: MoE, cfg, x, *, model_axis: str | None = None):
    """MoE FFN over local tokens. x (T, d) -> (T, d)."""
    if model_axis is not None:
        raise NotImplementedError(
            "MoE over a model mesh axis (tp psum / ep all_to_all) comes with the "
            "port's dist slice; with no mesh pass model_axis=None")
    tl, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ p.router.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = topk_stable(probs, k)                    # (T, k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    copies_e = top_e.reshape(-1)                            # (T·k,)
    copies_w = top_w.reshape(-1)
    copies_t = torch.arange(tl, device=x.device).repeat_interleave(k)

    cap = int(max(8, -(-round(tl * k / e * cfg.capacity_factor) // 8) * 8))
    slot_token, slot_weight, _ = _dispatch(copies_e, copies_w, copies_t, e, cap)
    filled = (slot_token >= 0)[:, None]
    rows = torch.clamp(slot_token, min=0).long()
    xe = torch.where(filled, x[rows], 0.0).reshape(e, cap, d)
    ye = _expert_ffn(xe, p.w_gate, p.w_up, p.w_down, cfg.act)
    ye = ye.reshape(e * cap, d) * slot_weight[:, None].to(x.dtype)
    out = torch.zeros((tl, d), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows, torch.where(filled, ye, 0.0).to(x.dtype))
