"""Decoder-only LM assembly for all families (dense / moe / vlm / ssm /
hybrid): init, the forward pass, prefill with caches and the cached decode
step.

The port of ``repro.models.transformer`` on one device. Where JAX stacks
the blocks on a leading ``layers`` axis and scans them, the port keeps one
``nn.Module`` a block in an ``nn.ModuleList`` and loops. The caches keep
JAX's stacked layout (``kv.k`` is (L, B, S, nk, dh), ``rwkv.wkv`` is
(L, B, H, K, K), ...), with ``len`` and ``offset`` as host ``int``s, so a
decode step never waits for the card. ``decode_step`` writes the new
token's state into the cache tensors **in place**: the dict it returns
holds the same tensors as the one passed in, now updated, and the caller
must not reuse the old dict's contents as the state before the step.

Families:
* dense / vlm  — [norm → GQA attn → +res, norm → (Sw)iGLU MLP → +res] × L
* moe          — MLP replaced by ``moe_ffn_local``
* ssm (rwkv6)  — RWKV6 time-mix + channel-mix blocks
* hybrid       — zamba2: groups of ``attn_every`` mamba2 blocks, each group
                 followed by one **shared** (single-parameter) attention+MLP
                 block

VLM: ``img`` stub embeddings replace the first ``n_patches`` token
embeddings (the CLIP frontend is out of scope).

Over a mesh (``mesh=``, the parameters placed by
``dist.sharding.place_params``), ``forward``, ``forward_with_caches`` and
``decode_step`` split the batch rows over the data ranks (contiguously,
when they divide; else every row runs on the first rank) and run each
rank's rows on its device with the parameters gathered there as they are
read; the outputs (and caches) come back joined on the first rank's
device. The MoE keeps JAX's ``shard_map`` dispatch (``_moe_apply``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import gather, region_of
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MLP, Embed, Norm, apply_mlp, apply_norm, dtype_of,
                                       embed_specs, embed_tokens, lm_logits, mlp_specs,
                                       norm_specs)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.mlp = (moe_mod.MoE(cfg, gen, dtype, device) if cfg.family == "moe"
                    else MLP(cfg, gen, dtype, device))
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)


class LM(nn.Module):
    """The parameters of a decoder-only LM under the JAX package's names:
    ``embed``, ``final_norm``, ``blocks.N.*`` and, for the hybrid,
    ``shared``, ``blocks_norm.N`` and ``shared_norm``."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        self.embed = Embed(cfg, gen, dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        if cfg.family in ("dense", "moe", "vlm"):
            block = DenseBlock
        elif cfg.family == "ssm":
            block = rwkv_mod.RWKVBlock
        elif cfg.family == "hybrid":
            block = ssm_mod.Mamba2
            self.shared = DenseBlock(dataclasses.replace(cfg, family="dense"), gen, dtype,
                                     device)
            self.blocks_norm = nn.ModuleList(Norm(cfg, dtype, device)
                                             for _ in range(cfg.n_layers))
            self.shared_norm = Norm(cfg, dtype, device)
        else:
            raise ValueError(cfg.family)
        self.blocks = nn.ModuleList(block(cfg, gen, dtype, device)
                                    for _ in range(cfg.n_layers))


def init_lm(cfg, gen: torch.Generator, device) -> LM:
    return LM(cfg, gen, device)


def stack_specs(s: dict) -> dict:
    """A block's logical specs with the stacked ``layers`` axis first."""
    return {k: stack_specs(v) if isinstance(v, dict) else ("layers",) + v
            for k, v in s.items()}


def dense_block_specs(cfg) -> dict:
    return {"attn": attn.attention_specs(cfg),
            "mlp": moe_mod.moe_specs(cfg) if cfg.family == "moe" else mlp_specs(cfg),
            "ln1": norm_specs(cfg), "ln2": norm_specs(cfg)}


def lm_specs(cfg) -> dict:
    """The JAX ``init_lm``'s logical spec tree (layers stacked first)."""
    specs = {"embed": embed_specs(cfg), "final_norm": norm_specs(cfg)}
    if cfg.family in ("dense", "moe", "vlm"):
        specs["blocks"] = stack_specs(dense_block_specs(cfg))
    elif cfg.family == "ssm":
        specs["blocks"] = stack_specs(rwkv_mod.rwkv_specs(cfg))
    elif cfg.family == "hybrid":
        specs["blocks"] = stack_specs(ssm_mod.mamba2_specs(cfg))
        specs["shared"] = dense_block_specs(dataclasses.replace(cfg, family="dense"))
        specs["blocks_norm"] = stack_specs(norm_specs(cfg))
        specs["shared_norm"] = norm_specs(cfg)
    else:
        raise ValueError(cfg.family)
    return specs


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _moe_apply(pm, cfg, x, mesh=None):
    """The MoE over (B, S, d) activations. Over a mesh, as the JAX package's
    ``shard_map``: the B·S tokens split into one contiguous chunk a data
    rank when they divide (otherwise every rank takes them all, so the
    first rank's result stands for all), each chunk dispatched on its own
    (its drops are its own) across its row's model ranks; ``dp`` mode takes
    the local path with each row's full weights. ``pm`` is then a view of
    placed parameters (``ShardedModel.view``): a rank's view covers exactly
    its own chunk."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if mesh is None:
        return moe_mod.moe_ffn_local(pm, cfg, x2).reshape(b, s, d)
    n = shd.n_data_ranks(mesh)
    t = b * s
    if pm.data_index is not None:
        chunks = [(slice(0, t), pm.data_index)]
    elif t % n == 0 and t >= n:
        chunks = [(slice(i * (t // n), (i + 1) * (t // n)), i) for i in range(n)]
    else:                               # tiny decode batches replicate tokens
        chunks = [(slice(0, t), 0)]
    # dp mode replicates expert weights: no model-axis collective
    maxis = "model" if (shd.get_mode() != "dp" and "model" in mesh.axis_names) else None
    specs = moe_mod.moe_specs(cfg)
    outs = []
    for rows, c in chunks:
        dev = shd.rank_device(mesh, c)
        if maxis is None:
            p = _MoEWeights(pm, specs, mesh, c, None)
            y = moe_mod.moe_ffn_local(p, cfg, x2[rows].to(dev))
        else:
            ranks = [_MoEWeights(pm, specs, mesh, c, m) for m in range(mesh.shape["model"])]
            y = moe_mod.moe_ffn_local(ranks, cfg, x2[rows].to(dev), model_axis=maxis)
        outs.append(y.to(x.device))
    return torch.cat(outs).reshape(b, s, d)


class _MoEWeights:
    """One model rank's MoE weights in data row ``c``: each leaf's block
    under ``spec_of(moe_specs)`` (all of it with ``model=None``), gathered
    onto that rank's device from the placed leaves."""

    def __init__(self, pm, specs, mesh, c, model):
        pos = shd.position(mesh, c, model=model or 0)
        prefer = {**shd.data_row(mesh, c), **({} if model is None else {"model": model})}
        for name, logical in specs.items():
            leaf = pm.leaf(name)
            region = (None if model is None
                      else region_of(mesh, shd.spec_of(logical, mesh), leaf.shape, pos))
            setattr(self, name, gather(leaf, mesh.devices[pos], region, prefer=prefer))


def _ffn(pl, cfg, h, mesh=None):
    if cfg.family == "moe":
        return _moe_apply(pl.mlp, cfg, h, mesh)
    return apply_mlp(pl.mlp, h, cfg.act)


def _dense_block_fwd(pl, cfg, x, positions, mesh=None, *, return_kv: bool = False):
    h = apply_norm(pl.ln1, x, cfg.norm)
    h = attn.attention_train(pl.attn, cfg, h, positions, return_kv=return_kv)
    if return_kv:
        h, kv = h
    x = x + h
    x = x + _ffn(pl, cfg, apply_norm(pl.ln2, x, cfg.norm), mesh)
    return (x, kv) if return_kv else x


def _embed_inputs(params, cfg, tokens, img):
    cdt = dtype_of(cfg.compute_dtype)
    b, s = tokens.shape
    x = embed_tokens(params.embed, tokens, cdt)
    if cfg.family == "vlm" and img is not None:
        x = torch.cat([img.to(cdt), x[:, cfg.n_patches:]], dim=1)
    positions = torch.arange(s, device=tokens.device)[None].expand(b, s)
    return x, positions


def hybrid_groups(cfg):
    """The hybrid's layer groups: ``attn_every`` mamba2 layers each, every
    group followed by the shared attention block."""
    ae = cfg.attn_every
    return [range(g * ae, (g + 1) * ae) for g in range(cfg.n_layers // ae)]


def _shared_block(params, cfg, x, positions, *, return_kv: bool = False):
    shared = params.shared
    h = apply_norm(params.shared_norm, x, cfg.norm)
    h = attn.attention_train(shared.attn, cfg, h, positions, return_kv=return_kv)
    if return_kv:
        h, kv = h
    x = x + h
    x = x + apply_mlp(shared.mlp, apply_norm(shared.ln2, x, cfg.norm), cfg.act)
    return (x, kv) if return_kv else x


def remat(cfg, fn, *args):
    """``fn(*args)``; under ``cfg.remat == "block"`` with gradients on, its
    activations are recomputed in the backward pass instead of kept
    (``jax.checkpoint`` of the JAX package's scanned block bodies). The
    values are the same either way."""
    if cfg.remat == "block" and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _rwkv_block(pl, cfg, x):
    return rwkv_mod.rwkv_block_forward(pl, cfg, x)[0]


def _mamba_block(pl, norm, cfg, x):
    return x + ssm_mod.mamba2_forward(pl, cfg, apply_norm(norm, x, cfg.norm))


def forward(params: LM, cfg, tokens, *, img=None, mesh=None):
    """Training/prefill forward. tokens (B, S) -> logits (B, S, V) f32."""
    if shd.is_sharded(params, mesh):
        dev = shd.rank_device(mesh, 0)
        return shd.cat_ranks(shd.on_ranks(params, mesh, tokens.shape[0], lambda v, rows, d: forward(
            v, cfg, tokens[rows].to(d), img=shd.rows_to(img, rows, d), mesh=mesh)), 0, dev)
    x, positions = _embed_inputs(params, cfg, tokens, img)
    if cfg.family in ("dense", "moe", "vlm"):
        for pl in params.blocks:
            x = remat(cfg, _dense_block_fwd, pl, cfg, x, positions, mesh)
    elif cfg.family == "ssm":
        for pl in params.blocks:
            x = remat(cfg, _rwkv_block, pl, cfg, x)
    elif cfg.family == "hybrid":
        for group in hybrid_groups(cfg):
            for i in group:
                x = remat(cfg, _mamba_block, params.blocks[i], params.blocks_norm[i], cfg, x)
            x = remat(cfg, _shared_block, params, cfg, x, positions)
    else:
        raise ValueError(cfg.family)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x)


# ---------------------------------------------------------------------------
# prefill: forward that also materializes decode caches
# ---------------------------------------------------------------------------

def _roll_pad(a, cache_size: int):
    """Pack a (B, S, ...) tensor into ``cache_size`` slots (ring layout)."""
    s = a.shape[1]
    if s >= cache_size:
        return torch.roll(a[:, s - cache_size:], s % cache_size, dims=1)
    pad = torch.zeros((a.shape[0], cache_size - s) + tuple(a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    return torch.cat([a, pad], dim=1)


def _kv_to_cache(cfg, k, v, cache_size: int):
    """Pack post-RoPE (B, S, nk, dh) K/V into a decode cache (ring layout
    for sliding-window archs; int8 + scales when cfg.kv_quant)."""
    if cfg.kv_quant:
        qk, sk = attn.quantize_kv(k)
        qv, sv = attn.quantize_kv(v)
        return {"k": _roll_pad(qk, cache_size), "v": _roll_pad(qv, cache_size),
                "k_scale": _roll_pad(sk, cache_size),
                "v_scale": _roll_pad(sv, cache_size)}
    return {"k": _roll_pad(k, cache_size), "v": _roll_pad(v, cache_size)}


def _stack(per_layer: list[dict]) -> dict:
    """Per-layer cache dicts -> one dict of (L, ...) tensors."""
    return {key: torch.stack([c[key] for c in per_layer]) for key in per_layer[0]}


def _no_quantized_hybrid(cfg):
    if cfg.family == "hybrid" and cfg.kv_quant:
        raise NotImplementedError(
            "kv_quant on the hybrid: the JAX package keeps no scales for the shared "
            "attention's cache")


@torch.no_grad()
def forward_with_caches(params: LM, cfg, tokens, cache_size: int, *, img=None, mesh=None):
    """Prefill: returns (logits (B, S, V), decode caches with len = S)."""
    if shd.is_sharded(params, mesh):
        dev = shd.rank_device(mesh, 0)
        parts = shd.on_ranks(params, mesh, tokens.shape[0], lambda v, rows, d: forward_with_caches(
            v, cfg, tokens[rows].to(d), cache_size, img=shd.rows_to(img, rows, d), mesh=mesh))
        return (shd.cat_ranks([p[0] for p in parts], 0, dev),
                shd.cat_ranks([p[1] for p in parts], 1, dev))
    _no_quantized_hybrid(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    x, positions = _embed_inputs(params, cfg, tokens, img)
    s = tokens.shape[1]

    if cfg.family in ("dense", "moe", "vlm"):
        size = cache_size if cfg.sliding_window is None \
            else min(cache_size, cfg.sliding_window)
        kvs = []
        for pl in params.blocks:
            x, (k, v) = _dense_block_fwd(pl, cfg, x, positions, mesh, return_kv=True)
            kvs.append(_kv_to_cache(cfg, k.to(cdt), v.to(cdt), size))
        caches = {"kv": _stack(kvs), "len": s, "offset": 0}
    elif cfg.family == "ssm":
        states = []
        for pl in params.blocks:
            x, st = rwkv_mod.rwkv_block_forward(pl, cfg, x)
            states.append(st)
        caches = {"rwkv": _stack(states), "len": s}
    elif cfg.family == "hybrid":
        mamba, kvs = [], []
        for group in hybrid_groups(cfg):
            for i in group:
                h = apply_norm(params.blocks_norm[i], x, cfg.norm)
                out, st = ssm_mod.mamba2_forward(params.blocks[i], cfg, h, return_state=True)
                x = x + out
                mamba.append(st)
            x, (k, v) = _shared_block(params, cfg, x, positions, return_kv=True)
            kvs.append(_kv_to_cache(cfg, k.to(cdt), v.to(cdt), cache_size))
        caches = {"mamba": _stack(mamba), "kv": _stack(kvs), "len": s, "offset": 0}
    else:
        raise ValueError(cfg.family)

    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x), caches


# ---------------------------------------------------------------------------
# decode (one token, stacked caches)
# ---------------------------------------------------------------------------

def _stacked(one: dict, n: int) -> dict:
    return {key: torch.zeros((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
            for key, t in one.items()}


def init_caches(cfg, batch: int, seq: int, device):
    """Stacked per-layer decode caches (zeros) for the given cache length."""
    _no_quantized_hybrid(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    l = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm"):
        one = attn.init_kv_cache(cfg, batch, seq, cdt, device)
        kv = _stacked({k: v for k, v in one.items() if k not in ("len", "offset")}, l)
        return {"kv": kv, "len": 0, "offset": 0}
    if cfg.family == "ssm":
        return {"rwkv": _stacked(rwkv_mod.init_rwkv_state(cfg, batch, cdt, device), l),
                "len": 0}
    if cfg.family == "hybrid":
        one = attn.init_kv_cache(cfg, batch, seq, cdt, device)
        return {"mamba": _stacked(ssm_mod.init_mamba2_state(cfg, batch, cdt, device), l),
                "kv": _stacked({k: one[k] for k in ("k", "v")}, len(hybrid_groups(cfg))),
                "len": 0, "offset": 0}
    raise ValueError(cfg.family)


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i``'s views into stacked caches (writes land in the stack)."""
    return {key: t[i] for key, t in stacked.items()}


def _write(stacked: dict, i: int, new: dict) -> None:
    for key, t in stacked.items():
        t[i].copy_(new[key])


def cached_attention(p, cfg, h, kv: dict, i: int, caches: dict):
    """One-token self-attention of layer ``i`` against its slice of the
    stacked K/V cache ``kv``, at ``caches``' ``len``/``offset``; writes the
    new K/V into ``kv`` in place."""
    cache = _layer(kv, i)
    cache.update(len=caches["len"], offset=caches["offset"])
    out, _ = attn.attention_decode(p, cfg, h, cache)
    return out


# one block of each kind at one decode step (the dry run traces these)

def dense_decode_block(pl, cfg, x, kv, i: int, caches: dict, mesh=None):
    h = apply_norm(pl.ln1, x, cfg.norm)
    x = x + cached_attention(pl.attn, cfg, h, kv, i, caches)
    return x + _ffn(pl, cfg, apply_norm(pl.ln2, x, cfg.norm), mesh)


def rwkv_decode_block(pl, cfg, x, st: dict, i: int):
    x, ns = rwkv_mod.rwkv_block_forward(pl, cfg, x, state=_layer(st, i))
    _write(st, i, ns)
    return x


def mamba_decode_block(pl, norm, cfg, x, mamba: dict, i: int):
    out, ns = ssm_mod.mamba2_decode(pl, cfg, apply_norm(norm, x, cfg.norm), _layer(mamba, i))
    _write(mamba, i, ns)
    return x + out


def shared_decode_block(params, cfg, x, kv, g: int, caches: dict):
    shared = params.shared
    h = apply_norm(params.shared_norm, x, cfg.norm)
    x = x + cached_attention(shared.attn, cfg, h, kv, g, caches)
    return x + apply_mlp(shared.mlp, apply_norm(shared.ln2, x, cfg.norm), cfg.act)


@torch.no_grad()
def decode_step(params: LM, cfg, tokens, caches, *, mesh=None):
    """tokens (B, 1) -> (logits (B, 1, V), caches advanced by one token,
    updated in place)."""
    if shd.is_sharded(params, mesh):
        return sharded_decode(params, mesh, tokens, caches, lambda v, t, c: decode_step(
            v, cfg, t, c, mesh=mesh))
    cdt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params.embed, tokens, cdt)

    if cfg.family in ("dense", "moe", "vlm"):
        kv = caches["kv"]
        for i, pl in enumerate(params.blocks):
            x = dense_decode_block(pl, cfg, x, kv, i, caches, mesh)
        new = {"kv": kv, "len": caches["len"] + 1, "offset": caches["offset"]}
    elif cfg.family == "ssm":
        st = caches["rwkv"]
        for i, pl in enumerate(params.blocks):
            x = rwkv_decode_block(pl, cfg, x, st, i)
        new = {"rwkv": st, "len": caches["len"] + 1}
    elif cfg.family == "hybrid":
        mamba, kv = caches["mamba"], caches["kv"]
        for g, group in enumerate(hybrid_groups(cfg)):
            for i in group:
                x = mamba_decode_block(params.blocks[i], params.blocks_norm[i], cfg, x,
                                       mamba, i)
            x = shared_decode_block(params, cfg, x, kv, g, caches)
        new = {"mamba": mamba, "kv": kv, "len": caches["len"] + 1,
               "offset": caches["offset"]}
    else:
        raise ValueError(cfg.family)

    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x), new


def sharded_decode(params, mesh, tokens, caches, step):
    """One decode ``step(view, tokens, caches)`` over the data ranks: each
    rank's rows of the stacked caches (batch on dim 1) advanced on its
    device, in place; the logits joined on the first rank's device."""
    def one(view, rows, dev):
        mine, back = shd.cache_rows(caches, rows, dev)
        logits, _ = step(view, tokens[rows].to(dev), mine)
        shd.write_back(back, rows)
        return logits

    dev = shd.rank_device(mesh, 0)
    logits = shd.cat_ranks(shd.on_ranks(params, mesh, tokens.shape[0], one), 0, dev)
    return logits, {**caches, "len": caches["len"] + 1}
