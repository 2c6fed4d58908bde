"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port of ``repro.models.encdec``. Frame embeddings (B, S_enc, d_model)
arrive precomputed in place of the mel-spectrogram conv stem. Encoder:
bidirectional attention. Decoder: causal self-attention + cross-attention
to the encoder memory, LayerNorm + GELU as in Whisper.

Serve path: ``encode`` runs once; ``precompute_cross_kv`` projects the
memory into per-layer cross K/V; ``decode_step`` runs the decoder layers
against a self-attention KV cache, written in place as in
``transformer.decode_step``. Over a mesh, ``forward`` and ``decode_step``
split the batch rows over the data ranks as ``transformer``'s do.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.dist import sharding as shd
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embed, Norm, apply_mlp, apply_norm, dtype_of,
                                       embed_specs, embed_tokens, lm_logits, mlp_specs,
                                       norm_specs)
from repro_torch.models.transformer import cached_attention, remat, sharded_decode, stack_specs


class EncBlock(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.attn = attn.Attention(cfg, gen, dtype, device)
        self.mlp = MLP(cfg, gen, dtype, device)
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)


class DecBlock(EncBlock):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__(cfg, gen, dtype, device)
        self.cross = attn.Attention(cfg, gen, dtype, device, cross=True)
        self.ln_cross = Norm(cfg, dtype, device)


class EncDec(nn.Module):
    """``embed``, ``enc_norm``, ``final_norm``, ``enc_blocks.N.*`` and
    ``dec_blocks.N.*`` (with ``cross`` and ``ln_cross``)."""

    def __init__(self, cfg, gen: torch.Generator, device):
        super().__init__()
        dtype = dtype_of(cfg.param_dtype)
        self.embed = Embed(cfg, gen, dtype, device)
        self.enc_norm = Norm(cfg, dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        self.enc_blocks = nn.ModuleList(EncBlock(cfg, gen, dtype, device)
                                        for _ in range(cfg.enc_layers))
        self.dec_blocks = nn.ModuleList(DecBlock(cfg, gen, dtype, device)
                                        for _ in range(cfg.dec_layers))


def init_encdec(cfg, gen: torch.Generator, device) -> EncDec:
    return EncDec(cfg, gen, device)


def encdec_specs(cfg) -> dict:
    """The JAX ``init_encdec``'s logical spec tree (layers stacked first)."""
    enc = {"attn": attn.attention_specs(cfg), "mlp": mlp_specs(cfg), "ln1": norm_specs(cfg),
           "ln2": norm_specs(cfg)}
    dec = {**enc, "cross": attn.attention_specs(cfg, cross=True), "ln_cross": norm_specs(cfg)}
    return {"embed": embed_specs(cfg), "enc_norm": norm_specs(cfg),
            "final_norm": norm_specs(cfg), "enc_blocks": stack_specs(enc),
            "dec_blocks": stack_specs(dec)}


def _positions(b: int, s: int, device):
    return torch.arange(s, device=device)[None].expand(b, s)


def _enc_block(pl, cfg, x, positions):
    h = apply_norm(pl.ln1, x, cfg.norm)
    x = x + attn.attention_train(pl.attn, cfg, h, positions, causal=False)
    return x + apply_mlp(pl.mlp, apply_norm(pl.ln2, x, cfg.norm), cfg.act)


def _dec_block(pl, cfg, x, positions, memory):
    h = apply_norm(pl.ln1, x, cfg.norm)
    x = x + attn.attention_train(pl.attn, cfg, h, positions)
    h = apply_norm(pl.ln_cross, x, cfg.norm)
    x = x + attn.attention_train(pl.cross, cfg, h, positions, xkv=memory, causal=False)
    return x + apply_mlp(pl.mlp, apply_norm(pl.ln2, x, cfg.norm), cfg.act)


def encode(params: EncDec, cfg, frames):
    """frames (B, S_enc, d_model) stub embeddings -> encoder memory."""
    x = frames.to(dtype_of(cfg.compute_dtype))
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for pl in params.enc_blocks:
        x = remat(cfg, _enc_block, pl, cfg, x, positions)
    return apply_norm(params.enc_norm, x, cfg.norm)


def forward(params: EncDec, cfg, tokens, frames, *, mesh=None):
    """Teacher-forced forward -> logits (B, S_dec, V)."""
    if shd.is_sharded(params, mesh):
        dev = shd.rank_device(mesh, 0)
        return shd.cat_ranks(shd.on_ranks(params, mesh, tokens.shape[0], lambda v, rows, d: forward(
            v, cfg, tokens[rows].to(d), frames[rows].to(d))), 0, dev)
    memory = encode(params, cfg, frames)
    x = embed_tokens(params.embed, tokens, dtype_of(cfg.compute_dtype))
    b, s = tokens.shape
    positions = _positions(b, s, x.device)
    for pl in params.dec_blocks:
        x = remat(cfg, _dec_block, pl, cfg, x, positions, memory)
    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x)


def init_decode_caches(cfg, batch: int, seq: int, enc_len: int, device):
    cdt = dtype_of(cfg.compute_dtype)
    l = cfg.dec_layers

    def zeros(s):
        return torch.zeros((l, batch, s, cfg.n_kv, cfg.d_head), dtype=cdt, device=device)

    return {"kv": {"k": zeros(seq), "v": zeros(seq)},
            "cross": {"k": zeros(enc_len), "v": zeros(enc_len)},
            "len": 0, "offset": 0, "enc_len": enc_len}


@torch.no_grad()
def precompute_cross_kv(params: EncDec, cfg, memory):
    """Per-decoder-layer K/V of the encoder memory (computed once),
    stacked (L, B, S_enc, nk, dh)."""
    b, s, _ = memory.shape
    ks, vs = [], []
    for pl in params.dec_blocks:
        ks.append((memory @ pl.cross.wk).reshape(b, s, cfg.n_kv, cfg.d_head))
        vs.append((memory @ pl.cross.wv).reshape(b, s, cfg.n_kv, cfg.d_head))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def dec_decode_block(pl, cfg, x, i: int, caches: dict):
    """Decoder layer ``i`` at one decode step (the dry run traces it)."""
    h = apply_norm(pl.ln1, x, cfg.norm)
    x = x + cached_attention(pl.attn, cfg, h, caches["kv"], i, caches)
    cross = caches["cross"]
    ccache = {"k": cross["k"][i], "v": cross["v"][i], "len": caches["enc_len"], "offset": 0}
    h = apply_norm(pl.ln_cross, x, cfg.norm)
    h, _ = attn.attention_decode(pl.cross, cfg, h, ccache, xkv_cache_only=True)
    x = x + h
    return x + apply_mlp(pl.mlp, apply_norm(pl.ln2, x, cfg.norm), cfg.act)


@torch.no_grad()
def decode_step(params: EncDec, cfg, tokens, caches, *, mesh=None):
    """One decoder token against the self KV cache (updated in place) and
    the precomputed cross K/V."""
    if shd.is_sharded(params, mesh):
        return sharded_decode(params, mesh, tokens, caches,
                              lambda v, t, c: decode_step(v, cfg, t, c))
    x = embed_tokens(params.embed, tokens, dtype_of(cfg.compute_dtype))
    for i, pl in enumerate(params.dec_blocks):
        x = dec_decode_block(pl, cfg, x, i, caches)
    new = dict(caches)
    new["len"] = caches["len"] + 1
    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x), new
