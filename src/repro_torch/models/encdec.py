"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port of ``repro.models.encdec``. Frame embeddings (B, S_enc, d_model)
arrive precomputed in place of the mel-spectrogram conv stem. Encoder:
bidirectional attention. Decoder: causal self-attention + cross-attention
to the encoder memory, LayerNorm + GELU as in Whisper.

Serve path: ``encode`` runs once; ``precompute_cross_kv`` projects the
memory into per-layer cross K/V; ``decode_step`` runs the decoder layers
against a self-attention KV cache, written in place as in
``transformer.decode_step``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embed, Norm, apply_mlp, apply_norm, dtype_of,
                                       embed_tokens, lm_logits)
from repro_torch.models.transformer import cached_attention, remat


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


def forward(params: EncDec, cfg, tokens, frames):
    """Teacher-forced forward -> logits (B, S_dec, V)."""
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


@torch.no_grad()
def decode_step(params: EncDec, cfg, tokens, caches):
    """One decoder token against the self KV cache (updated in place) and
    the precomputed cross K/V."""
    x = embed_tokens(params.embed, tokens, dtype_of(cfg.compute_dtype))
    kv, cross = caches["kv"], caches["cross"]
    for i, pl in enumerate(params.dec_blocks):
        h = apply_norm(pl.ln1, x, cfg.norm)
        x = x + cached_attention(pl.attn, cfg, h, kv, i, caches)
        ccache = {"k": cross["k"][i], "v": cross["v"][i], "len": caches["enc_len"],
                  "offset": 0}
        h = apply_norm(pl.ln_cross, x, cfg.norm)
        h, _ = attn.attention_decode(pl.cross, cfg, h, ccache, xkv_cache_only=True)
        x = x + h
        x = x + apply_mlp(pl.mlp, apply_norm(pl.ln2, x, cfg.norm), cfg.act)
    new = dict(caches)
    new["len"] = caches["len"] + 1
    x = apply_norm(params.final_norm, x, cfg.norm)
    return lm_logits(params.embed, x), new
