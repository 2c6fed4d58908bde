"""GQA attention: the chunked online-softmax prefill path and the cached
decode path.

The port of ``repro.models.attention``, in plain torch ops that follow the
JAX math: float32 logits, ``NEG_INF = -1e30`` for masked entries and the
same chunking, so a float32 run agrees with the JAX package to float32
rounding. (``scaled_dot_product_attention`` would change the numerics; a
faster kernel is later work.)

* ``attention_train``: online softmax over KV chunks, so the (S × S) score
  matrix never materializes. With ``sliding_window`` set and S above it,
  each query chunk attends only a KV slice of size (W + chunk): O(S · W).
* ``attention_decode``: one query token against a cache, over cache chunks
  with online softmax; sliding-window caches are ring buffers of size W
  (keys stored post-RoPE at absolute positions). The new K/V slot is
  written into the cache tensors **in place**: the returned cache dict holds
  the same tensors, now updated.
* Cross-attention (whisper decoder) reuses the same chunked machinery
  without the causal mask.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import apply_rope, dense_init, full, rms_norm_vec

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg, gen, dtype, device, *, cross: bool = False):
        super().__init__()
        d, nh, nk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
        self.wq = dense_init(gen, (d, nh * dh), dtype, device)
        self.wk = dense_init(gen, (d, nk * dh), dtype, device)
        self.wv = dense_init(gen, (d, nk * dh), dtype, device)
        self.wo = dense_init(gen, (nh * dh, d), dtype, device)
        if cfg.qkv_bias and not cross:
            self.bq = full((nh * dh,), 0.0, dtype, device)
            self.bk = full((nk * dh,), 0.0, dtype, device)
            self.bv = full((nk * dh,), 0.0, dtype, device)
        if cfg.qk_norm and not cross:
            self.q_norm = full((dh,), 1.0, dtype, device)
            self.k_norm = full((dh,), 1.0, dtype, device)


def attention_specs(cfg, *, cross: bool = False) -> dict:
    s = {"wq": ("embed", "heads"), "wk": ("embed", "kv"),
         "wv": ("embed", "kv"), "wo": ("heads", "embed")}
    if cfg.qkv_bias and not cross:
        s.update(bq=("heads",), bk=("kv",), bv=("kv",))
    if cfg.qk_norm and not cross:
        s.update(q_norm=("none",), k_norm=("none",))
    return s


def _q(p, cfg, xq, positions_q, *, rope: bool):
    b, sq, _ = xq.shape
    q = xq @ p.wq
    bq = getattr(p, "bq", None)
    if bq is not None:
        q = q + bq
    q = q.reshape(b, sq, cfg.n_heads, cfg.d_head)
    q_norm = getattr(p, "q_norm", None)
    if q_norm is not None:
        q = rms_norm_vec(q, q_norm)
    return apply_rope(q, positions_q, cfg.rope_theta) if rope else q


def _qkv(p, cfg, xq, xkv, positions_q, positions_kv, *, rope: bool = True):
    b, skv, _ = xkv.shape
    nk, dh = cfg.n_kv, cfg.d_head
    q = _q(p, cfg, xq, positions_q, rope=rope)
    k = xkv @ p.wk
    v = xkv @ p.wv
    bk = getattr(p, "bk", None)
    if bk is not None:
        k, v = k + bk, v + p.bv
    k = k.reshape(b, skv, nk, dh)
    v = v.reshape(b, skv, nk, dh)
    k_norm = getattr(p, "k_norm", None)
    if k_norm is not None:
        k = rms_norm_vec(k, k_norm)
    if rope:
        k = apply_rope(k, positions_kv, cfg.rope_theta)
    return q, k, v


def _sdp_chunk(qc, kc, vc, mask, scale):
    """One (q-chunk, kv-chunk) online-softmax step.

    qc (B, Cq, nk, g, dh), kc (B, Ck, nk, dh), vc (B, Ck, nk, dh),
    mask (Cq, Ck) bool (True = attend). Returns (scores_max, exp_sum,
    weighted_v) contributions.
    """
    logits = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = torch.amax(logits, dim=-1)                                 # (B,k,g,Cq)
    e = torch.exp(logits - m[..., None])
    e = torch.where(mask, e, 0.0)
    l = torch.sum(e, dim=-1)
    wv = torch.einsum("bkgqs,bskd->bkgqd", e, vc.float())
    return m, l, wv


def _merge(carry, new):
    m0, l0, a0 = carry
    m1, l1, a1 = new
    m = torch.maximum(m0, m1)
    c0 = torch.exp(m0 - m)
    c1 = torch.exp(m1 - m)
    return m, l0 * c0 + l1 * c1, a0 * c0[..., None] + a1 * c1[..., None]


def _init_carry(b, nk, g, cq, dh, device):
    return (torch.full((b, nk, g, cq), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, nk, g, cq), dtype=torch.float32, device=device),
            torch.zeros((b, nk, g, cq, dh), dtype=torch.float32, device=device))


def attention_train(p, cfg, x, positions, *, xkv=None, causal=True,
                    return_kv: bool = False):
    """Full training/prefill attention. x (B, S, d) -> (B, S, d).
    With ``return_kv``, also returns the post-RoPE (k, v) for cache prefill.
    """
    b, s, d = x.shape
    nh, nk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    g = nh // nk
    cq = min(cfg.attn_chunk, s)
    assert s % cq == 0, (s, cq)
    nq = s // cq
    cross = xkv is not None
    kv_src = xkv if cross else x
    skv = kv_src.shape[1]
    pos_kv = positions if not cross else None
    q, k, v = _qkv(p, cfg, x, kv_src, positions, pos_kv, rope=not cross)
    scale = 1.0 / math.sqrt(dh)
    q = q.reshape(b, nq, cq, nk, g, dh)
    dev = x.device
    ar_q = torch.arange(cq, device=dev)

    outs = []
    window = cfg.sliding_window if (causal and not cross) else None
    if window is not None and s > window:
        # --- sub-quadratic sliding-window path: O(S · W) ---
        w = window
        cw = min(w + cq, skv)                          # static KV slice size
        ar_k = torch.arange(cw, device=dev)
        for qi in range(nq):
            start = max(qi * cq - w, 0)
            start = min(start, skv - cw)
            kc, vc = k[:, start:start + cw], v[:, start:start + cw]
            qpos = qi * cq + ar_q
            kpos = start + ar_k
            mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - w)
            _, l, wv = _sdp_chunk(q[:, qi], kc, vc, mask, scale)
            outs.append(wv / torch.clamp(l[..., None], min=1e-30))
    else:
        # --- chunked full/causal attention (online softmax over KV) ---
        ck = cq if not cross else min(cfg.attn_chunk, skv)
        nkc = skv // ck
        ar_k = torch.arange(ck, device=dev)
        for qi in range(nq):
            carry = _init_carry(b, nk, g, cq, dh, dev)
            for kj in range(nkc):
                if causal and not cross:
                    if kj * ck > qi * cq + cq - 1:
                        # wholly masked: its merge would leave the carry
                        # exactly as it is (weight exp(-1e30 - m) = 0)
                        break
                    mask = (kj * ck + ar_k)[None, :] <= (qi * cq + ar_q)[:, None]
                else:
                    mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
                new = _sdp_chunk(q[:, qi], k[:, kj * ck:(kj + 1) * ck],
                                 v[:, kj * ck:(kj + 1) * ck], mask, scale)
                carry = _merge(carry, new)
            _, l, acc = carry
            outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1)                     # (B, nq, k, g, Cq, dh)
    out = out.permute(0, 1, 4, 2, 3, 5)                # (B, nq, Cq, k, g, dh)
    out = out.reshape(b, s, nh * dh).to(x.dtype)
    if return_kv:
        return out @ p.wo, (k, v)
    return out @ p.wo


def attention_decode(p, cfg, x, cache, *, xkv_cache_only: bool = False):
    """One-token decode. x (B, 1, d); cache dict with k/v (B, Sc, nk, dh)
    (int8 with ``k_scale``/``v_scale`` (B, Sc, nk) under ``cfg.kv_quant``),
    ``len`` (host int: tokens already in the cache) and ``offset`` (host int:
    absolute position of slot 0). Writes the new token's K/V into the
    cache's tensors in place and returns (out, cache with ``len`` + 1).
    """
    b, _, d = x.shape
    nh, nk, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    g = nh // nk
    k, v = cache["k"], cache["v"]
    sc = k.shape[1]
    quant = "k_scale" in cache
    n = cache["len"]
    if xkv_cache_only:                                 # cross-attn: static memory
        q = _q(p, cfg, x, None, rope=False)
        valid_len = n
    else:
        pos = cache["offset"] + n                      # absolute position
        pos_b = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
        q, k_new, v_new = _qkv(p, cfg, x, x, pos_b, pos_b)
        # ring buffer for a sliding window; otherwise the next slot, clamped
        # to the last one as JAX's dynamic_update_slice clamps it
        slot = n % sc if cfg.sliding_window is not None else min(n, sc - 1)
        if quant:
            qk, sk = quantize_kv(k_new)                # (b,1,nk,dh)/(b,1,nk)
            qv, sv = quantize_kv(v_new)
            k[:, slot] = qk[:, 0]
            v[:, slot] = qv[:, 0]
            cache["k_scale"][:, slot] = sk[:, 0]
            cache["v_scale"][:, slot] = sv[:, 0]
        else:
            k[:, slot] = k_new[:, 0].to(k.dtype)
            v[:, slot] = v_new[:, 0].to(v.dtype)
        valid_len = min(n + 1, sc)

    scale = 1.0 / math.sqrt(dh)
    q1 = q.reshape(b, 1, nk, g, dh)                    # Cq = 1
    # big caches in a single pass (the JAX code's flash-decoding layout)
    ck = sc if sc >= 16384 else min(4096, sc)
    nck = sc // ck
    carry = _init_carry(b, nk, g, 1, dh, x.device)
    idx = torch.arange(ck, device=x.device)
    for kj in range(nck):
        sl = slice(kj * ck, (kj + 1) * ck)
        if quant:
            kc = dequantize_kv(k[:, sl], cache["k_scale"][:, sl])
            vc = dequantize_kv(v[:, sl], cache["v_scale"][:, sl])
        else:
            kc, vc = k[:, sl], v[:, sl]
        mask = (kj * ck + idx < valid_len)[None, :]
        carry = _merge(carry, _sdp_chunk(q1, kc, vc, mask, scale))
    _, l, acc = carry
    out = acc / torch.clamp(l[..., None], min=1e-30)   # (B, nk, g, 1, dh)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, nh * dh).to(x.dtype)
    new_cache = dict(cache)
    if not xkv_cache_only:
        # ``len`` counts all tokens ever seen (ring slots wrap via len % sc);
        # ``offset`` stays 0: absolute positions are offset + len.
        new_cache["len"] = n + 1
    return out @ p.wo, new_cache


def init_kv_cache(cfg, batch: int, seq: int, dtype, device):
    """Cache sized ``seq`` (sliding-window archs: min(seq, W) ring).

    With ``cfg.kv_quant`` the K/V payload is int8 with per-(token, head)
    absmax scales in bfloat16 (KIVI-style, per-token post-RoPE).
    """
    size = seq if cfg.sliding_window is None else min(seq, cfg.sliding_window)
    shape = (batch, size, cfg.n_kv, cfg.d_head)
    cache = {"len": 0, "offset": 0}
    if cfg.kv_quant:
        cache.update(k=torch.zeros(shape, dtype=torch.int8, device=device),
                     v=torch.zeros(shape, dtype=torch.int8, device=device),
                     k_scale=torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
                     v_scale=torch.zeros(shape[:3], dtype=torch.bfloat16, device=device))
    else:
        cache.update(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))
    return cache


def quantize_kv(x):
    """(… , dh) -> int8 payload + per-(…) absmax scale (bfloat16)."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def dequantize_kv(q, scale):
    return q.float() * scale.float()[..., None]
