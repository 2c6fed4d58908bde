"""RWKV6 ("Finch") block: data-dependent per-channel decay linear attention.

The port of ``repro.models.rwkv``. Time-mix recurrence per head
(K = V = rwkv_headdim):

    S_t = diag(w_t) · S_{t-1} + kᵀ_t v_t
    y_t = r_t · (S_{t-1} + diag(u) kᵀ_t v_t)

with w_t = exp(-exp(w0 + lora(x_t))) ∈ (0,1) per channel. The recurrence
runs as a loop over tokens (``_wkv_scan``). With gradients on it runs in
chunks of ``cfg.rwkv_chunk`` tokens, each under ``torch.utils.checkpoint``
as the JAX package's chunks are under ``jax.checkpoint``: the backward pass
keeps one state a chunk and recomputes the rest, which bounds training
memory and leaves the values as they are. Channel-mix is the RWKV
squared-ReLU FFN with token shift.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import dense_init, full


def n_heads_of(cfg) -> int:
    return cfg.d_model // cfg.rwkv_headdim


class RWKVBlock(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        lora = 64
        f32 = torch.float32
        # time-mix
        self.mu = full((5, d), 0.5, dtype, device)             # r,k,v,w,g shift mix
        self.wr = dense_init(gen, (d, d), dtype, device)
        self.wk = dense_init(gen, (d, d), dtype, device)
        self.wv = dense_init(gen, (d, d), dtype, device)
        self.wg = dense_init(gen, (d, d), dtype, device)
        self.wo = dense_init(gen, (d, d), dtype, device)
        self.w0 = full((d,), -2.0, f32, device)                # decay bias
        self.w_lora_a = dense_init(gen, (d, lora), dtype, device)
        self.w_lora_b = dense_init(gen, (lora, d), dtype, device, scale=0.01)
        self.u = full((d,), 0.0, f32, device)                  # bonus
        self.ln_scale = full((d,), 1.0, dtype, device)         # per-head groupnorm
        # channel-mix
        self.mu_c = full((2, d), 0.5, dtype, device)
        self.ck = dense_init(gen, (d, f), dtype, device)
        self.cv = dense_init(gen, (f, d), dtype, device)
        self.cr = dense_init(gen, (d, d), dtype, device)


def rwkv_specs(cfg) -> dict:
    return {"mu": ("none", "embed"), "wr": ("embed", "heads"), "wk": ("embed", "heads"),
            "wv": ("embed", "heads"), "wg": ("embed", "heads"), "wo": ("heads", "embed"),
            "w0": ("embed",), "w_lora_a": ("embed", "none"), "w_lora_b": ("none", "embed"),
            "u": ("embed",), "ln_scale": ("embed",),
            "mu_c": ("none", "embed"), "ck": ("embed", "mlp"), "cv": ("mlp", "embed"),
            "cr": ("embed", "heads")}


def _token_shift(x, prev):
    """prev: (B, 1, d) last token of previous segment (zeros at start)."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _head_groupnorm(y, scale, n_heads, eps=1e-5):
    b, s, d = y.shape
    yh = y.reshape(b, s, n_heads, d // n_heads).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(b, s, d) * scale.float()).to(y.dtype)


def _wkv_scan(r, k, v, w, u, state, chunk: int):
    """The WKV recurrence: one token at a time, and with gradients on in
    checkpointed chunks of ``chunk`` tokens (the last may be shorter).

    r,k,v,w: (B, S, H, K) f32 (w = decay in (0,1)); u (H, K);
    state (B, H, K, K). Returns (y (B,S,H,K), final state).
    """
    s = r.shape[1]
    if not torch.is_grad_enabled() or s <= chunk:
        return _wkv_tokens(r, k, v, w, u, state)
    ys = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        y, state = checkpoint(_wkv_tokens, r[:, sl], k[:, sl], v[:, sl], w[:, sl], u, state,
                              use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _wkv_tokens(r, k, v, w, u, state):
    ys = []
    bonus = u[None, :, :, None]
    for t in range(r.shape[1]):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + bonus * kv))
        state = w[:, t][..., None] * state + kv
    return torch.stack(ys, dim=1), state


def rwkv_block_forward(p: RWKVBlock, cfg, x, state=None):
    """x (B, S, d) -> (B, S, d). ``state`` carries (shift_t, shift_c, wkv)
    across segments; None starts from zeros."""
    b, s, d = x.shape
    h = n_heads_of(cfg)
    kd = cfg.rwkv_headdim
    if state is None:
        state = init_rwkv_state(cfg, b, x.dtype, x.device)

    # ---- time mix ----
    x_in = x
    xs_ = _token_shift(x, state["shift_t"])
    mu = p.mu.to(x.dtype)
    xr, xk, xv, xw, xg = (x + mu[i][None, None] * (xs_ - x) for i in range(5))
    r = (xr @ p.wr).reshape(b, s, h, kd).float()
    k = (xk @ p.wk).reshape(b, s, h, kd).float()
    v = (xv @ p.wv).reshape(b, s, h, kd).float()
    g = F.silu(xg @ p.wg)
    wlog = p.w0[None, None] + (torch.tanh(xw @ p.w_lora_a) @ p.w_lora_b).float()
    w = torch.exp(-torch.exp(torch.clamp(wlog, -8.0, 1.0))).reshape(b, s, h, kd)
    u = p.u.float().reshape(h, kd)
    y, wkv = _wkv_scan(r, k, v, w, u, state["wkv"], cfg.rwkv_chunk)
    y = y.reshape(b, s, d).to(x.dtype)
    y = _head_groupnorm(y, p.ln_scale, h) * g
    x = x + y @ p.wo

    # ---- channel mix ----
    xsc = _token_shift(x, state["shift_c"])
    mu_c = p.mu_c.to(x.dtype)
    xk_c = x + mu_c[0][None, None] * (xsc - x)
    xr_c = x + mu_c[1][None, None] * (xsc - x)
    kc = torch.square(torch.relu(xk_c @ p.ck))
    out_c = torch.sigmoid(xr_c @ p.cr) * (kc @ p.cv)
    new_state = {"shift_t": x_in[:, -1:],   # last token of time-mix input
                 "shift_c": x[:, -1:],      # last token of channel-mix input
                 "wkv": wkv}
    return x + out_c, new_state


def init_rwkv_state(cfg, batch: int, dtype, device):
    h = n_heads_of(cfg)
    kd = cfg.rwkv_headdim
    return {"shift_t": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
            "shift_c": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
            "wkv": torch.zeros((batch, h, kd, kd), dtype=torch.float32, device=device)}
