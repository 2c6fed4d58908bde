"""Mamba2 (SSD) block: the chunked, matmul-dominant prefill and the O(1)
recurrent decode step.

The port of ``repro.models.ssm``. The SSD algorithm (Dao & Gu, 2024)
splits the sequence into chunks of ``cfg.ssm_chunk``: within a chunk the
recurrence is a masked (decay-weighted) attention-like product; across
chunks a short scan carries the (H, N, P) state. Decode updates the
(B, H, N, P) state one token at a time. As in the JAX package: a single
B/C group (G=1) and a causal depthwise conv of width ``ssm_conv``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import dense_init, full, param


def d_inner_of(cfg) -> int:
    return cfg.ssm_expand * cfg.d_model


def n_heads_of(cfg) -> int:
    return d_inner_of(cfg) // cfg.ssm_headdim


class Mamba2(nn.Module):
    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        din = d_inner_of(cfg)
        h = n_heads_of(cfg)
        n = cfg.ssm_state
        f32 = torch.float32
        # in_proj packs [z, x, B, C, dt]
        self.in_proj = dense_init(gen, (d, 2 * din + 2 * n + h), dtype, device)
        self.conv_w = dense_init(gen, (cfg.ssm_conv, din + 2 * n), dtype, device, scale=0.5)
        self.A_log = param(torch.log(torch.arange(1, h + 1, dtype=f32, device=device)))
        self.D = full((h,), 1.0, f32, device)
        self.dt_bias = full((h,), 0.0, f32, device)
        self.norm_scale = full((din,), 1.0, dtype, device)
        self.out_proj = dense_init(gen, (din, d), dtype, device)


def mamba2_specs(cfg) -> dict:
    return {"in_proj": ("embed", "inner"), "conv_w": ("none", "inner"),
            "A_log": ("none",), "D": ("none",), "dt_bias": ("none",),
            "norm_scale": ("inner",), "out_proj": ("inner", "embed")}


def _split_proj(cfg, zxbcdt):
    din = d_inner_of(cfg)
    n = cfg.ssm_state
    h = n_heads_of(cfg)
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:2 * din + 2 * n]
    dt = zxbcdt[..., 2 * din + 2 * n:2 * din + 2 * n + h]
    return z, xbc, dt


def _causal_conv(x, w):
    """Depthwise causal conv. x (B, S, C), w (K, C)."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None] for i in range(k))
    return F.silu(out)


def _gated_rmsnorm(x, z, scale, eps=1e-5):
    x = x * F.silu(z)
    xf = x.float()
    inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * inv * scale.float()).to(x.dtype)


def _segsum(dA):
    """Stable 'segment sum' matrix: out[..., i, j] = Σ_{j<t<=i} dA[..., t],
    -inf above the diagonal. dA (..., Cs)."""
    cs = dA.shape[-1]
    cum = torch.cumsum(dA, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]           # (..., i, j)
    i = torch.arange(cs, device=dA.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -math.inf)


def mamba2_forward(p: Mamba2, cfg, x, *, return_state: bool = False):
    """Training/prefill. x (B, S, d) -> (B, S, d) (+ final decode state)."""
    b, s, d = x.shape
    din = d_inner_of(cfg)
    h = n_heads_of(cfg)
    n = cfg.ssm_state
    ph = cfg.ssm_headdim
    cs = min(cfg.ssm_chunk, s)
    assert s % cs == 0, (s, cs)
    q = s // cs

    zxbcdt = x @ p.in_proj
    z, xbc_raw, dt_raw = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc_raw, p.conv_w)
    xs = xbc[..., :din]
    bmat = xbc[..., din:din + n]                           # (B, S, N)
    cmat = xbc[..., din + n:]
    dt = F.softplus(dt_raw.float() + p.dt_bias)            # (B, S, H)
    a = -torch.exp(p.A_log)                                # (H,)
    da = dt * a[None, None, :]                             # (B, S, H) ≤ 0

    xh = xs.reshape(b, q, cs, h, ph).float()
    dtc = dt.reshape(b, q, cs, h)
    dac = da.reshape(b, q, cs, h)
    bc = bmat.reshape(b, q, cs, n).float()
    cc = cmat.reshape(b, q, cs, n).float()
    xdt = xh * dtc[..., None]                              # input × Δt

    # intra-chunk: y[i] += C_i · ( Σ_{j<=i} exp(Σ_{j<t<=i} dA) B_j x_j dt_j )
    lmat = torch.exp(_segsum(dac.permute(0, 1, 3, 2)))     # (B,Q,H,Cs,Cs)
    scores = torch.einsum("bqin,bqjn->bqij", cc, bc)       # (B,Q,Cs,Cs)
    y_intra = torch.einsum("bqhij,bqij,bqjhp->bqihp", lmat, scores, xdt)

    # chunk summary states: S_q = Σ_j exp(Σ_{j<t<=end} dA) B_j ⊗ (x_j dt_j)
    cum = torch.cumsum(dac, dim=2)                         # (B,Q,Cs,H)
    total = cum[:, :, -1:, :]                              # (B,Q,1,H)
    decay_to_end = torch.exp(total - cum)                  # (B,Q,Cs,H)
    s_chunk = torch.einsum("bqjh,bqjn,bqjhp->bqhnp", decay_to_end, bc, xdt)

    # inter-chunk recurrence over Q chunks
    chunk_decay = torch.exp(total[:, :, 0, :])             # (B,Q,H)
    state = torch.zeros((b, h, n, ph), dtype=torch.float32, device=x.device)
    before = []                                            # state BEFORE each chunk
    for qi in range(q):
        before.append(state)
        state = state * chunk_decay[:, qi][..., None, None] + s_chunk[:, qi]
    states_before = torch.stack(before, dim=1)             # (B,Q,H,N,P)

    # inter-chunk contribution: y[i] += C_i · state_before · exp(cum_i)
    y_inter = torch.einsum("bqin,bqih,bqhnp->bqihp", cc, torch.exp(cum), states_before)

    y = (y_intra + y_inter).reshape(b, s, h, ph)
    y = y + xh.reshape(b, s, h, ph) * p.D[None, None, :, None]
    y = y.reshape(b, s, din).to(x.dtype)
    y = _gated_rmsnorm(y, z, p.norm_scale)
    out = y @ p.out_proj
    if return_state:
        return out, {"ssm": state, "conv": xbc_raw[:, s - (cfg.ssm_conv - 1):, :]}
    return out


def mamba2_decode(p: Mamba2, cfg, x, state):
    """Single-token step. x (B, 1, d); state dict {ssm (B,H,N,P), conv
    (B, K-1, din+2N)} -> (out (B,1,d), new_state)."""
    b = x.shape[0]
    din = d_inner_of(cfg)
    h = n_heads_of(cfg)
    n = cfg.ssm_state
    ph = cfg.ssm_headdim

    zxbcdt = x @ p.in_proj
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    conv_in = torch.cat([state["conv"], xbc], dim=1)       # (B, K, C)
    xbc_t = F.silu(torch.einsum("bkc,kc->bc", conv_in, p.conv_w))[:, None]
    new_conv = conv_in[:, 1:]
    xs = xbc_t[..., :din]
    bmat = xbc_t[..., din:din + n].float()                 # (B,1,N)
    cmat = xbc_t[..., din + n:].float()
    dt = F.softplus(dt_raw[:, 0].float() + p.dt_bias)      # (B,H)
    a = -torch.exp(p.A_log)
    dec = torch.exp(dt * a[None])                          # (B,H)
    xh = xs.reshape(b, h, ph).float()
    upd = torch.einsum("bn,bhp->bhnp", bmat[:, 0], xh * dt[..., None])
    new_ssm = state["ssm"] * dec[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], new_ssm)
    y = y + xh * p.D[None, :, None]
    y = y.reshape(b, 1, din).to(x.dtype)
    y = _gated_rmsnorm(y, z, p.norm_scale)
    return y @ p.out_proj, {"ssm": new_ssm, "conv": new_conv}


def init_mamba2_state(cfg, batch: int, dtype, device):
    return {"ssm": torch.zeros((batch, n_heads_of(cfg), cfg.ssm_state, cfg.ssm_headdim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_inner_of(cfg) + 2 * cfg.ssm_state),
                                dtype=dtype, device=device)}
