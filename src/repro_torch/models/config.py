"""Architecture configuration dataclass shared by all model families."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int | None = None           # default d_model // n_heads

    # attention details
    qk_norm: bool = False               # qwen3
    qkv_bias: bool = False              # qwen1.5
    sliding_window: int | None = None   # mixtral
    rope_theta: float = 10_000.0
    attn_chunk: int = 512               # q-chunk for flash-style attention

    # norms / activation
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    act: Literal["silu", "gelu"] = "silu"

    # MoE
    n_experts: int = 0
    top_k: int = 2
    moe_sharding: Literal["tp", "ep"] = "tp"
    capacity_factor: float = 1.25

    # SSM (mamba2) / hybrid
    ssm_state: int = 64
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    attn_every: int = 0                 # zamba2: shared attn block cadence
    ssm_chunk: int = 128                # SSD chunk length

    # RWKV6
    rwkv_headdim: int = 64
    rwkv_chunk: int = 64                # remat-scan chunk

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stubs
    frontend: Literal["none", "audio_stub", "vision_stub"] = "none"
    n_patches: int = 576                # vision stub: patch embeddings prepended

    # dtypes / training / serving
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    kv_quant: bool = False      # int8 KV cache (per-token-per-head absmax)
    tie_embeddings: bool = False
    remat: Literal["none", "block", "full"] = "block"
    max_seq: int = 524_288

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can this arch run the long_500k shape? (see DESIGN.md)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for 6·N·D."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        nh, nk, dh = self.n_heads, self.n_kv, self.d_head
        attn = d * (nh * dh) + 2 * d * (nk * dh) + (nh * dh) * d
        mlp_dense = 3 * d * f if self.act == "silu" else 2 * d * f
        if self.family == "moe":
            mlp = self.n_experts * mlp_dense
        else:
            mlp = mlp_dense
        if self.family == "ssm":                      # rwkv6
            blk = 2 * d * d * 2 + 2 * d * f           # timemix + channelmix approx
            return v * d * 2 + self.n_layers * blk
        if self.family == "hybrid":                   # zamba2
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            return v * d * 2 + self.n_layers * (mamba + mlp_dense // 3)
        n = v * d * (1 if self.tie_embeddings else 2)
        layers = self.enc_layers + self.dec_layers if self.family == "encdec" \
            else self.n_layers
        cross = attn if self.family == "encdec" else 0
        return n + layers * (attn + mlp + cross)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.act == "silu" else 2) * d * f
        full = self.param_count()
        mlp_all = self.n_layers * self.n_experts * per_expert
        mlp_act = self.n_layers * self.top_k * per_expert
        return full - mlp_all + mlp_act
