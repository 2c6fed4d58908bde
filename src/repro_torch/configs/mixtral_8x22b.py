"""mixtral-8x22b: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]. Experts use TP sharding (8 experts do not divide the
16-wide model axis); SWA window 4096 makes long_500k sub-quadratic."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144,
    n_heads=48, n_kv=8, d_head=128, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, moe_sharding="tp", sliding_window=4096,
    norm="rmsnorm", act="silu", rope_theta=1_000_000.0)
