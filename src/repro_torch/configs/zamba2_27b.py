"""zamba2-2.7b: Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242] (simplified shared block — see DESIGN.md)."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv=32, d_head=80, d_ff=10240, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    norm="rmsnorm", act="gelu", rope_theta=10_000.0)
