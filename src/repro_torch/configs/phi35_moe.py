"""phi3.5-moe-42b-a6.6b: 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct]. 16 experts / 16-wide model axis = one
expert per rank -> EP sharding with all_to_all dispatch."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_head=128, d_ff=6400, vocab=32064,
    n_experts=16, top_k=2, moe_sharding="ep",
    norm="layernorm", act="gelu", rope_theta=10_000.0)
