"""stablelm-3b: dense MHA, LayerNorm [hf:stabilityai/stablelm-2 family]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense", n_layers=32, d_model=2560,
    n_heads=32, n_kv=32, d_head=80, d_ff=6912, vocab=50304,
    norm="layernorm", act="silu", rope_theta=10_000.0)
