"""qwen3-4b: dense GQA with qk-norm, head_dim 128 [hf:Qwen/Qwen3 family]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv=8, d_head=128, d_ff=9728, vocab=151936,
    qk_norm=True, norm="rmsnorm", act="silu", rope_theta=1_000_000.0)
