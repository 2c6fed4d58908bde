"""qwen1.5-32b: dense MHA with QKV bias [hf:Qwen/Qwen1.5 family]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv=40, d_head=128, d_ff=27392, vocab=152064,
    qkv_bias=True, norm="rmsnorm", act="silu", rope_theta=1_000_000.0)
