"""smollm-360m: llama-arch small dense GQA [hf:HuggingFaceTB/SmolLM-360M]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense", n_layers=32, d_model=960,
    n_heads=15, n_kv=5, d_head=64, d_ff=2560, vocab=49152,
    norm="rmsnorm", act="silu", rope_theta=10_000.0)
