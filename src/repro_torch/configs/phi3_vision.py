"""phi-3-vision-4.2b: phi3-mini backbone + CLIP frontend STUB — patch
embeddings replace the first n_patches token positions
[hf:microsoft/Phi-3-vision-128k-instruct]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv=32, d_head=96, d_ff=8192, vocab=32064,
    frontend="vision_stub", n_patches=576,
    norm="rmsnorm", act="silu", rope_theta=10_000.0)
