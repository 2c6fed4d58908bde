"""whisper-base: enc-dec audio backbone; conv frontend STUBBED — frame
embeddings arrive precomputed [arXiv:2212.04356]. Vocab padded 51865 ->
51872 for 16-way TP divisibility."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec", n_layers=6, enc_layers=6,
    dec_layers=6, d_model=512, n_heads=8, n_kv=8, d_head=64, d_ff=2048,
    vocab=51872, norm="layernorm", act="gelu", tie_embeddings=True,
    frontend="audio_stub")
