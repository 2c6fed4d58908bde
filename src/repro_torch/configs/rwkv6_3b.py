"""rwkv6-3b ("Finch"): attention-free, data-dependent decay linear RNN
[arXiv:2404.05892]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
    n_heads=40, n_kv=40, d_head=64, d_ff=8960, vocab=65536,
    rwkv_headdim=64, norm="layernorm", act="silu")
