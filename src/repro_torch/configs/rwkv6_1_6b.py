"""rwkv6-1.6b — Finch: attention-free, data-dependent decay.

[arXiv:2404.05892; unverified]  24L d_model=2048 d_ff=7168 vocab=65536.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                       # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    tie_embeddings=False,
)
