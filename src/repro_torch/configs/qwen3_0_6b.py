"""qwen3-0.6b — small dense GQA model with QK-norm.

[hf:Qwen/Qwen3-8B; hf]  28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm; head_dim 128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    num_layers=28,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    block_pattern=("attn",),
    qk_norm=True,
    mlp_act="silu",
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)
