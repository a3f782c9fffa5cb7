"""yi-6b — llama-architecture dense GQA model.

[arXiv:2403.04652; hf]  32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000; SwiGLU.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    block_pattern=("attn",),
    mlp_act="silu",
    rope_theta=5_000_000.0,
)
