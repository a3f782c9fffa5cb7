"""starcoder2-15b — dense GQA code model.

[arXiv:2402.19173; hf]  40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152; plain (non-GLU) 4x GELU FFN; RoPE.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    block_pattern=("attn",),
    mlp_act="gelu",
    mlp_variant="plain",
    rope_theta=100_000.0,
)
