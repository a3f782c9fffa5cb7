"""grok-1-314b — MoE 8 experts top-2.

[hf:xai-org/grok-1; unverified]  64L d_model=6144 48H (GQA kv=8)
d_ff=32768 vocab=131072, 8 experts top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131_072,
    block_pattern=("attn",),
    num_experts=8,
    experts_per_token=2,
    capacity_factor=1.25,
    attn_softcap=30.0,                  # grok uses attn logit capping
    mlp_act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=False,
)
