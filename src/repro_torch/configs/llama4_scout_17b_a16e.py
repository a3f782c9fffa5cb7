"""llama4-scout-17b-a16e — MoE 16 experts top-1 (early-fusion backbone).

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]  48L d_model=5120
40H (GQA kv=8) d_ff=8192 vocab=202048, 16 experts top-1.
Text backbone only (the early-fusion modality encoder is out of scope
per the assignment; token inputs).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    block_pattern=("attn",),
    num_experts=16,
    experts_per_token=1,
    capacity_factor=1.5,
    mlp_act="silu",
    rope_theta=500_000.0,
)
