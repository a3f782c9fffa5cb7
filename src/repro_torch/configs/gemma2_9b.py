"""gemma2-9b — local/global alternating attention with logit softcaps.

[arXiv:2408.00118; hf]  42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000; window 4096; attn softcap 50, final softcap 30; GeGLU;
sandwich (pre+post) norms; head_dim 256.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256_000,
    block_pattern=("local", "attn"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_block_norm=True,
    mlp_act="gelu",
    rope_theta=10_000.0,
)
