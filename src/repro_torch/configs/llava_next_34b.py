"""llava-next-34b — VLM backbone (Yi-34B-ish decoder), anyres tiling stub.

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]  60L d_model=7168
56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower is a STUB:
``input_specs`` supplies precomputed patch embeddings (B, P, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,                       # 56 % 16 != 0 -> seq-shard attention
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64_000,
    block_pattern=("attn",),
    patch_positions=576,                # one anyres base tile of embeddings
    rope_theta=5_000_000.0,
)
