"""musicgen-large — decoder-only over EnCodec tokens (4 codebooks).

[arXiv:2306.05284; hf]  48L d_model=2048 32H (GQA kv=32 -> MHA)
d_ff=8192 vocab=2048.  The EnCodec frontend is a STUB: ``input_specs``
supplies codebook token ids; embeddings of the K=4 streams are summed and
K untied heads predict the next frame (delay pattern handled upstream).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=("attn",),
    num_codebooks=4,
    mlp_act="gelu",
    mlp_variant="plain",
    tie_embeddings=False,
    rope_theta=10_000.0,
)
