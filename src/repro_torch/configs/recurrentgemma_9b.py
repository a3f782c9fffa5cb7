"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 2:1.

[arXiv:2402.19427; unverified]  38L d_model=4096 16H (GQA kv=1 -> MQA)
d_ff=12288 vocab=256000, window 2048, rnn width 4096.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,                      # 12 full (rglru,rglru,local) groups + 2 tail
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    rnn_width=4096,
    conv_width=4,
    mlp_act="gelu",
    rope_theta=10_000.0,
)
