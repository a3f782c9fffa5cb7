"""Model configuration covering all assigned architecture families.

One dataclass describes dense / MoE / SSM / hybrid / VLM / audio decoder
LMs; the per-arch files in ``repro_torch.configs`` instantiate it with the
exact published hyperparameters.  A copy of the JAX package's
``ModelConfig`` (every field, the same checks and the same
``param_count``), so the two packages describe one model alike.  The
training-side knobs (``remat_policy``, ``scan_layers``, ``loss_chunks``,
``attn_q_chunks``) are kept for that parity; the port's serving path
reads none of them except ``scan_layers``, which orders the JAX
package's parameter tree (``models/convert.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "local", "rglru", "rwkv"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None     # default d_model // num_heads

    # Per-layer temporal-mixing pattern, cycled across layers, e.g.
    #   ("attn",)                    — every layer global attention
    #   ("local", "attn")            — gemma2 alternation
    #   ("rglru", "rglru", "local")  — recurrentgemma 2:1
    #   ("rwkv",)                    — attention-free
    block_pattern: tuple[str, ...] = ("attn",)
    window: int = 4096              # local-attention window
    attn_softcap: float | None = None
    final_softcap: float | None = None
    qk_norm: bool = False
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU)
    mlp_variant: str = "glu"        # glu | plain (starcoder2/musicgen 4x FFN)
    post_block_norm: bool = False   # gemma2 sandwich norms

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # recurrent widths
    rnn_width: int | None = None    # RG-LRU recurrence width (default d_model)
    conv_width: int = 4             # Griffin temporal conv
    rwkv_head_dim: int = 64

    # modality frontends (stubs: input_specs supplies embeddings)
    num_codebooks: int = 1          # musicgen: 4 parallel EnCodec streams
    patch_positions: int = 0        # llava: image patch-embedding positions

    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logits_dtype: str = "float32"
    dtype: str = "bfloat16"

    # training-side knobs that affect the graph
    remat_policy: str = "minimal"   # none | minimal | full
    scan_layers: bool = True
    loss_chunks: int = 1            # chunk the LM-head + xent over seq
                                    # (bounds fp32 logits memory at big vocab)
    attn_q_chunks: int = 1          # scan attention over query blocks
                                    # (bounds S x T score memory at 32k prefill;
                                    #  the Pallas flash kernel is the TPU fast
                                    #  path, this is the XLA-graph equivalent)

    def __post_init__(self):
        if self.num_heads % max(1, self.num_kv_heads):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.num_experts and not self.experts_per_token:
            raise ValueError("MoE config needs experts_per_token")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def resolved_rnn_width(self) -> int:
        return self.rnn_width or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def blocks(self) -> tuple[str, ...]:
        """The per-layer block kinds, pattern cycled to num_layers."""
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.num_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer does full-sequence attention (long_500k ok)."""
        return "attn" not in self.blocks

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        Dh = self.resolved_head_dim
        H, Hkv = self.num_heads, self.num_kv_heads
        total = V * D * self.num_codebooks
        if not self.tie_embeddings:
            total += V * D * self.num_codebooks
        for kind in self.blocks:
            if kind in ("attn", "local"):
                total += D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
            elif kind == "rglru":
                R = self.resolved_rnn_width
                total += 2 * D * R + R * D + self.conv_width * R + 4 * R
            elif kind == "rwkv":
                total += 4 * D * D + 6 * D  # r,k,v,o + decays/bonus (approx)
            n_mats = 3 if self.mlp_variant == "glu" else 2
            if kind == "rwkv":
                total += 2 * D * int(3.5 * D)  # channel-mix
            elif self.is_moe:
                total += (self.num_experts * n_mats * D * F
                          + D * self.num_experts)
            else:
                total += n_mats * D * F
            total += 2 * D  # norms
        return total

    def active_param_count(self) -> int:
        """Per-token active params (= param_count for dense)."""
        if not self.is_moe:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_variant == "glu" else 2
        dense_like = self.param_count()
        moe_layers = sum(1 for k in self.blocks if k in ("attn", "local"))
        inactive = (self.num_experts - self.experts_per_token) * n_mats * D * F
        return dense_like - moe_layers * inactive
