"""Architecture registry, shape cells and smoke-config reduction.

The port's copy of the JAX package's ``repro.configs``: the same ten
architectures with their published hyperparameters (one file each), the
four LM shape cells, ``cell_applicable`` and ``smoke_config``:

  train_4k     seq=4096   global_batch=256   -> train_step
  prefill_32k  seq=32768  global_batch=32    -> serve prefill
  decode_32k   seq=32768  global_batch=128   -> serve decode (KV cache of S)
  long_500k    seq=524288 global_batch=1     -> decode; sub-quadratic archs only

The JAX package's ``ShapeDtypeStruct`` input specs exist for its multi-pod
dry-run and have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llava-next-34b": "llava_next_34b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-6b": "yi_6b",
    "gemma2-9b": "gemma2_9b",
    "qwen3-0.6b": "qwen3_0_6b",
    "grok-1-314b": "grok_1_314b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "musicgen-large": "musicgen_large",
}


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def list_archs() -> list[str]:
    return list(ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; know {list(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


def cell_applicable(cfg: ModelConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for sub-quadratic archs."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("full attention at 512k context is O(S^2) by "
                       "design — skipped per assignment; see DESIGN.md "
                       "§Arch-applicability")
    return True, ""


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    pat = cfg.block_pattern
    heads = 4
    kv = min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else heads
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=max(2, len(pat)) + (2 if cfg.name.startswith("recurrentgemma") else 0),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=96,
        vocab_size=128,
        window=min(cfg.window, 8),
        rnn_width=64,
        rwkv_head_dim=16,
        num_experts=min(cfg.num_experts, 4) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.is_moe else 0,
        patch_positions=8 if cfg.family == "vlm" else 0,
        num_codebooks=cfg.num_codebooks,
        dtype="float32",
    )
