"""FFN block: the dense gated-linear-unit MLP (SwiGLU/GeGLU) or the plain
two-matrix MLP.

The port of the dense half of the JAX package's ``repro/models/mlp.py``.
``jax.nn.gelu`` defaults to the tanh approximation, so GeGLU here is
``F.gelu(..., approximate="tanh")``.  The capacity-based MoE is not
ported yet: ``init_mlp`` raises for a MoE config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import param


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class MLP(nn.Module):
    """w_in (D, F), w_out (F, D) and, for ``glu``, w_gate (D, F)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, Fd = cfg.d_model, cfg.d_ff
        dt = getattr(torch, cfg.dtype)
        self.w_in = param((D, Fd), dt, device)
        self.w_out = param((Fd, D), dt, device)
        if cfg.mlp_variant == "glu":
            self.w_gate = param((D, Fd), dt, device)


def init_mlp(cfg: ModelConfig, device=None) -> MLP:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN is not ported yet (ROADMAP.md, queue "
            f"1, item 13: LM side, MoE)")
    return MLP(cfg, device)


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = _act(cfg.mlp_act)
    if cfg.mlp_variant == "glu":
        h = act(x @ p.w_gate) * (x @ p.w_in)
    else:
        h = act(x @ p.w_in)
    return h @ p.w_out
