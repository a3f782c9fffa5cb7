"""FFN blocks: the dense gated-linear-unit MLP (SwiGLU/GeGLU), the plain
two-matrix MLP, and the capacity-based MoE.

The port of the JAX package's ``repro/models/mlp.py``.  ``jax.nn.gelu``
defaults to the tanh approximation, so GeGLU here is
``F.gelu(..., approximate="tanh")``.

The MoE is the JAX package's single-device body (``_moe_local``, which
``apply_moe`` runs when there is no mesh): the standard dropped-token
capacity dispatch (GShard/Switch lineage).  A router in fp32 picks each
token's top-k experts (gates renormalised; the Switch load-balance loss
from the first choice), each (token, choice) takes the next free slot
of its expert by a token-major count, slots past the capacity ``C`` are
dropped, the kept tokens are scattered into (E, C, D), the experts run
as batched GEMMs (``torch.bmm``: the JAX package computes them with
``einsum``, outside any Pallas kernel), and each token gathers its k
results back, weighted by its gates.  ``C`` comes from the call's own
token count, so a decode step has its own, as in the JAX package.

In a sharded model (``core/parallel.py``) the dense MLP is
column-parallel in ``w_gate``/``w_in`` and row-parallel in ``w_out`` over
``model`` where ``d_ff`` divides (else whole on every model rank), its
weights FSDP-gathered over ``data``.  The MoE is the JAX package's
per-shard body ``_moe_local`` (``mlp.py:102-165`` there): the router fp32
and whole, ``C`` and the slots from the rank's own tokens, the experts
``(E, D/data, F/tp)`` gathered over ``data``, the partial output summed
over ``model`` and then gathered over ``data`` along ``D`` (``w_out``
keeps its ``D/data`` shard), exactly as there; the aux loss is meaned
over the batch axes by the loss.  Where tokens drop this differs from
the one-process MoE by design.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding
from repro_torch.core import parallel
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal, param, weight


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

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        si = normal(1 / math.sqrt(cfg.d_model))
        return {"w_in": si, "w_gate": si,
                "w_out": normal(1 / math.sqrt(cfg.d_ff))}

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"w_in": ("embed_p", "mlp"), "w_gate": ("embed_p", "mlp"),
                "w_out": ("mlp", "embed_p")}


class MoE(nn.Module):
    """router (D, E) fp32; w_gate, w_in (E, D, F); w_out (E, F, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
        dt = getattr(torch, cfg.dtype)
        self.router = param((D, E), torch.float32, device)
        self.w_gate = param((E, D, Fd), dt, device)
        self.w_in = param((E, D, Fd), dt, device)
        self.w_out = param((E, Fd, D), dt, device)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        """``init_moe``'s: router and the input experts N(0, 1/D),
        w_out N(0, 1/F)."""
        si = normal(1 / math.sqrt(cfg.d_model))
        return {"router": si, "w_gate": si, "w_in": si,
                "w_out": normal(1 / math.sqrt(cfg.d_ff))}

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"router": ("embed_p", "expert"),
                "w_gate": ("expert", "embed_p", "mlp"),
                "w_in": ("expert", "embed_p", "mlp"),
                "w_out": ("expert", "mlp", "embed_p")}


def init_mlp(cfg: ModelConfig, device=None) -> MLP | MoE:
    """The FFN of an attention or RG-LRU layer: MoE for MoE configs."""
    return MoE(cfg, device) if cfg.is_moe else MLP(cfg, device)


def apply_mlp(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    act = _act(cfg.mlp_act)
    px = parallel.plan_of(p.w_in)
    cols = px.split(cfg.d_ff) if px is not None else None
    if cols is None:
        w_in, w_out = weight(p.w_in), weight(p.w_out)
        w_gate = weight(p.w_gate) if cfg.mlp_variant == "glu" else None
    else:                                # tensor parallel over d_ff
        f0, f1 = cols
        x = px.copy_in(x)
        w_in, w_out = px.fetch(p.w_in, (1, f0, f1)), px.fetch(
            p.w_out, (0, f0, f1))
        w_gate = px.fetch(p.w_gate, (1, f0, f1)) \
            if cfg.mlp_variant == "glu" else None
    if cfg.mlp_variant == "glu":
        h = act(x @ w_gate) * (x @ w_in)
    else:
        h = act(x @ w_in)
    y = h @ w_out
    return y if cols is None else px.reduce_out(y)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert has for a call of ``tokens`` tokens."""
    return max(8, int(math.ceil(tokens * cfg.experts_per_token
                                / cfg.num_experts * cfg.capacity_factor)))


def moe_route(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> dict:
    """The router and the capacity dispatch of x (B, S, D): ``gates``
    (T, k) fp32 renormalised, ``experts`` (T, k), ``aux`` (the Switch
    loss), ``C``, and per (token, choice) in token-major order ``keep``
    (T k,) and ``slot`` (T k,) into the flat (E C) buffer."""
    E, k = cfg.num_experts, cfg.experts_per_token
    T = x.shape[0] * x.shape[1]
    logits = x.reshape(T, -1).to(torch.float32) @ weight(p.router)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)               # (T, k)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch): E * sum_e f_e * p_e
    ce = F.one_hot(experts[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(probs.mean(dim=0) * ce)

    C = capacity(cfg, T)
    flat = experts.reshape(T * k)
    onehot = F.one_hot(flat, E).to(torch.int32)                 # (T k, E)
    before = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    pos = (before * onehot).sum(dim=-1)                         # (T k,)
    keep = pos < C
    slot = flat * C + torch.clamp(pos, max=C - 1)
    return {"gates": gates, "experts": experts, "aux": aux, "C": C,
            "keep": keep, "slot": slot}


def apply_moe(p: MoE, cfg: ModelConfig, x: torch.Tensor):
    """The MoE FFN on x (B, S, D); returns (y (B, S, D), aux).  The
    scatter adds ``where(keep, x, 0)`` (``index_add_``): a dropped token
    shares its clamped slot with a kept one, and adding zeros leaves the
    kept value exact in any order, where an indexed assignment would
    depend on which write lands last."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    px = parallel.plan_of(p.w_gate)
    if px is None:
        w_gate, w_in, w_out = p.w_gate, p.w_in, p.w_out
    else:                                # ``_moe_local`` on this rank
        cols = px.split(cfg.d_ff)
        if cols is None:
            raise ValueError(f"{cfg.name}: the sharded MoE needs d_ff "
                             f"{cfg.d_ff} to divide over model={px.tp}")
        w_gate = px.fetch(p.w_gate, (2, *cols))
        w_in = px.fetch(p.w_in, (2, *cols))
        w_out = px.fetch(p.w_out, (1, *cols), fsdp=False)
    rt = moe_route(p, cfg, x)
    C, keep, slot = rt["C"], rt["keep"], rt["slot"]
    xe = x if px is None else px.copy_in(x)
    xk = xe.reshape(B * S, D).repeat_interleave(k, dim=0)       # (T k, D)
    buf = x.new_zeros((E * C, D)).index_add_(
        0, slot, torch.where(keep[:, None], xk, 0)).view(E, C, D)
    h = _act(cfg.mlp_act)(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_in)
    y = torch.bmm(h, w_out)                                     # (E, C, D)
    if px is not None:
        # partial over the rank's F: summed over model; w_out kept its
        # D/data shard, so each rank's D slice is gathered over data
        y = px.reduce_out(y)
        axes = sharding.dim_axes(p.w_out.spec, 2)
        y = parallel.gather(y, px.group(axes), 2, px.label(axes))
    out = y.reshape(E * C, D)[slot] * (keep[:, None]
                                    * rt["gates"].reshape(B * S * k, 1))
    out = out.view(B * S, k, D).sum(dim=1)
    return out.view(B, S, D).to(x.dtype), rt["aux"]
