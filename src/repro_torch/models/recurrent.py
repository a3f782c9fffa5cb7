"""Recurrent temporal-mixing blocks: RG-LRU (Griffin, recurrentgemma) and
RWKV-6 (Finch, rwkv6).

The port of the JAX package's ``repro/models/recurrent.py``, dtype by
dtype: the projections and the causal conv in the model dtype (the conv
summed in the JAX order, ``((t0 + t1) + t2) + t3``), the gates, decays
and recurrences in fp32, and the fp32 leaves (``lam``, ``mu``, ``c_mu``,
``w0``, ``u``) stored fp32 whatever ``cfg.dtype`` is.  The two
recurrences run on hand-written kernels (``ops.rglru_scan``,
``ops.wkv6``), and so do their gradients in training
(``ops.rglru_scan_bwd``, ``ops.wkv6_bwd``, through the kernels'
autograd Functions); on the CPU those are their plain loops over time,
differentiated by autograd.

Both blocks carry O(1) decode state, a dict per layer that
``models/transformer.py`` keeps as the layer's cache and writes in place:

* RG-LRU: ``{"h": (B, R) fp32, "conv": (B, W-1, R)}``, the recurrence's
  last state and the conv's last ``W - 1`` inputs;
* RWKV-6: ``{"x_prev_t": (B, D), "x_prev_c": (B, D), "S": (B, H, hd, hd)
  fp32}``, the last (normed) input of the time and channel mixes and the
  matrix state.

``RWKVBlock`` holds the time mix and the channel mix in one module, as the
JAX package packs both under the layer's ``ffn``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.operator import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import const, normal, param

LORA = 64          # the decay LoRA's rank (``init_rwkv_block``)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

class RGLRUBlock(nn.Module):
    """w_x, w_gate (D, R); conv (W, R); w_a, w_i (R, R); lam (R,) fp32;
    w_out (R, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, R, W = cfg.d_model, cfg.resolved_rnn_width, cfg.conv_width
        dt = getattr(torch, cfg.dtype)
        self.w_x = param((D, R), dt, device)
        self.w_gate = param((D, R), dt, device)
        self.conv = param((W, R), dt, device)
        self.w_a = param((R, R), dt, device)
        self.w_i = param((R, R), dt, device)
        self.lam = param((R,), torch.float32, device)
        self.w_out = param((R, D), dt, device)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        """``init_rglru_block``'s distributions: lam 0.65 puts
        a = exp(-8 softplus(lam) r) near 0.95."""
        si = normal(1 / math.sqrt(cfg.d_model))
        sr = normal(1 / math.sqrt(cfg.resolved_rnn_width))
        return {"w_x": si, "w_gate": si, "conv": normal(0.1), "w_a": sr,
                "w_i": sr, "lam": const(0.65), "w_out": sr}


def apply_rglru_block(p: RGLRUBlock, cfg: ModelConfig, x: torch.Tensor,
                      state: dict | None = None):
    """Griffin's recurrent block on x (B, T, D); returns (y, the new
    state ``{"h", "conv"}``)."""
    B, T, _ = x.shape
    R, W = cfg.resolved_rnn_width, cfg.conv_width
    u = x @ p.w_x
    gate = x @ p.w_gate
    # causal depthwise conv over time (width W), in the model dtype
    prev = state["conv"] if state is not None else u.new_zeros((B, W - 1, R))
    u_pad = torch.cat([prev, u], dim=1)                  # (B, T + W - 1, R)
    conv = u_pad[:, :T] * p.conv[0]
    for i in range(1, W):
        conv = conv + u_pad[:, i:i + T] * p.conv[i]
    new_conv = u_pad[:, T:]                              # last W - 1 inputs

    r = torch.sigmoid((conv @ p.w_a).to(torch.float32))
    i = torch.sigmoid((conv @ p.w_i).to(torch.float32))
    log_a = -8.0 * F.softplus(p.lam) * r                 # (B, T, R) fp32
    a = torch.exp(log_a)
    # sqrt(1 - a^2) from log_a
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * conv.to(torch.float32))

    h0 = state["h"].to(torch.float32) if state is not None else None
    h = ops.rglru_scan(a, b, h0)                         # (B, T, R) fp32
    y = F.gelu(gate.to(torch.float32), approximate="tanh") * h
    y = y.to(x.dtype) @ p.w_out
    return y, {"h": h[:, -1], "conv": new_conv}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    dev = resolve_device(device)
    R, W = cfg.resolved_rnn_width, cfg.conv_width
    return {"h": torch.zeros((batch, R), dtype=torch.float32, device=dev),
            "conv": torch.zeros((batch, W - 1, R),
                                dtype=getattr(torch, cfg.dtype), device=dev)}


# ---------------------------------------------------------------------------
# RWKV-6
# ---------------------------------------------------------------------------

class RWKVBlock(nn.Module):
    """Time mix: w_r, w_k, w_v, w_g, w_o (D, D); mu (5, D) fp32 (token
    shift of r, k, v, g, w); w0 (H, hd) fp32; w_lora_a (D, 64), w_lora_b
    (64, D); u (H, hd) fp32.  Channel mix: c_mu (2, D) fp32; c_k (D, F);
    c_v (F, D); c_r (D, D)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, Fd, hd = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
        H = D // hd
        dt = getattr(torch, cfg.dtype)
        f32 = torch.float32
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, param((D, D), dt, device))
        self.mu = param((5, D), f32, device)
        self.w0 = param((H, hd), f32, device)
        self.w_lora_a = param((D, LORA), dt, device)
        self.w_lora_b = param((LORA, D), dt, device)
        self.u = param((H, hd), f32, device)
        self.c_mu = param((2, D), f32, device)
        self.c_k = param((D, Fd), dt, device)
        self.c_v = param((Fd, D), dt, device)
        self.c_r = param((D, D), dt, device)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        """``init_rwkv_block``'s distributions: decays' base w0 -2, token
        shifts 0.5, bonus u N(0, 0.1^2)."""
        s = normal(1 / math.sqrt(cfg.d_model))
        return {"w_r": s, "w_k": s, "w_v": s, "w_g": s, "w_o": s,
                "mu": const(0.5), "w0": const(-2.0), "w_lora_a": s,
                "w_lora_b": normal(0.1), "u": normal(0.1),
                "c_mu": const(0.5), "c_k": s,
                "c_v": normal(1 / math.sqrt(cfg.d_ff)), "c_r": s}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """x shifted one step along time, ``prev`` (B, D) (zeros) first."""
    if prev is None:
        prev = x.new_zeros((x.shape[0], x.shape[2]))
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def apply_rwkv_time_mix(p: RWKVBlock, cfg: ModelConfig, x: torch.Tensor,
                        state: dict | None = None):
    """RWKV-6 time mix on x (B, T, D); returns (y, ``{"x_prev_t", "S"}``)."""
    B, T, D = x.shape
    hd = cfg.rwkv_head_dim
    H = D // hd
    x_shift = _token_shift(x, state["x_prev_t"] if state is not None
                           else None)

    def mix(i):
        return x + (x_shift - x) * p.mu[i].to(x.dtype)

    xr, xk, xv, xg, xw = (mix(i) for i in range(5))
    r = (xr @ p.w_r).view(B, T, H, hd)
    k = (xk @ p.w_k).view(B, T, H, hd)
    v = (xv @ p.w_v).view(B, T, H, hd)
    g = xg @ p.w_g
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x))), fp32
    dw = (xw @ p.w_lora_a) @ p.w_lora_b
    logw = p.w0[None, None] + dw.view(B, T, H, hd).to(torch.float32)
    w = torch.exp(-torch.exp(logw))

    S0 = state["S"] if state is not None else None
    f32 = torch.float32
    out, S_T = ops.wkv6(r.to(f32), k.to(f32), v.to(f32), w, p.u, S0)
    out = out.reshape(B, T, D) * F.silu(g.to(f32))
    y = out.to(x.dtype) @ p.w_o
    return y, {"x_prev_t": x[:, -1], "S": S_T}


def apply_rwkv_channel_mix(p: RWKVBlock, cfg: ModelConfig, x: torch.Tensor,
                           state: dict | None = None):
    """RWKV channel mix (token-shifted squared-relu FFN) on x (B, T, D);
    returns (y, ``{"x_prev_c"}``)."""
    x_shift = _token_shift(x, state["x_prev_c"] if state is not None
                           else None)
    xk = x + (x_shift - x) * p.c_mu[0].to(x.dtype)
    xr = x + (x_shift - x) * p.c_mu[1].to(x.dtype)
    kk = torch.square(torch.relu(xk @ p.c_k))
    vv = kk @ p.c_v
    rr = torch.sigmoid(xr @ p.c_r)
    return rr * vv, {"x_prev_c": x[:, -1]}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    dev = resolve_device(device)
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    dt = getattr(torch, cfg.dtype)
    return {"x_prev_t": torch.zeros((batch, D), dtype=dt, device=dev),
            "x_prev_c": torch.zeros((batch, D), dtype=dt, device=dev),
            "S": torch.zeros((batch, D // hd, hd, hd), dtype=torch.float32,
                             device=dev)}
