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

In a sharded model (``core/parallel.py``) both blocks shard their
``"rnn"`` width over ``model`` where it divides (RWKV-6: into whole
heads), and otherwise run whole on every model rank; ``rglru_scan``,
``wkv6`` and their backward kernels run on the rank's channels and
heads.  RG-LRU's ``w_a``/``w_i`` are ``("rnn", None)``: the rank's rows
give a partial product over all channels, summed over ``model`` with the
rank keeping its own channels (``scatter_model``).  RWKV-6's decay LoRA
runs whole up to its rank-64 hidden, which enters the rank's columns of
``w_lora_b`` by ``copy_in``; the channel mix is tensor parallel over
``d_ff`` (``c_k``/``c_v``) and its receptance gathered over ``model``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import parallel
from repro_torch.core.operator import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import const, normal, param, weight

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

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"w_x": ("embed_p", "rnn"), "w_gate": ("embed_p", "rnn"),
                "conv": (None, "rnn"), "w_a": ("rnn", None),
                "w_i": ("rnn", None), "lam": ("rnn",),
                "w_out": ("rnn", "embed_p")}


def apply_rglru_block(p: RGLRUBlock, cfg: ModelConfig, x: torch.Tensor,
                      state: dict | None = None):
    """Griffin's recurrent block on x (B, T, D); returns (y, the new
    state ``{"h", "conv"}``)."""
    B, T, _ = x.shape
    R, W = cfg.resolved_rnn_width, cfg.conv_width
    px = parallel.plan_of(p.w_x)
    chans = px.split(R) if px is not None else None
    if chans is None:
        w_x, w_gate, conv_w, w_a, w_i, lam, w_out = (weight(t) for t in (
            p.w_x, p.w_gate, p.conv, p.w_a, p.w_i, p.lam, p.w_out))
    else:                               # the rank's channels [c0, c1)
        c0, c1 = chans
        R = c1 - c0
        x = px.copy_in(x)
        w_x, w_gate, conv_w = (px.fetch(t, (1, c0, c1))
                               for t in (p.w_x, p.w_gate, p.conv))
        w_a, w_i, lam, w_out = (px.fetch(t, (0, c0, c1))
                                for t in (p.w_a, p.w_i, p.lam, p.w_out))
    u = x @ w_x
    gate = x @ w_gate
    # causal depthwise conv over time (width W), in the model dtype
    prev = state["conv"] if state is not None else u.new_zeros((B, W - 1, R))
    u_pad = torch.cat([prev, u], dim=1)                  # (B, T + W - 1, R)
    conv = u_pad[:, :T] * conv_w[0]
    for i in range(1, W):
        conv = conv + u_pad[:, i:i + T] * conv_w[i]
    new_conv = u_pad[:, T:]                              # last W - 1 inputs

    za, zi = conv @ w_a, conv @ w_i
    if chans is not None:               # partial over the rank's rows
        za, zi = px.scatter_model(torch.stack([za, zi]), -1)
    r = torch.sigmoid(za.to(torch.float32))
    i = torch.sigmoid(zi.to(torch.float32))
    log_a = -8.0 * F.softplus(lam) * r                   # (B, T, R) fp32
    a = torch.exp(log_a)
    # sqrt(1 - a^2) from log_a
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * conv.to(torch.float32))

    h0 = state["h"].to(torch.float32) if state is not None else None
    h = ops.rglru_scan(a, b, h0)                         # (B, T, R) fp32
    y = F.gelu(gate.to(torch.float32), approximate="tanh") * h
    y = y.to(x.dtype) @ w_out
    if chans is not None:
        y = px.reduce_out(y)
    return y, {"h": h[:, -1], "conv": new_conv}


def rglru_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """``{leaf: (shape, dtype, fill)}`` of the RG-LRU state."""
    R, W = cfg.resolved_rnn_width, cfg.conv_width
    return {"h": ((batch, R), torch.float32, 0),
            "conv": ((batch, W - 1, R), getattr(torch, cfg.dtype), 0)}


def _filled(shapes: dict, device) -> dict:
    dev = resolve_device(device)
    return {n: torch.full(shape, fill, dtype=dt, device=dev)
            for n, (shape, dt, fill) in shapes.items()}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return _filled(rglru_state_shapes(cfg, batch), device)


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

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"w_r": ("embed_p", "rnn"), "w_k": ("embed_p", "rnn"),
                "w_v": ("embed_p", "rnn"), "w_g": ("embed_p", "rnn"),
                "w_o": ("rnn", "embed_p"), "mu": (None, "embed_p"),
                "w0": (None, None), "w_lora_a": ("embed_p", None),
                "w_lora_b": (None, "embed_p"), "u": (None, None),
                "c_mu": (None, "embed_p"), "c_k": ("embed_p", "mlp"),
                "c_v": ("mlp", "embed_p"), "c_r": ("embed_p", "rnn")}


def rwkv_heads(cfg: ModelConfig, px) -> tuple | None:
    """The rank's RWKV-6 heads ``[h0, h1)``, or ``None`` where the width
    does not split into whole heads over ``model``."""
    r = px.split(cfg.d_model)
    if r is None or (r[1] - r[0]) % cfg.rwkv_head_dim:
        return None
    return r[0] // cfg.rwkv_head_dim, r[1] // cfg.rwkv_head_dim


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
    px = parallel.plan_of(p.w_r)
    heads = rwkv_heads(cfg, px) if px is not None else None
    x_shift = _token_shift(x, state["x_prev_t"] if state is not None
                           else None)
    mu = weight(p.mu)

    def mix(i):
        return x + (x_shift - x) * mu[i].to(x.dtype)

    xr, xk, xv, xg, xw = (mix(i) for i in range(5))
    lora = xw @ weight(p.w_lora_a)
    if heads is None:
        w_r, w_k, w_v, w_g, w_lora_b, w0, u, w_o = (weight(t) for t in (
            p.w_r, p.w_k, p.w_v, p.w_g, p.w_lora_b, p.w0, p.u, p.w_o))
    else:                               # the rank's heads [h0, h1)
        h0, h1 = heads
        c0, c1 = h0 * hd, h1 * hd
        H, D = h1 - h0, c1 - c0
        xr, xk, xv, xg = (px.copy_in(t) for t in (xr, xk, xv, xg))
        lora = px.copy_in(lora)
        w_r, w_k, w_v, w_g, w_lora_b = (px.fetch(t, (1, c0, c1)) for t in (
            p.w_r, p.w_k, p.w_v, p.w_g, p.w_lora_b))
        w0, u = (px.fetch(t, (0, h0, h1)) for t in (p.w0, p.u))
        w_o = px.fetch(p.w_o, (0, c0, c1))
    r = (xr @ w_r).view(B, T, H, hd)
    k = (xk @ w_k).view(B, T, H, hd)
    v = (xv @ w_v).view(B, T, H, hd)
    g = xg @ w_g
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x))), fp32
    dw = lora @ w_lora_b
    logw = w0[None, None] + dw.view(B, T, H, hd).to(torch.float32)
    w = torch.exp(-torch.exp(logw))

    S0 = state["S"] if state is not None else None
    f32 = torch.float32
    out, S_T = ops.wkv6(r.to(f32), k.to(f32), v.to(f32), w, u, S0)
    out = out.reshape(B, T, D) * F.silu(g.to(f32))
    y = out.to(x.dtype) @ w_o
    if heads is not None:
        y = px.reduce_out(y)
    return y, {"x_prev_t": x[:, -1], "S": S_T}


def apply_rwkv_channel_mix(p: RWKVBlock, cfg: ModelConfig, x: torch.Tensor,
                           state: dict | None = None):
    """RWKV channel mix (token-shifted squared-relu FFN) on x (B, T, D);
    returns (y, ``{"x_prev_c"}``)."""
    x_shift = _token_shift(x, state["x_prev_c"] if state is not None
                           else None)
    c_mu = weight(p.c_mu)
    xk = x + (x_shift - x) * c_mu[0].to(x.dtype)
    xr = x + (x_shift - x) * c_mu[1].to(x.dtype)
    px = parallel.plan_of(p.c_k)
    ffn = px.split(cfg.d_ff) if px is not None else None
    if ffn is None:
        kk = torch.square(torch.relu(xk @ weight(p.c_k)))
        vv = kk @ weight(p.c_v)
    else:                               # tensor parallel over d_ff
        kk = torch.square(torch.relu(px.copy_in(xk)
                                     @ px.fetch(p.c_k, (1, *ffn))))
        vv = px.reduce_out(kk @ px.fetch(p.c_v, (0, *ffn)))
    cols = px.split(cfg.d_model) if px is not None else None
    if cols is None:
        rr = torch.sigmoid(xr @ weight(p.c_r))
    else:                               # the rank's columns, gathered
        rr = px.gather_model(torch.sigmoid(
            px.copy_in(xr) @ px.fetch(p.c_r, (1, *cols))), -1)
    return rr * vv, {"x_prev_c": x[:, -1]}


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """``{leaf: (shape, dtype, fill)}`` of the RWKV-6 state."""
    D, hd = cfg.d_model, cfg.rwkv_head_dim
    dt = getattr(torch, cfg.dtype)
    return {"x_prev_t": ((batch, D), dt, 0), "x_prev_c": ((batch, D), dt, 0),
            "S": ((batch, D // hd, hd, hd), torch.float32, 0)}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    return _filled(rwkv_state_shapes(cfg, batch), device)
