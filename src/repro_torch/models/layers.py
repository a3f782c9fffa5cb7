"""Shared transformer layers: RMSNorm, RoPE, GQA attention (global/local).

The port of the JAX package's ``repro/models/layers.py``.  Each layer is
an ``nn.Module`` holding its parameters under the JAX package's names,
with their logical axes (``specs``, the JAX package's ``*_specs``), and
the math is a plain function on tensors (``apply_rmsnorm``,
``apply_rope``, ``apply_attention``, ``project_kv``).

In a sharded model (``core/parallel.py``: its parameters carry a
``Plan``) the parameters are the rank's shards and ``weight`` fetches
what a layer computes with.  Attention shards by heads over ``model`` where
``num_heads`` divides and the rank's query heads read whole K/V heads
(its ``H/tp`` query heads and the K/V heads they read; the input by
``copy_in``, the output projection's partial sum by ``reduce_out``), and
the ``local_attention`` kernel and its backward run on those local
heads.  Elsewhere (llava-next's 56 heads at tp 16) attention runs whole
on every model rank: the JAX package shards the query sequence there
instead, a layout its compiler picks that leaves the results the same.

Attention has two paths, as in the JAX package:

* prefill and training (``kv is None``): K/V come from ``x`` and stay
  at ``Hkv`` heads; the scores, mask, softmax and V product are one call of the
  hand-written ``local_attention`` kernel (``kernels/ops.py``) on
  ``(B, H, S, D)`` views of the ``(B, S, H, D)`` projections, with the
  layer's window for ``local`` layers and ``S`` (plain causal attention)
  for global ones.  No ``(B, H, S, S)`` score tensor exists.  Where
  autograd records (training), the call is the kernel's autograd
  Function: its backward is the hand-written backward kernel.
* decode (``kv`` given): one query step against the ring-buffer cache,
  in plain PyTorch, rounded as the JAX package rounds: operands in the
  model dtype, the query pre-scaled in it, products summed in fp32 (the
  operands are widened to fp32 first: a product of two bf16 values is
  exact in fp32, which is the JAX package's
  ``preferred_element_type=float32``), an fp32 softmax, probabilities
  cast to V's dtype before the fp32-summed V product.  A sharded
  model's step (``decode_attention``) gathers the step's query and K/V
  heads over ``model`` and scores the rank's slots of a time-sharded
  ring, its softmax reduced over ``model``.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch
from torch import nn

from repro_torch.core import parallel
from repro_torch.core.operator import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


def normal(std: float) -> tuple:
    """An ``inits`` entry: N(0, std^2), drawn in fp32 (``init_model``)."""
    return ("normal", std)


def const(value: float) -> tuple:
    """An ``inits`` entry: every element ``value``."""
    return ("const", value)


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialised, trainable parameter (``init_model`` fills it;
    serving runs under ``torch.no_grad``, so it records nothing).
    ``device=None`` is the card, as at every entry point of the port: the
    modules built from these (``RMSNorm``, ``Attention``, ``MLP``,
    ``Layer``, ``Transformer``) raise without one unless the caller asks
    for the CPU."""
    meta = device is not None and torch.device(device).type == "meta"
    return nn.Parameter(torch.empty(
        shape, dtype=dtype,
        device=torch.device("meta") if meta else resolve_device(device)))


def weight(p: torch.Tensor, need: tuple | None = None,
           fsdp: bool = True) -> torch.Tensor:
    """The parameter itself, or for a rank's shard the weight the layer
    computes with (``parallel.Plan.fetch``)."""
    px = parallel.plan_of(p)
    return p if px is None else px.fetch(p, need, fsdp)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def apply_rmsnorm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    # gemma-style (1 + scale) so zero-init is identity
    return (y * (1.0 + scale)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), torch.float32, device)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        return {"scale": const(0.0)}

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"scale": ("embed_p",)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_rmsnorm(weight(self.scale), x, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with even D; positions: (B, S) integer."""
    D = x.shape[-1]
    half = D // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angle = positions[..., None].to(torch.float32) * freq  # (B, S, half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (global causal or sliding-window local, GQA, qk-norm, softcap)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """wq (D, H, Dh), wk/wv (D, Hkv, Dh), wo (H, Dh, D); q_norm/k_norm
    (Dh,) with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D = cfg.d_model
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        dt = getattr(torch, cfg.dtype)
        self.wq = param((D, H, Dh), dt, device)
        self.wk = param((D, Hkv, Dh), dt, device)
        self.wv = param((D, Hkv, Dh), dt, device)
        self.wo = param((H, Dh, D), dt, device)
        if cfg.qk_norm:
            self.q_norm = param((Dh,), torch.float32, device)
            self.k_norm = param((Dh,), torch.float32, device)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        """``init_attention``'s: projections in N(0, 1/D), wo N(0,
        1/(H Dh)), the qk-norm scales 0."""
        si = normal(1 / math.sqrt(cfg.d_model))
        return {"wq": si, "wk": si, "wv": si,
                "wo": normal(1 / math.sqrt(cfg.num_heads
                                           * cfg.resolved_head_dim)),
                "q_norm": const(0.0), "k_norm": const(0.0)}

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        return {"wq": ("embed_p", "heads", "qkv"),
                "wk": ("embed_p", "kv_heads", "qkv"),
                "wv": ("embed_p", "kv_heads", "qkv"),
                "wo": ("heads", "qkv", "embed_p"),
                "q_norm": ("qkv",), "k_norm": ("qkv",)}


def attention_heads(cfg: ModelConfig, px) -> tuple | None:
    """The rank's query heads ``[h0, h1)`` and the K/V heads ``[k0, k1)``
    they read, or ``None`` where attention runs whole on every model
    rank (``num_heads`` does not divide ``model``, or the rank's query
    heads would not read whole K/V heads in one group size)."""
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    G = H // Hkv
    r = px.split(H)
    if r is None:
        return None
    h0, h1 = r
    hq = h1 - h0
    if hq % G == 0:
        return h0, h1, h0 // G, h1 // G
    if G % hq == 0:
        return h0, h1, h0 // G, h0 // G + 1
    return None


def _attention_weights(p: Attention, cfg: ModelConfig):
    """(weights, plan): the layer's own parameters in one process; in a
    sharded model, the fetched weights of the rank's heads (with the plan)
    or of all of them (``None``: no collective on the activations)."""
    px = parallel.plan_of(p.wq)
    if px is None:
        return p, None
    names = ["wq", "wk", "wv", "wo"] + (["q_norm", "k_norm"]
                                        if cfg.qk_norm else [])
    heads = attention_heads(cfg, px)
    if heads is None:
        return SimpleNamespace(**{n: px.fetch(getattr(p, n))
                                  for n in names}), None
    h0, h1, k0, k1 = heads
    Dh = cfg.resolved_head_dim
    need = {"wq": (1, h0, h1), "wk": (1, k0, k1), "wv": (1, k0, k1),
            "wo": (0, h0, h1), "q_norm": (0, 0, Dh), "k_norm": (0, 0, Dh)}
    return SimpleNamespace(**{n: px.fetch(getattr(p, n), need[n])
                              for n in names}), px


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matmul."""
    D, Hn, Dh = w.shape
    return (x @ w.reshape(D, Hn * Dh)).view(*x.shape[:-1], Hn, Dh)


def project_kv(p: Attention, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor):
    """K/V projection (+rope, +k-norm): (B, S, Hkv, Dh) each."""
    k = _project(x, p.wk)
    v = _project(x, p.wv)
    if cfg.qk_norm:
        k = apply_rmsnorm(p.k_norm, k, cfg.norm_eps)
    k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _project_q(p: Attention, cfg: ModelConfig, x, positions):
    q = _project(x, p.wq)
    if cfg.qk_norm:
        q = apply_rmsnorm(p.q_norm, q, cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta)


def _out_proj(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)``."""
    H, Dh, D = p.wo.shape
    return out.reshape(*out.shape[:2], H * Dh) @ p.wo.reshape(H * Dh, D)


def prefill_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor, *, local: bool,
                      whole_kv: bool = False):
    """Attention over the prompt itself on the ``local_attention``
    kernel; returns ``(y, k, v)``, the roped K/V ``(B, S, Hkv, Dh)``
    being what the cache stores (``project_kv``'s values, computed
    once).  In a sharded model whose heads split over ``model``, ``k``/
    ``v`` are the rank's K/V heads, or with ``whole_kv`` every K/V head
    (``gather_heads``: one all-gather over ``model``), as a cache fill
    needs them."""
    S = x.shape[1]
    w, px = _attention_weights(p, cfg)
    if px is not None:
        x = px.copy_in(x)
    q = _project_q(w, cfg, x, positions)
    k, v = project_kv(w, cfg, x, positions)
    out = ops.local_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        window=cfg.window if local else max(S, 1),
        softcap=cfg.attn_softcap)
    y = _out_proj(w, out.transpose(1, 2))
    if px is not None:
        y = px.reduce_out(y)
        if whole_kv:
            Hkv = cfg.num_kv_heads
            k, v = gather_heads(px, [(k, Hkv), (v, Hkv)])
    return y, k, v


def gather_heads(px, parts: list) -> list[torch.Tensor]:
    """Every head on every model rank: ``parts`` holds ``(t, n)`` pairs,
    ``t`` ``(B, S, h, Dh)`` the rank's heads of a tensor of ``n`` heads
    (its query heads ``[h0, h1)``, or the K/V heads ``[k0, k1)`` they
    read), concatenated along the heads and all-gathered over ``model`` in
    ONE collective.  K/V heads that several ranks share (``G`` a multiple
    of the rank's query heads) come back once each."""
    tp = px.tp
    widths = [t.shape[2] for t, _ in parts]
    allh = px.gather_model(torch.cat([t for t, _ in parts], dim=2), 2)
    B, S, Dh = allh.shape[0], allh.shape[1], allh.shape[-1]
    allh = allh.view(B, S, tp, sum(widths), Dh)
    out, c = [], 0
    for (_, n), h in zip(parts, widths):
        part = allh[:, :, :, c:c + h].reshape(B, S, tp * h, Dh)
        out.append(part[:, :, ::tp * h // n])
        c += h
    return out


def _decode_scores(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   positions: torch.Tensor, kv_positions: torch.Tensor,
                   kv_mask: torch.Tensor | None, local: bool):
    """The masked fp32 scores ``(B, H, S, T)`` of the query ``q`` (B, S,
    H, Dh) against the cache's keys ``k`` (B, T, Hkv, Dh), rounded as the
    JAX package rounds (the query pre-scaled in the model dtype, the
    products of fp32-widened operands); masked entries -1e30."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    T = k.shape[1]
    q = q * torch.tensor(1.0 / math.sqrt(Dh), dtype=q.dtype)
    # head h reads K/V head h // G: group the query heads by their K/V head
    qg = q.view(B, S, Hkv, G, Dh).permute(0, 2, 3, 1, 4).reshape(
        B, Hkv, G * S, Dh)
    s = torch.matmul(qg.to(torch.float32),
                     k.permute(0, 2, 3, 1).to(torch.float32))
    s = s.view(B, H, S, T)
    if cfg.attn_softcap is not None:
        s = torch.tanh(s / cfg.attn_softcap) * cfg.attn_softcap
    qp = positions[:, None, :, None]
    kp = kv_positions[:, None, None, :]
    m = kp <= qp
    if local:
        m = m & (kp > qp - cfg.window)
    if kv_mask is not None:
        m = m & kv_mask[:, None, None, :]
    return torch.where(m, s, -1e30)


def _probs_v(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``probs`` (B, H, S, T) fp32 cast to V's dtype, times ``v`` (B, T,
    Hkv, Dh) summed in fp32: (B, H, S, Dh) fp32."""
    B, H, S, T = probs.shape
    Hkv, Dh = v.shape[2], v.shape[3]
    G = H // Hkv
    o = torch.matmul(probs.to(v.dtype).view(B, Hkv, G * S, T)
                     .to(torch.float32),
                     v.permute(0, 2, 1, 3).to(torch.float32))
    return o.view(B, H, S, Dh)


def _write_slot(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                pos: int, t0: int) -> torch.Tensor:
    """Write the step's K/V (B, 1, Hkv, Dh) into slot ``pos % Lc`` of the
    ring where this rank holds it (its slots ``[t0, t0 + Tl)``) and the
    position into ``pos`` (whole); returns the positions of the rank's
    slots, (B, Tl)."""
    Lc, Tl = cache["pos"].shape[0], cache["k"].shape[1]
    idx = pos % Lc
    if t0 <= idx < t0 + Tl:
        cache["k"][:, idx - t0] = k_new[:, 0]
        cache["v"][:, idx - t0] = v_new[:, 0]
    cache["pos"][idx] = pos
    return cache["pos"][t0:t0 + Tl][None].expand(k_new.shape[0], Tl)


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     positions: torch.Tensor, cache: dict, pos: int, *,
                     local: bool) -> torch.Tensor:
    """One decode step of a layer: the step's K/V written into slot
    ``pos % Lc`` of the ring, then attention of the step's query over the
    cache (``apply_attention``'s numerics).

    In a sharded model the cache ``k``/``v`` hold the rank's rows and,
    where ``Lc`` divides ``model`` (``cache_specs``' ``"cache_seq"``), its
    slots ``[m Lc/tp, (m + 1) Lc/tp)``; ``pos`` (Lc,) is whole on every
    rank.  Where the heads split over ``model`` the rank projects its own
    heads and ONE all-gather over ``model`` gives every rank the step's
    query at every head and its K/V heads (the JAX package constrains the
    query replicated, ``layers.py:176-179`` there).  The rank owning the
    slot writes it; each rank scores its own slots, the max over
    ``model`` (``all_reduce_max``) and then the exp-sums and the partial
    ``P V`` summed over ``model`` in ONE all-reduce of a stacked tensor
    (context parallelism, ``layers.py:209-211`` there); the output
    projection runs on the rank's heads (``reduce_out``), or whole where
    attention is whole on every model rank."""
    px = parallel.plan_of(p.wq)
    if px is None:
        k_new, v_new = project_kv(p, cfg, x, positions)
        kv_pos = _write_slot(cache, k_new, v_new, pos, 0)
        return apply_attention(p, cfg, x, positions, local=local,
                               kv=(cache["k"], cache["v"]),
                               kv_positions=kv_pos, kv_mask=kv_pos >= 0)
    w, hp = _attention_weights(p, cfg)
    heads = attention_heads(cfg, px) if hp is not None else None
    q = _project_q(w, cfg, x, positions)
    k_new, v_new = project_kv(w, cfg, x, positions)
    if heads is not None:
        H, Hkv = cfg.num_heads, cfg.num_kv_heads
        q, k_new, v_new = gather_heads(px, [(q, H), (k_new, Hkv),
                                            (v_new, Hkv)])
    Lc, Tl = cache["pos"].shape[0], cache["k"].shape[1]
    kv_pos = _write_slot(cache, k_new, v_new, pos,
                         px.m * Tl if Tl < Lc else 0)
    s = _decode_scores(cfg, q, cache["k"], positions, kv_pos, kv_pos >= 0,
                       local)
    if Tl == Lc:
        o = _probs_v(torch.softmax(s, dim=-1), cache["v"])
    else:
        m = px.model_max(s.amax(dim=-1))                   # (B, H, S)
        e = torch.exp(s - m[..., None])
        both = px.reduce_out(torch.cat(
            [_probs_v(e, cache["v"]), e.sum(dim=-1)[..., None]], dim=-1))
        o = both[..., :-1] / both[..., -1:]
    out = o.permute(0, 2, 1, 3).to(x.dtype)
    if heads is None:
        return _out_proj(w, out)
    h0, h1 = heads[:2]
    return px.reduce_out(_out_proj(w, out[:, :, h0:h1]))


def apply_attention(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, S, D)
    positions: torch.Tensor,            # (B, S)
    *,
    local: bool,
    kv: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, T, Hkv, Dh)
    kv_positions: torch.Tensor | None = None,             # (B, T)
    kv_mask: torch.Tensor | None = None,                  # (B, T) validity
) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention.

    Training/prefill: ``kv`` is None — K/V come from ``x`` (the kernel).
    Decode: the caller passes the cache as ``kv`` (+ positions/mask),
    ``x`` is the single-step query.
    """
    if kv is None:
        return prefill_attention(p, cfg, x, positions, local=local)[0]
    q = _project_q(p, cfg, x, positions)
    s = _decode_scores(cfg, q, kv[0], positions, kv_positions, kv_mask,
                       local)
    o = _probs_v(torch.softmax(s, dim=-1), kv[1])          # fp32 softmax
    return _out_proj(p, o.permute(0, 2, 1, 3).to(x.dtype))
