"""Decoder-only LM assembly: init, forward, training loss, prefill, decode.

The port of the JAX package's ``repro/models/transformer.py`` for the
text family with attention blocks (``attn`` | ``local``) and the dense
MLP — gemma2-9b's alternating local/global attention with soft-caps and
sandwich norms among them.  The JAX package scans its layers in groups
of the block pattern; here ``Transformer.layers`` is an
``nn.ModuleList`` in layer order and a Python loop runs it
(``models/convert.py`` maps the JAX package's stacked tree onto it).

Caches: each attention layer has a ring-buffer KV cache of
``min(window, max_seq)`` slots for ``local`` layers and ``max_seq`` for
global ones, with the position held in each slot (-1: empty).  Unlike
the JAX package, which returns new cache arrays, ``prefill`` and
``decode_step`` write the caches in place (one cache of gemma2-9b at
batch 2 and 8224 positions is 4.2 GB in bf16) and return the same
object.

Training (``forward_hidden``, ``loss_fn``; the JAX package's
``transformer.py:288-409``) runs with autograd: the attention is the
``local_attention`` kernel's autograd Function (its backward the
hand-written backward kernel), ``remat_policy`` "minimal" or "full" puts
each layer under ``torch.utils.checkpoint`` (recomputed in the backward;
the math is the same), ``loss_chunks`` splits the LM head and the cross
entropy over sequence chunks, each under checkpoint, so one chunk's fp32
logits exist at a time.  Every backward on the path sums in a fixed
order on the card (the embedding lookup's, torch's sort-based
``index_put_`` with accumulation; the label logit's ``gather``, one add
into each row), so two runs of a step give the same bits.

Not ported yet, each raising ``NotImplementedError`` that names its
``ROADMAP.md`` item: the recurrent blocks (``rglru``, ``rwkv``), the MoE
FFN and the VLM/audio front ends.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.operator import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models.config import ModelConfig

_TODO = "is not ported yet (ROADMAP.md, queue 1, item 13: LM side, {})"


class Layer(nn.Module):
    """Pre-norm block (with gemma2's post norms when ``post_block_norm``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        if kind not in ("attn", "local"):
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} "
                + _TODO.format("recurrent blocks"))
        self.kind = kind
        D, eps = cfg.d_model, cfg.norm_eps
        self.norm1 = L.RMSNorm(D, eps, device)
        self.norm2 = L.RMSNorm(D, eps, device)
        if cfg.post_block_norm:
            self.norm1_post = L.RMSNorm(D, eps, device)
            self.norm2_post = L.RMSNorm(D, eps, device)
        self.mix = L.Attention(cfg, device)
        self.ffn = M.init_mlp(cfg, device)


class Transformer(nn.Module):
    """embed (V, D), final_norm, head (D, V) when embeddings are untied,
    and ``layers`` in layer order."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} front end "
                + _TODO.format("VLM/audio front ends"))
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        V, D = cfg.vocab_size, cfg.d_model
        self.embed = L.param((V, D), dt, device)
        self.final_norm = L.RMSNorm(D, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.head = L.param((D, V), dt, device)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, device) for kind in cfg.blocks)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(cfg: ModelConfig, *, seed: int = 0,
               device=None) -> Transformer:
    """Random weights with the JAX package's distributions and scales:
    embed and head N(0, 1/D); wq, wk, wv, w_in, w_gate N(0, 1/D); wo
    N(0, 1/(H Dh)); w_out N(0, 1/F); every norm scale 0.  The numbers
    come from a ``torch.Generator`` on ``device`` seeded with ``seed``
    (they cannot be ``jax.random``'s), drawn in fp32 and cast to
    ``cfg.dtype``.  ``device=None`` is the card."""
    dev = resolve_device(device)
    model = Transformer(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, F = cfg.d_model, cfg.d_ff
    H, Dh = cfg.num_heads, cfg.resolved_head_dim
    std = {"embed": 1 / math.sqrt(D), "head": 1 / math.sqrt(D),
           "wq": 1 / math.sqrt(D), "wk": 1 / math.sqrt(D),
           "wv": 1 / math.sqrt(D), "wo": 1 / math.sqrt(H * Dh),
           "w_in": 1 / math.sqrt(D), "w_gate": 1 / math.sqrt(D),
           "w_out": 1 / math.sqrt(F)}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in std:
            p.copy_(torch.randn(p.shape, generator=g, device=dev)
                    .mul_(std[leaf]))
        else:                                   # norm scales
            p.zero_()
    return model


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _apply_layer(lp: Layer, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None = None,
                 decode_pos: int | None = None) -> torch.Tensor:
    """One block.  Prefill (``decode_pos`` None): attention on the
    kernel, and the ring buffer filled when a ``cache`` is given.
    Decode: the step's K/V written into slot ``decode_pos % Lc`` of the
    cache, then attention over the cache."""
    h = lp.norm1(x)
    local = lp.kind == "local"
    if decode_pos is not None:
        k_new, v_new = L.project_kv(lp.mix, cfg, h, positions)
        Lc = cache["k"].shape[1]
        idx = decode_pos % Lc
        cache["k"][:, idx] = k_new[:, 0]
        cache["v"][:, idx] = v_new[:, 0]
        cache["pos"][idx] = decode_pos
        kv_pos = cache["pos"][None].expand(x.shape[0], Lc)
        mix = L.apply_attention(lp.mix, cfg, h, positions, local=local,
                                kv=(cache["k"], cache["v"]),
                                kv_positions=kv_pos, kv_mask=kv_pos >= 0)
    else:
        mix, k_full, v_full = L.prefill_attention(lp.mix, cfg, h, positions,
                                                  local=local)
        if cache is not None:
            _fill_cache(cache, k_full, v_full, positions)
    if cfg.post_block_norm:
        mix = lp.norm1_post(mix)
    x = x + mix

    h = lp.norm2(x)
    ffn = M.apply_mlp(lp.ffn, cfg, h)
    if cfg.post_block_norm:
        ffn = lp.norm2_post(ffn)
    return x + ffn


def _fill_cache(cache: dict, k_full: torch.Tensor, v_full: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write the last min(S, L_cache) positions of k/v into the ring, in
    place."""
    S = positions.shape[1]
    Lc = cache["k"].shape[1]
    take = min(S, Lc)
    pos_tail = positions[0, S - take:]
    slots = pos_tail % Lc
    cache["k"][:, slots] = k_full[:, S - take:]
    cache["v"][:, slots] = v_full[:, S - take:]
    cache["pos"][slots] = pos_tail.to(torch.int32)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed_tokens(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    x = model.embed[tokens]
    return x * torch.tensor(math.sqrt(model.cfg.d_model), dtype=x.dtype)


def _lm_head(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> logits fp32 (B, S, V)."""
    cfg = model.cfg
    w = model.embed.mT if cfg.tie_embeddings else model.head
    logits = (x @ w).to(torch.float32)
    if cfg.final_softcap is not None:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    return logits


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits fp32 (B, S, V)."""
    cfg = model.cfg
    x = _embed_tokens(model, tokens)
    positions = _positions(*tokens.shape, x.device)
    for lp in model.layers:
        x = _apply_layer(lp, cfg, x, positions)
    return _lm_head(model, model.final_norm(x))


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def forward_hidden(model: Transformer, tokens: torch.Tensor):
    """Full-sequence forward up to the final norm, recording for
    autograd: tokens (B, S) -> (x (B, S, D), aux).  ``aux`` (the MoE
    router's loss) is 0: the dense MLP has none.  With ``remat_policy``
    "minimal" or "full" each layer runs under ``checkpoint`` (its
    activations recomputed in the backward, attention included)."""
    cfg = model.cfg
    x = _embed_tokens(model, tokens)
    positions = _positions(*tokens.shape, x.device)
    remat = cfg.remat_policy in ("minimal", "full")
    for lp in model.layers:
        if remat:
            x = checkpoint(_apply_layer, lp, cfg, x, positions,
                           use_reentrant=False)
        else:
            x = _apply_layer(lp, cfg, x, positions)
    return (model.final_norm(x),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _xent(lg: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """Cross entropy of fp32 logits (..., V) at integer labels (...):
    log-sum-exp minus the label's logit.  (The label's logit is read by
    ``gather``; its backward adds one value into each row, so no two
    adds meet.)"""
    lse = torch.logsumexp(lg, dim=-1)
    sel = torch.gather(lg, -1, lb[..., None].long())[..., 0]
    return lse - sel


def _nll_block(model: Transformer, x: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """Head + cross entropy for one sequence block: x (B, s, D) ->
    nll (B, s) fp32."""
    return _xent(_lm_head(model, x), labels)


def loss_fn(model: Transformer, batch: dict):
    """Next-token cross entropy (+ ``router_aux_coef`` x aux).  ``batch``
    holds ``tokens`` and ``labels`` (B, S) and optionally ``loss_mask``
    (B, S), tensors on the model's device.  Returns (total, {"loss",
    "aux"}).  ``cfg.loss_chunks > 1`` (dividing S) runs the head and the
    cross entropy chunk by chunk along the sequence, each chunk under
    ``checkpoint``, as the JAX package's scan with remat does."""
    cfg = model.cfg
    x, aux = forward_hidden(model, batch["tokens"])
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(torch.float32)
    S = labels.shape[-1]
    lc = cfg.loss_chunks
    if lc <= 1 or S % lc:
        nll = _nll_block(model, x, labels)
        loss = (torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
                if mask is not None else torch.mean(nll))
    else:
        c = S // lc
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(lc):
            sl = slice(i * c, (i + 1) * c)
            nll = checkpoint(_nll_block, model, x[:, sl], labels[:, sl],
                             use_reentrant=False)
            if mask is None:
                tot = tot + torch.sum(nll)
                cnt = cnt + float(nll.numel())
            else:
                tot = tot + torch.sum(nll * mask[:, sl])
                cnt = cnt + torch.sum(mask[:, sl])
        loss = tot / torch.clamp(cnt, min=1.0)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> list[dict]:
    """Empty ring-buffer caches, one dict per layer (``k``/``v``
    (B, Lc, Hkv, Dh) in the model dtype, ``pos`` (Lc,) int32 of -1)."""
    dev = resolve_device(device)
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    caches = []
    for kind in cfg.blocks:
        if kind not in ("attn", "local"):
            raise NotImplementedError(
                f"{cfg.name}: the {kind!r} state "
                + _TODO.format("recurrent blocks"))
        Lc = max_seq if kind == "attn" else min(cfg.window, max_seq)
        caches.append({
            "k": torch.zeros((batch, Lc, Hkv, Dh), dtype=dt, device=dev),
            "v": torch.zeros((batch, Lc, Hkv, Dh), dtype=dt, device=dev),
            "pos": torch.full((Lc,), -1, dtype=torch.int32, device=dev)})
    return caches


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            cache: list[dict] | None):
    """Process the prompt tokens (B, S); returns (last-position logits
    (B, V) fp32, cache).  Only the final position is projected to the
    vocabulary.  ``cache=None`` runs the prompt without filling one."""
    cfg = model.cfg
    x = _embed_tokens(model, tokens)
    positions = _positions(*tokens.shape, x.device)
    for i, lp in enumerate(model.layers):
        x = _apply_layer(lp, cfg, x, positions,
                         None if cache is None else cache[i])
    logits = _lm_head(model, model.final_norm(x[:, -1:]))
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(model: Transformer, cache: list[dict], tokens: torch.Tensor,
                pos: int):
    """One decode step: tokens (B, 1) at position ``pos`` (a Python int).
    Returns (logits (B, V) fp32, cache)."""
    cfg = model.cfg
    x = _embed_tokens(model, tokens)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(model.layers):
        x = _apply_layer(lp, cfg, x, positions, cache[i], decode_pos=pos)
    logits = _lm_head(model, model.final_norm(x))
    return logits[:, 0], cache
