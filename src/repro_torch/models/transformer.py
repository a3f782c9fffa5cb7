"""Decoder-only LM assembly: init, forward, training loss, prefill, decode.

The port of the JAX package's ``repro/models/transformer.py`` for every
architecture family in ``configs/``: the per-layer block pattern
(``attn`` | ``local`` | ``rglru`` | ``rwkv``), the FFN (the dense MLP,
the capacity MoE, or RWKV's channel mix, which lives with its time mix
under ``ffn``), and the two front ends:

* ``vlm``: precomputed patch embeddings (B, P, D) are cast to the model
  dtype and concatenated ahead of the token embeddings, and positions
  run over P + S (the vision tower is a stub, as in the JAX package);
* ``audio``: K parallel codebook streams, tokens (B, K, S), embed
  (K, V, D) summed over the streams, K untied heads (K, D, V), logits
  (B, S, K, V).

The JAX package scans its layers in groups of the block pattern; here
``Transformer.layers`` is an ``nn.ModuleList`` in layer order and a Python
loop runs it (``models/convert.py`` maps the JAX package's stacked tree
onto it).  Attention runs on the ``local_attention`` kernel, RG-LRU's and
RWKV-6's recurrences on the ``rglru_scan`` and ``wkv6`` kernels
(``models/recurrent.py``).

Caches: each attention layer has a ring-buffer KV cache of
``min(window, max_seq)`` slots for ``local`` layers and ``max_seq`` for
global ones, with the position held in each slot (-1: empty); each
recurrent layer its O(1) state (``models/recurrent.py``).  Unlike the
JAX package, which returns new cache arrays, ``prefill`` and
``decode_step`` write the caches in place (one cache of gemma2-9b at
batch 2 and 8224 positions is 4.2 GB in bf16) and return the same
object.

Training (``forward_hidden``, ``loss_fn``; the JAX package's
``transformer.py:288-409``) runs with autograd: the attention is the
``local_attention`` kernel's autograd Function (its backward the
hand-written backward kernel), ``remat_policy`` puts each layer under
``torch.utils.checkpoint`` ("full": recomputed whole in the backward;
"minimal": the weight GEMMs' outputs saved and the rest recomputed,
``_run_layer``; the math is the same), ``loss_chunks`` splits the LM
head and the cross entropy over sequence chunks, each under checkpoint,
so one chunk's fp32 logits exist at a time.  Every backward on the path
sums in a fixed order on the card (the embedding lookup's, torch's
sort-based ``index_put_`` with accumulation; the label logit's
``gather``, one add into each row), so two runs of a step give the same
bits.  The
recurrences of ``rglru``/``rwkv`` layers are their kernels' autograd
Functions on the card (``ops.rglru_scan``, ``ops.wkv6``): a layer
launches the forward kernel twice a step (the forward, and again in the
remat recompute; RWKV-6's also keeps its state at each chunk's start)
and the backward kernel once; on the CPU autograd differentiates their
plain loops.

Sharded training (``training/train.py::make_train_step`` over a mesh,
``core/parallel.py``): ``init_model(..., plan=)`` draws every leaf as the
one-process init does and keeps the rank's shard (``model_specs``, the
logical axes, resolved by ``repro_torch.sharding``; each carries the
plan), and ``loss_fn`` of such a model runs on the rank's rows.  The
embedding is vocab-parallel over ``model`` (ids outside the rank's rows masked, the
lookups summed by ``reduce_out``) and gathered over ``data`` once a step;
the head and the cross entropy are vocab-parallel inside ``loss_chunks``
(the max, the sum of exponentials and the label's logit all-reduced over
``model``); tied embeddings use the one gathered shard for both.  The
loss is the global batch's: each rank's sum over the global count
(``batch_sum``), the MoE aux loss ``batch_mean``-ed.  ``checkpoint``
recomputes a layer's forward collectives in the backward.

Sharded serving (``prefill`` / ``decode_step`` of such a model): each
rank serves its rows of the batch (``batch_rows``) from its shards of the
weights and of the caches (``init_cache(..., plan=)``, the layout of
``cache_specs``: the KV ring's time axis over ``model``, the RG-LRU
state on the rank's channels, RWKV-6's matrix state on its heads).  The
prefill runs the ``local_attention`` kernel on the rank's heads and
gathers their K/V over ``model`` once a layer to fill the rank's slots;
a decode step scores its slots and reduces the softmax over ``model``
(``layers.decode_attention``); the vocab-parallel logits are gathered
over ``model``, so every rank of a row block picks the same tokens.
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import sharding
from repro_torch.core import parallel
from repro_torch.core.operator import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import recurrent as R
from repro_torch.models.config import ModelConfig

BLOCK_KINDS = ("attn", "local", "rglru", "rwkv")


class Layer(nn.Module):
    """Pre-norm block (with gemma2's post norms when ``post_block_norm``):
    ``mix`` (attention or RG-LRU) and ``ffn`` (MLP or MoE), or, for
    ``rwkv``, ``ffn`` alone holding the time and channel mixes, as the
    JAX package's tree (``transformer.py:45-68``)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        if kind not in BLOCK_KINDS:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        self.kind = kind
        D, eps = cfg.d_model, cfg.norm_eps
        self.norm1 = L.RMSNorm(D, eps, device)
        self.norm2 = L.RMSNorm(D, eps, device)
        if cfg.post_block_norm:
            self.norm1_post = L.RMSNorm(D, eps, device)
            self.norm2_post = L.RMSNorm(D, eps, device)
        if kind == "rwkv":
            self.ffn = R.RWKVBlock(cfg, device)
            return
        self.mix = (R.RGLRUBlock(cfg, device) if kind == "rglru"
                    else L.Attention(cfg, device))
        self.ffn = M.init_mlp(cfg, device)


class Transformer(nn.Module):
    """embed (V, D) (audio: (K, V, D)), final_norm, head (D, V) (audio:
    (K, D, V)) when embeddings are untied, and ``layers`` in layer
    order."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        V, D, K = cfg.vocab_size, cfg.d_model, cfg.num_codebooks
        audio = cfg.family == "audio"
        self.embed = L.param((K, V, D) if audio else (V, D), dt, device)
        self.final_norm = L.RMSNorm(D, cfg.norm_eps, device)
        if not cfg.tie_embeddings:
            self.head = L.param((K, D, V) if audio else (D, V), dt, device)
        self.layers = nn.ModuleList(
            Layer(cfg, kind, device) for kind in cfg.blocks)

    @staticmethod
    def inits(cfg: ModelConfig) -> dict:
        s = L.normal(1 / math.sqrt(cfg.d_model))
        return {"embed": s, "head": s}

    @staticmethod
    def specs(cfg: ModelConfig) -> dict:
        if cfg.family == "audio":
            return {"embed": ("codebook", "vocab", "embed_p"),
                    "head": ("codebook", "embed_p", "vocab")}
        return {"embed": ("vocab", "embed_p"), "head": ("embed_p", "vocab")}


def model_specs(cfg: ModelConfig) -> dict:
    """``{parameter name: logical axes}`` of the port's parameters: each
    module's ``specs``, the JAX package's ``model_specs`` leaf for leaf
    (a stacked leaf's ``"layers"`` axis, never sharded, dropped)."""
    model = Transformer(cfg, torch.device("meta"))
    out = {}
    for mod_name, mod in model.named_modules():
        params = dict(mod.named_parameters(recurse=False))
        if params:
            table = type(mod).specs(cfg)
            for name in params:
                out[f"{mod_name}.{name}" if mod_name else name] = table[name]
    return out


def resolved_specs(cfg: ModelConfig, mesh) -> dict:
    """``{parameter name: spec}`` on ``mesh`` (``sharding.resolve_spec``
    with each parameter's shape)."""
    model = Transformer(cfg, torch.device("meta"))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return {n: sharding.resolve_spec(spec, mesh, shapes[n])
            for n, spec in model_specs(cfg).items()}


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_model(cfg: ModelConfig, *, seed: int = 0, device=None,
               plan=None) -> Transformer:
    """Random weights with the JAX package's distributions and scales,
    keyed by module kind and parameter name (each module's ``inits``):
    the ``init_*`` functions of ``repro/models`` leaf for leaf, constants
    included (norm scales 0; RG-LRU's ``lam`` 0.65; RWKV's ``mu`` and
    ``c_mu`` 0.5, ``w0`` -2).  A parameter no table names raises.  The
    numbers come from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (they cannot be ``jax.random``'s), drawn in fp32 and cast
    to the parameter's dtype.  ``device=None`` is the card.

    With ``plan`` (``core/parallel.Plan``, on its mesh's device) each
    parameter is the rank's shard, its spec in ``.spec`` and the plan in
    ``.plan``: every leaf is
    drawn whole, one at a time, in the same order, and cut, so a sharded
    model starts bitwise the one-process one without the whole model
    ever on the device."""
    dev = resolve_device(device) if plan is None else plan.device
    model = Transformer(cfg, dev if plan is None else torch.device("meta"))
    specs = None if plan is None else resolved_specs(cfg, plan.mesh)
    g = torch.Generator(device=dev).manual_seed(seed)
    for mod_name, mod in model.named_modules():
        params = dict(mod.named_parameters(recurse=False))
        if not params:
            continue
        table = type(mod).inits(cfg)
        for name, p in params.items():
            if name not in table:
                raise KeyError(f"{cfg.name}: no init for "
                               f"{mod_name}.{name} ({type(mod).__name__})")
            how, value = table[name]
            if plan is None:
                if how == "const":
                    p.fill_(value)
                else:
                    p.copy_(torch.randn(p.shape, generator=g, device=dev)
                            .mul_(value))
                continue
            full = (torch.full(p.shape, value, dtype=p.dtype, device=dev)
                    if how == "const" else
                    torch.randn(p.shape, generator=g, device=dev)
                    .mul_(value).to(p.dtype))
            spec = specs[f"{mod_name}.{name}" if mod_name else name]
            p = nn.Parameter(plan.shard(full, spec).clone())
            p.spec, p.plan = spec, plan
            mod._parameters[name] = p
    return model


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------

def _update(cache: dict | None, state: dict) -> None:
    """Write a recurrent layer's new state into its cache, in place."""
    if cache is not None:
        for name, t in state.items():
            cache[name].copy_(t)


def _apply_layer(lp: Layer, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, cache: dict | None = None,
                 decode_pos: int | None = None):
    """One block; returns (x, aux), aux the MoE's router loss (else
    None).
    Attention: prefill (``decode_pos`` None) on the kernel, the ring
    buffer filled when a ``cache`` is given; decode, the step's K/V
    written into slot ``decode_pos % Lc`` of the cache, then attention
    over the cache.  Recurrent blocks start from the cache's state (from
    zeros without one) and write their new state into it."""
    aux = None
    h = lp.norm1(x)
    if lp.kind == "rglru":
        mix, st = R.apply_rglru_block(lp.mix, cfg, h, cache)
        _update(cache, st)
    elif lp.kind == "rwkv":
        mix, st = R.apply_rwkv_time_mix(lp.ffn, cfg, h, cache)
        _update(cache, st)
    elif decode_pos is not None:
        mix = L.decode_attention(lp.mix, cfg, h, positions, cache,
                                 decode_pos, local=lp.kind == "local")
    else:
        mix, k_full, v_full = L.prefill_attention(
            lp.mix, cfg, h, positions, local=lp.kind == "local",
            whole_kv=cache is not None)
        if cache is not None:
            _fill_cache(cache, k_full, v_full, positions,
                        parallel.plan_of(lp.mix.wq))
    if cfg.post_block_norm:
        mix = lp.norm1_post(mix)
    x = x + mix

    h = lp.norm2(x)
    if lp.kind == "rwkv":
        ffn, st = R.apply_rwkv_channel_mix(lp.ffn, cfg, h, cache)
        _update(cache, st)
    elif cfg.is_moe:
        ffn, aux = M.apply_moe(lp.ffn, cfg, h)
    else:
        ffn = M.apply_mlp(lp.ffn, cfg, h)
    if cfg.post_block_norm:
        ffn = lp.norm2_post(ffn)
    return x + ffn, aux


def _fill_cache(cache: dict, k_full: torch.Tensor, v_full: torch.Tensor,
                positions: torch.Tensor, px=None) -> None:
    """Write the last min(S, L_cache) positions of k/v into the ring, in
    place; in a sharded model whose cache splits its slots over
    ``model``, the rank's slots only (``pos`` is whole everywhere)."""
    S = positions.shape[1]
    Lc, Tl = cache["pos"].shape[0], cache["k"].shape[1]
    take = min(S, Lc)
    pos_tail = positions[0, S - take:]
    slots = pos_tail % Lc
    cache["pos"][slots] = pos_tail.to(torch.int32)
    k_tail, v_tail = k_full[:, S - take:], v_full[:, S - take:]
    if Tl < Lc:                         # the rank's slots [t0, t0 + Tl)
        t0 = px.m * Tl
        mine = (slots >= t0) & (slots < t0 + Tl)
        slots, k_tail, v_tail = slots[mine] - t0, k_tail[:, mine], \
            v_tail[:, mine]
    cache["k"][:, slots] = k_tail
    cache["v"][:, slots] = v_tail


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def _embed_weight(model: Transformer):
    """(table, vocab range): the embedding itself in one process; in a
    sharded model, the rank's vocab rows ``[v0, v1)`` gathered over
    ``data`` (``None`` as the range where the vocab does not divide over
    ``model``: the whole table on every model rank)."""
    px = parallel.plan_of(model.embed)
    if px is None:
        return model.embed, None
    vr = px.split(model.cfg.vocab_size)
    vdim = 1 if model.cfg.family == "audio" else 0
    return (px.fetch(model.embed) if vr is None
            else px.fetch(model.embed, (vdim, *vr))), vr


def _lookup(table: torch.Tensor, ids: torch.Tensor, vr) -> torch.Tensor:
    """``table[ids]``; with a vocab range, ids outside it give zeros."""
    if vr is None:
        return table[ids]
    inr = (ids >= vr[0]) & (ids < vr[1])
    rows = table[torch.where(inr, ids - vr[0], 0)]
    return torch.where(inr[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))


def _embed_tokens(model: Transformer, tokens: torch.Tensor,
                  patch_embeds: torch.Tensor | None = None,
                  table: torch.Tensor | None = None,
                  vr: tuple | None = None) -> torch.Tensor:
    """tokens (B, S) (audio: (B, K, S)) -> x (B, S, D) in the model dtype
    (VLM with ``patch_embeds`` (B, P, D): (B, P + S, D), the patches
    first).  ``table`` and ``vr``: ``_embed_weight``'s (a vocab-parallel
    shard, whose lookups are summed over ``model``)."""
    cfg = model.cfg
    table = model.embed if table is None else table
    if cfg.family == "audio":
        # one lookup a codebook, summed in order (MusicGen sums the streams)
        x = _lookup(table[0], tokens[:, 0], vr)
        for c in range(1, cfg.num_codebooks):
            x = x + _lookup(table[c], tokens[:, c], vr)
    else:
        x = _lookup(table, tokens, vr)
    if vr is not None:
        x = parallel.plan_of(model.embed).reduce_out(x)
    x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
    if cfg.family == "vlm" and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x


def _lm_head(model: Transformer, x: torch.Tensor,
             w: torch.Tensor | None = None) -> torch.Tensor:
    """x: (B, S, D) -> logits fp32 (B, S, V) (audio: (B, S, K, V)); ``w``
    the head weight (D, V) (audio (K, D, V)) where the caller fetched
    it."""
    cfg = model.cfg
    if w is None:
        w = model.embed.mT if cfg.tie_embeddings else model.head
    if cfg.family == "audio":
        logits = torch.einsum("bsd,kdv->bskv", x, w).to(torch.float32)
    else:
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
def forward(model: Transformer, tokens: torch.Tensor, *,
            patch_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Full-sequence forward: tokens (B, S) -> logits fp32 (B, S, V)
    (audio: tokens (B, K, S) -> (B, S, K, V); VLM with ``patch_embeds``:
    (B, P + S, V))."""
    x, _ = _hidden(model, tokens, patch_embeds, "none")
    return _lm_head(model, x)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

#: the ops whose outputs ``remat_policy="minimal"`` saves: the 2-D
#: products with no batch dims (the JAX package's
#: ``dots_with_no_batch_dims_saveable``)
SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _minimal_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_layer(lp: Layer, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, remat: str):
    """``_apply_layer`` under ``remat`` (``cfg.remat_policy``):

    * ``"full"``: the layer under ``checkpoint``; the backward recomputes
      all of it (the JAX package's ``nothing_saveable``);
    * ``"minimal"``: the same with a selective policy that saves the
      outputs of ``aten.mm``/``addmm`` (projections, MLP, router,
      recurrent projections, RWKV's LoRA) and recomputes everything else:
      batched products (the MoE's experts), elementwise ops, the
      collectives (so the FSDP gathers run again, as under "full", and no
      rank keeps a gathered weight), and the hand-written kernels, which
      fill a ``torch.empty`` through ``ctypes`` where the dispatcher
      cannot see them: their autograd Functions run again in the
      recompute and launch again;
    * ``"none"``: no checkpoint."""
    if remat == "none":
        return _apply_layer(lp, cfg, x, positions)
    if remat == "full":
        return checkpoint(_apply_layer, lp, cfg, x, positions,
                          use_reentrant=False)
    if remat == "minimal":
        return checkpoint(_apply_layer, lp, cfg, x, positions,
                          use_reentrant=False, context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _minimal_policy))
    raise ValueError(f"remat_policy {remat!r} is not 'none', 'minimal' or "
                     f"'full'")


def _hidden(model: Transformer, tokens, patch_embeds, remat: str,
            table=None, vr=None):
    cfg = model.cfg
    x = _embed_tokens(model, tokens, patch_embeds, table, vr)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in model.layers:
        x, a = _run_layer(lp, cfg, x, positions, remat)
        if a is not None:
            aux = aux + a
    return model.final_norm(x), aux


def forward_hidden(model: Transformer, tokens: torch.Tensor, *,
                   patch_embeds: torch.Tensor | None = None):
    """Full-sequence forward up to the final norm, recording for
    autograd: tokens (B, S) (audio (B, K, S)) -> (x (B, S, D), aux), aux
    the MoE router's loss summed over the layers (0 without MoE).  Each
    layer runs under ``cfg.remat_policy`` (``_run_layer``)."""
    return _hidden(model, tokens, patch_embeds, model.cfg.remat_policy)


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
    """Head + cross entropy for one sequence block: x (B, s, D) and
    labels (B, s) (audio (B, K, s), the mean over the K streams) -> nll
    (B, s) fp32."""
    logits = _lm_head(model, x)
    if model.cfg.family == "audio":
        return _xent(logits, labels.movedim(1, 2)).mean(dim=-1)
    return _xent(logits, labels)


def loss_fn(model: Transformer, batch: dict):
    """Next-token cross entropy (+ ``router_aux_coef`` x aux).  ``batch``
    holds ``tokens`` and ``labels`` (B, S) (audio: (B, K, S)), optionally
    ``loss_mask`` (B, S) and, for the VLM, ``patch_embeds`` (B, P, D),
    whose positions the loss drops; tensors on the model's device.
    Returns (total, {"loss", "aux"}).  ``cfg.loss_chunks > 1`` (dividing
    S) runs the head and the cross entropy chunk by chunk along the
    sequence, each chunk under ``checkpoint``, as the JAX package's scan
    with remat does."""
    cfg = model.cfg
    if parallel.plan_of(model.embed) is not None:
        return _sharded_loss(model, batch, parallel.plan_of(model.embed))
    x, aux = forward_hidden(model, batch["tokens"],
                            patch_embeds=batch.get("patch_embeds"))
    labels = batch["labels"]
    S = labels.shape[-1]
    if cfg.family == "vlm":
        x = x[:, -S:]                            # drop patch positions
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(torch.float32)
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
            nll = checkpoint(_nll_block, model, x[:, sl], labels[..., sl],
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


def _xent_sharded(px, lg: torch.Tensor, lb: torch.Tensor,
                  vr: tuple) -> torch.Tensor:
    """``_xent`` over a vocab-parallel shard ``lg`` (..., V/tp) of the
    logits, columns ``[v0, v1)``: the max over ``model`` (no gradient),
    then the sum of exponentials and the label's logit (zero off the
    rank's columns) summed over ``model`` in one all-reduce."""
    m = px.model_max(lg.detach().amax(dim=-1))
    e = torch.exp(lg - m[..., None]).sum(dim=-1)
    inr = (lb >= vr[0]) & (lb < vr[1])
    sel = torch.gather(lg, -1, torch.where(inr, lb - vr[0], 0)[..., None]
                       .long())[..., 0]
    both = px.reduce_out(torch.stack([e, torch.where(inr, sel, 0.0)], -1))
    return m + torch.log(both[..., 0]) - both[..., 1]


def _nll_sharded(model: Transformer, w: torch.Tensor, x: torch.Tensor,
                 labels: torch.Tensor, vr) -> torch.Tensor:
    """``_nll_block`` with the fetched head weight ``w`` (vocab-parallel
    where ``vr`` is a range)."""
    logits = _lm_head(model, x, w)
    if model.cfg.family == "audio":
        labels = labels.movedim(1, 2)
    nll = (_xent(logits, labels) if vr is None
           else _xent_sharded(parallel.plan_of(model.embed), logits, labels,
                              vr))
    return nll.mean(dim=-1) if model.cfg.family == "audio" else nll


def _sharded_loss(model: Transformer, batch: dict, px):
    """``loss_fn`` of a sharded model on the rank's rows: the loss of
    the global batch (each rank's sum over the global count, summed over
    the batch axes by ``batch_sum``; the aux loss ``batch_mean``-ed)."""
    cfg = model.cfg
    table, vr = _embed_weight(model)
    x, aux = _hidden(model, batch["tokens"], batch.get("patch_embeds"),
                     cfg.remat_policy, table, vr)
    w = _head_weight(model, table, vr)
    labels = batch["labels"]
    S = labels.shape[-1]
    if cfg.family == "vlm":
        x = x[:, -S:]                            # drop patch positions
    if vr is not None:
        x = px.copy_in(x)
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask.to(torch.float32)
    lc = cfg.loss_chunks if cfg.loss_chunks > 1 and not S % \
        cfg.loss_chunks else 1
    c = S // lc
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(lc):
        sl = slice(i * c, (i + 1) * c)
        if lc == 1:
            nll = _nll_sharded(model, w, x, labels, vr)
        else:
            nll = checkpoint(_nll_sharded, model, w, x[:, sl],
                             labels[..., sl], vr, use_reentrant=False)
        if mask is None:
            tot = tot + torch.sum(nll)
            cnt = cnt + float(nll.numel())
        else:
            tot = tot + torch.sum(nll * mask[:, sl])
            cnt = cnt + torch.sum(mask[:, sl])
    loss = px.batch_sum(tot / torch.clamp(px.batch_total(cnt), min=1.0))
    if cfg.is_moe:
        aux = px.batch_mean(aux)
    total = loss + cfg.router_aux_coef * aux
    return total, {"loss": loss, "aux": aux}


def cache_specs(cfg: ModelConfig) -> list[dict]:
    """The logical axes of each layer's cache leaves, one dict a layer
    (the JAX package's ``cache_specs``, ``transformer.py:432-458`` there,
    unstacked): attention ``k``/``v`` ``("batch", "cache_seq", None,
    None)``, the ring's TIME axis over ``model`` (K/V heads rarely divide
    ``model``; positions do), ``pos`` whole; RG-LRU ``h`` ``("batch",
    "rnn")`` and ``conv`` ``("batch", None, "rnn")``, the channels the
    block computes on the rank (``models/recurrent.py``).

    RWKV-6 differs from the reference, whose ``x_prev_*`` are ``("batch",
    "rnn")`` and ``S`` ``("batch", None, None, None)``: here ``S`` is
    ``("batch", "rnn", None, None)`` (the rank's heads: its time mix runs
    ``wkv6`` on them alone) and ``x_prev_t``/``x_prev_c`` ``("batch",
    None)`` (its token shifts read the whole row).  Either of the
    reference's layouts would cost a collective a step that the layer
    does not issue.  A rank of rwkv6-1.6b (32 heads of 64, D 2048) at
    ``model`` 2 holds ``S`` of 16 heads, 262,144 bytes a row, and both
    ``x_prev`` whole, 8,192 bytes a row in bf16, where the reference's
    layout holds 524,288 and 4,096."""
    out = []
    for kind in cfg.blocks:
        if kind in ("attn", "local"):
            out.append({"k": ("batch", "cache_seq", None, None),
                        "v": ("batch", "cache_seq", None, None),
                        "pos": (None,)})
        elif kind == "rglru":
            out.append({"h": ("batch", "rnn"),
                        "conv": ("batch", None, "rnn")})
        else:
            out.append({"x_prev_t": ("batch", None),
                        "x_prev_c": ("batch", None),
                        "S": ("batch", "rnn", None, None)})
    return out


def cache_shapes(cfg: ModelConfig, batch: int, max_seq: int) -> list[dict]:
    """``{leaf: (whole shape, dtype, fill)}`` a layer: attention a ring of
    ``Lc = max_seq`` (global) or ``min(window, max_seq)`` (local) slots,
    ``pos`` -1 (empty); the recurrent states zeros
    (``models/recurrent.py``)."""
    Hkv, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dt = getattr(torch, cfg.dtype)
    out = []
    for kind in cfg.blocks:
        if kind == "rglru":
            out.append(R.rglru_state_shapes(cfg, batch))
        elif kind == "rwkv":
            out.append(R.rwkv_state_shapes(cfg, batch))
        else:
            Lc = max_seq if kind == "attn" else min(cfg.window, max_seq)
            out.append({"k": ((batch, Lc, Hkv, Dh), dt, 0),
                        "v": ((batch, Lc, Hkv, Dh), dt, 0),
                        "pos": ((Lc,), torch.int32, -1)})
    return out


def resolved_cache_specs(cfg: ModelConfig, mesh, batch: int,
                         max_seq: int) -> list[dict]:
    """``cache_specs`` on ``mesh`` (``sharding.resolve_spec`` with each
    leaf's shape: a ring whose ``Lc`` does not divide ``model``, or a
    batch that does not divide ``(pod, data)``, stays whole)."""
    return [{n: sharding.resolve_spec(spec[n], mesh, shape[n][0])
             for n in spec}
            for spec, shape in zip(cache_specs(cfg),
                                   cache_shapes(cfg, batch, max_seq))]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None, plan=None) -> list[dict]:
    """Empty caches, one dict per layer: attention a ring buffer (``k``/
    ``v`` (B, Lc, Hkv, Dh) in the model dtype, ``pos`` (Lc,) int32 of
    -1); ``rglru`` ``{"h", "conv"}`` and ``rwkv`` ``{"x_prev_t",
    "x_prev_c", "S"}``, zeros (``models/recurrent.py``).

    With ``plan`` (a sharded model's, on its device) each leaf is the
    rank's shard under ``resolved_cache_specs``: K/V ``(B/|pod data|,
    Lc/|model|, Hkv, Dh)``, its rows and its slots of the ring; ``pos``
    whole; RG-LRU's ``h``/``conv`` its channels; RWKV-6's ``S`` its heads
    and ``x_prev_*`` whole (``cache_specs``)."""
    dev = resolve_device(device) if plan is None else plan.device
    specs = None if plan is None else resolved_cache_specs(
        cfg, plan.mesh, batch, max_seq)
    caches = []
    for i, layer in enumerate(cache_shapes(cfg, batch, max_seq)):
        c = {}
        for name, (shape, dt, fill) in layer.items():
            if specs is not None:
                shape = sharding.local_shape(shape, specs[i][name],
                                             plan.sizes)
            c[name] = torch.full(shape, fill, dtype=dt, device=dev)
        caches.append(c)
    return caches


def batch_rows(plan, batch: int) -> tuple[int, int]:
    """The rows ``[r0, r1)`` of a ``batch``-row request that the rank
    serves: its block over ``(pod, data)`` (rank ``(p, d)`` block ``p
    |data| + d``), or all of them where ``batch`` does not divide
    (``cache_specs``' ``"batch"`` falls back to whole)."""
    if plan is None or batch % plan.n_batch:
        return 0, batch
    b = batch // plan.n_batch
    return plan.batch_index * b, (plan.batch_index + 1) * b


def _head_weight(model: Transformer, table, vr):
    """The head weight a sharded model computes its logits with (the
    rank's vocab columns where ``vr`` is a range; ``table.mT`` tied);
    ``None`` in one process (``_lm_head`` takes the model's own)."""
    px = parallel.plan_of(model.embed)
    if px is None:
        return None
    if model.cfg.tie_embeddings:
        return table.mT
    vdim = 2 if model.cfg.family == "audio" else 1
    return (px.fetch(model.head) if vr is None
            else px.fetch(model.head, (vdim, *vr)))


def _logits(model: Transformer, x: torch.Tensor, table, vr) -> torch.Tensor:
    """The final norm and the head on x (B, 1, D): logits fp32 (B, 1, V)
    (audio (B, 1, K, V)); a vocab-parallel shard's gathered over
    ``model``, so every rank holds the whole vocabulary of its rows."""
    logits = _lm_head(model, model.final_norm(x),
                      _head_weight(model, table, vr))
    if vr is not None:
        logits = parallel.plan_of(model.embed).gather_model(logits, -1)
    return logits


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            cache: list[dict] | None, *,
            patch_embeds: torch.Tensor | None = None):
    """Process the prompt tokens (B, S) (audio (B, K, S); VLM with
    ``patch_embeds`` (B, P, D) ahead of them, at positions 0..P-1);
    returns (last-position logits (B, V) (audio (B, K, V)) fp32, cache).
    Only the final position is projected to the vocabulary.  ``cache=None``
    runs the prompt without filling one.

    A sharded model (``init_model(..., plan=)``) takes the rank's rows
    (``batch_rows``) of ``tokens`` and ``patch_embeds`` and the rank's
    cache (``init_cache(..., plan=)``).  Its collectives
    (``training/schedule.py::prefill_collectives``): the weights' FSDP
    gathers over ``data``; the vocab-parallel lookups summed over
    ``model``; each tensor-parallel block's ``reduce_out``; where the
    heads split, one all-gather over ``model`` of the rank's K/V heads a
    layer (the cache holds every head of the rank's slots); the logits
    gathered over ``model``."""
    cfg = model.cfg
    table, vr = _embed_weight(model)
    x = _embed_tokens(model, tokens, patch_embeds, table, vr)
    positions = _positions(x.shape[0], x.shape[1], x.device)
    for i, lp in enumerate(model.layers):
        x, _ = _apply_layer(lp, cfg, x, positions,
                            None if cache is None else cache[i])
    return _logits(model, x[:, -1:], table, vr)[:, 0], cache


@torch.no_grad()
def decode_step(model: Transformer, cache: list[dict], tokens: torch.Tensor,
                pos: int):
    """One decode step: tokens (B, 1) (audio (B, K, 1)) at position
    ``pos`` (a Python int; for the VLM counting the patch positions).
    Returns (logits (B, V) (audio (B, K, V)) fp32, cache).

    A sharded model takes its rows and its cache, as ``prefill``.  Each
    attention layer runs ``layers.decode_attention``: one all-gather of
    the step's query and K/V heads over ``model`` where the heads split,
    and over a time-sharded ring an ``all_reduce_max`` and one
    ``all_reduce`` of the stacked exp-sums and partial ``P V``; the rest
    as ``prefill`` (``training/schedule.py::decode_collectives``)."""
    cfg = model.cfg
    table, vr = _embed_weight(model)
    x = _embed_tokens(model, tokens, None, table, vr)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    for i, lp in enumerate(model.layers):
        x, _ = _apply_layer(lp, cfg, x, positions, cache[i], decode_pos=pos)
    return _logits(model, x, table, vr)[:, 0], cache
