"""The collectives of one sharded train step, and of one sharded prefill
or decode step, predicted from the config and the mesh (the schedule
that ``collectives.record`` of a step must equal, op for op: the tests
and ``chip_smoke.py`` phase 16 hold it).  The serving steps
(``prefill_collectives``, ``decode_collectives``) issue a train step's
forward collectives once and none of its backward's, plus the K/V
gathers, the decode attention's reductions and the logits' gather their
docstrings list.

``step_collectives`` returns a ``Counter`` of ``(op, shape, dtype,
axes)``: ``op`` one of ``all_gather``, ``reduce_scatter``,
``all_reduce``, ``all_reduce_max``; ``shape`` the payload one rank hands
the collective (a gather or scatter along dim ``i`` moves ``i`` to the
front); ``axes`` the mesh axes of its group.  Axes of size 1 issue
nothing.  The rules, per microbatch:

* a weight (``Plan.fetch``): each ``data``-sharded dim gathered
  (``all_gather`` forward, ``reduce_scatter`` backward; the MoE's
  ``w_out`` keeps its shard); its ``model`` dim kept where the rank's
  part is its shard, else gathered whole for a replicated layer
  (forward only), or a replicated weight cut after ``copy_in``
  (``all_reduce`` of its gradient over ``model``);
* a tensor-parallel layer: ``copy_in`` of its input (an ``all_reduce``
  of the input's gradient) and ``reduce_out`` of its output (an
  ``all_reduce`` forward); RG-LRU's ``w_a``/``w_i`` products one
  ``reduce_scatter`` forward / ``all_gather`` backward; the MoE's output
  summed over ``model`` and gathered over ``data``; RWKV-6's receptance
  gathered over ``model`` (forward only);
* the embedding's lookups summed over ``model``; the head's input
  ``copy_in``; each loss chunk one ``all_reduce_max`` and one
  ``all_reduce`` of (sum of exponentials, label logit); the loss's count
  and value summed over the batch axes, the MoE aux loss likewise;
* every forward collective inside ``checkpoint`` issued again by the
  backward's recompute of the region (early stop off): a layer's
  ``REMAT_FORWARDS[remat_policy]`` times in all ("full" recomputes the
  whole layer; "minimal" saves only ``aten.mm``/``addmm`` outputs, and
  a collective is no such op, so its recompute re-issues every FSDP
  gather, ``reduce_out`` and ``scatter_model`` as "full" does and no
  rank holds a gathered weight between the passes); each loss chunk's
  twice when ``loss_chunks > 1``;

and once a step: each gradient all-reduced over the batch axes its spec
does not shard (fp32 after microbatches, else the parameter's dtype),
and the squared norm over every axis.

With ``compression`` (``optim/compression.py`` on the mesh), after the
sync (over ``data`` only on a mesh with ``pod``: each pod its own
gradient), each compressed leaf (``models.convert.leaf_layout`` with
its spec) issues, in fp32 at ``r = min(rank, q)``: ``M Q``'s partial ``(p_loc,
r)`` all-reduced over its last dim's axes (+ ``pod``), ``P`` gathered
over each sharded leading dim in turn (``Plan.unshard`` of ``(*lead_loc,
r)``), ``M^T P``'s partial ``(q_loc, r)`` all-reduced over the leading
dims' axes (+ ``pod``) and gathered over the last dim's; with ``pod``,
each uncompressed leaf is all-reduced whole over ``pod``.
``pod_bytes`` sums a schedule's payloads on groups that span ``pod``:
what crosses the pods a step, a rank.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch import sharding
from repro_torch.models import convert as LV
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import capacity
from repro_torch.models.recurrent import LORA
from repro_torch.optim import compression as comp

F32 = "float32"

#: how many times a step issues each forward collective of a layer, by
#: ``remat_policy``: once, plus once more in the recompute wherever the
#: layer runs under ``checkpoint``
REMAT_FORWARDS = {"none": 1, "minimal": 2, "full": 2}


def _name(dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


class _Schedule:
    """The collectives of a sharded model's passes, built rule by rule;
    ``grad`` adds the backward's (a train step), else a forward under
    ``no_grad`` (prefill, decode)."""

    def __init__(self, cfg: ModelConfig, mesh, grad: bool):
        self.cfg, self.grad = cfg, grad
        self.sizes = sharding.mesh_axes(mesh)
        self.names = tuple(self.sizes)
        self.tp = self.sizes["model"]
        self.model = T.Transformer(cfg, torch.device("meta"))
        self.params = dict(self.model.named_parameters())
        self.specs = T.resolved_specs(cfg, self.sizes)
        self.dt = cfg.dtype
        self.out: Counter = Counter()

    def count(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def add(self, op, shape, dtype, axes, n=1):
        if self.count(axes) > 1 and n:
            label = "+".join(a for a in self.names if a in tuple(axes))
            self.out[(op, tuple(shape), dtype, label)] += n

    @staticmethod
    def moved(shape, i):
        return [shape[i]] + shape[:i] + shape[i + 1:]

    def split(self, n):
        return (0, n // self.tp) if n % self.tp == 0 else None

    def fetch(self, name, need=None, fwd=1, fsdp=True):
        spec, p = self.specs[name], self.params[name]
        pdt = _name(p.dtype)
        cur = list(sharding.local_shape(tuple(p.shape), spec, self.sizes))
        mdim = None
        for i in range(p.ndim):
            axes = sharding.dim_axes(spec, i)
            if "model" in axes:
                mdim = i
            elif axes and fsdp:
                self.add("all_gather", self.moved(cur, i), pdt, axes, fwd)
                cur[i] *= self.count(axes)
                if self.grad:
                    self.add("reduce_scatter", self.moved(cur, i), pdt, axes)
        if need is None:
            if mdim is not None:
                self.add("all_gather", self.moved(cur, mdim), pdt,
                         ("model",), fwd)
        elif mdim is None:
            if self.grad:
                self.add("all_reduce", cur, pdt, ("model",))
        elif not (mdim == need[0] and need[2] - need[1] == cur[mdim]):
            self.add("all_gather", self.moved(cur, mdim), pdt, ("model",),
                     fwd)
            cur[mdim] *= self.tp
            if self.grad:
                self.add("reduce_scatter", self.moved(cur, mdim), pdt,
                         ("model",))

    def copy_in(self, shape, dtype=None):
        if self.grad:
            self.add("all_reduce", shape, dtype or self.dt, ("model",))

    def reduce_out(self, shape, fwd, dtype=None):
        self.add("all_reduce", shape, dtype or self.dt, ("model",), fwd)

    def attention(self, pre, rows, L, f, mode, Lc):
        """An attention block: ``mode`` "train", "prefill" (the cache's
        K/V heads gathered) or "decode" (``Lc`` the ring's slots)."""
        cfg = self.cfg
        H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        G, hq = H // Hkv, H // self.tp
        tp_attn = H % self.tp == 0 and (hq % G == 0 or G % hq == 0)
        ws = ["wq", "wk", "wv", "wo"] + (["q_norm", "k_norm"]
                                         if cfg.qk_norm else [])
        act = [rows, L, cfg.d_model]
        if tp_attn:
            nk = hq // G if hq % G == 0 else 1
            need = {"wq": (1, 0, hq), "wk": (1, 0, nk), "wv": (1, 0, nk),
                    "wo": (0, 0, hq), "q_norm": (0, 0, Dh),
                    "k_norm": (0, 0, Dh)}
            if mode != "decode":
                self.copy_in(act)
            for w in ws:
                self.fetch(pre + "mix." + w, need[w], f)
            if mode == "prefill":
                self.add("all_gather", [2 * nk, rows, L, Dh], self.dt,
                         ("model",))
            if mode == "decode":
                self.add("all_gather", [hq + 2 * nk, rows, L, Dh], self.dt,
                         ("model",))
        else:
            for w in ws:
                self.fetch(pre + "mix." + w, None, f)
        if mode == "decode" and Lc % self.tp == 0:    # a time-sharded ring
            self.add("all_reduce_max", [rows, H, L], F32, ("model",))
            self.add("all_reduce", [rows, H, L, Dh + 1], F32, ("model",))
        if tp_attn:
            self.reduce_out(act, f)

    def layer(self, n, kind, rows, L, f, mode="train", max_seq=0):
        """Layer ``n``'s collectives on ``rows`` x ``L`` tokens, its
        forward ones ``f`` times."""
        cfg = self.cfg
        fetch, copy_in, reduce_out, split, add = (
            self.fetch, self.copy_in, self.reduce_out, self.split, self.add)
        D, dt, tp = cfg.d_model, self.dt, self.tp
        act = [rows, L, D]
        pre = f"layers.{n}."
        fetch(pre + "norm1.scale", fwd=f)
        if kind in ("attn", "local"):
            self.attention(pre, rows, L, f, mode, max_seq if kind == "attn"
                           else min(cfg.window, max_seq))
        elif kind == "rglru":
            R = cfg.resolved_rnn_width
            c = split(R)
            if c is None:
                for w in ("w_x", "w_gate", "conv", "w_a", "w_i", "lam",
                          "w_out"):
                    fetch(pre + "mix." + w, None, f)
            else:
                copy_in(act)
                for w in ("w_x", "w_gate", "conv"):
                    fetch(pre + "mix." + w, (1, *c), f)
                for w in ("w_a", "w_i", "lam", "w_out"):
                    fetch(pre + "mix." + w, (0, *c), f)
                add("reduce_scatter", [R, 2, rows, L], dt, ("model",), f)
                if self.grad:
                    add("all_gather", [R // tp, 2, rows, L], dt, ("model",))
                reduce_out(act, f)
        else:                                        # rwkv time mix
            hd = cfg.rwkv_head_dim
            fetch(pre + "ffn.mu", None, f)
            fetch(pre + "ffn.w_lora_a", None, f)
            c = split(D)
            if c is None or c[1] % hd:
                for w in ("w_r", "w_k", "w_v", "w_g", "w_lora_b", "w0", "u",
                          "w_o"):
                    fetch(pre + "ffn." + w, None, f)
            else:
                for _ in range(4):                   # xr, xk, xv, xg
                    copy_in(act)
                copy_in([rows, L, LORA])
                for w in ("w_r", "w_k", "w_v", "w_g", "w_lora_b"):
                    fetch(pre + "ffn." + w, (1, *c), f)
                for w in ("w0", "u"):
                    fetch(pre + "ffn." + w, (0, 0, c[1] // hd), f)
                fetch(pre + "ffn.w_o", (0, *c), f)
                reduce_out(act, f)
        if cfg.post_block_norm:
            fetch(pre + "norm1_post.scale", fwd=f)
        fetch(pre + "norm2.scale", fwd=f)
        if kind == "rwkv":                           # channel mix
            fetch(pre + "ffn.c_mu", None, f)
            c = split(cfg.d_ff)
            if c is None:
                fetch(pre + "ffn.c_k", None, f)
                fetch(pre + "ffn.c_v", None, f)
            else:
                copy_in(act)
                fetch(pre + "ffn.c_k", (1, *c), f)
                fetch(pre + "ffn.c_v", (0, *c), f)
                reduce_out(act, f)
            c = split(D)
            if c is None:
                fetch(pre + "ffn.c_r", None, f)
            else:
                copy_in(act)
                fetch(pre + "ffn.c_r", (1, *c), f)
                add("all_gather", [D // tp, rows, L], dt, ("model",), f)
        elif cfg.is_moe:
            E = cfg.num_experts
            c = split(cfg.d_ff)
            fetch(pre + "ffn.router", None, f)
            fetch(pre + "ffn.w_gate", (2, *c), f)
            fetch(pre + "ffn.w_in", (2, *c), f)
            fetch(pre + "ffn.w_out", (1, *c), f, fsdp=False)
            copy_in(act)
            C = capacity(cfg, rows * L)
            daxes = sharding.dim_axes(self.specs[pre + "ffn.w_out"], 2)
            dl = D // self.count(daxes)
            reduce_out([E, C, dl], f)
            add("all_gather", [dl, E, C], dt, daxes, f)
            if self.grad:
                add("reduce_scatter", [D, E, C], dt, daxes)
        else:
            c = split(cfg.d_ff)
            ws = ["w_in", "w_out"] + (["w_gate"] if cfg.mlp_variant == "glu"
                                      else [])
            if c is None:
                for w in ws:
                    fetch(pre + "ffn." + w, None, f)
            else:
                copy_in(act)
                for w in ws:
                    fetch(pre + "ffn." + w, (0 if w == "w_out" else 1, *c),
                          f)
                reduce_out(act, f)
        if cfg.post_block_norm:
            fetch(pre + "norm2_post.scale", fwd=f)

    def vocab(self):
        """(the rank's vocab range or ``None``, the vocab-sharded dim of
        the embedding, of the head)."""
        audio = self.cfg.family == "audio"
        return self.split(self.cfg.vocab_size), 1 if audio else 0, \
            2 if audio else 1

    def embed(self, rows, seq):
        vr, edim, _ = self.vocab()
        self.fetch("embed", None if vr is None else (edim, *vr))
        if vr is not None:
            self.reduce_out([rows, seq, self.cfg.d_model], 1)

    def head(self):
        vr, _, hdim = self.vocab()
        self.fetch("final_norm.scale")
        if not self.cfg.tie_embeddings:
            self.fetch("head", None if vr is None else (hdim, *vr))


def step_collectives(cfg: ModelConfig, mesh, rows: int, seq: int,
                     microbatches: int = 1,
                     compression: comp.CompressionConfig | None = None
                     ) -> Counter:
    """The collectives a rank issues in one step of ``make_train_step(cfg,
    tc, mesh)``: ``rows`` the rank's rows of a microbatch, ``seq`` the
    labels' length (VLM: the patch positions come on top);
    ``compression`` is ``tc.compression``."""
    sc = _Schedule(cfg, mesh, grad=True)
    sizes, names, add = sc.sizes, sc.names, sc.add
    compress = compression is not None and compression.enabled
    per_pod = compress and "pod" in sizes
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    params, specs = sc.params, sc.specs
    L = seq + (cfg.patch_positions if cfg.family == "vlm" else 0)
    f = REMAT_FORWARDS[cfg.remat_policy]
    audio = cfg.family == "audio"
    vr = sc.vocab()[0]
    K = cfg.num_codebooks
    for _ in range(microbatches):
        sc.embed(rows, seq)
        for n, kind in enumerate(cfg.blocks):
            sc.layer(n, kind, rows, L, f)
        sc.head()
        lc = cfg.loss_chunks if cfg.loss_chunks > 1 and \
            not seq % cfg.loss_chunks else 1
        if vr is not None:
            sc.copy_in([rows, seq, cfg.d_model])
            per = [rows, seq // lc] + ([K] if audio else [])
            fc = 2 if lc > 1 else 1
            add("all_reduce_max", per, F32, ("model",), fc * lc)
            add("all_reduce", per + [2], F32, ("model",), fc * lc)
        add("all_reduce", [], F32, batch_axes, 2)      # count, loss
        if cfg.is_moe:
            add("all_reduce", [], F32, batch_axes)     # aux
    sync = ("data",) if per_pod else batch_axes
    for name, p in params.items():
        spec = specs[name]
        held = {a for i in range(len(spec))
                for a in sharding.dim_axes(spec, i)}
        axes = tuple(a for a in sync if a not in held)
        add("all_reduce", sharding.local_shape(tuple(p.shape), spec, sizes),
            F32 if microbatches > 1 else _name(p.dtype), axes)
    if compress:
        pod = ("pod",) if per_pod else ()
        for leaf in LV.leaf_layout(sc.model, specs, sizes):
            loc = list(leaf.local_shape)
            if not comp.compressed(leaf, compression):
                add("all_reduce", loc, F32 if microbatches > 1 else
                    _name(params[leaf.names[0]].dtype), pod)
                continue
            nd, r = leaf.ndim, min(compression.rank, leaf.shape[-1])
            lead = tuple(a for i in range(nd - 1)
                         for a in sharding.dim_axes(leaf.spec, i))
            last = sharding.dim_axes(leaf.spec, nd - 1)
            add("all_reduce", [math.prod(loc[:-1]), r], F32, last + pod)
            cur = loc[:-1] + [r]
            for i in range(nd - 1):
                axes = sharding.dim_axes(leaf.spec, i)
                if axes:
                    add("all_gather", sc.moved(cur, i), F32, axes)
                    cur[i] *= sc.count(axes)
            add("all_reduce", [loc[-1], r], F32, lead + pod)
            add("all_gather", [loc[-1], r], F32, last)
    add("all_reduce", [], F32, names)                  # the norm
    return sc.out


def _serve(cfg: ModelConfig, mesh, rows: int, seq: int, max_seq: int,
           mode: str) -> Counter:
    sc = _Schedule(cfg, mesh, grad=False)
    L = seq + (cfg.patch_positions if cfg.family == "vlm"
               and mode == "prefill" else 0)
    sc.embed(rows, seq)
    for n, kind in enumerate(cfg.blocks):
        sc.layer(n, kind, rows, L, 1, mode, max_seq)
    sc.head()
    vr = sc.vocab()[0]
    if vr is not None:                   # the logits gathered over model
        sc.add("all_gather", [vr[1], rows, 1] + (
            [cfg.num_codebooks] if cfg.family == "audio" else []), F32,
            ("model",))
    return sc.out


def prefill_collectives(cfg: ModelConfig, mesh, rows: int, prompt: int,
                        max_seq: int) -> Counter:
    """The collectives a rank issues in one ``transformer.prefill`` of a
    sharded model: ``rows`` its rows, ``prompt`` the tokens' length (the
    VLM's patch positions come on top), ``max_seq`` the positions its
    cache was made for (``init_cache``'s, the VLM's patches included).
    The forward's fetches and ``reduce_out``s of a train step, once;
    where the heads split, one ``all_gather`` of the rank's K/V heads
    ``(2 nk, rows, L, Dh)`` over ``model`` a layer; the logits gathered
    over ``model``."""
    return _serve(cfg, mesh, rows, prompt, max_seq, "prefill")


def decode_collectives(cfg: ModelConfig, mesh, rows: int,
                       max_seq: int) -> Counter:
    """The collectives a rank issues in one ``transformer.decode_step``:
    as ``prefill_collectives`` on one token, but each attention layer
    gathers its query and K/V heads ``(hq + 2 nk, rows, 1, Dh)`` where
    the heads split, and over a time-sharded ring (``Lc`` divides
    ``model``) issues an ``all_reduce_max`` of ``(rows, H, 1)`` and one
    ``all_reduce`` of the stacked ``(rows, H, 1, Dh + 1)`` (partial
    ``P V`` and exp-sums), both fp32."""
    return _serve(cfg, mesh, rows, 1, max_seq, "decode")


def pod_bytes(schedule: Counter) -> int:
    """The bytes a rank hands collectives whose group spans ``pod``, over
    a schedule (``step_collectives`` or ``record_counter``)."""
    return sum(n * math.prod(shape) * getattr(torch, dtype).itemsize
               for (op, shape, dtype, axes), n in schedule.items()
               if "pod" in axes.split("+"))


def record_counter(record: list) -> Counter:
    """``collectives.record`` in ``step_collectives``'s form."""
    return Counter((c["op"], tuple(c["shape"]), c["dtype"],
                    c.get("axes", "")) for c in record)
