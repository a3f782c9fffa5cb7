"""Carry the JAX package's parameters (and caches) over to the port.

The JAX package keeps a model's layers as ``groups`` — one repetition of
the block pattern, stacked on a leading axis and scanned — plus a
ragged ``tail`` list (``repro/models/transformer.py:99-129``).  Layer
``g * len(pattern) + i`` of the model is entry ``g`` of ``groups["b{i}"]``
and the tail follows.  ``from_jax_params`` takes that tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the state dict
of the port's ``Transformer`` (``model.load_state_dict(...)``), so both
packages can be run on the same weights.  ``jax_layers`` does the same
unstacking for any per-layer tree; ``from_jax_cache`` / ``to_jax_cache``
carry a KV cache each way, and ``shard_cache`` / ``unshard_cache`` cut a
whole cache into a rank's shards under ``transformer.cache_specs`` and
gather it back.

bf16 arrays (numpy's ``bfloat16`` extension type) are carried bit for
bit through an int16 view.  ``from_jax_params`` maps any tree of the
parameters' structure the same way: gradients and optimizer moments too.

The other direction, for training: ``leaf_layout(model)`` lists the JAX
package's leaves over the port's parameters, in its flattening order
(dict keys sorted).  Two things in training depend on those leaves and
not on the port's per-layer tensors:

* AdamW decays a leaf when ``ndim >= 2`` (``repro/optim/adamw.py:83``).
  A stacked norm scale ``(n_groups, D)`` is decayed; its per-layer
  tensor ``(D,)`` here is 1-D.  ``final_norm.scale`` ``(D,)`` is not
  decayed, nor, with ``scan_layers=False``, any per-layer ``(D,)``
  (``decayed`` gives the set).
* The gradient compression factors each stacked leaf as one matrix
  (every leading dim collapsed, ``repro/optim/compression.py:44``): one
  ``(28 * 1024 * 16, 128)`` matrix for qwen3-0.6b's ``wq``, not 28.

Each ``Leaf`` names its JAX path (``"groups/b0/mix/wq"``), the port's
parameters it stacks (one per group, in group order; one for an
unstacked leaf) and its JAX shape.  ``gather`` stacks a leaf from a dict
of per-parameter tensors, ``scatter`` splits a stacked value back.  Over
a mesh (a sharded model's parameters carry ``.spec`` and ``.plan``, or
the caller gives ``specs`` and the mesh's ``sizes``) a leaf also carries
its spec (the stacked ``"layers"`` dim never sharded, then its
parameters') and the shape of one rank's stack of shards; ``shape``
stays the whole leaf's, as the JAX package's global arrays.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


def group_layout(cfg: ModelConfig):
    """(pattern, n_groups, tail_kinds) of the JAX package's tree."""
    pat = cfg.block_pattern
    if not cfg.scan_layers:
        return pat, 0, cfg.blocks
    n_groups = cfg.num_layers // len(pat)
    return pat, n_groups, cfg.blocks[n_groups * len(pat):]


def _to_tensor(a) -> torch.Tensor:
    """A numpy array (bf16 included) as a torch tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def jax_layers(tree: dict, cfg: ModelConfig) -> list:
    """The per-layer entries of a JAX ``groups``/``tail`` tree, in layer
    order."""
    pat, n_groups, tail = group_layout(cfg)
    out = [_index(tree["groups"][f"b{i}"], g)
           for g in range(n_groups) for i in range(len(pat))]
    out += list(tree.get("tail", []))
    if len(out) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: the tree holds {len(out)} layers, "
                         f"the config {cfg.num_layers}")
    return out


def _flatten(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        elif v is not None:
            out[prefix + k] = _to_tensor(v)


def from_jax_params(np_tree: dict, cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree (numpy leaves) as the state dict
    of ``repro_torch.models.transformer.Transformer``."""
    state: dict = {}
    _flatten({k: v for k, v in np_tree.items()
              if k not in ("groups", "tail")}, "", state)
    for n, layer in enumerate(jax_layers(np_tree, cfg)):
        _flatten(layer, f"layers.{n}.", state)
    return state


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str                    # the JAX tree path, "/"-joined
    names: tuple[str, ...]       # the port's parameters, in group order
    stacked: bool                # a leading group axis over ``names``
    shape: tuple[int, ...]       # the JAX leaf's shape
    spec: tuple = ()             # over a mesh: one entry a dim
    shard: tuple | None = None   # over a mesh: a rank's stack of shards

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def local_shape(self) -> tuple[int, ...]:
        return self.shape if self.shard is None else self.shard


def _sort_key(parts: tuple):
    # JAX sorts dict keys as strings and keeps list order (the tail)
    return tuple((0, p) if isinstance(p, int) else (1, p) for p in parts)


def leaf_layout(model, specs: dict | None = None,
                sizes: dict | None = None) -> list[Leaf]:
    """The JAX package's leaves over ``model``'s parameters, in its
    flattening order; with each leaf's spec and shard shape where the
    parameters carry their plan (or ``specs`` and ``sizes`` are given for
    a whole model)."""
    from repro_torch import sharding
    cfg = model.cfg
    pat, n_groups, tail = group_layout(cfg)
    params = dict(model.named_parameters())
    shapes = {n: tuple(p.shape) for n, p in params.items()}
    plan = next((p.plan for p in params.values()
                 if getattr(p, "plan", None) is not None), None)
    local = plan is not None
    if local:
        specs, sizes = {n: p.spec for n, p in params.items()}, plan.sizes

    def count(spec, i):
        return math.prod(sizes[a] for a in sharding.dim_axes(spec, i))

    def placed(names, stacked, shape):
        """(the whole leaf's shape, its spec, a rank's stack of shards)"""
        if specs is None:
            return shape, (), None
        spec = tuple(specs[names[0]])
        lead = (None,) if stacked else ()
        spec = lead + spec + (None,) * (len(shape) - len(lead) - len(spec))
        if local:
            return tuple(n * count(spec, i) for i, n in enumerate(shape)), \
                spec, shape
        return shape, spec, sharding.local_shape(shape, spec, sizes)
    entries = []
    for name in ("embed", "final_norm.scale", "head"):
        if name in shapes:
            entries.append((tuple(name.split(".")), (name,), False,
                            shapes[name]))
    per_layer = lambda n: [key.split(".", 2)[2] for key in shapes
                           if key.startswith(f"layers.{n}.")]
    for i in range(len(pat)):
        for sub in per_layer(i):
            names = tuple(f"layers.{g * len(pat) + i}.{sub}"
                          for g in range(n_groups))
            if names:
                entries.append((("groups", f"b{i}", *sub.split(".")), names,
                                True, (n_groups, *shapes[names[0]])))
    for t in range(len(tail)):
        n = n_groups * len(pat) + t
        for sub in per_layer(n):
            name = f"layers.{n}.{sub}"
            entries.append((("tail", t, *sub.split(".")), (name,), False,
                            shapes[name]))
    entries.sort(key=lambda e: _sort_key(e[0]))
    return [Leaf("/".join(str(p) for p in parts), names, stacked,
                 *placed(names, stacked, shape))
            for parts, names, stacked, shape in entries]


def gather(leaf: Leaf, tensors: dict) -> torch.Tensor:
    """The leaf's value from per-parameter ``tensors`` (stacked: a new
    tensor; else the tensor itself)."""
    if leaf.stacked:
        return torch.stack([tensors[n] for n in leaf.names])
    return tensors[leaf.names[0]]


def scatter(leaf: Leaf, value: torch.Tensor) -> dict:
    """``{name: tensor}`` of a leaf's value (views of ``value``)."""
    if leaf.stacked:
        return dict(zip(leaf.names, value.unbind(0)))
    return {leaf.names[0]: value}


def shard_params(full: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's shards, on ``mesh`` (a ``DeviceMesh``, or its
    ``core/parallel.Plan``), of a whole model: the JAX package's
    parameter tree (numpy leaves) or a port state dict (``{name:
    tensor}``); ``{name: tensor}`` on the mesh's device."""
    from repro_torch.core.parallel import Plan
    from repro_torch.models.transformer import resolved_specs
    plan = mesh if isinstance(mesh, Plan) else Plan(mesh)
    if "groups" in full or "tail" in full or any(
            isinstance(v, dict) for v in full.values()):
        full = from_jax_params(full, cfg)
    specs = resolved_specs(cfg, plan.mesh)
    return {n: plan.shard(torch.as_tensor(t), specs[n]).to(
        plan.device).contiguous() for n, t in full.items()}


def gather_params(shards: dict, plan) -> dict:
    """The whole model from every rank's shards (``{name: tensor}`` whose
    tensors carry ``.spec``, as a sharded model's parameters do, or a
    module): the inverse of ``shard_params``, by all-gathers through
    ``core/collectives.py`` on every rank."""
    if isinstance(shards, torch.nn.Module):
        shards = dict(shards.named_parameters())
    return {n: plan.unshard(t, t.spec) for n, t in shards.items()}


def from_jax_cache(np_tree: dict, cfg: ModelConfig) -> list[dict]:
    """The JAX package's cache (``init_cache``'s ``{"groups", "tail"}``
    tree, numpy leaves, stacked by ``group_layout``) as the port's
    per-layer list of ``{leaf: tensor}`` (``transformer.init_cache``)."""
    return [{k: _to_tensor(v) for k, v in layer.items()}
            for layer in jax_layers(np_tree, cfg)]


def to_jax_cache(cache: list, cfg: ModelConfig) -> dict:
    """The port's per-layer cache in the JAX package's ``{"groups",
    "tail"}`` layout: each group leaf the layers' tensors stacked in
    group order, the tail a list (torch tensors; ``np.asarray`` each
    for the JAX package)."""
    pat, n_groups, tail = group_layout(cfg)
    if len(cache) != cfg.num_layers:
        raise ValueError(f"{cfg.name}: {len(cache)} layer caches, the "
                         f"config has {cfg.num_layers} layers")
    out: dict = {}
    if n_groups:
        out["groups"] = {f"b{i}": {k: torch.stack(
            [cache[g * len(pat) + i][k] for g in range(n_groups)])
            for k in cache[i]} for i in range(len(pat))}
    if tail:
        out["tail"] = list(cache[n_groups * len(pat):])
    return out


def shard_cache(full: list, cfg: ModelConfig, plan) -> list[dict]:
    """This rank's shards of a whole cache (the port's per-layer list)
    under ``transformer.cache_specs`` on ``plan`` (a
    ``core/parallel.Plan``), on its device: what ``init_cache(...,
    plan=)`` holds."""
    from repro_torch import sharding
    from repro_torch.models.transformer import cache_specs
    return [{k: plan.shard(t, sharding.resolve_spec(
        spec[k], plan.mesh, tuple(t.shape))).to(plan.device).contiguous()
        for k, t in layer.items()}
        for layer, spec in zip(full, cache_specs(cfg))]


def unshard_cache(cache: list, cfg: ModelConfig, plan, batch: int,
                  max_seq: int) -> list[dict]:
    """The whole cache of a ``batch``-row, ``max_seq``-position request
    from every rank's shards (``init_cache(..., plan=)``'s): the inverse
    of ``shard_cache``, by all-gathers through ``core/collectives.py`` on
    every rank."""
    from repro_torch.models.transformer import resolved_cache_specs
    specs = resolved_cache_specs(cfg, plan.mesh, batch, max_seq)
    return [{k: plan.unshard(t, spec[k]) for k, t in layer.items()}
            for layer, spec in zip(cache, specs)]


def decayed(layout: list[Leaf]) -> set[str]:
    """The port's parameters that AdamW decays: those of the leaves
    with ``ndim >= 2``."""
    return {n for leaf in layout if leaf.ndim >= 2 for n in leaf.names}
