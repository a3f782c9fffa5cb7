"""Carry the JAX package's parameters (and caches) over to the port.

The JAX package keeps a model's layers as ``groups`` — one repetition of
the block pattern, stacked on a leading axis and scanned — plus a
ragged ``tail`` list (``repro/models/transformer.py:99-129``).  Layer
``g * len(pattern) + i`` of the model is entry ``g`` of ``groups["b{i}"]``
and the tail follows.  ``from_jax_params`` takes that tree as numpy
arrays (``jax.tree.map(np.asarray, params)``) and returns the state dict
of the port's ``Transformer`` (``model.load_state_dict(...)``), so both
packages can be run on the same weights.  ``jax_layers`` does the same
unstacking for any per-layer tree, such as a KV cache.

bf16 arrays (numpy's ``bfloat16`` extension type) are carried bit for
bit through an int16 view.
"""
from __future__ import annotations

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
