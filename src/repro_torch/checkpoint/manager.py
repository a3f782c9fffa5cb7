"""Atomic checkpointing (PyTorch port of ``repro/checkpoint/manager.py``).

* **atomicity** — a step is written to ``step_XXXXXXXX.tmp``, its files
  and the directory fsynced, then published with one ``os.replace``; an
  existing step is moved aside, never deleted first, so a crash at any
  point leaves the old step, the new one, or a ``.tmp``/``.old``
  leftover that ``all_steps`` ignores;
* **retention** — keeps the newest ``keep`` steps;
* **quarantine** — a step whose files are unreadable is renamed
  ``step_XXXXXXXX.corrupt`` (``.corrupt1``, ... on collision) so resume
  never offers it again and the evidence survives.

The on-disk format is the JAX package's, letter for letter, so either
package reads the other's step directories: ``arrays.npz`` holds the
leaves under the keys ``jax.tree_util`` paths print as (``['Q']`` for a
dict key, ``[0]`` for a sequence index, joined by ``/``; dict keys in
sorted order), and ``meta.json`` holds ``{"step", "keys", "extra"}``.
Leaves are numpy arrays or torch tensors (any device; a bf16 tensor is
saved as fp32, losslessly, and cast back on restore).
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile

import numpy as np
import torch

from repro_torch.core.errors import CheckpointCorruptError
from repro_torch.core.faults import fault_hook

#: error classes that mean "this step's files are unreadable" (truncated
#: zip, torn JSON, missing member) as opposed to a caller bug
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, EOFError,
                   json.JSONDecodeError, zipfile.BadZipFile)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:            # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flatten(tree, path=()):
    """``(keys, leaves)`` of a tree of dicts, lists and tuples, in the
    order and with the key strings of ``jax.tree_util``: dict keys
    sorted; ``None`` holds no leaf."""
    if tree is None:
        return [], []
    if isinstance(tree, dict):
        items = [(f"[{key!r}]", tree[key]) for key in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        return ["/".join(path)], [tree]
    keys, leaves = [], []
    for name, sub in items:
        k, v = _flatten(sub, path + (name,))
        keys += k
        leaves += v
    return keys, leaves


def _unflatten(like, leaves):
    """A tree of ``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array ``arrays.npz`` stores (bf16 as fp32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _restore_leaf(a: np.ndarray, like):
    """The saved array in the container and dtype of the template leaf:
    numpy stays numpy (64-bit kept), a tensor is rebuilt on its device."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.asarray(a)).to(dtype=like.dtype,
                                                  device=like.device)
    return np.asarray(a).astype(np.asarray(like).dtype)


def _placements(like, shardings) -> list:
    """One ``(mesh, placements)`` pair or ``None`` per leaf of ``like``,
    in flatten order, from ``shardings`` (a tree matching ``like``, with
    pairs or ``None`` at its leaves, or ``None`` for a whole subtree)."""
    from torch.distributed.device_mesh import DeviceMesh
    if like is None:
        return []
    if shardings is None:
        return [None] * len(_flatten(like)[1])
    if isinstance(shardings, tuple) and len(shardings) == 2 and \
            isinstance(shardings[0], DeviceMesh):
        if isinstance(like, (dict, list, tuple)):
            raise ValueError("a (mesh, placements) pair places one leaf, "
                             "not a subtree")
        return [shardings]
    if isinstance(like, dict) and isinstance(shardings, dict) and \
            like.keys() == shardings.keys():
        return [p for key in sorted(like)
                for p in _placements(like[key], shardings[key])]
    if isinstance(like, (list, tuple)) and \
            isinstance(shardings, (list, tuple)) and \
            len(like) == len(shardings):
        return [p for a, b in zip(like, shardings)
                for p in _placements(a, b)]
    raise ValueError(f"shardings does not match the tree it restores: "
                     f"{type(shardings).__name__} against "
                     f"{type(like).__name__}")


def _place(leaf, mesh, placements):
    """A restored leaf distributed over ``mesh`` as ``placements`` say, on
    the mesh's device."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import mesh_device
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(leaf))
    return distribute_tensor(t.to(mesh_device(mesh)), mesh, list(placements))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore ------------------------------------------------------

    def save(self, step: int, state, extra: dict | None = None) -> str:
        """Persist ``state`` (a tree of arrays) atomically as step
        ``step``; ``extra`` (JSON-serializable) rides in ``meta.json``
        (``read_meta(step)["extra"]``).  The tmp dir is written and
        fsynced before the one ``os.replace`` that publishes it."""
        keys, vals = _flatten(state)
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        shutil.rmtree(tmp, ignore_errors=True)   # clobber a stale tmp
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: _host(v) for k, v in zip(keys, vals)})
        meta = {"step": step, "keys": keys}
        if extra is not None:
            meta["extra"] = extra
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_file(os.path.join(tmp, "arrays.npz"))
        _fsync_dir(tmp)
        # chaos site: "crashed after writing the tmp but before publishing"
        fault_hook("checkpoint_write", None)
        old = None
        if os.path.exists(final):
            # move the previous copy aside instead of deleting it, so some
            # intact copy exists at every instant
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
        os.replace(tmp, final)          # atomic publish
        _fsync_dir(self.dir)
        if old is not None:
            shutil.rmtree(old, ignore_errors=True)
        self._gc()
        return final

    def read_meta(self, step: int) -> dict:
        """The step's ``meta.json``; a missing, torn or foreign file
        raises ``CheckpointCorruptError`` so resume can quarantine it."""
        path = os.path.join(self._step_dir(step), "meta.json")
        try:
            with open(path) as f:
                meta = json.load(f)
        except _CORRUPT_ERRORS as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable meta.json at {path!r} "
                f"({type(e).__name__}: {e})") from e
        if not isinstance(meta, dict) or "keys" not in meta:
            raise CheckpointCorruptError(
                f"step {step}: meta.json at {path!r} parsed but is not a "
                f"checkpoint manifest (missing 'keys')")
        return meta

    def quarantine(self, step: int) -> str:
        """Rename a corrupt step out of the resume path (``.corrupt``,
        suffix-numbered on collision); returns the new path."""
        src = self._step_dir(step)
        dst = src + ".corrupt"
        i = 1
        while os.path.exists(dst):
            dst = f"{src}.corrupt{i}"
            i += 1
        os.replace(src, dst)
        return dst

    def restore(self, step: int, like, shardings=None):
        """Restore into the structure, containers and dtypes of ``like``
        (a matching tree).  Unreadable files raise
        ``CheckpointCorruptError``.

        ``shardings`` places the restored arrays on a device mesh (elastic
        restore onto whatever mesh the new job has): a tree matching
        ``like`` whose leaves are ``(mesh, placements)`` pairs — that leaf
        comes back as a ``DTensor`` through ``distribute_tensor`` (every
        rank of the mesh makes the call) — or ``None``, a plain leaf as
        without ``shardings``; ``None`` in place of a subtree covers all
        of it."""
        path = self._step_dir(step)
        keys, likes = _flatten(like)
        try:
            with np.load(os.path.join(path, "arrays.npz")) as data:
                arrays = [data[k] for k in keys]
        except _CORRUPT_ERRORS as e:
            raise CheckpointCorruptError(
                f"step {step}: unreadable arrays.npz under {path!r} "
                f"({type(e).__name__}: {e}) — truncated write or disk "
                f"corruption") from e
        leaves = [_restore_leaf(a, v) for a, v in zip(arrays, likes)]
        if shardings is not None:
            leaves = [a if s is None else _place(a, *s) for a, s in
                      zip(leaves, _placements(like, shardings))]
        return _unflatten(like, leaves)

    def restore_latest(self, like, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, like, shardings)

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
