"""Device meshes over ``torch.distributed`` (the port of
``repro/launch/mesh.py``).

Single pod: 16 x 16 = 256 ranks, axes (data, model).  Multi-pod:
2 x 16 x 16 = 512 ranks, axes (pod, data, model).  The JAX package is
single-controller (one process sees every device); here every rank of
the world runs the same program and builds the same mesh, so the default
process group must exist before a mesh does (``torchrun`` sets the
environment that ``init_device_mesh`` reads, or the caller runs
``torch.distributed.init_process_group`` itself).

A ``"cuda"`` mesh puts rank r on ``cuda:{local_rank % device_count}``;
a ``"cpu"`` mesh (gloo) is what the tests use.  ``make_host_mesh`` uses
the card unless the caller asks for the CPU, and raises without one.

``axes_group(mesh, axes)`` is the ONE process group over the product of
``axes`` (row-major mesh order, as ``P(("pod", "data"), None)`` shards
rows): the sharded solver's "one all-reduce a step" needs one group, not
one all-reduce per axis.  Each group is created once per mesh, by every
rank (group creation is collective), and kept on the mesh object; the
group over every dim of the mesh is the one its barriers take.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_host_mesh", "make_production_mesh", "axes_group",
           "mesh_device", "shard_count", "mesh_from_arg"]


def _device_type(device) -> str:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch builds its meshes on the GPU by default and no "
                "CUDA device is visible; pass device='cpu' for a gloo mesh "
                "on the CPU")
        return "cuda"
    kind = torch.device(device).type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"a mesh lives on 'cuda' or 'cpu', got {device!r}")
    return kind


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _mesh(device, shape: tuple, names: tuple) -> DeviceMesh:
    kind = _device_type(device)
    if kind == "cuda":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, shape, mesh_dim_names=names)


def make_production_mesh(multi_pod: bool = False, *,
                         device=None) -> DeviceMesh:
    """The paper's layouts: (16, 16) as ("data", "model"), or (2, 16, 16)
    as ("pod", "data", "model"); the world must hold 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, names)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   pod: int | None = None, device=None) -> DeviceMesh:
    """A (data, model) mesh over the world (tests, examples, one host);
    ``data`` defaults to world size // (``model`` x ``pod``).  With
    ``pod``, a (pod, data, model) mesh."""
    if not dist.is_initialized():
        _device_type(device)              # no card and no device: raise
        dist.init_process_group()         # torchrun's environment
    if data is None:
        data = dist.get_world_size() // (model * (pod or 1))
    if pod is not None:
        return _mesh(device, (pod, data, model), ("pod", "data", "model"))
    return _mesh(device, (data, model), ("data", "model"))


def mesh_from_arg(spec: str, dev: torch.device) -> DeviceMesh:
    """The mesh a launcher's ``--mesh`` names (``DATA,MODEL``,
    ``POD,DATA,MODEL`` or ``production``), over the world ``torchrun``
    set up; the process group is made here unless the caller made one:
    gloo on the CPU and where ranks share a card, else NCCL."""
    if not dist.is_initialized():
        gloo = dev.type == "cpu" or int(os.environ.get(
            "LOCAL_WORLD_SIZE", 1)) > torch.cuda.device_count()
        dist.init_process_group("gloo" if gloo else "nccl")
    if spec == "production":
        world = dist.get_world_size()
        if world not in (256, 512):
            raise ValueError(f"--mesh production takes 256 or 512 ranks, "
                             f"the world has {world}")
        return make_production_mesh(world == 512, device=dev.type)
    dims = tuple(int(n) for n in spec.split(","))
    if len(dims) == 2:
        return make_host_mesh(*dims, device=dev.type)
    if len(dims) == 3:
        return make_host_mesh(dims[1], dims[2], pod=dims[0], device=dev.type)
    raise ValueError(f"--mesh takes DATA,MODEL or POD,DATA,MODEL, got {spec!r}")


def mesh_device(mesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if not isinstance(mesh, DeviceMesh):
        from repro_torch.core.errors import InputError
        raise InputError(f"mesh= takes a torch.distributed DeviceMesh, got "
                         f"{type(mesh).__name__}")
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type != "cuda":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' meshes, got "
                         f"{mesh.device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' mesh and no visible CUDA device")
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


def shard_count(mesh, axes) -> int:
    """Shards of a row-sharding over ``axes``: the product of their sizes."""
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axes_group(mesh, axes) -> dist.ProcessGroup:
    """One process group over the product of ``axes`` of ``mesh``, its
    group rank the flat shard index (row-major over ``axes``): the
    subgroups of the ranks that share every coordinate outside ``axes``,
    enumerated by every rank (``dist.new_subgroups_by_enumeration``, a
    public and collective call)."""
    axes = tuple(axes)
    names = mesh.mesh_dim_names or ()
    missing = [a for a in axes if a not in names]
    if not axes or missing:
        raise ValueError(f"axes {axes} are not dims of the mesh {names}")
    groups = mesh.__dict__.setdefault("_repro_axes_groups", {})
    if axes not in groups:
        dims = [names.index(a) for a in axes]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, shard_count(mesh, axes))
        groups[axes], _ = dist.new_subgroups_by_enumeration(ranks.tolist())
    return groups[axes]
