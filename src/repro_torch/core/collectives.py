"""The sharded solver's collectives (the port of the JAX package's
``psum`` / ``psum_scatter`` / ``all_gather`` inside ``shard_map``).

Thin wrappers over ``torch.distributed``: ``all_reduce`` (a sum, in
place), ``reduce_scatter`` (a sum, dim-0 chunk ``rank`` of it back) and
``all_gather`` (the ranks' tensors stacked along dim 0 in group-rank
order), plus ``barrier``.  This is the one module that knows the torch
API's names (``all_gather_into_tensor`` and ``reduce_scatter_tensor``,
deprecated in favour of ``all_gather_single`` and
``reduce_scatter_single`` in newer torch; whichever this torch has is
used).
It never changes the group's backend and never moves a tensor to the
host on the caller's behalf: gloo stages CUDA tensors through the host
itself, NCCL keeps them on the card.

``record`` is the per-process list of the collectives issued since the
last ``reset_record()``, one dict each (``op``, ``shape``, ``dtype``,
``bytes`` of the payload one rank contributes, ``group_size`` and, where
the caller names them, the mesh ``axes`` of the group, e.g.
``"pod+data"``); the tests and ``chip_smoke.py`` read it as they read
``ops.launches``.  ``all_reduce(..., op="max")`` is recorded as
``all_reduce_max``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

#: the collectives issued since the last ``reset_record()``
record: list[dict] = []


def reset_record() -> None:
    record.clear()


def _log(op: str, x: torch.Tensor, group, axes: str | None) -> None:
    entry = {"op": op, "shape": tuple(x.shape),
             "dtype": str(x.dtype).rsplit(".", 1)[-1],
             "bytes": x.numel() * x.element_size(),
             "group_size": dist.get_world_size(group)}
    if axes is not None:
        entry["axes"] = axes
    record.append(entry)


def all_reduce(x: torch.Tensor, group, *, op: str = "sum",
               axes: str | None = None) -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over ``group``, in
    place; returns ``x``.  Every rank gets the same bits."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op {op!r} is not 'sum' or 'max'")
    _log("all_reduce" if op == "sum" else "all_reduce_max", x, group, axes)
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group)
    return x


def reduce_scatter(x: torch.Tensor, group, *,
                   axes: str | None = None) -> torch.Tensor:
    """Rows ``[r * c, (r + 1) * c)`` of the sum of ``x`` over ``group``
    for group rank ``r``, ``c = x.shape[0] // size``; the rows must
    divide evenly."""
    size = dist.get_world_size(group)
    if x.shape[0] % size:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows do not divide "
                         f"over {size} ranks")
    _log("reduce_scatter", x, group, axes)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // size, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    scatter = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    scatter(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, group, *,
               axes: str | None = None) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in group-rank order."""
    size = dist.get_world_size(group)
    _log("all_gather", x, group, axes)
    x = x.contiguous()
    out = torch.empty((size * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x, group=group)
    return out


def barrier(group) -> None:
    """Wait until every rank of ``group`` arrives (not recorded: no
    payload)."""
    dist.barrier(group=group)
