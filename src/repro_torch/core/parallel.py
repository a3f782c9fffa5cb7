"""Explicit SPMD for the sharded LM: autograd collectives, the rank's
plan over a mesh, and the weight fetches of FSDP x TP.

The JAX package trains on a ``("data", "model")`` (or ``("pod", "data",
"model")``) mesh by GSPMD: the logical-axis rules (``repro_torch.
sharding``) place the weights, and the compiler inserts the collectives.
Here every rank holds its own shards (plain local tensors: the kernels
are bound with ``ctypes`` and take no DTensor) and the layers issue the
collectives themselves, through ``core/collectives.py`` inside autograd
Functions, so ``collectives.record`` counts every one:

* ``gather(x, group, dim)`` — ``all_gather`` forward, ``reduce_scatter``
  backward: a weight's FSDP shards over ``data`` (each data rank's
  gradient is of its own rows, so the shard's gradient is their sum);
* ``gather(..., same=True)`` — ``all_gather`` forward, the rank's own
  slice of the gradient backward: a value whose every user computes the
  same thing on the same data (a weight stored sharded but used whole by
  a replicated layer);
* ``scatter_sum(x, group, dim)`` — ``reduce_scatter`` forward,
  ``all_gather`` backward: partial sums of which the rank keeps its
  slice (RG-LRU's ``w_a``/``w_i`` products);
* ``copy_in(x, group)`` — identity forward, ``all_reduce`` backward: the
  tensor-parallel input of a column-parallel product;
* ``reduce_out(x, group)`` — ``all_reduce`` forward, identity backward:
  the tensor-parallel output of a row-parallel product, and the sum of a
  scalar over the batch axes (``batch_mean`` divides it).

A ``None`` group (an axis of size 1) makes each of them the identity.
Nothing here calls ``redistribute`` or ``full_tensor()``: on gloo with
CUDA tensors (ranks sharing a card) both crash inside torch, while c10d's
own collectives work.

``Plan(mesh)`` is one rank's view of a mesh: axis sizes, its
coordinates, one process group per set of axes (``launch/mesh.py::
axes_group``; every set of the mesh's axes, created eagerly and in the
same order on every rank: the compressed step reduces over the axes a
leaf's dims are sharded on, plus ``pod``).  A
sharded model's parameters carry it (``.plan``, beside their ``.spec``;
``plan_of``), as the JAX package's arrays carry their sharding; a layer
whose parameters carry none runs its one-process code.  ``Plan.fetch``
turns a parameter's local shard into the weight a layer computes with:
every ``data``-sharded dim gathered (FSDP), and its ``model`` dim kept,
cut or gathered as the layer asks (``need``).
"""
from __future__ import annotations

import itertools

import torch

from repro_torch import sharding
from repro_torch.core import collectives as coll

def plan_of(p: torch.Tensor) -> "Plan | None":
    """The plan a sharded model's parameter carries, or ``None``."""
    return getattr(p, "plan", None)


# ---------------------------------------------------------------------------
# autograd collectives
# ---------------------------------------------------------------------------

def _all_gather(x, group, dim, label):
    return coll.all_gather(x.movedim(dim, 0), group, axes=label).movedim(
        0, dim)


def _reduce_scatter(x, group, dim, label):
    return coll.reduce_scatter(x.movedim(dim, 0), group,
                               axes=label).movedim(0, dim)


def _own_slice(x, group, dim):
    size, r = group.size(), group.rank()
    n = x.shape[dim] // size
    return x.narrow(dim, r * n, n)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, label, same):
        ctx.group, ctx.dim, ctx.label, ctx.same = group, dim, label, same
        return _all_gather(x, group, dim, label)

    @staticmethod
    def backward(ctx, g):
        if ctx.same:
            return _own_slice(g, ctx.group, ctx.dim), None, None, None, None
        return (_reduce_scatter(g, ctx.group, ctx.dim, ctx.label), None,
                None, None, None)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, label):
        ctx.group, ctx.dim, ctx.label = group, dim, label
        return _reduce_scatter(x, group, dim, label)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim, ctx.label), None, None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, label):
        ctx.group, ctx.label = group, label
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (coll.all_reduce(g.contiguous().clone(), ctx.group,
                                axes=ctx.label), None, None)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, label):
        return coll.all_reduce(x.contiguous().clone(), group, axes=label)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def gather(x, group, dim: int, label: str, same: bool = False):
    """The ranks' ``x`` concatenated along ``dim`` (group-rank order);
    the gradient is summed over the group and scattered back
    (``same=True``: the rank's own slice of it, no sum)."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim % x.ndim, label, same)


def scatter_sum(x, group, dim: int, label: str):
    """The rank's slice along ``dim`` of the sum of ``x`` over the group;
    the gradient is gathered back."""
    if group is None:
        return x
    return _ScatterSum.apply(x, group, dim % x.ndim, label)


def copy_in(x, group, label: str):
    """``x`` itself; its gradient summed over the group."""
    return x if group is None else _CopyIn.apply(x, group, label)


def reduce_out(x, group, label: str):
    """The sum of ``x`` over the group; the gradient passed through."""
    return x if group is None else _ReduceOut.apply(x, group, label)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")


class Plan:
    """One rank's view of ``mesh`` (a ``DeviceMesh``) for the sharded
    LM."""

    def __init__(self, mesh):
        from repro_torch.launch.mesh import axes_group, mesh_device
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        if "model" not in self.names or "data" not in self.names:
            raise ValueError(f"the sharded LM runs on a ('data', 'model') or "
                             f"('pod', 'data', 'model') mesh, got "
                             f"{self.names}")
        self.sizes = sharding.mesh_axes(mesh)
        self.coord = dict(zip(self.names, mesh.get_coordinate()))
        self.device = mesh_device(mesh)
        self.batch_axes = tuple(a for a in BATCH_AXES if a in self.names)
        self._groups = {}
        for k in range(1, len(self.names) + 1):     # collective: every rank
            for axes in itertools.combinations(self.names, k):
                if self.count(axes) > 1:
                    self._groups[axes] = axes_group(mesh, axes)
        self.tp = self.sizes["model"]
        self.m = self.coord["model"]

    # -- axes ---------------------------------------------------------------
    def count(self, axes) -> int:
        n = 1
        for a in axes:
            n *= self.sizes[a]
        return n

    def index(self, axes) -> int:
        """This rank's flat index over ``axes`` (row-major)."""
        i = 0
        for a in axes:
            i = i * self.sizes[a] + self.coord[a]
        return i

    def group(self, axes):
        """The process group over ``axes`` (in mesh order), ``None`` where
        it holds one rank."""
        axes = tuple(a for a in self.names if a in tuple(axes))
        if self.count(axes) == 1:
            return None
        if axes not in self._groups:
            raise KeyError(f"no group over {axes} was created")
        return self._groups[axes]

    def label(self, axes) -> str:
        """The axes as ``collectives.record`` names them, in mesh
        order."""
        return "+".join(a for a in self.names if a in tuple(axes))

    @property
    def n_batch(self) -> int:
        return self.count(self.batch_axes)

    @property
    def batch_index(self) -> int:
        return self.index(self.batch_axes)

    # -- activations ----------------------------------------------------------
    def copy_in(self, x):
        return copy_in(x, self.group(("model",)), "model")

    def reduce_out(self, x):
        return reduce_out(x, self.group(("model",)), "model")

    def scatter_model(self, x, dim: int):
        return scatter_sum(x, self.group(("model",)), dim, "model")

    def gather_model(self, x, dim: int):
        """A model-sharded value of a replicated layer, whole (``same``)."""
        return gather(x, self.group(("model",)), dim, "model", same=True)

    def batch_sum(self, x):
        return reduce_out(x, self.group(self.batch_axes),
                          self.label(self.batch_axes))

    def batch_mean(self, x):
        """The mean of a per-rank scalar over the batch axes; its
        gradient, passed through, is summed over those ranks by the
        gradient sync, so the objective holds the mean once."""
        return self.batch_sum(x) / self.n_batch

    def batch_total(self, x):
        """The sum over the batch axes of a value without gradient."""
        g = self.group(self.batch_axes)
        if g is None:
            return x
        return coll.all_reduce(x.detach().clone(), g,
                               axes=self.label(self.batch_axes))

    def model_max(self, x):
        g = self.group(("model",))
        if g is None:
            return x
        return coll.all_reduce(x.detach().contiguous().clone(), g, op="max",
                               axes="model")

    # -- ranges ---------------------------------------------------------------
    def split(self, n: int) -> tuple[int, int] | None:
        """This model rank's range of ``n`` units split over ``model``, or
        ``None`` where ``n`` does not divide."""
        if n % self.tp:
            return None
        k = n // self.tp
        return self.m * k, (self.m + 1) * k

    # -- parameters -------------------------------------------------------------
    def shard(self, full: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's shard of ``full`` under ``spec`` (a view)."""
        x = full
        for i in range(full.ndim):
            axes = sharding.dim_axes(spec, i)
            if axes:
                n = full.shape[i] // self.count(axes)
                x = x.narrow(i, self.index(axes) * n, n)
        return x

    def unshard(self, local: torch.Tensor, spec: tuple) -> torch.Tensor:
        """The whole tensor from every rank's ``local`` shard (plain
        all-gathers, no gradient)."""
        x = local.detach()
        for i in range(local.ndim):
            group = self.group(sharding.dim_axes(spec, i))
            if group is not None:
                x = _all_gather(x, group, i, self.label(
                    sharding.dim_axes(spec, i)))
        return x.contiguous()

    def fetch(self, p: torch.Tensor, need: tuple | None = None,
              fsdp: bool = True) -> torch.Tensor:
        """The weight a layer computes with, from the parameter ``p`` (the
        rank's shard, its spec in ``p.spec``).

        Every dim sharded over axes without ``model`` is gathered over
        them (FSDP; ``fsdp=False`` keeps it, for the MoE's ``w_out``).
        ``need=None``: the layer computes the same on every model rank,
        and a model-sharded dim is gathered whole (``same``).  ``need=(dim,
        lo, hi)``: the rank computes its own part with entries
        ``[lo, hi)`` of ``dim`` (the rest whole); a shard that is exactly
        that range is kept, a replicated one is cut after ``copy_in``, an
        other shard is gathered (gradients summed) and cut."""
        spec = p.spec
        x = p
        mdim = None
        for i in range(p.ndim):
            axes = sharding.dim_axes(spec, i)
            if not axes:
                continue
            if "model" in axes:
                if axes != ("model",):
                    raise NotImplementedError(
                        f"a weight dim sharded over {axes}: the sharded LM "
                        f"takes 'model' alone on a dim")
                mdim = i
            elif fsdp:
                x = gather(x, self.group(axes), i, self.label(axes))
        model = self.group(("model",))
        if need is None:
            if mdim is not None:
                x = gather(x, model, mdim, "model", same=True)
            return x
        dim, lo, hi = need
        if mdim is None:
            return copy_in(x, model, "model").narrow(dim, lo, hi - lo)
        n = x.shape[mdim]
        if mdim == dim and (lo, hi) == (self.m * n, (self.m + 1) * n):
            return x
        x = gather(x, model, mdim, "model")
        return x.narrow(dim, lo, hi - lo)
