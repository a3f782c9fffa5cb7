"""Truncated-SVD (power-method) gradient compression with error feedback
(the port of the JAX package's ``repro/optim/compression.py``).

The paper's block power method applied in the optimizer: each
compressible leaf's gradient ``M (p x q)``, plus its error buffer, is
factored to rank ``r`` by one block power-iteration step from a
warm-started subspace ``Q`` (the paper's Alg 2 with the JAX package's
warm start), and only the skinny factors would cross the links:

    P = M Q          ops.block_matvec
    P = orth(P)
    Qn = M^T P       ops.block_rmatvec
    M_hat = P Qn^T;  err <- M - M_hat;  Q <- orth(Qn)

Both products are fp32, so on the card they run the hand-written block
sweeps on ``tf32x3`` (3xTF32) and on the CPU their plain versions.

Leaves are the JAX package's (``models.convert.leaf_layout``): a stacked
leaf is one matrix with every leading dim collapsed, as there, so its rank-r
approximation is the JAX package's and not one per layer.  A leaf is
compressed when it has two dims or more and ``min_size`` elements; the
rest pass through whole.  ``compress_ratio`` is the JAX package's
count, ``p q`` against ``r (p + q)`` elements a compressed leaf.

``init_state`` draws each leaf's ``Q0`` from a ``torch.Generator``
seeded from ``(seed, leaf index)``, the leaf index being the JAX
package's, as its ``fold_in(PRNGKey(seed), i)``; the two generators'
numbers differ, so the tests hand the JAX package's ``Q0`` to the port.

Over a mesh (``plan``, a ``core/parallel.Plan``; the JAX package's
``train.py:150-229``) each rank holds its shard of every gradient and
of its error buffer, and the two products become the paper's
distributed step on a 2-D-sharded matrix.  ``M_loc`` is the rank's
stack of shards plus its error buffer, ``(p_loc, q_loc)``:

    P   = M_loc Q[cols]    summed over the axes of the last dim (+ pod),
                           gathered over the leading dims' axes in
                           global row order (``Plan.unshard``), orth
    Qn  = M_loc^T P[rows]  summed over the leading dims' axes (+ pod),
                           gathered over the last dim's axes
    M_hat[rows, cols] = P[rows] Qn[cols]^T;  err <- M_loc - M_hat[...]

With a ``pod`` axis (the cross-pod mode) each pod's ``M`` is its own
gradient plus its own error buffer, both sums also run over ``pod`` and
are divided by the pod count (``pmean``), and each uncompressed leaf is
mean-all-reduced over ``pod`` whole; without one the gradients came
synced and only the factors' partial sums cross ranks.  Every rank
orthonormalizes the same gathered bits, so ``P`` and the new ``Q`` are
bitwise equal on every rank; only rank-r factors and the uncompressed
leaves cross ``pod``, never a gradient-sized payload.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.models import convert as LV


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rank: int = 8
    min_size: int = 65_536      # don't compress small leaves
    seed: int = 17
    enabled: bool = True


def _mat_shape(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """Collapse an nD weight to 2D (leading dims x last dim); None = skip."""
    if len(shape) < 2:
        return None
    return int(np.prod(shape[:-1])), shape[-1]


def compressed(leaf: LV.Leaf, cfg: CompressionConfig) -> bool:
    return (cfg.enabled and _mat_shape(leaf.shape) is not None
            and leaf.size >= cfg.min_size)


def _generator_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def init_state(layout: list[LV.Leaf], cfg: CompressionConfig,
               device) -> dict:
    """``{"Q": {path: (q, r) fp32}, "err": {path: zeros of the leaf's
    shape (over a mesh: of the rank's stack of shards), fp32}}`` over the
    compressed leaves of ``layout``."""
    qs, errs = {}, {}
    for i, leaf in enumerate(layout):
        if not compressed(leaf, cfg):
            continue
        g = torch.Generator(device=device).manual_seed(
            _generator_seed(cfg.seed, i))
        Q = torch.randn((leaf.shape[-1], cfg.rank), generator=g,
                        device=device)
        qs[leaf.path] = _orthonormalize(Q)
        errs[leaf.path] = torch.zeros(leaf.local_shape,
                                      dtype=torch.float32, device=device)
    return {"Q": qs, "err": errs}


def _orthonormalize(P: torch.Tensor) -> torch.Tensor:
    """QR-based orthonormalization (r is small; cost r^2 p)."""
    return torch.linalg.qr(P.to(torch.float32)).Q


@torch.no_grad()
def compress_grads(grads: dict, state: dict, cfg: CompressionConfig,
                   layout: list[LV.Leaf], plan=None):
    """Compress and decompress ``grads`` (``{name: tensor}`` over the
    port's parameters) leaf by leaf with error feedback.  Returns (a new
    dict of decompressed gradients in each gradient's dtype, the new
    state, ``{"compress_ratio"}``).  With ``plan`` the gradients, the
    error buffers and ``layout``'s shard shapes are the rank's (a layout
    with specs: ``models.convert.leaf_layout`` of the sharded model)."""
    if plan is not None:
        return _compress_sharded(grads, state, cfg, layout, plan)
    out = dict(grads)
    new_q, new_e = {}, {}
    for leaf in layout:
        if leaf.path not in state["Q"]:     # not compressed
            continue
        g = LV.gather(leaf, grads)
        ms = _mat_shape(leaf.shape)
        M = g.to(torch.float32).reshape(ms) + state["err"][leaf.path].reshape(
            ms)
        P = _orthonormalize(ops.block_matvec(M, state["Q"][leaf.path]))
        Qn = ops.block_rmatvec(M, P)
        M_hat = P @ Qn.mT
        new_e[leaf.path] = (M - M_hat).reshape(leaf.shape)
        out.update(LV.scatter(leaf, M_hat.reshape(leaf.shape).to(g.dtype)))
        new_q[leaf.path] = _orthonormalize(Qn)
    return out, {"Q": new_q, "err": new_e}, _stats(layout, state, cfg)


def _stats(layout: list[LV.Leaf], state: dict, cfg: CompressionConfig):
    """``{"compress_ratio"}``: ``p q`` against ``r (p + q)`` elements a
    compressed leaf (``r`` its ``Q``'s width: ``min(rank, q)``), the whole
    leaf a passed one, over whole leaves."""
    full = sent = 0
    for leaf in layout:
        full += leaf.size * 4
        if leaf.path in state["Q"]:
            p, q = _mat_shape(leaf.shape)
            sent += state["Q"][leaf.path].shape[1] * (p + q) * 4
        else:
            sent += leaf.size * 4
    return {"compress_ratio": torch.tensor(full / max(sent, 1),
                                           dtype=torch.float32)}


def _compress_sharded(grads, state, cfg, layout, plan):
    """``compress_grads`` over a mesh (see the module docstring)."""
    pods = ("pod",) if "pod" in plan.names else ()
    npods = plan.count(pods)

    def mean(x, axes):
        """``x`` summed over ``axes`` (+ pod) in place, the pods' sum
        divided by their count."""
        axes = tuple(axes) + pods
        group = plan.group(axes)
        if group is not None:
            collectives.all_reduce(x, group, axes=plan.label(axes))
        return x.div_(npods) if npods > 1 else x

    out = dict(grads)
    new_q, new_e = {}, {}
    for leaf in layout:
        if leaf.path not in state["Q"]:     # not compressed
            if npods > 1:
                g = LV.gather(leaf, grads)
                out.update(LV.scatter(leaf, mean(
                    g if leaf.stacked else g.clone(), ())))
            continue
        spec, nd = leaf.spec, leaf.ndim
        lead = tuple(a for i in range(nd - 1)
                     for a in sharding.dim_axes(spec, i))
        last = sharding.dim_axes(spec, nd - 1)
        lead_spec = spec[:-1] + (None,)
        g = LV.gather(leaf, grads)
        p_loc, q_loc = math.prod(g.shape[:-1]), g.shape[-1]
        # row-major for the card's sweeps (a shard's gradient may come
        # with the strides of a transposed use)
        M = (g.to(torch.float32).reshape(p_loc, q_loc) +
             state["err"][leaf.path].reshape(p_loc, q_loc)).contiguous()
        r = state["Q"][leaf.path].shape[1]
        Q = plan.shard(state["Q"][leaf.path], (spec[-1],)).contiguous()
        P = mean(ops.block_matvec(M, Q), last)
        P = plan.unshard(P.reshape(*g.shape[:-1], r), lead_spec)
        P = _orthonormalize(P.reshape(-1, r))
        P_loc = plan.shard(P.reshape(*leaf.shape[:-1], r),
                           lead_spec).reshape(p_loc, r).contiguous()
        Qn_loc = mean(ops.block_rmatvec(M, P_loc), lead)
        Qn = plan.unshard(Qn_loc, (spec[-1],))
        M_hat = P_loc @ Qn_loc.mT
        new_e[leaf.path] = (M - M_hat).reshape(g.shape)
        out.update(LV.scatter(leaf, M_hat.reshape(g.shape).to(g.dtype)))
        new_q[leaf.path] = _orthonormalize(Qn)
    return out, {"Q": new_q, "err": new_e}, _stats(layout, state, cfg)
