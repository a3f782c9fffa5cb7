"""Truncated-SVD (power-method) gradient compression with error feedback
(the port of the JAX package's ``repro/optim/compression.py``).

The paper's block power method applied in the optimizer: each
compressible leaf's gradient ``M (p x q)``, plus its error buffer, is
factored to rank ``r`` by one block power-iteration step from a
warm-started subspace ``Q`` (the paper's Alg 2 with the JAX package's
warm start), and only the skinny factors would cross the links:

    P = M Q          ops.block_matvec   (pmean over ``group``)
    P = orth(P)
    Qn = M^T P       ops.block_rmatvec  (pmean over ``group``)
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
With ``group`` (a ``torch.distributed`` process group, the counterpart
of ``axis_name``) ``P``, ``Qn`` and every uncompressed leaf are
mean-all-reduced through ``core/collectives.py``; without it the math
is the same with no collective.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    shape, fp32}}`` over the compressed leaves of ``layout``."""
    qs, errs = {}, {}
    for i, leaf in enumerate(layout):
        if not compressed(leaf, cfg):
            continue
        g = torch.Generator(device=device).manual_seed(
            _generator_seed(cfg.seed, i))
        Q = torch.randn((leaf.shape[-1], cfg.rank), generator=g,
                        device=device)
        qs[leaf.path] = _orthonormalize(Q)
        errs[leaf.path] = torch.zeros(leaf.shape, dtype=torch.float32,
                                      device=device)
    return {"Q": qs, "err": errs}


def _orthonormalize(P: torch.Tensor) -> torch.Tensor:
    """QR-based orthonormalization (r is small; cost r^2 p)."""
    return torch.linalg.qr(P.to(torch.float32)).Q


@torch.no_grad()
def compress_grads(grads: dict, state: dict, cfg: CompressionConfig,
                   layout: list[LV.Leaf], group=None):
    """Compress and decompress ``grads`` (``{name: tensor}`` over the
    port's parameters) leaf by leaf with error feedback.  Returns (a new
    dict of decompressed gradients in each gradient's dtype, the new
    state, ``{"compress_ratio"}``)."""
    if group is None:
        pmean = lambda x: x
    else:
        size = torch.distributed.get_world_size(group)
        pmean = lambda x: collectives.all_reduce(x, group).div_(size)
    out = dict(grads)
    new_q, new_e = {}, {}
    bytes_full = bytes_sent = 0
    for leaf in layout:
        if leaf.path not in state["Q"]:     # not compressed: plain mean
            if group is not None:
                for n in leaf.names:
                    out[n] = pmean(grads[n].clone())
            bytes_full += leaf.size * 4
            bytes_sent += leaf.size * 4
            continue
        g = LV.gather(leaf, grads)
        ms = _mat_shape(leaf.shape)
        M = g.to(torch.float32).reshape(ms) + state["err"][leaf.path].reshape(
            ms)
        P = pmean(ops.block_matvec(M, state["Q"][leaf.path]))
        P = _orthonormalize(P)
        Qn = pmean(ops.block_rmatvec(M, P))
        M_hat = P @ Qn.mT
        new_e[leaf.path] = (M - M_hat).reshape(leaf.shape)
        out.update(LV.scatter(leaf, M_hat.reshape(leaf.shape).to(g.dtype)))
        new_q[leaf.path] = _orthonormalize(Qn)
        bytes_full += M.numel() * 4
        bytes_sent += (P.numel() + Qn.numel()) * 4
    stats = {"compress_ratio": torch.tensor(bytes_full / max(bytes_sent, 1),
                                            dtype=torch.float32)}
    return out, {"Q": new_q, "err": new_e}, stats
