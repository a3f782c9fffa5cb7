"""The distributed deflation t-SVD engine over mesh axes (paper Algs 3
and 4; the port of ``repro/core/dist_svd.py``).

The paper's N-GPU layout, on ``torch.distributed``:

* ``A`` row-sharded over the product of the axes (RSVD; wide inputs are
  transposed in by the front door and the factors swapped out: CSVD),
* ``U`` row-sharded alongside ``A``,
* ``Sigma`` and ``V`` replicated,
* the NCCL all-reduce -> ``core/collectives.py`` over the axes' one
  process group (NCCL on the card, gloo on the CPU or for ranks that
  share a card),
* per-GPU batched tiles -> a loop over contiguous row blocks of the
  shard (``n_blocks``), summed in block order.

Every rank runs the same engine (multi-controller: the JAX package's
``shard_map`` body, run by each rank on its rows).  Two fidelity levels:

* ``faithful=True`` — the paper's collective schedule: Alg 4's three
  all-reduces a power step (lines 6, 8, 16); the Alg-3 Gram all-reduced
  whole on every rank before power iteration;
* ``faithful=False`` (default) — (1) the two n-vector all-reduces fused
  by linearity (``X^T(Xv) - X^T U S V^T v = X^T (Xv - U(S V^T v))``),
  whose local part is one ``ops.deflate_rmatvec`` read of the shard;
  (2) the k-vector riding in the same payload: ONE ``(n + k,)``
  all-reduce a power step; (3) the Gram path on one axis keeps ``B``
  row-sharded (a reduce-scatter in place of the all-reduce) at the cost
  of one all-gather of ``B_loc v`` a step; on several axes it
  all-reduces ``B``, as the reference does.

A-sized products run on the kernels of ``kernels/ops.py``: ``matvec``
and ``deflate_rmatvec`` for the chain and the u recovery, ``gram`` for
the residual shard's Gram; the residual ``A_loc - U_loc S V^T`` is one
``torch.addmm``, as on the dense tier.  The small replicated products
(``V^T v``, ``V (S UtXv)``, ``B v``) are plain PyTorch.

Every rank must take the same steps, or a rank that stops early leaves
the others waiting in the next collective: the power loop's stop test
reads only replicated values (all-reduce outputs, the same bits on
every rank), as the reference's ``psum`` outputs are.

Pass accounting is the reference's: the faithful chain 3 A-sweeps a
power step, the fused one 2, plus one u-recovery sweep a rank; the Gram
path 3 a rank.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.collectives import (all_gather, all_reduce,
                                          reduce_scatter)
from repro_torch.core.config import SVDConfig, SVDResult
from repro_torch.core.tsvd import (_l2norm, _start, power_iterate_chain,
                                   power_iterate_gram, seeded_generator)
from repro_torch.kernels import ops

__all__ = ["dist_tsvd", "DistTSVDResult", "deflated_matvec_faithful"]

#: Back-compat alias — the per-backend result NamedTuples were unified.
DistTSVDResult = SVDResult


def _row_blocks(m_loc: int, n_blocks: int) -> list:
    """``[lo, hi)`` of the shard's row blocks: ``n_blocks`` of
    ``m_loc // n_blocks`` rows, then the ragged tail, if any."""
    rows = m_loc // max(n_blocks, 1)
    if n_blocks <= 1 or rows == 0:
        return [(0, m_loc)]
    blocks = [(b * rows, (b + 1) * rows) for b in range(n_blocks)]
    if rows * n_blocks != m_loc:
        blocks.append((rows * n_blocks, m_loc))
    return blocks


def _deflated_chain_step(A_loc, U_loc, S, V, v, group, *, faithful: bool,
                         n_blocks: int = 1):
    """One Alg-4 power step on the row-sharded residual operator; returns
    the unnormalized ``v1`` (replicated).  ``A_loc`` (m_loc, n), ``U_loc``
    (m_loc, k), ``S`` (k,), ``V`` (n, k), ``v`` (n,)."""
    Vtv = V.mT @ v                                       # (k,) replicated
    SVtv = S * Vtv
    if faithful:
        # the paper's schedule: three all-reduces (Alg 4 lines 6, 8, 16)
        Xv = ops.matvec(A_loc, v)                        # (m_loc,) local
        t1 = all_reduce(ops.matvec(A_loc, Xv, trans=True), group)
        UtXv = all_reduce(U_loc.mT @ Xv, group)
        t2 = V @ (S * UtXv)
        t3 = all_reduce(ops.matvec(A_loc, U_loc @ SVtv, trans=True), group)
        t4 = V @ (S * S * Vtv)
        return t1 - t2 - t3 + t4
    # fused: one read of each row block for X^T (Xv - U S V^T v) and
    # U^T Xv together, the blocks summed in order, ONE collective
    n, k = V.shape
    fused = torch.zeros((n + k,), dtype=torch.float32, device=v.device)
    for lo, hi in _row_blocks(A_loc.shape[0], n_blocks):
        a, u = A_loc[lo:hi], U_loc[lo:hi]
        t13, utxv = ops.deflate_rmatvec(a, u, ops.matvec(a, v), SVtv)
        fused[:n] += t13
        fused[n:] += utxv
    all_reduce(fused, group)                             # (n + k,)
    t13, UtXv = fused[:n], fused[n:]
    return t13 - V @ (S * UtXv) + V @ (S * S * Vtv)


def _dist_deflation(A_loc: torch.Tensor, k: int, layout, *, method: str,
                    faithful: bool, n_blocks: int, eps: float,
                    max_iters: int, force_iters: bool, seed: int = 0,
                    x0=None):
    """Rank-one deflation of the matrix whose rows ``A_loc`` (this rank's,
    contiguous fp32 on ``layout.device``) are row-sharded as ``layout``
    says (``core/operator.py::ShardLayout``; the tall orientation).

    Returns ``(U_loc, S, V, iters, passes)``: this rank's rows of ``U``,
    the replicated ``S`` and ``V``, per-rank ``iters`` (numpy int32) and
    ``passes_over_A``.  ``x0`` (``(k, n)``, e.g. the JAX package's own
    draws) replaces the seeded normal start vectors, which are the same
    on every rank; each is normalized.
    """
    group = layout.group
    m_loc, n = A_loc.shape
    dev = A_loc.device
    if x0 is None:
        x0 = torch.randn((k, n), generator=seeded_generator(dev, seed),
                         device=dev, dtype=torch.float32)
    else:
        x0 = _start(x0, dev)
        if tuple(x0.shape) != (k, n):
            raise ValueError(f"x0 must have shape {(k, n)}, got "
                             f"{tuple(x0.shape)}")
    scatter = method == "gram" and not faithful and len(layout.axes) == 1
    if scatter and n % layout.n_shards:
        raise ValueError(f"n={n} not divisible by shards={layout.n_shards}: "
                         f"the fused Gram path row-shards B (faithful=True "
                         f"all-reduces it whole)")
    U_loc = torch.zeros((m_loc, k), dtype=torch.float32, device=dev)
    S = torch.zeros((k,), dtype=torch.float32, device=dev)
    V = torch.zeros((n, k), dtype=torch.float32, device=dev)
    iters = np.zeros((k,), np.int32)
    resid = torch.empty_like(A_loc) if method == "gram" else None

    for l in range(k):
        v0 = x0[l] / _l2norm(x0[l])
        if method == "gram":
            # the residual shard's Gram once a rank (the paper's Alg 3)
            torch.addmm(A_loc, U_loc * S, V.mT, alpha=-1.0, out=resid)
            B = ops.gram(resid)
            if scatter:
                # B row-sharded: a reduce-scatter, then B_loc v gathered
                B_loc = reduce_scatter(B, group)
                del B
                v, it = power_iterate_chain(
                    lambda x: all_gather(torch.mv(B_loc, x), group), v0,
                    eps=eps, max_iters=max_iters, force_iters=force_iters)
                del B_loc
            else:
                v, it = power_iterate_gram(
                    all_reduce(B, group), v0, eps=eps, max_iters=max_iters,
                    force_iters=force_iters)
                del B
        else:
            v, it = power_iterate_chain(
                lambda x: _deflated_chain_step(
                    A_loc, U_loc, S, V, x, group, faithful=faithful,
                    n_blocks=n_blocks),
                v0, eps=eps, max_iters=max_iters, force_iters=force_iters)
        # u = (A - U S V^T) v, deflated so that duplicates stay orthogonal
        u_loc = ops.matvec(A_loc, v) - U_loc @ (S * (V.mT @ v))
        sigma = torch.sqrt(all_reduce(torch.sum(u_loc * u_loc), group))
        U_loc[:, l] = u_loc / (sigma + 1e-30)
        S[l] = sigma
        V[:, l] = v
        iters[l] = it
    del resid
    if method == "gram":
        passes = 3 * k                     # residual + Gram + u, per rank
    else:
        per_step = 3 if faithful else 2    # + u recovery per rank
        passes = per_step * int(iters.sum()) + k
    return U_loc, S, V, iters, passes


# ---------------------------------------------------------------------------
# Deprecated back-compat shim
# ---------------------------------------------------------------------------

def dist_tsvd(A, k: int, mesh, *, axes: tuple = ("data",),
              method: str = "gramfree", faithful: bool = False,
              n_blocks: int = 1, eps: float = 1e-6, max_iters: int = 200,
              force_iters: bool = False, seed: int = 0, warmup_q: int = 0,
              oversample: int = 8, sweep_dtype: str = "float32"
              ) -> SVDResult:
    """Deprecated: use ``repro_torch.svd(A, k, mesh=mesh, axes=axes,
    ...)``.  Translates the legacy keywords into an ``SVDConfig`` (this
    entry point's old default was ``method="gramfree"``) and delegates to
    the front door; warns once a process."""
    from repro_torch.core.svd import svd, warn_legacy
    warn_legacy("dist_tsvd")
    if method == "block" and n_blocks > 1:  # legacy contract preserved
        raise ValueError("method='block' supports neither faithful=True "
                         "nor n_blocks > 1 (its step is one fused matmat)")
    cfg = SVDConfig(method=method, eps=eps, max_iters=max_iters,
                    force_iters=force_iters, warmup_q=warmup_q,
                    oversample=oversample, sweep_dtype=sweep_dtype,
                    n_blocks=max(n_blocks, 1), seed=seed, faithful=faithful)
    return svd(A, k, mesh=mesh, axes=axes, config=cfg)


# ---------------------------------------------------------------------------
# Faithful Alg-4 mat-vec (for the tests and as the schedule's baseline)
# ---------------------------------------------------------------------------

def deflated_matvec_faithful(A_loc, U_loc, S, V, v, group):
    """The paper-faithful Alg-4 step (three all-reduces over ``group``)."""
    return _deflated_chain_step(A_loc, U_loc, S, V, v, group,
                                faithful=True)
