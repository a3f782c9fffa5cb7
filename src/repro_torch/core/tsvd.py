"""Numerical helpers the block driver shares (PyTorch port).

The counterparts of ``sweep_ops``, ``rayleigh_ritz_from_W``,
``rayleigh_ritz``, ``warm_start_width``, ``reconstruct`` and
``relative_error`` in the JAX package's ``repro/core/tsvd.py``.  Every
A-sized product goes through the sweep wrappers of ``kernels/ops.py``
(the Hopper kernels on the card, their plain versions on the CPU); the
thin QR and the small SVD are ``torch.linalg`` calls, as they were
``jnp.linalg`` calls in the JAX package.

The serial deflation engine of that module (``method="gram"`` /
``"gramfree"``) is not ported yet (ROADMAP.md, queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.kernels import ops


def rayleigh_ritz_from_W(W: torch.Tensor, Q: torch.Tensor):
    """Rayleigh–Ritz extraction from a precomputed projection ``W = X Q``:
    thin QR of the skinny ``W``, SVD of the small ``(k, k)`` triangle."""
    Uw, Rw = torch.linalg.qr(W)
    Us, S, Vh = torch.linalg.svd(Rw)             # (k, k) — tiny
    return Uw @ Us, S, Q @ Vh.mT


def rayleigh_ritz(X: torch.Tensor, Q: torch.Tensor):
    """Extract ``(U, S, V)`` from a converged right-subspace basis ``Q``
    of a tall ``X``: one sweep over ``X`` plus the small factorizations."""
    return rayleigh_ritz_from_W(ops.block_matvec(X, Q), Q)


def warm_start_width(k: int, oversample: int, N: int) -> int:
    """Oversampled iterate width ``l = min(k + p, N)``."""
    return min(k + max(oversample, 0), N)


def sweep_ops(X: torch.Tensor, sweep_dtype):
    """``(matmat, rmatmat)`` closures for the two A-sized block sweeps.

    ``X`` is cast to ``sweep_dtype`` once, here; the closures cast only
    the skinny operand and accumulate in fp32.
    """
    Xs = X.to(resolve_sweep_dtype(sweep_dtype))
    return ((lambda Q: ops.block_matvec(Xs, Q)),
            (lambda Y: ops.block_rmatvec(Xs, Y)))


def reconstruct(res) -> torch.Tensor:
    """``U diag(S) V^T`` — rank-k reconstruction."""
    return (res.U * res.S[None, :]) @ res.V.mT


def relative_error(A: torch.Tensor, res) -> torch.Tensor:
    """``||A - U S V^T||_F / ||A||_F``."""
    num = torch.linalg.norm(A - reconstruct(res))
    return num / (torch.linalg.norm(A) + 1e-30)
