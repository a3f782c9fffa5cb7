"""The serial deflation engine (paper Alg 1 around Alg 2/4) and the
numerical helpers every backend shares (PyTorch port).

The counterparts of the JAX package's ``repro/core/tsvd.py``: the block
driver's ``sweep_ops``, ``rayleigh_ritz_from_W``, ``rayleigh_ritz``,
``warm_start_width``, ``reconstruct`` and ``relative_error``, and the
rank-one deflation engine ``_dense_deflation`` with its power loops
(``power_iterate_gram``, ``power_iterate_chain``, ``svd_1d``) and the
paper's four-term Eq. 2/3 chains (``_deflated_matvec``/``_left``).

Every A-sized product goes through the wrappers of ``kernels/ops.py``
(the Hopper kernels on the card, their plain versions on the CPU): the
block sweeps, and for deflation ``matvec``, the fused reverse sweep
``deflate_rmatvec`` and the Gram product ``gram``.  The thin QR, the
small SVD, the residual ``A - U S V^T`` of ``method="gram"`` (one
``torch.addmm``, a plain large product the JAX package left to XLA) and
the power loop's ``B @ v`` on the small Gram matrix are PyTorch calls.

The JAX package's ``lax.while_loop``/``fori_loop`` become Python loops
with the same semantics: a rank stops at the first step where
``|v . v1| >= 1 - eps`` (one ``.item()`` sync per step), or runs exactly
``max_iters`` steps under ``force_iters`` (no sync at all).

Pass accounting (``passes_over_A``, the JAX package's count of the
paper's schedule): ``gram`` 3 per rank (residual, Gram product, u
recovery); ``gramfree`` 3 per power step (``A v``, ``A^T X v``,
``A^T U S V^T v``) plus 1 per rank for u recovery.  The fused reverse
sweep reads ``A`` once for the last two, so the card reads ``A`` twice
per power step; the reported count stays the schedule's.
"""
from __future__ import annotations

import numpy as np
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


def seeded_generator(device, seed: int) -> torch.Generator:
    """The port's RNG: a ``torch.Generator`` on ``device`` seeded with
    the integer seed.  It does not reproduce the JAX package's threefry
    draws; a test that needs the same start feeds it explicitly."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


# ---------------------------------------------------------------------------
# Power iteration (paper Alg 2) and the gram-free chains (Eq. 2/3)
# ---------------------------------------------------------------------------

def _start(x0, device) -> torch.Tensor:
    """Caller-supplied start vector(s) as an fp32 tensor on ``device``
    (a copy of a numpy array: it may be read-only)."""
    if isinstance(x0, torch.Tensor):
        return x0.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x0, np.float32), device=device)


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # rsqrt-free for numerical clarity; fp32 accumulation
    return torch.sqrt(torch.sum(x.to(torch.float32) ** 2))


def power_iterate_chain(matvec, v0: torch.Tensor, *, eps: float = 1e-6,
                        max_iters: int = 100, force_iters: bool = False):
    """Power iteration ``v <- normalize(matvec(v))`` until
    ``|v . v1| >= 1 - eps`` or ``max_iters``; ``force_iters=True`` runs
    exactly ``max_iters`` steps.  Returns ``(v, iters)``.  The stop flag
    is synced every step (one ``.item()``): a lagged check would run one
    step more than the reference."""
    v, iters = v0, 0
    while iters < max_iters:
        v1 = matvec(v)
        v1 = v1 / (_l2norm(v1) + 1e-30)
        iters += 1
        done = None if force_iters else torch.abs(torch.dot(v, v1)) >= 1.0 - eps
        v = v1
        if done is not None and bool(done.item()):
            break
    return v, iters


def power_iterate_gram(B: torch.Tensor, v0: torch.Tensor, *,
                       eps: float = 1e-6, max_iters: int = 100,
                       force_iters: bool = False):
    """Paper Alg 2 lines 10-15: ``v <- normalize(B v)`` on the small
    Gram matrix ``B``; see ``power_iterate_chain`` for the loop."""
    return power_iterate_chain(lambda v: torch.mv(B, v), v0, eps=eps,
                               max_iters=max_iters, force_iters=force_iters)


def svd_1d(X: torch.Tensor, seed: int = 0, *, x0=None, eps: float = 1e-6,
           max_iters: int = 100, force_iters: bool = False):
    """Paper Alg 2: dominant singular direction of ``X`` by the Gram
    power method — the right singular vector when ``m >= n``, else the
    left one.  The start is ``x0`` when given, else a normal draw from
    ``seed``; either way normalized.  Returns ``(v, iters)``."""
    m, n = X.shape
    kdim = min(m, n)
    if x0 is None:
        x = torch.randn((kdim,), generator=seeded_generator(X.device, seed),
                        device=X.device, dtype=torch.float32)
    else:
        x = _start(x0, X.device)
    x = x / _l2norm(x)
    B = ops.gram(X.contiguous(), trans=m < n)
    return power_iterate_gram(B, x, eps=eps, max_iters=max_iters,
                              force_iters=force_iters)


def _deflated_matvec(A, U, S, V, v):
    """``(A - U S V^T)^T (A - U S V^T) v`` as the paper's right-to-left
    chain of four terms (Eq. 2): three sweeps over ``A``, no residual or
    Gram matrix formed.  The faithful schedule the fused engine step is
    held against."""
    Xv = ops.matvec(A, v)                              # (m,)
    t1 = ops.matvec(A, Xv, trans=True)                 # X^T X v
    t2 = V @ (S * (U.mT @ Xv))                         # V S U^T X v
    Vtv = V.mT @ v
    t3 = ops.matvec(A, U @ (S * Vtv), trans=True)      # X^T U S V^T v
    t4 = V @ (S * S * Vtv)                             # V S^2 V^T v
    return t1 - t2 - t3 + t4


def _deflated_matvec_left(A, U, S, V, u):
    """Left-side analogue (Eq. 3): the ``X X^T`` chain applied to ``u``."""
    Atu = ops.matvec(A, u, trans=True)                 # (n,)
    t1 = ops.matvec(A, Atu)                            # X X^T u
    t2 = U @ (S * (V.mT @ Atu))                        # U S V^T X^T u
    Utu = U.mT @ u
    t3 = ops.matvec(A, V @ (S * Utu))                  # X V S U^T u
    t4 = U @ (S * S * Utu)                             # U S^2 U^T u
    return t1 - t2 - t3 + t4


# ---------------------------------------------------------------------------
# Serial deflation engine (called by the front door for gram/gramfree)
# ---------------------------------------------------------------------------

def _dense_deflation(A: torch.Tensor, k: int, *, seed: int = 0,
                     eps: float, max_iters: int, force_iters: bool,
                     method: str, x0=None):
    """Rank-one deflation to rank ``k`` (paper Alg 1 around Alg 2/4).

    Returns ``(U, S, V, iters, passes)``: fp32 factors on ``A``'s
    device, per-rank ``iters`` (numpy int32) and ``passes_over_A``.
    Wide inputs power-iterate the left side, as in the JAX package.
    ``x0`` (``(k, min(m, n))``, e.g. the JAX package's own draws) replaces
    the seeded normal start vectors; each is normalized.

    The kernels read a row-major operand.  A column-major ``A`` (a
    transposed view) is used as the row-major ``A^T`` beneath it, with
    the kernels' ``trans`` flags swapped: no copy of ``A``.
    """
    m, n = A.shape
    tall = m >= n
    kdim = n if tall else m
    dev = A.device
    flip = not A.is_contiguous() and A.mT.is_contiguous()
    R = A.mT if flip else A.contiguous()   # row-major; A = R^T when flip
    if x0 is None:
        x0 = torch.randn((k, kdim), generator=seeded_generator(dev, seed),
                         device=dev, dtype=torch.float32)
    else:
        x0 = _start(x0, dev)
        if tuple(x0.shape) != (k, kdim):
            raise ValueError(f"x0 must have shape {(k, kdim)}, got "
                             f"{tuple(x0.shape)}")

    def fwd(x):                  # A @ x
        return ops.matvec(R, x, trans=flip)

    def bwd(y):                  # A^T @ y
        return ops.matvec(R, y, trans=not flip)

    U = torch.zeros((m, k), dtype=torch.float32, device=dev)
    S = torch.zeros((k,), dtype=torch.float32, device=dev)
    V = torch.zeros((n, k), dtype=torch.float32, device=dev)
    iters = np.zeros((k,), np.int32)
    resid = torch.empty_like(R) if method == "gram" else None

    def gramfree_step(v):
        # the Eq. 2 chain with its two A^T sweeps fused into one read of A
        Vtv = V.mT @ v
        t13, utxv = ops.deflate_rmatvec(R, U, fwd(v), S * Vtv, trans=flip)
        return t13 - V @ (S * utxv) + V @ (S * S * Vtv)

    def gramfree_step_left(u):
        Utu = U.mT @ u
        t13, vtxu = ops.deflate_rmatvec(R, V, bwd(u), S * Utu,
                                        trans=not flip)
        return t13 - U @ (S * vtxu) + U @ (S * S * Utu)

    for l in range(k):
        x = x0[l] / _l2norm(x0[l])
        if method == "gram":
            # residual X = A - U S V^T in R's layout (ranks >= l are zero)
            if flip:
                torch.addmm(R, V * S, U.mT, alpha=-1.0, out=resid)
            else:
                torch.addmm(R, U * S, V.mT, alpha=-1.0, out=resid)
            B = ops.gram(resid, trans=flip if tall else not flip)
            vec, it = power_iterate_gram(B, x, eps=eps, max_iters=max_iters,
                                         force_iters=force_iters)
        else:
            vec, it = power_iterate_chain(
                gramfree_step if tall else gramfree_step_left, x, eps=eps,
                max_iters=max_iters, force_iters=force_iters)
        # recover the other side through the deflated operator, so that
        # repeated singular values stay orthogonal
        if tall:
            w = fwd(vec) - (U * S) @ (V.mT @ vec)
        else:
            w = bwd(vec) - (V * S) @ (U.mT @ vec)
        sigma = _l2norm(w)
        w = w / (sigma + 1e-30)
        U[:, l], V[:, l] = (w, vec) if tall else (vec, w)
        S[l] = sigma
        iters[l] = it
    del resid
    if method == "gram":
        passes = 3 * k                     # residual + Gram + u, per rank
    else:
        passes = 3 * int(iters.sum()) + k  # 3 sweeps/step + u recovery
    return U, S, V, iters, passes
