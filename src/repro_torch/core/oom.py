"""Out-of-memory (degree-0/1) blocked computation (paper §III-IV, Alg 3),
PyTorch port of the JAX package's ``repro/core/oom.py``.

Device memory is bounded by streaming ``A`` through in row blocks:

* ``HostBlockedMatrix`` — the paper's degree-1 scenario: ``A`` lives in
  host memory in ``n_blocks`` row blocks and each block crosses to the
  card when a streamed op needs it.  On the card the copies go through
  ``core/staging.py``: pinned host blocks (the caller's fp32 rows
  page-locked in place), one copy stream, two device buffers whose rows
  are padded to whole 16 bytes, and events, so the copy of block
  ``b + 1`` runs while block ``b``'s kernels do — the CUDA streams the
  JAX package could only imitate.  On the CPU (``device="cpu"``) the
  blocks are the host tensors themselves.
* the per-block steps (``hostblock_*``): each block's product runs on
  the port's kernels (``kernels/ops.py``) and is added to the fp32
  accumulator in block order — no atomics, no split across blocks — so
  reruns are bitwise equal.  The fused chain step ``acc + A_b^T (A_b Q)``
  is the hot loop's: the block is read once for both sweep halves.
* ``blocked_gram``, ``tiled_gram`` (the paper's Alg-3 column batches
  with the symmetric-task trick) and ``blocked_deflated_matvec`` (one
  Alg-4 step over row blocks) on resident blocks.
* ``_oom_deflation`` — the rank-one deflation engine (paper Alg 1+4,
  ``method="gramfree"``) on a ``HostBlockedMatrix``: per power step one
  stream of ``matvec`` over the blocks and one of the fused reverse
  sweep ``deflate_rmatvec``, plus one ``matvec`` stream per rank for u
  recovery.  The block subspace iteration runs in the shared driver
  (``core/svd.py`` over ``core/operator.py::HostBlockedOperator``).
  ``oom_tsvd`` is the deprecated back-compat shim.

``stage_dtype="bfloat16"`` stages the host blocks at 2 bytes an element
(torch's round-to-nearest-even cast, bit for bit the JAX package's
``ml_dtypes`` staging), so every H2D copy moves half the bytes; the
chain and the sketch read the narrow blocks with fp32 sums, while
``matmat``/``rmatmat`` (the extraction pass) and the deflation sweeps
read the staged values widened to fp32, as the JAX package's promotion
does.

A pass is ONE full stream of the host blocks; block costs ``[1 + q if
warm] + iters + 1`` passes and deflation ``sum_l (2 iters_l + 1)``,
exactly what ``CountingHostMatrix`` counts.  bf16 staging halves
``bytes_per_pass``, never the number of passes.
"""
from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.config import SVDConfig, SVDResult
from repro_torch.core.faults import fault_hook, retry_io
from repro_torch.core.operator import (host_sync_scalar, resolve_device,
                                       sweep_copy)
from repro_torch.core.partition import make_batch_plan, symmetric_tasks
from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.core.tsvd import _l2norm, _start, seeded_generator
from repro_torch.kernels import ops

__all__ = ["HostBlockedMatrix", "CountingHostMatrix", "OOMResult",
           "CONVERGENCE_CHECK_EVERY", "blocked_gram", "tiled_gram",
           "blocked_deflated_matvec", "oom_tsvd"]


def _dense32(blk: torch.Tensor) -> torch.Tensor:
    """A block as the deflation kernels read it: contiguous fp32 (a copy
    only of a narrow block, or of a device block whose rows are
    padded)."""
    if blk.dtype != torch.float32:
        return blk.to(torch.float32)      # contiguous: a fresh copy
    return blk.contiguous()


# ---------------------------------------------------------------------------
# Per-block steps: each is the kernels of kernels/ops.py on one staged
# block, its product added to the fp32 accumulator in place
# ---------------------------------------------------------------------------

def hostblock_gram_step(acc, blk):
    """``acc + blk^T blk`` — one block of the streamed Gram."""
    return acc.add_(ops.gram(blk))


def hostblock_matvec(blk, v):
    """``blk @ v`` — one block of the streamed mat-vec (fp32)."""
    return ops.matvec(_dense32(blk), v)


def hostblock_matmat(blk, Q):
    """``blk @ Q`` — one block of the streamed extraction pass: the
    staged values widened to fp32 (rows padded to 16 bytes on the
    card), ``Q`` fp32."""
    return ops.block_matvec(sweep_copy(blk, torch.float32), Q)


def hostblock_rmatmat_step(acc, blk, yb):
    """``acc + blk^T y_b`` — one block of the streamed ``A^T Y`` (fp32,
    as ``hostblock_matmat``)."""
    return acc.add_(ops.block_rmatvec(sweep_copy(blk, torch.float32), yb))


def hostblock_chain_step(acc, blk, Q):
    """``acc + blk^T (blk Q)`` — one block of the FUSED gram chain, the
    hot loop's step.  Both sweep operands in the staged dtype (``Q`` and
    the intermediate rounded to bf16 under bf16 staging), fp32 sums."""
    return acc.add_(ops.block_gram_chain(blk, Q))


def hostblock_sketch_step(acc, blk, om):
    """``acc + blk^T om_b`` — one block of the streamed range sketch
    (``om_b`` rounded to the staged dtype)."""
    return acc.add_(ops.block_rmatvec(blk, om, dtype=blk.dtype))


def hostblock_deflate_step(acc, blk, xvb, ub, svtv):
    """``acc + blk^T (xv_b - u_b svtv)`` — one block of the fused Alg-4
    reverse sweep."""
    return acc.add_(ops.deflate_rmatvec(_dense32(blk), ub, xvb, svtv)[0])


# ---------------------------------------------------------------------------
# Resident blocks: blocked Gram, Alg-3 tiles, one Alg-4 step
# ---------------------------------------------------------------------------

def blocked_gram(blocks: torch.Tensor) -> torch.Tensor:
    """``B = sum_b blocks[b].T @ blocks[b]``; blocks (n_b, rows_b, n), fp32
    sums in block order (``ops.gram`` per block)."""
    blocks = torch.as_tensor(blocks)
    if blocks.dtype not in (torch.float32, torch.bfloat16):
        blocks = blocks.to(torch.float32)
    n = blocks.shape[-1]
    acc = torch.zeros((n, n), dtype=torch.float32, device=blocks.device)
    for blk in blocks:
        hostblock_gram_step(acc, blk)
    return acc


def tiled_gram(A: torch.Tensor, n_batches: int) -> torch.Tensor:
    """Paper Alg 3's tile structure: ``A (m x n)`` split into ``n_b``
    column batches ``A_j``; the tiles ``B_ij = A_i^T A_j`` for ``i <= j``
    only, each mirrored.  The reference for the gram kernel's task
    enumeration."""
    A = torch.as_tensor(A).to(torch.float32)
    m, n = A.shape
    plan = make_batch_plan(n, n_batches)
    bs = plan.batch_size
    n_pad = plan.n_batches * bs
    Ap = torch.zeros((m, n_pad), dtype=torch.float32, device=A.device)
    Ap[:, :n] = A
    B = torch.zeros((n_pad, n_pad), dtype=torch.float32, device=A.device)
    for i, j in symmetric_tasks(plan.n_batches):
        Bij = Ap[:, i * bs:(i + 1) * bs].mT @ Ap[:, j * bs:(j + 1) * bs]
        B[i * bs:(i + 1) * bs, j * bs:(j + 1) * bs] = Bij
        if i != j:
            B[j * bs:(j + 1) * bs, i * bs:(i + 1) * bs] = Bij.mT
    return B[:n, :n]


def blocked_deflated_matvec(blocks, U_blocks, S, V, v) -> torch.Tensor:
    """One Alg-4 step over row blocks, ``v1 = X'^T X' v`` without forming
    the residual: per block ``(Xv)_b = A_b v`` (``matvec``) and the fused
    ``A_b^T ((Xv)_b - U_b (S * V^T v))`` with ``U_b^T (Xv)_b``
    (``deflate_rmatvec``), summed in block order.

    blocks (n_b, rows_b, n), U_blocks (n_b, rows_b, k), S (k,), V (n, k),
    v (n,)."""
    Vtv = V.mT @ v
    SVtv = S * Vtv
    n, k = blocks.shape[-1], S.shape[0]
    t13 = torch.zeros((n,), dtype=torch.float32, device=v.device)
    UtXv = torch.zeros((k,), dtype=torch.float32, device=v.device)
    for A_b, U_b in zip(blocks, U_blocks):
        A_b = _dense32(A_b)
        t, u = ops.deflate_rmatvec(A_b, U_b, ops.matvec(A_b, v), SVtv)
        t13 += t
        UtXv += u
    return t13 - V @ (S * UtXv) + V @ (S * S * Vtv)


# ---------------------------------------------------------------------------
# Host-resident blocked matrix (true degree-1 OOM staging)
# ---------------------------------------------------------------------------

def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over the numpy array's memory (a copy only for
    negative strides, which torch cannot view); read only."""
    if any(s < 0 for s in a.strides):
        a = np.ascontiguousarray(a)
    with warnings.catch_warnings():        # read-only arrays: never written
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a)


def _release(res: dict) -> None:
    """A matrix's finalizer: wait for its copy stream, then unpin what it
    pinned (the device buffers go after this, with ``res``)."""
    ring = res.get("ring")
    if ring is not None:
        ring.close()
    for key in res.get("keys", ()):
        staging.unregister(key)
    res.clear()


class HostBlockedMatrix:
    """Row-blocked matrix living in host memory, streamed block-by-block.

    ``A_host`` (m, n) is split by ``make_batch_plan(m, n_blocks,
    collinear=True)``.  fp32 C-contiguous input is kept as row views of
    the caller's array (no copy; on the card its bytes are page-locked in
    place, registered once however many matrices share the array); any
    other input — another dtype, ``stage_dtype="bfloat16"``, a transposed
    or strided view — is staged into one host tensor a block, pinned on
    the card.  ``device=None`` means the card (and raises without one);
    ``device="cpu"`` streams nothing: the blocks are the host tensors.

    The staging hop is the ONE extension point, as in the JAX package:
    ``host_block(b)`` returns the staged host copy of block ``b``,
    ``block(b)`` puts it on the device (the H2D copy, under
    ``fault_hook("h2d")`` and ``retry_io``).  A block returned by
    ``block(b)`` may be read until the next ``block()`` call; the
    streamed ops below fetch in block order, one block at a time.  The
    disk tier (``core/diskio.py::MemmapMatrix``) overrides both and
    inherits every streamed op.

    ``close()`` (or the collection of the matrix) waits for the copy
    stream, unpins and frees the device buffers.
    """

    def __init__(self, A_host, n_blocks: int, stage_dtype="float32",
                 device=None):
        self.device = resolve_device(device)
        A = A_host if isinstance(A_host, np.ndarray) else np.asarray(A_host)
        if A.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {A.shape}")
        self.m, self.n = A.shape
        self.stage_dtype = resolve_sweep_dtype(stage_dtype)
        self.plan = make_batch_plan(self.m, n_blocks, collinear=True)
        self._res: dict = {"ring": None, "keys": []}
        self._finalizer = weakref.finalize(self, _release, self._res)
        self._blocks = self._stage(A)
        # resilience plumbing, installed per-solve by the driver via
        # LinearOperator.set_resilience (None = defaults, no telemetry)
        self.telemetry = None
        self.retry_policy = None

    def _stage(self, A: np.ndarray) -> list:
        pin = self.device.type == "cuda"
        bounds = [self.plan.bounds(b) for b in range(self.plan.n_batches)]
        if (A.dtype == np.float32 and self.stage_dtype == torch.float32
                and A.flags.c_contiguous):
            whole = _host_tensor(A)            # the caller's rows, no copy
            if pin:
                self._res["keys"].append(staging.register(whole))
                self._res["array"] = A         # alive while registered
            return [whole[lo:hi] for lo, hi in bounds]
        blocks = []
        for lo, hi in bounds:
            shape = (hi - lo, self.n)
            if pin:
                blk, key = staging.pinned_empty(shape, self.stage_dtype)
                self._res["keys"].append(key)
            else:
                blk = torch.empty(shape, dtype=self.stage_dtype)
            blk.copy_(_host_tensor(np.asarray(A[lo:hi], dtype=np.float32)))
            blocks.append(blk)
        return blocks

    @property
    def n_blocks(self) -> int:
        return self.plan.n_batches

    @property
    def bytes_per_pass(self) -> int:
        """H2D bytes one full stream of the host blocks moves."""
        return self.m * self.n * self.stage_dtype.itemsize

    def host_block(self, b: int) -> torch.Tensor:
        """Staged host-side copy of block ``b`` (already at stage_dtype)."""
        return self._blocks[b]

    def _ring(self) -> staging.H2DRing:
        if not self._finalizer.alive:
            raise RuntimeError("this HostBlockedMatrix was closed")
        ring = self._res["ring"]
        if ring is None:
            ring = self._res["ring"] = staging.H2DRing(
                self.plan.batch_size, self.n, self.stage_dtype, self.device)
        return ring

    def _to_device(self, blk: torch.Tensor) -> torch.Tensor:
        """The H2D hop of one staged host block (none on the CPU)."""
        if self.device.type == "cpu":
            return blk
        return self._ring().put(blk)

    def block(self, b: int) -> torch.Tensor:
        blk = self.host_block(b)

        def _put():
            fault_hook("h2d", self.telemetry)
            return self._to_device(blk)            # the H2D copy

        return retry_io(_put, site="h2d", policy=self.retry_policy,
                        telemetry=self.telemetry)

    def close(self) -> None:
        """Wait for the copy stream, unpin the host blocks and free the
        device buffers; the matrix streams no more."""
        self._finalizer()

    def _sweep(self):
        """``(lo, hi, block)`` in block order: one pass over ``A``; each
        block is fetched after the previous one's kernels are enqueued."""
        for b in range(self.n_blocks):
            lo, hi = self.plan.bounds(b)
            yield lo, hi, self.block(b)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def gram(self) -> torch.Tensor:
        """Streamed ``A^T A`` with bounded device memory."""
        acc = self._zeros(self.n, self.n)
        for _, _, blk in self._sweep():
            hostblock_gram_step(acc, blk)
        return acc

    def matvec(self, v: torch.Tensor) -> torch.Tensor:
        """``A @ v`` streamed; returns (m,)."""
        return torch.cat([hostblock_matvec(blk, v)
                          for _, _, blk in self._sweep()])

    def matmat(self, Q: torch.Tensor) -> torch.Tensor:
        """``A @ Q`` streamed; Q (n, k) -> (m, k).  One pass over A: the
        Rayleigh–Ritz extraction pass of the block driver.  ``Q`` stays
        fp32; only ``A``'s staging is narrow."""
        return torch.cat([hostblock_matmat(blk, Q)
                          for _, _, blk in self._sweep()])

    def rmatmat(self, Y: torch.Tensor) -> torch.Tensor:
        """``A.T @ Y`` streamed; Y (m, k) -> (n, k).  One pass over A."""
        acc = self._zeros(self.n, Y.shape[1])
        for lo, hi, blk in self._sweep():
            hostblock_rmatmat_step(acc, blk, Y[lo:hi])
        return acc

    def gram_chain(self, Q: torch.Tensor) -> torch.Tensor:
        """``A^T (A Q)`` in ONE streamed pass: each host block crosses to
        the device once and is multiplied against all k columns."""
        acc = self._zeros(self.n, Q.shape[1])
        for _, _, blk in self._sweep():
            hostblock_chain_step(acc, blk, Q)
        return acc

    def rmatvec_minus_correction(self, Xv_blocks, U_blocks, SVtv):
        """``sum_b A_b^T (Xv_b - U_b @ SVtv)`` streamed (fused Alg-4
        sweep)."""
        acc = self._zeros(self.n)
        for b, (_, _, blk) in enumerate(self._sweep()):
            hostblock_deflate_step(acc, blk, Xv_blocks[b], U_blocks[b],
                                   SVtv)
        return acc


class CountingHostMatrix(HostBlockedMatrix):
    """Instrumented ``HostBlockedMatrix``: counts host-block fetches.

    ``fetches / n_blocks`` is the number of full passes over ``A`` the
    driver actually streamed — the ground truth the analytic
    ``passes_over_A`` accounting is asserted against.
    """

    def __init__(self, A_host, n_blocks, stage_dtype="float32", device=None):
        super().__init__(A_host, n_blocks, stage_dtype=stage_dtype,
                         device=device)
        self.fetches = 0

    def block(self, b):
        self.fetches += 1
        return super().block(b)

    @property
    def passes(self) -> float:
        return self.fetches / self.n_blocks

    def reset_counters(self):
        self.fetches = 0


# ---------------------------------------------------------------------------
# OOM deflation engine (blocked operator, single device)
# ---------------------------------------------------------------------------

#: Back-compat alias — the per-backend result NamedTuples were unified.
OOMResult = SVDResult

#: How often the deflation loop syncs its convergence flag to the host
#: (one ``.item()`` every few steps, at the cost of at most
#: ``CONVERGENCE_CHECK_EVERY - 1`` extra steps a rank); the block driver
#: uses its lag-one check instead.
CONVERGENCE_CHECK_EVERY = 4


def _oom_deflation(op: HostBlockedMatrix, k: int, *, eps, max_iters,
                   force_iters, seed, x0=None):
    """Alg-4 rank-one deflation on the streamed host-resident operator.

    Per power step two streams of the blocks: ``matvec`` (``Xv_b =
    A_b v``, with ``U_b^T Xv_b``) and the fused reverse sweep
    ``deflate_rmatvec``; per rank one more ``matvec`` stream recovers
    ``u``.  Expects the tall orientation.  ``x0`` (k, n) replaces the
    seeded normal start vectors (for a start shared with the JAX
    package).  Returns ``(U, S, V, iters, passes)``.
    """
    m, n = op.m, op.n
    dev = op.device
    bounds = [op.plan.bounds(b) for b in range(op.n_blocks)]
    if x0 is None:
        x0 = torch.randn((k, n), generator=seeded_generator(dev, seed),
                         device=dev, dtype=torch.float32)
    else:
        x0 = _start(x0, dev)
        if tuple(x0.shape) != (k, n):
            raise ValueError(f"x0 must have shape {(k, n)}, got "
                             f"{tuple(x0.shape)}")
    U = torch.zeros((m, k), dtype=torch.float32, device=dev)
    S = torch.zeros((k,), dtype=torch.float32, device=dev)
    V = torch.zeros((n, k), dtype=torch.float32, device=dev)
    iters_out = np.zeros((k,), np.int32)
    passes = 0
    for l in range(k):
        v = x0[l] / _l2norm(x0[l])
        it = 0
        for it in range(1, max_iters + 1):
            Vtv = V.mT @ v
            SVtv = S * Vtv
            Xv_blocks = []
            UtXv = torch.zeros((k,), dtype=torch.float32, device=dev)
            for lo, hi, blk in op._sweep():            # stream 1
                xvb = hostblock_matvec(blk, v)
                Xv_blocks.append(xvb)
                UtXv += U[lo:hi].mT @ xvb
            t13 = op.rmatvec_minus_correction(         # stream 2
                Xv_blocks, [U[lo:hi] for lo, hi in bounds], SVtv)
            v1 = t13 - V @ (S * UtXv) + V @ (S * S * Vtv)
            v1 = v1 / (_l2norm(v1) + 1e-30)
            done = torch.abs(torch.dot(v, v1)) >= 1.0 - eps
            v = v1
            if force_iters:
                continue
            if it % CONVERGENCE_CHECK_EVERY == 0 or it == max_iters:
                if host_sync_scalar(done):       # sanctioned periodic sync
                    break
        iters_out[l] = it
        passes += 2 * it + 1       # 2 streams per power step + u recovery
        SVtv = S * (V.mT @ v)      # u = (A - U S V^T) v, streamed
        u = torch.cat([hostblock_matvec(blk, v) - U[lo:hi] @ SVtv
                       for lo, hi, blk in op._sweep()])
        sigma = _l2norm(u)
        U[:, l] = u / (sigma + 1e-30)
        S[l] = sigma
        V[:, l] = v
    return U, S, V, iters_out, passes


# ---------------------------------------------------------------------------
# Deprecated back-compat shim
# ---------------------------------------------------------------------------

def oom_tsvd(
    A_host: np.ndarray,
    k: int,
    *,
    n_blocks: int = 4,
    eps: float = 1e-6,
    max_iters: int = 200,
    seed: int = 0,
    method: str = "gramfree",   # legacy default (svd() uses "block")
    op: HostBlockedMatrix | None = None,
    warmup_q: int = 0,
    oversample: int = 8,
    sweep_dtype: str = "float32",
    device=None,
) -> SVDResult:
    """Deprecated: use ``repro_torch.core.svd(A_host, k, ...)`` — a numpy
    array (or a pre-built ``HostBlockedMatrix``) dispatches to the
    out-of-core backend.  The JAX package's ``key=`` has no torch
    counterpart: the start is drawn from the integer ``seed``."""
    from repro_torch.core.svd import svd, warn_legacy
    warn_legacy("oom_tsvd")
    cfg = SVDConfig(method=method, eps=eps, max_iters=max_iters,
                    warmup_q=warmup_q, oversample=oversample,
                    sweep_dtype=sweep_dtype, n_blocks=n_blocks, seed=seed)
    return svd(op if op is not None else np.asarray(A_host), k,
               config=cfg, device=device)
