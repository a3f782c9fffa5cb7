"""The blocked-operator protocol behind the SVD front door (PyTorch port).

``LinearOperator`` is the surface the shared block driver
(``core/svd.py``) needs, as in the JAX package's
``repro/core/operator.py``.  Its adapters here: ``DenseOperator`` for a
tensor resident on one device, ``HostBlockedOperator`` for the row
blocks of a host matrix streamed to the device (``core/oom.py``), and
``MemmapOperator`` for a matrix on disk (``core/diskio.py``): the
demotion ladder dense -> host-blocked -> memmap of the JAX package; and
``SparseStreamOperator`` for a streamed sparse matrix
(``core/sparse.py``).  The sharded adapter comes with a later slice of
the port (ROADMAP.md, queue 1).

Every A-sized product of ``DenseOperator`` goes through the sweep
wrappers of ``kernels/ops.py``: on the card those launch the Hopper
kernels, on the CPU (which the caller must ask for) their plain
versions.  QR, the subspace gap and Rayleigh–Ritz stay ``torch.linalg``
/ small products, as they were XLA ops in the JAX package.

Pass and byte accounting is the JAX package's: on the dense tier
``gram_chain`` costs ``chain_passes = 2`` sweeps, ``range_sketch``,
``matmat``, ``rmatmat`` and ``extract`` one each, ``bytes_per_pass = M *
N * itemsize(sweep dtype)`` and ``bytes_moved = {"device": passes *
bytes_per_pass}``; on the streamed tiers a pass is one stream of the
host blocks (the fused chain one, ``chain_passes = 1``) and
``bytes_moved`` adds the host tier (and the disk tier's counters); on
the sparse stream a pass is one stream of the nonzeros, ``bytes_per_pass
= nnz * itemsize(sweep dtype)`` and ``bytes_moved = {"host": passes *
bytes_per_pass}``, the JAX package's numbers (the real PCIe bytes, which
carry the columns and offsets too, are the stream's ``feed_stats``).
``lagged_sync``: CUDA launches and the streamed tiers' copies are
asynchronous, so the driver's lagged ``.item()`` of the previous gap
lands after the next step is queued.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from repro_torch.core.errors import InputError
from repro_torch.core.precision import dtype_name, resolve_sweep_dtype
from repro_torch.core.staging import pitch
from repro_torch.core.tsvd import (rayleigh_ritz_from_W, seeded_generator,
                                   warm_start_width)
from repro_torch.kernels import ops

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "HostBlockedOperator",
    "MemmapOperator",
    "SparseStreamOperator",
    "host_sync_scalar",
    "resolve_device",
    "warm_start_width",
]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  ``None`` means ``"cuda"`` and raises when no card
    is visible — the port never moves to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the GPU by default and no CUDA device "
                "is visible; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def host_sync_scalar(x):
    """The ONE sanctioned device->host sync in the driver loop: blocks
    until ``x`` (a 0-d tensor, numpy scalar or python number) is ready
    and returns it as a python scalar.  A scalar from ``_gap`` on the
    card was copied to pinned host memory when it was produced, so this
    waits for the work that made it, not for the work the driver queued
    after it (``x.item()`` would queue its copy behind that)."""
    if isinstance(x, (bool, int, float)):
        return x
    staged = getattr(x, "_repro_host", None)
    if staged is not None:
        host, ready = staged
        ready.synchronize()
        return host.item()
    return x.item()


def _orth(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(X).Q


def _gap(Q: torch.Tensor, Qn: torch.Tensor) -> torch.Tensor:
    # sum of squared sines of the principal angles between span(Q) and
    # span(Qn): invariant to rotations within the subspace.  Returned
    # unsynced — a 0-d device tensor the driver floats one step late.
    g = Q.shape[1] - torch.sum((Q.mT @ Qn) ** 2)
    if g.is_cuda:
        # its copy to the host starts now, in stream order: the lagged
        # read (host_sync_scalar) then waits for this step alone, while
        # the next step's work, and the streamed tiers' copies of the next
        # pass, are already queued behind it
        host = torch.empty((), dtype=g.dtype, pin_memory=True)
        host.copy_(g, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        g._repro_host = (host, ready)
    return g


# ---------------------------------------------------------------------------
# Protocol / base class
# ---------------------------------------------------------------------------

#: serializes first-touch creation of the per-operator solve lock for
#: duck-typed operators that never ran ``LinearOperator.__init__``
_SOLVE_GUARD_INIT = threading.Lock()


class LinearOperator:
    """Base class + protocol for the shared block-iteration driver.

    Subclasses implement ``shape``, ``matmat``, ``rmatmat``,
    ``range_sketch``, ``random_block`` and ``bytes_per_pass``; the
    defaults below supply everything else.  Implementations MUST call
    ``self._count(n)`` once per A-sized sweep so ``passes`` stays the
    ground truth of the accounting.
    """

    #: passes one ``gram_chain`` costs (two A-sized sweeps)
    chain_passes = 2
    #: passes one ``range_sketch`` costs
    sketch_passes = 1
    #: driver syncs the convergence scalar one iteration late
    lagged_sync = False
    #: tag reported in ``SVDResult.backend``
    backend = "operator"

    def __init__(self):
        self._passes = 0
        self._telemetry = None
        self._retry_policy = None
        self._solve_lock = threading.Lock()

    def _count(self, n):
        self._passes += n

    # -- exclusive-solve guard (one driver loop per operator instance) ------

    def acquire_solve(self):
        """Claim this operator for one driver loop.  The pass/byte
        counters and the per-solve telemetry are instance state, so two
        interleaved solves on ONE operator would cross-wire them; reusing
        a live operator raises the typed ``InputError`` instead."""
        lock = self.__dict__.get("_solve_lock")
        if lock is None:
            with _SOLVE_GUARD_INIT:
                lock = self.__dict__.setdefault("_solve_lock",
                                                threading.Lock())
        if not lock.acquire(blocking=False):
            raise InputError(
                f"operator {self.fingerprint!r} is already running a "
                f"solve: LinearOperator instances hold per-solve mutable "
                f"state (pass/byte counters, fault telemetry) and cannot "
                f"be shared by concurrent svd() calls — build one "
                f"operator per job")

    def release_solve(self):
        """Release the exclusive-solve claim (idempotent)."""
        lock = self.__dict__.get("_solve_lock")
        if lock is not None and lock.locked():
            try:
                lock.release()
            except RuntimeError:  # pragma: no cover - released elsewhere
                pass

    @property
    def passes(self):
        """A-sized operand sweeps performed so far (the accounting)."""
        return self._passes

    def reset_passes(self):
        self._passes = 0

    def reset_counters(self):
        """Zero the pass/byte counters before a solve's delta accounting."""
        self.reset_passes()

    # -- required surface ---------------------------------------------------

    @property
    def shape(self) -> tuple[int, int]:
        raise NotImplementedError

    @property
    def dtype(self):
        return torch.float32

    def matmat(self, Q):
        """``A @ Q`` at full (fp32) precision — one pass over ``A``."""
        raise NotImplementedError

    def rmatmat(self, Y):
        """``A.T @ Y`` at full (fp32) precision — one pass over ``A``."""
        raise NotImplementedError

    def range_sketch(self, l, seed):
        """``A.T @ Omega``, ``Omega ~ N(0,1)^(M x l)`` from the
        operator's native RNG — one pass over ``A``."""
        raise NotImplementedError

    def random_block(self, k, seed):
        """An (N, k) standard-normal block (NOT orthonormalized)."""
        raise NotImplementedError

    @property
    def bytes_per_pass(self) -> int:
        """Bytes one A-sized pass moves at the configured sweep dtype."""
        raise NotImplementedError

    # -- defaults the adapters may override ---------------------------------

    @property
    def bytes_moved(self) -> dict[str, int]:
        """Total bytes moved so far, per memory tier: every pass reads
        ``A`` from device memory."""
        return {"device": self.passes * self.bytes_per_pass}

    def gram_chain(self, Q):
        """``A.T @ (A @ Q)`` honoring the sweep-dtype policy (default:
        the two exact products, counted by the sub-calls)."""
        return self.rmatmat(self.matmat(Q))

    def orth(self, X):
        """Orthonormalize columns (thin-QR Q factor)."""
        return _orth(X)

    def subspace_gap(self, Q, Qn):
        """Rotation-invariant gap ``l - ||Q^T Qn||_F^2`` (an unsynced
        0-d tensor; the driver floats it)."""
        return _gap(Q, Qn)

    def extract(self, Q):
        """Rayleigh–Ritz extraction from the converged basis: one
        ``matmat`` pass + small QR/SVD factorizations."""
        return rayleigh_ritz_from_W(self.matmat(Q), Q)

    # -- solver-state round-trip (warm restarts, cross-package states) ------

    def to_host(self, X) -> np.ndarray:
        """The iterate as a host fp32 numpy array."""
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu()
        return np.asarray(X, np.float32)

    def from_host(self, W):
        """A host fp32 array lifted into the operator's namespace (a
        copy: host trees may hold read-only arrays), on its ``device``
        where it has one."""
        return torch.tensor(np.asarray(W, np.float32),
                            device=getattr(self, "device", None))

    @property
    def fingerprint(self) -> str:
        """Identity of the problem — backend, shape, element/sweep dtypes;
        the JAX package's string for the same problem."""
        m, n = self.shape
        sd = getattr(self, "sweep_dtype", "float32")
        return f"{self.backend}:{int(m)}x{int(n)}:{dtype_name(self.dtype)}:{sd}"

    # -- resilience (core/faults.py) ----------------------------------------

    def set_resilience(self, telemetry=None, retry_policy=None):
        """Install the per-solve fault telemetry + retry policy."""
        self._telemetry = telemetry
        self._retry_policy = retry_policy

    def demote(self, cfg):
        """The next-lower memory tier for this problem, as a fresh
        operator carrying the SAME matrix — or None when there is no
        lower tier.  Called by the driver when a step hits device OOM."""
        return None


# ---------------------------------------------------------------------------
# DenseOperator — a tensor resident on one device
# ---------------------------------------------------------------------------

def sweep_copy(A: torch.Tensor, sd: torch.dtype) -> torch.Tensor:
    """``A`` (m, n) in the sweep dtype ``sd``: ``A`` itself where the
    dtype is already ``sd``; else a copy whose rows are padded to whole
    16 bytes, as an (m, n) view of the (m, ld) allocation, so that a TMA
    tensor map describes it whatever n is."""
    if A.dtype == sd:
        return A
    m, n = A.shape
    out = torch.empty((m, pitch(n, sd)), dtype=sd, device=A.device)[:, :n]
    out.copy_(A)
    return out


class DenseOperator(LinearOperator):
    """An in-memory ``(M, N)`` tensor behind the protocol.

    ``device=None`` means the card (and raises without one); the tests
    pass ``device="cpu"``.  The driver expects the tall orientation
    (M >= N); the front door hands a wide input in as the transposed
    VIEW ``A.mT``.  That view is column-major, and the operator keeps
    the row-major ``A`` underneath and swaps the kernels
    (``X @ Q = block_rmatvec(A, Q)``, ``X^T @ Y = block_matvec(A, Y)``)
    instead of copying: a contiguous transpose of a 32 GiB ``A`` would
    cost another 32 GiB of device memory.

    The sweeps of ``gram_chain`` and ``range_sketch`` read ``A`` at
    ``sweep_dtype`` (cast once, here: the bf16 copy holds half of A's
    bytes beside it); ``matmat``/``rmatmat``/``extract`` stay fp32.  The
    bf16 copy is an ``(m, n)`` view of rows padded to whole 16 bytes
    (``sweep_copy``), so that the tensor cores' kernel reads it at any
    width; the padding is never read.  The fp32 ``A`` is never copied.
    """

    backend = "dense"
    lagged_sync = True

    def __init__(self, X, *, device=None, sweep_dtype="float32"):
        super().__init__()
        self.device = resolve_device(device)
        X = torch.as_tensor(X).to(device=self.device, dtype=torch.float32)
        if X.ndim != 2:
            raise InputError(f"DenseOperator takes a 2-D matrix, got "
                             f"shape {tuple(X.shape)}")
        self._shape = (int(X.shape[0]), int(X.shape[1]))
        # a column-major X is A^T of a row-major A: keep A, swap sweeps
        self._trans = not X.is_contiguous() and X.mT.is_contiguous()
        self._A = X.mT if self._trans else X.contiguous()
        sd = resolve_sweep_dtype(sweep_dtype)
        self.sweep_dtype = dtype_name(sd)
        self._As = sweep_copy(self._A, sd)     # no copy for fp32 sweeps

    @property
    def shape(self):
        return self._shape

    def _fwd(self, A, Q):
        """``X @ Q`` for ``X = A`` or ``X = A^T``."""
        return ops.block_rmatvec(A, Q) if self._trans else \
            ops.block_matvec(A, Q)

    def _bwd(self, A, Y):
        """``X^T @ Y`` for ``X = A`` or ``X = A^T``."""
        return ops.block_matvec(A, Y) if self._trans else \
            ops.block_rmatvec(A, Y)

    def matmat(self, Q):
        self._count(1)
        return self._fwd(self._A, Q)

    def rmatmat(self, Y):
        self._count(1)
        return self._bwd(self._A, Y)

    def gram_chain(self, Q):
        self._count(self.chain_passes)
        return ops.block_gram_chain(self._As, Q, trans=self._trans)

    def range_sketch(self, l, seed):
        self._count(self.sketch_passes)
        Om = torch.randn((self._shape[0], l), generator=seeded_generator(
            self.device, seed), device=self.device, dtype=torch.float32)
        return self._bwd(self._As, Om)

    def random_block(self, k, seed):
        return torch.randn((self._shape[1], k), generator=seeded_generator(
            self.device, seed), device=self.device, dtype=torch.float32)

    def extract(self, Q):
        self._count(1)
        return rayleigh_ritz_from_W(self._fwd(self._A, Q), Q)

    def demote(self, cfg):
        """Device OOM: pull ``A`` back to the host and stream it block by
        block (same math, same sweep dtype, an H2D copy per block in
        place of a device-resident ``A``)."""
        from repro_torch.core.oom import HostBlockedMatrix
        A = self._A.cpu().numpy()
        host = HostBlockedMatrix(A.T if self._trans else A, cfg.n_blocks,
                                 stage_dtype=self.sweep_dtype,
                                 device=self.device)
        return HostBlockedOperator(host)

    @property
    def bytes_per_pass(self):
        m, n = self._shape
        return m * n * self._As.element_size()


# ---------------------------------------------------------------------------
# HostBlockedOperator — host-resident row blocks streamed H2D (degree-1)
# ---------------------------------------------------------------------------

class HostBlockedOperator(LinearOperator):
    """Wraps a ``HostBlockedMatrix`` (or an instrumented subclass).

    A "pass" is one full H2D stream of the host blocks — the paper's
    dominant degree-1 cost.  The fused ``gram_chain`` copies each block
    ONCE for both sweep halves (``chain_passes = 1``), and the sketch's
    Omega row blocks are drawn one block at a time, never resident.
    ``lagged_sync``: the driver syncs the convergence scalar one
    iteration late, so the host never waits inside a pass and the copy
    stream runs ahead.  The sweep dtype is the matrix's ``stage_dtype``
    (bf16 staging halves every H2D copy; sums stay fp32).
    """

    backend = "hostblocked"
    chain_passes = 1
    lagged_sync = True

    def __init__(self, host):
        super().__init__()
        self._host = host
        self.device = host.device
        self.sweep_dtype = dtype_name(host.stage_dtype)

    @property
    def host(self):
        return self._host

    @property
    def shape(self):
        return (self._host.m, self._host.n)

    def matmat(self, Q):
        self._count(1)
        return self._host.matmat(Q)

    def rmatmat(self, Y):
        self._count(1)
        return self._host.rmatmat(Y)

    def gram_chain(self, Q):
        self._count(self.chain_passes)
        return self._host.gram_chain(Q)

    def range_sketch(self, l, seed):
        """``A^T Omega`` in one stream: each block's Omega rows drawn
        from one seeded generator in block order and rounded to the
        staged dtype."""
        from repro_torch.core.oom import hostblock_sketch_step
        self._count(self.sketch_passes)
        host = self._host
        g = seeded_generator(self.device, seed)
        acc = torch.zeros((host.n, l), dtype=torch.float32,
                          device=self.device)
        for lo, hi, blk in host._sweep():     # one pass; Omega never whole
            om = torch.randn((hi - lo, l), generator=g, device=self.device,
                             dtype=torch.float32)
            hostblock_sketch_step(acc, blk, om)
        return acc

    def random_block(self, k, seed):
        return torch.randn((self._host.n, k), generator=seeded_generator(
            self.device, seed), device=self.device, dtype=torch.float32)

    def reset_counters(self):
        self.reset_passes()
        reset = getattr(self._host, "reset_counters", None)
        if reset is not None:
            reset()

    def set_resilience(self, telemetry=None, retry_policy=None):
        # the staging hops live on the matrix, so the retry loop's
        # telemetry/policy must land there
        super().set_resilience(telemetry, retry_policy)
        self._host.telemetry = telemetry
        self._host.retry_policy = retry_policy

    def demote(self, cfg):
        """Host pressure: spill the staged blocks to a temp ``.npy`` and
        re-wrap them as the disk tier, with the same block plan (so the
        streamed accumulation order, and with it the bits, is unchanged).
        The host cache budget is ``cfg.host_budget_bytes`` when set, else
        half the file.  The caller owns the temp file (``spill_path``)."""
        import tempfile
        from repro_torch.core.diskio import MemmapMatrix, write_npy
        host = self._host
        fd, path = tempfile.mkstemp(suffix=".npy", prefix="repro_demoted_")
        os.close(fd)
        write_npy(path, (host.m, host.n), host.stage_dtype,
                  ((host.plan.bounds(b)[0], host.host_block(b))
                   for b in range(host.n_blocks)))  # nothing A-sized
        budget = cfg.host_budget_bytes or (
            host.m * host.n * host.stage_dtype.itemsize) // 2
        mm = MemmapMatrix(path, host.n_blocks, stage_dtype=host.stage_dtype,
                          host_budget_bytes=budget, device=host.device)
        op = MemmapOperator(mm)
        op.spill_path = path
        return op

    @property
    def bytes_per_pass(self):
        return self._host.bytes_per_pass

    @property
    def bytes_moved(self):
        # every pass crosses the host tier (the H2D copy of the staged
        # blocks) and is then read once from device memory
        moved = self.passes * self.bytes_per_pass
        return {"host": moved, "device": moved}


# ---------------------------------------------------------------------------
# MemmapOperator — disk-resident row blocks staged disk->host->device
# ---------------------------------------------------------------------------

class MemmapOperator(HostBlockedOperator):
    """Wraps a ``MemmapMatrix`` (``core/diskio.py``): the disk tier.

    The host tier's streaming and pass semantics, plus the disk rung:
    ``bytes_moved`` reports the matrix's ACTUAL tier counters, so a
    host cache that holds every staged block shows one cold file read
    and a capped budget one disk read per pass.
    """

    backend = "memmap"

    def demote(self, cfg):
        return None          # disk is the bottom of the ladder

    @property
    def bytes_moved(self):
        return self._host.bytes_moved


# ---------------------------------------------------------------------------
# SparseStreamOperator — a procedural sparse (or duck-typed streamed) matrix
# ---------------------------------------------------------------------------

def stream_call(sp, name: str, X, block_rows: int, device, **kw):
    """``sp.<name>(X, block_rows, **kw)`` on ``device``.  The port's own
    streams (``streams_on_device``) take the tensor and run on its
    device; any other object keeps the JAX package's contract, numpy in
    and numpy out on the host, and its result is lifted to ``device``."""
    if getattr(sp, "streams_on_device", False):
        return getattr(sp, name)(X, block_rows, device=device, **kw)
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    out = getattr(sp, name)(X, block_rows, **kw)
    return torch.as_tensor(np.asarray(out, np.float32), device=device)


class SparseStreamOperator(LinearOperator):
    """Wraps a streamed matrix (``SyntheticSparseMatrix``,
    ``ScipySparseMatrix``, ``DenseStreamOperator``, or anything with their
    ``matmat``/``rmatmat``/``gram_chain``/``range_sketch`` surface).

    A "pass" is one full stream of the nonzeros; ``gram_chain`` runs both
    sweep halves on each streamed block (``chain_passes = 1``).  The
    chain and the sketch read the values at ``sweep_dtype`` with fp32
    sums; the extraction pass is fp32.  The JAX package's choices stay:
    ``lagged_sync = False`` (the gap is read every step), and the cold
    start ``random_block`` is numpy's ``default_rng(seed)``, so both
    packages start from the same ``Q0``.  The iterate lives on
    ``device`` and is orthonormalized there.
    """

    backend = "sparsestream"
    chain_passes = 1

    def __init__(self, sp, *, block_rows=1 << 16, sweep_dtype="float32",
                 device=None):
        super().__init__()
        self._sp = sp
        self._block_rows = block_rows
        self.sweep_dtype = dtype_name(resolve_sweep_dtype(sweep_dtype))
        self.device = resolve_device(device)

    @property
    def shape(self):
        return (self._sp.m, self._sp.n)

    def _call(self, name, X, **kw):
        return stream_call(self._sp, name, X, self._block_rows, self.device,
                           **kw)

    def matmat(self, Q):
        self._count(1)
        return self._call("matmat", Q)

    def rmatmat(self, Y):
        self._count(1)
        return self._call("rmatmat", Y)

    def gram_chain(self, Q):
        self._count(self.chain_passes)
        return self._call("gram_chain", Q, dtype=self.sweep_dtype)

    def range_sketch(self, l, seed):
        self._count(self.sketch_passes)
        kw = {"seed": seed, "block_rows": self._block_rows,
              "dtype": self.sweep_dtype}
        if getattr(self._sp, "streams_on_device", False):
            return self._sp.range_sketch(l, device=self.device, **kw)
        return self.from_host(self._sp.range_sketch(l, **kw))

    def random_block(self, k, seed):
        rng = np.random.default_rng(seed)
        return self.from_host(
            rng.standard_normal((self._sp.n, k)).astype(np.float32))

    @property
    def bytes_per_pass(self):
        sp = self._sp
        elems = getattr(sp, "nnz", sp.m * sp.n)
        return elems * resolve_sweep_dtype(self.sweep_dtype).itemsize

    @property
    def bytes_moved(self):
        # the JAX package's accounting: the nonzero stream is generated or
        # read on the host, once a pass
        return {"host": self.passes * self.bytes_per_pass}
