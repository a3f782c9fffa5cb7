"""The blocked-operator protocol behind the SVD front door (PyTorch port).

``LinearOperator`` is the surface the shared block driver
(``core/svd.py``) needs, as in the JAX package's
``repro/core/operator.py``; ``DenseOperator`` is its in-memory adapter
for a tensor resident on one device.  The other adapters of the JAX
package (sharded, host-blocked, memmap, sparse-stream) come with later
slices of the port (ROADMAP.md, queue 1).

Every A-sized product of ``DenseOperator`` goes through the sweep
wrappers of ``kernels/ops.py``: on the card those launch the Hopper
kernels, on the CPU (which the caller must ask for) their plain
versions.  QR, the subspace gap and Rayleigh–Ritz stay ``torch.linalg``
/ small products, as they were XLA ops in the JAX package.

Pass and byte accounting is the JAX package's: ``gram_chain`` costs
``chain_passes = 2`` sweeps, ``range_sketch``, ``matmat``, ``rmatmat``
and ``extract`` one each, ``bytes_per_pass = M * N * itemsize(sweep
dtype)`` and ``bytes_moved = {"device": passes * bytes_per_pass}``.
``lagged_sync``: CUDA launches are asynchronous, so the driver's lagged
``.item()`` of the previous gap lands after the next step is queued.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.errors import InputError
from repro_torch.core.precision import dtype_name, resolve_sweep_dtype
from repro_torch.core.tsvd import rayleigh_ritz_from_W, warm_start_width
from repro_torch.kernels import ops

__all__ = [
    "LinearOperator",
    "DenseOperator",
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
    and returns it as a python scalar."""
    if isinstance(x, (bool, int, float)):
        return x
    return x.item()


def _orth(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(X).Q


def _gap(Q: torch.Tensor, Qn: torch.Tensor) -> torch.Tensor:
    # sum of squared sines of the principal angles between span(Q) and
    # span(Qn): invariant to rotations within the subspace.  Returned
    # unsynced — a 0-d device tensor the driver floats one step late.
    return Q.shape[1] - torch.sum((Q.mT @ Qn) ** 2)


def _generator(device: torch.device, seed: int) -> torch.Generator:
    """The operator-native RNG: a ``torch.Generator`` on the operand's
    device seeded with ``cfg.seed``.  It does not reproduce the JAX
    package's threefry draws; the subspace, not the values, is the
    contract between the packages."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


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
        copy: host trees may hold read-only arrays)."""
        return torch.tensor(np.asarray(W, np.float32))

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
    bytes beside it); ``matmat``/``rmatmat``/``extract`` stay fp32.
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
        self._As = self._A.to(sd)              # no copy for fp32 sweeps

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
        Om = torch.randn((self._shape[0], l), generator=_generator(
            self.device, seed), device=self.device, dtype=torch.float32)
        return self._bwd(self._As, Om)

    def random_block(self, k, seed):
        return torch.randn((self._shape[1], k), generator=_generator(
            self.device, seed), device=self.device, dtype=torch.float32)

    def extract(self, Q):
        self._count(1)
        return rayleigh_ritz_from_W(self._fwd(self._A, Q), Q)

    def from_host(self, W):
        return torch.tensor(np.asarray(W, np.float32), device=self.device)

    @property
    def bytes_per_pass(self):
        m, n = self._shape
        return m * n * self._As.element_size()
