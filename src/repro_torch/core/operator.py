"""The blocked-operator protocol behind the SVD front door (PyTorch port).

``LinearOperator`` is the surface the shared block driver
(``core/svd.py``) needs, as in the JAX package's
``repro/core/operator.py``.  Its adapters here: ``DenseOperator`` for a
tensor resident on one device, ``HostBlockedOperator`` for the row
blocks of a host matrix streamed to the device (``core/oom.py``), and
``MemmapOperator`` for a matrix on disk (``core/diskio.py``): the
demotion ladder dense -> host-blocked -> memmap of the JAX package;
``SparseStreamOperator`` for a streamed sparse matrix
(``core/sparse.py``); and ``ShardedOperator`` for the rows of ``A``
sharded over the axes of a ``torch.distributed`` device mesh, one rank
each (the paper's N-GPU layout; ``core/collectives.py``), with its own
ladder of each rank's rows: ``ShardedHostOperator`` (host) ->
``ShardedMemmapOperator`` (disk).

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
    "ShardedOperator",
    "ShardedHostOperator",
    "ShardedMemmapOperator",
    "ShardLayout",
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


def stage_scalar(x: torch.Tensor) -> torch.Tensor:
    """``x`` (0-d) with its copy to pinned host memory started now, in
    stream order, where it lives on the card: a later
    ``host_sync_scalar(x)`` then waits for the work that made it alone,
    while the work queued after it (the next step, the streamed tiers'
    copies of the next pass) runs on."""
    if x.is_cuda:
        host = torch.empty((), dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        x._repro_host = (host, ready)
    return x


def _gap(Q: torch.Tensor, Qn: torch.Tensor) -> torch.Tensor:
    # sum of squared sines of the principal angles between span(Q) and
    # span(Qn): invariant to rotations within the subspace.  Returned
    # unsynced — a 0-d device tensor the driver floats one step late.
    return stage_scalar(Q.shape[1] - torch.sum((Q.mT @ Qn) ** 2))


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

    # -- ranks (a sharded operator is driven by every rank of its mesh) ------

    #: this process writes the solver's checkpoints (on a mesh: one rank)
    writes_checkpoints = True

    def sync_ranks(self):
        """Wait for every rank driving this operator (none but this one
        here)."""


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
# ShardedOperator — rows of A sharded over torch.distributed mesh axes
# ---------------------------------------------------------------------------

class ShardLayout:
    """Where this rank's rows of a matrix row-sharded over ``axes`` of
    ``mesh`` live: the one process group over those axes
    (``launch/mesh.py::axes_group``), the shard count, this rank's flat
    shard index (row-major over ``axes``, as ``P(("pod", "data"), None)``
    orders the rows), the device (from the mesh) and the DTensor
    placements of such a matrix."""

    def __init__(self, mesh, axes=("data",), device=None):
        import torch.distributed as dist
        from torch.distributed.tensor import Replicate, Shard
        from repro_torch.launch.mesh import (axes_group, mesh_device,
                                             shard_count)
        self.device = mesh_device(mesh)
        want = None if device is None else torch.device(device)
        if want is not None and (want.type != self.device.type or (
                want.index is not None and want.index != self.device.index)):
            raise ValueError(f"device={device!r} disagrees with the mesh, "
                             f"whose rank {dist.get_rank()} lives on "
                             f"{self.device}; drop device= on a mesh")
        self.mesh, self.axes = mesh, tuple(axes)
        names = tuple(mesh.mesh_dim_names or ())
        if not self.axes or any(a not in names for a in self.axes):
            raise ValueError(f"axes {self.axes} are not dims of the mesh "
                             f"{names}")
        dims = [names.index(a) for a in self.axes]
        if dims != sorted(dims):
            raise ValueError(f"axes {self.axes} must follow the mesh's own "
                             f"order {names}")
        self.group = axes_group(mesh, self.axes)
        self.n_shards = shard_count(mesh, self.axes)
        coord = mesh.get_coordinate()
        self.index = 0
        for d in dims:
            self.index = self.index * mesh.size(d) + coord[d]
        if self.index != dist.get_rank(self.group):
            raise ValueError(
                f"rank {dist.get_rank()} is shard {self.index} of the mesh "
                f"but rank {dist.get_rank(self.group)} of its group: build "
                f"the mesh over ranks in row-major order")
        self.placements = [Shard(0) if name in self.axes else Replicate()
                           for name in names]
        # dims outside the axes replicate the rows, so shard 0 is one rank
        # for each of their coordinates: the checkpoints have one writer,
        # the mesh's first rank, and every rank of the mesh waits for it
        self.writes_checkpoints = (dist.get_rank()
                                   == int(mesh.mesh.flatten()[0]))
        self.mesh_group = axes_group(mesh, names)

    def sync(self) -> None:
        """Wait for every rank of the mesh."""
        from repro_torch.core.collectives import barrier
        barrier(self.mesh_group)

    def check_rows(self, m: int) -> int:
        """Rows a shard holds; the reference's error when they do not
        divide."""
        if m % self.n_shards:
            raise ValueError(f"m={m} not divisible by shards={self.n_shards}; "
                             "pad first")
        return m // self.n_shards

    def local_rows(self, X) -> torch.Tensor:
        """This rank's rows of ``X`` (the tall orientation: a tensor, an
        ndarray, either's transposed view, or a DTensor) as a contiguous
        fp32 tensor on the rank's device.  Only those rows are copied: of
        a transposed view, the column slice of the matrix beneath it."""
        from torch.distributed.tensor import DTensor
        if isinstance(X, DTensor):
            if X.device_mesh != self.mesh:
                raise ValueError("the DTensor lives on another mesh than "
                                 "mesh=")
            self.check_rows(X.shape[0])
            X = X.redistribute(self.mesh, self.placements).to_local()
            return X.to(device=self.device, dtype=torch.float32).contiguous()
        m_loc = self.check_rows(X.shape[0])
        rows = X[self.index * m_loc:(self.index + 1) * m_loc]
        if isinstance(rows, np.ndarray):
            rows = torch.from_numpy(np.array(rows, np.float32))
        return rows.to(device=self.device,
                       dtype=torch.float32).contiguous()

    def dtensor(self, X_loc: torch.Tensor, m: int):
        """The row-sharded global ``(m, ...)`` DTensor of this rank's rows
        (``full_tensor()`` gathers it)."""
        from torch.distributed.tensor import DTensor
        shape = (m, *X_loc.shape[1:])
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(X_loc.contiguous(), self.mesh,
                                  self.placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)


def _shard_seed(seed: int, index: int) -> int:
    """The sketch's seed for shard ``index``: one stream per (seed,
    shard), so no rank draws another's rows of Omega."""
    return int(np.random.SeedSequence([int(seed) % 2**64, index])
               .generate_state(1, np.uint64)[0])


def sharded_extract(W_loc, Q, all_reduce):
    """Rayleigh–Ritz of ``A`` row-sharded, from this rank's rows ``W_loc``
    of ``A Q``: the all-reduced ``(l, l)`` Gram of ``W``, ``eigh`` on every
    rank.  Returns this rank's rows of ``U``, ``S`` and ``V``."""
    lam, P = torch.linalg.eigh(all_reduce(W_loc.mT @ W_loc))   # ascending
    lam, P = lam.flip(0), P.flip(1)
    S = torch.sqrt(torch.clamp(lam, min=0.0))
    # zero, don't 1/eps-blow-up, the directions beyond the numerical rank
    # (lam ~ 0): their U columns are noise either way, but every entry
    # stays finite when k > rank(A)
    inv = torch.where(S > 1e-6 * S[0], 1.0 / (S + 1e-30),
                      torch.zeros_like(S))
    return (W_loc @ P) * inv, S, Q @ P


class _OnShards:
    """What the operators of a row-sharded matrix share: the sums over
    their layout's group, and its one checkpoint writer and barrier."""

    def _sum(self, X):
        from repro_torch.core.collectives import all_reduce
        return all_reduce(X, self.layout.group)

    @property
    def writes_checkpoints(self) -> bool:
        return self.layout.writes_checkpoints

    def sync_ranks(self):
        self.layout.sync()

    @property
    def fingerprint(self):
        return super().fingerprint + f":shards={self.layout.n_shards}"


class ShardedOperator(_OnShards, LinearOperator):
    """``A`` row-sharded over ``axes`` of a ``torch.distributed`` device
    mesh (the paper's N-GPU map); every rank of the mesh builds one and
    drives the same solve.

    ``A`` is the tall global matrix (a tensor or an ndarray, of which
    this rank keeps and copies only its rows) or a ``DTensor``
    row-sharded over the axes.  Each A-sized product is a local sweep of
    the rank's rows on the kernels of ``kernels/ops.py`` followed by at
    most ONE collective over the axes' group: ``gram_chain`` is the
    local ``A_loc^T (A_loc Q)`` (``ops.block_gram_chain`` on the sweep
    copy, bf16 rows padded as ``DenseOperator`` pads them) and one
    ``(n, k)`` fp32 all-reduce; ``rmatmat`` and ``range_sketch`` one
    all-reduce each (the sketch's Omega drawn a row block a shard, from a
    generator seeded by (seed, shard), never whole); ``matmat`` none (its
    result is this rank's rows); ``extract`` Rayleigh–Ritz through the
    all-reduced ``(l, l)`` Gram of ``W = A Q`` (``sharded_extract``).
    QR, the gap and the small products run replicated on every rank: the
    all-reduces give every rank the same bits, so every rank takes the
    same steps and stops at the same one.  ``extract`` returns this
    rank's rows of ``U``.  ``lagged_sync``: the gap is read one iteration
    late.  ``ShardedOperator.on_layout`` builds one on a ``ShardLayout``
    its caller has already made.
    """

    backend = "sharded"
    lagged_sync = True

    def __init__(self, A, mesh, axes=("data",), *, sweep_dtype="float32",
                 device=None):
        self._place(A, ShardLayout(mesh, axes, device), sweep_dtype)

    @classmethod
    def on_layout(cls, A, layout: ShardLayout, *, sweep_dtype="float32"):
        op = cls.__new__(cls)
        op._place(A, layout, sweep_dtype)
        return op

    def _place(self, A, layout: ShardLayout, sweep_dtype) -> None:
        LinearOperator.__init__(self)
        self.layout = layout
        self.mesh, self.axes = layout.mesh, layout.axes
        self.n_shards, self.device = layout.n_shards, layout.device
        if len(A.shape) != 2:
            raise InputError(f"ShardedOperator takes a 2-D matrix, got "
                             f"shape {tuple(A.shape)}")
        self._shape = (int(A.shape[0]), int(A.shape[1]))
        self._A = layout.local_rows(A)
        sd = resolve_sweep_dtype(sweep_dtype)
        self.sweep_dtype = dtype_name(sd)
        self._As = sweep_copy(self._A, sd)     # no copy for fp32 sweeps

    @property
    def shape(self):
        return self._shape

    def matmat(self, Q):
        self._count(1)
        return ops.block_matvec(self._A, Q)

    def rmatmat(self, Y):
        self._count(1)
        return self._sum(ops.block_rmatvec(self._A, Y))

    def gram_chain(self, Q):
        self._count(self.chain_passes)
        return self._sum(ops.block_gram_chain(self._As, Q))

    def range_sketch(self, l, seed):
        self._count(self.sketch_passes)
        g = seeded_generator(self.device, _shard_seed(seed, self.layout.index))
        Om = torch.randn((self._A.shape[0], l), generator=g,
                         device=self.device, dtype=torch.float32)
        return self._sum(ops.block_rmatvec(self._As, Om))

    def random_block(self, k, seed):
        return torch.randn((self._shape[1], k), generator=seeded_generator(
            self.device, seed), device=self.device, dtype=torch.float32)

    def extract(self, Q):
        self._count(1)
        return sharded_extract(ops.block_matvec(self._A, Q), Q, self._sum)

    def demote(self, cfg):
        """Device OOM: this rank's rows move to the host and are streamed
        on its device block by block, with the same one all-reduce a
        product: slower, but the solve finishes, and each rank holds 1/N
        of ``A`` on its host, as the paper lays the matrix out."""
        from repro_torch.core.oom import HostBlockedMatrix
        host = HostBlockedMatrix(self._A.cpu().numpy(), cfg.n_blocks,
                                 stage_dtype=self.sweep_dtype,
                                 device=self.device)
        return ShardedHostOperator(host, self.layout, self._shape)

    @property
    def bytes_per_pass(self):
        m, n = self._shape
        return m * n * self._As.element_size()


def spill_to_disk(host, cfg, shards: int = 1):
    """``host``'s staged blocks written block by block to a temp ``.npy``
    (nothing A-sized is resident) and re-opened as a ``MemmapMatrix`` with
    the same block plan, dtype and device; its host cache budget is half
    the file, or, when ``cfg.host_budget_bytes`` is set, a ``1/shards``
    share of it: the ``shards`` ranks that each spill their rows of a
    row-sharded matrix then cache together what one spill of the whole
    matrix would.  Returns the matrix and the file's path."""
    import tempfile
    from repro_torch.core.diskio import MemmapMatrix, write_npy
    fd, path = tempfile.mkstemp(suffix=".npy", prefix="repro_demoted_")
    os.close(fd)
    write_npy(path, (host.m, host.n), host.stage_dtype,
              ((host.plan.bounds(b)[0], host.host_block(b))
               for b in range(host.n_blocks)))
    budget = max(1, cfg.host_budget_bytes // shards) \
        if cfg.host_budget_bytes else \
        (host.m * host.n * host.stage_dtype.itemsize) // 2
    return MemmapMatrix(path, host.n_blocks, stage_dtype=host.stage_dtype,
                        host_budget_bytes=budget, device=host.device), path


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
        mm, path = spill_to_disk(self._host, cfg)
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


class _HostShards(_OnShards):
    """What the host-side tiers of a row-sharded matrix share: this rank's
    rows streamed block by block through the host tier's sweeps, and the
    sharded operator's collectives over the same group (one all-reduce a
    product, ``sharded_extract``).  ``shape``, the fingerprint's shard
    count and ``bytes_per_pass`` are the global matrix's, as on the tier
    above."""

    def __init__(self, host, layout: ShardLayout, shape):
        super().__init__(host)
        self.layout, self._shape = layout, tuple(shape)

    @property
    def shape(self):
        return self._shape

    def rmatmat(self, Y):
        return self._sum(super().rmatmat(Y))

    def gram_chain(self, Q):
        return self._sum(super().gram_chain(Q))

    def range_sketch(self, l, seed):
        return self._sum(super().range_sketch(
            l, _shard_seed(seed, self.layout.index)))

    def extract(self, Q):
        self._count(1)
        return sharded_extract(self._host.matmat(Q), Q, self._sum)

    @property
    def bytes_per_pass(self):
        m, n = self._shape
        return m * n * self._host.stage_dtype.itemsize


class ShardedHostOperator(_HostShards, HostBlockedOperator):
    """A ``ShardedOperator`` demoted after a device OOM: this rank's rows
    on the host (``_HostShards``).  Host pressure demotes it once more,
    to ``ShardedMemmapOperator``."""

    def demote(self, cfg):
        """Each rank spills only its own rows to its own temp ``.npy``
        (``spill_to_disk``, the host tier's block plan: each rank's sums
        keep their order and bits; each rank caches its share of
        ``cfg.host_budget_bytes``) and goes on with the same collectives.
        The caller owns the temp file (``spill_path``)."""
        mm, path = spill_to_disk(self._host, cfg, self.layout.n_shards)
        op = ShardedMemmapOperator(mm, self.layout, self._shape)
        op.spill_path = path
        return op


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


class ShardedMemmapOperator(_HostShards, MemmapOperator):
    """The disk tier of a row-sharded matrix: this rank's rows in its own
    ``.npy``, staged disk -> host -> device, and the sharded collectives
    (``_HostShards``).  Disk is the bottom of the ladder (``demote`` is
    ``MemmapOperator``'s).  ``bytes_moved`` is the global matrix's: every
    rank holds as many rows under the same block plan and the same share
    of the host budget, so each rank's tier counters are the same and the
    sum is ``n_shards`` times this rank's, which is what the reference's
    one gathered memmap moves."""

    @property
    def bytes_moved(self):
        return {tier: n * self.layout.n_shards
                for tier, n in self._host.bytes_moved.items()}


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
