"""Block-streamed sparse operators for PB-scale matrices (PyTorch port).

The counterpart of the JAX package's ``repro/core/sparse.py`` (paper
§VI: a synthetic sparse matrix of dense-equivalent size 128 PB, 33.5M x
33.5M per node at density 1e-6): the matrix is a **source of row
blocks**, never densified, and every streamed op is ONE stream of the
nonzeros with intermediates of O(m + n + k).

* ``RowBlockStream`` turns any ``row_block_coo(lo, hi)`` provider into
  the streamed surface (``matvec``/``rmatvec``/``matmat``/``rmatmat``/
  ``gram_chain``/``range_sketch``), with the JAX package's names and
  arguments plus an optional ``device``;
* ``SyntheticSparseMatrix`` emits row blocks procedurally from numpy's
  ``SeedSequence([seed, chunk])``, as the JAX package does, so its
  nonzeros are bitwise the JAX package's under any blocking;
* ``ScipySparseMatrix`` slices the row blocks of a real scipy CSR matrix
  (``.npz``/``.mtx`` datasets) in the JAX package's order;
  ``ScipySparseOperator`` tags those runs;
* ``DenseStreamOperator`` puts a dense array with a prescribed spectrum
  behind the same surface, its products on the port's block sweeps.

Where the JAX package sums on the host with ``np.add.at``, the port sums
on the device, in the same order, with every product rounded before its
add (``kernels/csr_sweep.py``): on the CPU the plain versions
(``index_add_``) are bitwise ``np.add.at``; on the card the CSR kernels
are too, by construction (``chip_smoke.py`` holds them to it).  A block
is CSR in stream order: int32 row offsets and columns, values in the
sweep dtype (bf16 halves the value bytes; the rounding is
round-to-nearest-even, the JAX package's ``_round_to``).  A stream whose
rows are out of order is sorted stably by row first: its ``matmat`` keeps
the JAX package's bits, its ``rmatmat`` sums each column in row order.

**The host -> device pipeline** (``_Feed``, the card only).  Host
threads pack row block ``b + 1`` (and on, one block a thread) into
page-locked CSR buffers (``staging.pinned_empty``) while the card
computes block ``b``: numpy's bulk generation, casts and copies release
the GIL.  The blocks are copied through a ``staging.H2DArrays`` ring
(a copy stream, two device buffer sets, ordered against the compute
stream by events as ``staging.H2DRing`` orders its blocks).  A host
buffer set is refilled only after its copy has run.  ``range_sketch``'s
``Omega_b`` (numpy, ``SeedSequence([seed, sketch seed, b])``) is drawn by
the same threads and rides along.  ``feed_stats()`` reports the real
PCIe bytes (offsets and columns included), the nonzeros packed, the
threads' packing seconds and the main thread's wait for them;
``bytes_moved`` keeps the JAX package's accounting.

Entry points run on the card unless the caller asks for the CPU: a
streamed op given a torch tensor runs on its device, given numpy and no
``device`` on the card (raising without one); ``device="cpu"`` runs the
plain versions.  Results are fp32 torch tensors on that device.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.config import SVDConfig, SVDResult
from repro_torch.core.operator import (SparseStreamOperator, resolve_device,
                                       sweep_copy)
from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.kernels import ops

__all__ = ["RowBlockStream", "SyntheticSparseMatrix", "ScipySparseMatrix",
           "ScipySparseOperator", "DenseStreamOperator", "SparseTSVDResult",
           "sparse_tsvd"]


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> the bits of the nearest bf16 (ties to even; NaN stays a
    quiet NaN), as ``uint16``: numpy has no bf16 of its own."""
    a = np.ascontiguousarray(x, np.float32)
    u = a.view(np.uint32)
    out = ((u + (np.uint32(0x7FFF) + ((u >> 16) & 1))) >> 16).astype(
        np.uint16)
    nan = np.isnan(a)
    if nan.any():
        out[nan] = 0x7FC0
    return out


def _round_to(x, dtype) -> np.ndarray:
    """Round operand values to the sweep dtype, as fp32 (the JAX
    package's ``_round_to``: bf16 operands, fp32 products and sums);
    ``float32`` is a no-op."""
    x = np.asarray(x, np.float32)
    if resolve_sweep_dtype(dtype) == torch.float32:
        return x
    return (_bf16_bits(x).astype(np.uint32) << 16).view(np.float32)


def _device_of(X, device) -> torch.device:
    """The device a streamed op runs on: ``device``, else the device of a
    torch operand, else the card."""
    if device is not None:
        return resolve_device(device)
    if isinstance(X, torch.Tensor):
        return X.device
    return resolve_device(None)


def _dense(X, dev: torch.device, sd: torch.dtype) -> torch.Tensor:
    """``X`` as a contiguous fp32 tensor on ``dev``, rounded to ``sd``."""
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    if sd != torch.float32:
        X = X.to(sd).to(torch.float32)
    return X.contiguous()


def _val_tensor(vals: np.ndarray, sd: torch.dtype) -> torch.Tensor:
    """A block's values as a host tensor of the sweep dtype."""
    if sd == torch.float32:
        return torch.from_numpy(np.ascontiguousarray(vals, np.float32))
    return torch.from_numpy(_bf16_bits(vals).view(np.int16)).view(
        torch.bfloat16)


def _feed_workers() -> int:
    """Host threads that pack row blocks ahead of the card: one CPU is
    left to the thread that launches the kernels."""
    return max(1, min(8, (os.cpu_count() or 2) - 1))


# ---------------------------------------------------------------------------
# The host -> device pipeline of the card
# ---------------------------------------------------------------------------

class _Stopped(Exception):
    """A packing task asked to stop: its pass ended early."""


class _HostSet:
    """One set of page-locked host buffers for a packed CSR block: grown
    (a fresh registration) when a block outgrows it."""

    def __init__(self):
        self._bufs: dict = {}
        self.copied = None            # event of the last copy out of it

    def _buf(self, name: str, n: int, dtype: torch.dtype) -> torch.Tensor:
        t, key = self._bufs.get(name, (None, None))
        if t is None or t.numel() < n or t.dtype != dtype:
            if key is not None:
                staging.unregister(key)
            t, key = staging.pinned_empty((max(n, 1),), dtype)
            self._bufs[name] = (t, key)
        return t[:n]

    def fill(self, off, col, val, om, sd: torch.dtype) -> dict:
        rows, nnz = off.size - 1, col.size
        views = {"off": self._buf("off", rows + 1, torch.int32),
                 "col": self._buf("col", nnz, torch.int32),
                 "val": self._buf("val", nnz, sd)}
        np.copyto(views["off"].numpy(), off, casting="unsafe")
        np.copyto(views["col"].numpy(), col, casting="unsafe")
        if sd == torch.float32:
            np.copyto(views["val"].numpy(), val, casting="unsafe")
        else:
            views["val"].view(torch.int16).numpy()[:] = \
                _bf16_bits(val).view(np.int16)
        if om is not None:
            views["om"] = self._buf("om", om.size, torch.float32).view(
                om.shape)
            np.copyto(views["om"].numpy(), om)
        return views

    def close(self) -> None:
        for _, key in self._bufs.values():
            staging.unregister(key)
        self._bufs.clear()


class _Feed:
    """The pipeline of one stream on one device at one sweep dtype:
    ``workers`` packing threads, ``workers + 2`` host buffer sets and a
    ``staging.H2DArrays`` ring (see the module docstring)."""

    def __init__(self, device: torch.device, sd: torch.dtype,
                 workers: int):
        self.device, self.sd, self.workers = device, sd, workers
        self.host = [_HostSet() for _ in range(workers + 2)]
        self.ring = staging.H2DArrays(device)
        self.stats = {"blocks": 0, "nnz": 0, "pcie_bytes": 0,
                      "pack_s": 0.0, "wait_s": 0.0}

    def run(self, src: "RowBlockStream", block_rows: int, sketch=None):
        """``(lo, hi, block, omega)`` of each row block in order, on the
        card; a block may be read by work enqueued before the next one is
        asked for."""
        bounds = [(lo, min(lo + block_rows, src.m))
                  for lo in range(0, src.m, block_rows)]
        free: queue.Queue = queue.Queue()
        for hs in self.host:
            free.put(hs)
        stop = threading.Event()

        def pack(b: int):
            while True:
                if stop.is_set():
                    raise _Stopped()
                try:
                    hs = free.get(timeout=0.05)
                    break
                except queue.Empty:
                    continue
            if hs.copied is not None:
                hs.copied.synchronize()       # its last copy has run
            t0 = time.perf_counter()
            lo, hi = bounds[b]
            off, col, val = src._csr_block32(lo, hi)
            om = None if sketch is None else sketch(b, lo, hi)
            views = hs.fill(off, col, val, om, self.sd)
            return hs, views, time.perf_counter() - t0

        depth = self.workers + 1
        ex = ThreadPoolExecutor(self.workers,
                                thread_name_prefix="repro-sparse-pack")
        futs = {b: ex.submit(pack, b) for b in range(min(depth, len(bounds)))}
        try:
            for b, (lo, hi) in enumerate(bounds):
                t0 = time.perf_counter()
                hs, views, dt = futs.pop(b).result()
                self.stats["wait_s"] += time.perf_counter() - t0
                self.stats["pack_s"] += dt
                if b + depth < len(bounds):
                    futs[b + depth] = ex.submit(pack, b + depth)
                blk = self.ring.put(views)
                hs.copied = self.ring.copies_done()
                free.put(hs)
                self.stats["pcie_bytes"] += sum(
                    v.numel() * v.element_size() for v in views.values())
                self.stats["blocks"] += 1
                self.stats["nnz"] += views["col"].numel()
                yield lo, hi, (blk["off"], blk["col"], blk["val"]), \
                    blk.get("om")
        finally:
            stop.set()
            ex.shutdown(wait=True, cancel_futures=True)

    def close(self) -> None:
        self.ring.close()
        for hs in self.host:
            hs.close()


def _close_feeds(feeds: dict) -> None:
    for feed in feeds.values():
        feed.close()
    feeds.clear()


# ---------------------------------------------------------------------------
# The streamed surface over any source of row blocks
# ---------------------------------------------------------------------------

class RowBlockStream:
    """The fused streamed surface over any source of COO row blocks.

    Subclasses provide ``m``, ``n``, ``seed`` and ``row_block_coo(lo,
    hi) -> (rows, cols, vals)`` (absolute row indices); they may override
    ``_csr_block`` with a faster path to the same CSR.  Every streamed op
    is ONE stream of the nonzeros; ``gram_chain`` runs both sweep halves
    on each block.
    """

    #: the streamed ops take torch tensors on the operator's device
    streams_on_device = True

    def row_block_coo(self, lo: int, hi: int):
        raise NotImplementedError

    def row_block_dense(self, lo: int, hi: int) -> np.ndarray:
        """Densify rows [lo, hi) — only for test-sized blocks."""
        rows, cols, vals = self.row_block_coo(lo, hi)
        out = np.zeros((hi - lo, self.n), np.float32)
        # duplicate (row, col) hits accumulate, matching COO semantics
        np.add.at(out, (rows - lo, cols), vals)
        return out

    def _csr_block(self, lo: int, hi: int):
        """Rows [lo, hi) as CSR in stream order: ``(off, cols, vals)``,
        ``off`` (hi - lo + 1) from 0, ``vals`` fp32 (numpy)."""
        rows, cols, vals = self.row_block_coo(lo, hi)
        r = np.asarray(rows, np.int64) - lo
        cols, vals = np.asarray(cols), np.asarray(vals, np.float32)
        if r.size > 1 and np.any(r[1:] < r[:-1]):
            order = np.argsort(r, kind="stable")
            r, cols, vals = r[order], cols[order], vals[order]
        off = np.zeros(max(hi - lo, 0) + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=max(hi - lo, 0)), out=off[1:])
        return off, cols, vals

    def _csr_block32(self, lo: int, hi: int):
        """``_csr_block``, refused where its offsets outgrow the int32 the
        CSR sweeps index a block's nonzeros with."""
        off, cols, vals = self._csr_block(lo, hi)
        if int(off[-1]) >= 2**31:
            raise ValueError(f"the CSR sweeps index a block's nonzeros in "
                             f"int32; rows [{lo}, {hi}) hold {int(off[-1])}: "
                             f"pass a smaller block_rows")
        return off, cols, vals

    # -- the pipeline ---------------------------------------------------------

    def _blocks(self, block_rows: int, dev: torch.device, sd: torch.dtype,
                sketch=None):
        """``(lo, hi, (off, col, val), omega)`` of each row block, in
        order, as tensors on ``dev``."""
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1, got {block_rows}")
        if self.n >= 2**31:
            raise ValueError(f"the CSR sweeps index columns in int32; "
                             f"n = {self.n} is too wide")
        if dev.type == "cpu":
            for b, lo in enumerate(range(0, self.m, block_rows)):
                hi = min(lo + block_rows, self.m)
                off, col, val = self._csr_block32(lo, hi)
                om = None if sketch is None else torch.from_numpy(
                    sketch(b, lo, hi))
                yield lo, hi, (torch.from_numpy(off.astype(np.int32)),
                               torch.from_numpy(col.astype(np.int32)),
                               _val_tensor(val, sd)), om
            return
        feeds = self.__dict__.get("_feeds")
        if feeds is None:
            feeds = self.__dict__["_feeds"] = {}
            weakref.finalize(self, _close_feeds, feeds)
        key = (dev, sd)
        if key not in feeds:
            feeds[key] = _Feed(dev, sd, _feed_workers())
        yield from feeds[key].run(self, block_rows, sketch)

    def feed_stats(self) -> dict:
        """The card's pipeline, summed over its feeds: blocks, nonzeros
        and PCIe bytes (the CSR arrays and any Omega) copied, the
        threads' packing seconds and the main thread's wait for them."""
        out = {"blocks": 0, "nnz": 0, "pcie_bytes": 0, "pack_s": 0.0,
               "wait_s": 0.0}
        for feed in self.__dict__.get("_feeds", {}).values():
            for key in out:
                out[key] += feed.stats[key]
        return out

    def reset_feed_stats(self) -> None:
        for feed in self.__dict__.get("_feeds", {}).values():
            for key in feed.stats:
                feed.stats[key] = 0

    def close(self) -> None:
        """Wait for the copy streams and unpin the host buffers."""
        _close_feeds(self.__dict__.get("_feeds", {}))

    # -- streamed linear algebra ----------------------------------------------

    def matvec(self, v, block_rows: int = 1 << 16, device=None):
        """``A @ v`` (fp32) streaming row blocks; O(m) memory."""
        return self.matmat(_column(v), block_rows, device=device)[:, 0]

    def rmatvec(self, u, block_rows: int = 1 << 16, device=None):
        """``A.T @ u`` (fp32) streaming row blocks; O(n) memory."""
        return self.rmatmat(_column(u), block_rows, device=device)[:, 0]

    def matmat(self, Q, block_rows: int = 1 << 16, dtype="float32",
               device=None) -> torch.Tensor:
        """``A @ Q`` streaming row blocks; Q (n, k) -> (m, k).  ``dtype``
        is the sweep dtype: values and ``Q`` round to it, sums stay fp32."""
        dev, sd = _device_of(Q, device), resolve_sweep_dtype(dtype)
        Qs = _dense(Q, dev, sd)
        out = torch.empty((self.m, Qs.shape[1]), dtype=torch.float32,
                          device=dev)
        for lo, hi, blk, _ in self._blocks(block_rows, dev, sd):
            ops.csr_matmat(*blk, Qs, out=out[lo:hi])
        return out

    def rmatmat(self, Y, block_rows: int = 1 << 16, dtype="float32",
                device=None) -> torch.Tensor:
        """``A.T @ Y`` streaming row blocks; Y (m, k) -> (n, k)."""
        dev, sd = _device_of(Y, device), resolve_sweep_dtype(dtype)
        Ys = _dense(Y, dev, sd)
        out = torch.zeros((self.n, Ys.shape[1]), dtype=torch.float32,
                          device=dev)
        for lo, hi, blk, _ in self._blocks(block_rows, dev, sd):
            ops.csr_rmatmat(*blk, Ys[lo:hi], out)
        return out

    def range_sketch(self, l: int, seed: int = 0, block_rows: int = 1 << 16,
                     dtype="float32", device=None) -> torch.Tensor:
        """``A^T Omega`` with ``Omega ~ N(0,1)^(m x l)`` drawn per row block
        from ``SeedSequence([self.seed, seed, b])`` (the JAX package's
        numbers), riding the same stream; the (m, l) ``Omega`` never
        exists."""
        dev, sd = _device_of(None, device), resolve_sweep_dtype(dtype)

        def omega(b, lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, seed, b]))
            return _round_to(rng.standard_normal((hi - lo, l)).astype(
                np.float32), sd)

        out = torch.zeros((self.n, l), dtype=torch.float32, device=dev)
        for _, _, blk, om in self._blocks(block_rows, dev, sd, omega):
            ops.csr_rmatmat(*blk, om, out)
        return out

    def gram_chain(self, Q, block_rows: int = 1 << 16, dtype="float32",
                   device=None) -> torch.Tensor:
        """``A^T (A Q)`` — the Eq. 2 chain on a k-wide block, fused: each
        row block's nonzeros are streamed ONCE for both halves.  Under
        ``dtype="bfloat16"`` the values, ``Q`` and the fp32-summed
        intermediate ``y`` round to bf16 (the JAX package's chain)."""
        dev, sd = _device_of(Q, device), resolve_sweep_dtype(dtype)
        Qs = _dense(Q, dev, sd)
        out = torch.zeros((self.n, Qs.shape[1]), dtype=torch.float32,
                          device=dev)
        for _, _, blk, _ in self._blocks(block_rows, dev, sd):
            ops.csr_gram_chain(*blk, Qs, out,
                               round_y=sd == torch.bfloat16)
        return out


def _column(v):
    """A vector as a one-column matrix (numpy or torch)."""
    return v[:, None] if isinstance(v, torch.Tensor) else \
        np.asarray(v, np.float32)[:, None]


@dataclasses.dataclass
class SyntheticSparseMatrix(RowBlockStream):
    """Procedural sparse matrix: ``nnz_per_row`` uniform columns a row.

    Deterministic per (seed, row): canonical chunk ``c`` of ``chunk``
    rows draws its columns and values from
    ``SeedSequence([seed, c])``, exactly as the JAX package does, so the
    nonzeros are bitwise the JAX package's under any blocking; only the
    accessed row blocks are ever materialized.
    """

    m: int
    n: int
    nnz_per_row: int
    seed: int = 0
    chunk: int = 4096  # canonical generation unit; blocking-invariant

    @property
    def density(self) -> float:
        return self.nnz_per_row / self.n

    @property
    def dense_bytes(self) -> int:
        return self.m * self.n * 4

    @property
    def nnz(self) -> int:
        return self.m * self.nnz_per_row

    def _chunk(self, c: int):
        """Columns and values of canonical chunk ``c``, (rows, nnz_per_row)."""
        lo = c * self.chunk
        hi = min(lo + self.chunk, self.m)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, c]))
        cols = rng.integers(0, self.n, size=(hi - lo, self.nnz_per_row))
        vals = rng.standard_normal(
            (hi - lo, self.nnz_per_row)).astype(np.float32)
        return lo, hi, cols, vals

    def _chunk_coo(self, c: int):
        """Nonzeros of canonical chunk ``c`` (rows [c*chunk, ...))."""
        lo, hi, cols, vals = self._chunk(c)
        rows = np.repeat(np.arange(lo, hi), self.nnz_per_row)
        return rows, cols.ravel(), vals.ravel()

    def row_block_coo(self, lo: int, hi: int):
        """(rows, cols, vals) for rows [lo, hi) — O(nnz_block), assembled
        from the canonical chunks; an empty range yields empty arrays."""
        if hi <= lo:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
        parts = []
        c0, c1 = lo // self.chunk, (hi - 1) // self.chunk
        for c in range(c0, c1 + 1):
            rows, cols, vals = self._chunk_coo(c)
            sel = (rows >= lo) & (rows < hi)
            parts.append((rows[sel], cols[sel], vals[sel]))
        rows = np.concatenate([p[0] for p in parts])
        cols = np.concatenate([p[1] for p in parts])
        vals = np.concatenate([p[2] for p in parts])
        return rows, cols, vals

    def _csr_block(self, lo: int, hi: int):
        """The same nonzeros as ``row_block_coo``, written straight into
        CSR: every row holds ``nnz_per_row`` of them."""
        w = self.nnz_per_row
        rows = max(hi - lo, 0)
        off = np.arange(rows + 1, dtype=np.int64) * w
        cols = np.empty(rows * w, np.int64)
        vals = np.empty(rows * w, np.float32)
        if rows:
            for c in range(lo // self.chunk, (hi - 1) // self.chunk + 1):
                clo, chi, cc, vv = self._chunk(c)
                a, b = max(lo, clo), min(hi, chi)
                cols[(a - lo) * w:(b - lo) * w] = cc[a - clo:b - clo].ravel()
                vals[(a - lo) * w:(b - lo) * w] = vv[a - clo:b - clo].ravel()
        return off, cols, vals


class ScipySparseMatrix(RowBlockStream):
    """A REAL scipy CSR/COO/CSC matrix behind the row-block stream.

    Converted once to fp32 CSR exactly as the JAX package converts it
    (``scipy.sparse.csr_matrix(A, dtype=float32)``); a row block is a
    slice of its arrays, in the order the JAX package's ``.tocoo()`` of
    the slice yields.  Requires scipy only at construction.
    """

    def __init__(self, sp_matrix, seed: int = 0):
        try:
            import scipy.sparse as _sps
        except ImportError as e:  # pragma: no cover - scipy is optional
            raise ImportError(
                "ScipySparseMatrix requires scipy; install it or use "
                "SyntheticSparseMatrix for procedural streams") from e
        if not _sps.issparse(sp_matrix):
            raise TypeError(f"expected a scipy.sparse matrix, got "
                            f"{type(sp_matrix).__name__}")
        self._csr = _sps.csr_matrix(sp_matrix, dtype=np.float32)
        self.m, self.n = self._csr.shape
        self.seed = seed

    @property
    def nnz(self) -> int:
        return int(self._csr.nnz)

    @property
    def dense_bytes(self) -> int:
        return self.m * self.n * 4

    @property
    def density(self) -> float:
        return self.nnz / max(1, self.m * self.n)

    def row_block_coo(self, lo: int, hi: int):
        if hi <= lo:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
        off, cols, vals = self._csr_block(lo, hi)
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64), np.diff(off))
        return (rows, np.asarray(cols, np.int64),
                np.asarray(vals, np.float32))

    def _csr_block(self, lo: int, hi: int):
        ptr = self._csr.indptr
        p0, p1 = int(ptr[lo]), int(ptr[hi])
        return (ptr[lo:hi + 1].astype(np.int64) - p0,
                self._csr.indices[p0:p1], self._csr.data[p0:p1])


class ScipySparseOperator(SparseStreamOperator):
    """``LinearOperator`` over a real scipy sparse matrix: the
    ``SparseStreamOperator`` surface on a ``ScipySparseMatrix``, tagged
    ``"scipysparse"``."""

    backend = "scipysparse"

    def __init__(self, sp, *, block_rows=1 << 16, sweep_dtype="float32",
                 seed: int = 0, device=None):
        if not isinstance(sp, ScipySparseMatrix):
            sp = ScipySparseMatrix(sp, seed=seed)
        super().__init__(sp, block_rows=block_rows, sweep_dtype=sweep_dtype,
                         device=device)


@dataclasses.dataclass
class DenseStreamOperator:
    """A dense array behind the streamed-operator interface, for a matrix
    with a *prescribed* spectrum (the warm-start tests).  ``A`` goes to
    the device once per sweep dtype (bf16 as the block solve's padded
    copy) and every product runs on the block sweeps of
    ``kernels/ops.py``; ``block_rows`` is accepted and ignored."""

    A: np.ndarray

    #: the streamed ops take torch tensors on the operator's device
    streams_on_device = True

    def __post_init__(self):
        self.A = np.asarray(self.A, np.float32)
        self.m, self.n = self.A.shape
        self._staged = {}  # (device, sweep dtype) -> A on that device

    def _A(self, dev: torch.device, dtype="float32") -> torch.Tensor:
        sd = resolve_sweep_dtype(dtype)
        key = (dev, sd)
        if key not in self._staged:
            A32 = self._staged.get((dev, torch.float32))
            if A32 is None:
                A32 = self._staged[(dev, torch.float32)] = \
                    torch.from_numpy(self.A).to(dev)
            self._staged[key] = sweep_copy(A32, sd)
        return self._staged[key]

    def matvec(self, v, block_rows: int = 0, device=None):
        dev = _device_of(v, device)
        return ops.block_matvec(self._A(dev), _dense(_column(v), dev,
                                                     torch.float32))[:, 0]

    def rmatvec(self, u, block_rows: int = 0, device=None):
        dev = _device_of(u, device)
        return ops.block_rmatvec(self._A(dev), _dense(_column(u), dev,
                                                      torch.float32))[:, 0]

    def matmat(self, Q, block_rows: int = 0, dtype="float32", device=None):
        dev = _device_of(Q, device)
        return ops.block_matvec(self._A(dev, dtype),
                                _dense(Q, dev, torch.float32), dtype=dtype)

    def rmatmat(self, Y, block_rows: int = 0, dtype="float32", device=None):
        dev = _device_of(Y, device)
        return ops.block_rmatvec(self._A(dev, dtype),
                                 _dense(Y, dev, torch.float32), dtype=dtype)

    def gram_chain(self, Q, block_rows: int = 0, dtype="float32",
                   device=None):
        dev = _device_of(Q, device)
        return ops.block_gram_chain(self._A(dev, dtype),
                                    _dense(Q, dev, torch.float32),
                                    dtype=dtype)

    def range_sketch(self, l, seed: int = 0, block_rows: int = 0,
                     dtype="float32", device=None):
        dev = _device_of(None, device)
        rng = np.random.default_rng(np.random.SeedSequence([seed, l]))
        om = rng.standard_normal((self.m, l)).astype(np.float32)
        return ops.block_rmatvec(self._A(dev, dtype),
                                 _dense(om, dev, torch.float32), dtype=dtype)


#: Back-compat alias — the per-backend result NamedTuples were unified.
SparseTSVDResult = SVDResult


def _sparse_deflation(A, k, *, eps, max_iters, force_iters, seed,
                      block_rows, device):
    """Alg-4 rank-one deflation on a streamed sparse operator, on
    ``device``: two streams of the nonzeros per power step plus one per
    rank for the u recovery; the start vectors are the JAX package's
    (numpy ``default_rng(seed)``).  Returns ``(U, S, V, iters, passes)``."""
    from repro_torch.core.operator import stream_call
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m, n = A.m, A.n
    U = torch.zeros((m, k), dtype=torch.float32, device=dev)
    S = torch.zeros((k,), dtype=torch.float32, device=dev)
    V = torch.zeros((n, k), dtype=torch.float32, device=dev)
    iters_out = np.zeros((k,), np.int32)
    passes = 0

    def sweep(name, x):
        return stream_call(A, name, x, block_rows, dev)

    for l in range(k):
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        v = v / torch.linalg.norm(v)
        it = 0
        for it in range(1, max_iters + 1):
            # deflated X = A - U S V^T applied twice, each a streamed op
            # and a skinny correction (the JAX package's regrouping)
            Xv = sweep("matvec", v) - U @ (S * (V.mT @ v))
            v1 = sweep("rmatvec", Xv) - V @ (S * (U.mT @ Xv))
            v1 = v1 / (torch.linalg.norm(v1) + 1e-30)
            done = abs(float(torch.dot(v, v1))) >= 1 - eps
            v = v1
            if done and not force_iters:
                break
        iters_out[l] = it
        passes += 2 * it + 1     # 2 streams per power step + u recovery
        u = sweep("matvec", v) - U @ (S * (V.mT @ v))
        sigma = torch.linalg.norm(u)
        U[:, l] = u / (sigma + 1e-30)
        S[l] = sigma
        V[:, l] = v
    return U, S, V, iters_out, passes


def sparse_tsvd(
    A: SyntheticSparseMatrix,
    k: int,
    *,
    eps: float = 1e-6,
    max_iters: int = 100,
    seed: int = 0,
    block_rows: int = 1 << 16,
    method: str = "gramfree",   # legacy default (svd() uses "block")
    warmup_q: int = 0,
    oversample: int = 8,
    sweep_dtype: str = "float32",
    device=None,
) -> SVDResult:
    """Deprecated: use ``repro_torch.svd(A, k, ...)``.  Translates the
    legacy keywords (defaults ``method="gramfree"``, ``max_iters=100``)
    into an ``SVDConfig`` and delegates to the front door."""
    from repro_torch.core.svd import svd, warn_legacy
    warn_legacy("sparse_tsvd")
    cfg = SVDConfig(method=method, eps=eps, max_iters=max_iters,
                    warmup_q=warmup_q, oversample=oversample,
                    sweep_dtype=sweep_dtype, block_rows=block_rows,
                    seed=seed)
    return svd(A, k, config=cfg, device=device)
