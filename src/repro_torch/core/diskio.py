"""Disk tier for the out-of-core path: memmap-backed blocked matrices
(PyTorch port of the JAX package's ``repro/core/diskio.py``).

The paper's memory hierarchy is disk -> host -> device; the host tier
(``core/oom.py::HostBlockedMatrix``) assumes the whole matrix sits in
host RAM.  ``MemmapMatrix`` keeps it in a ``.npy`` file and stages row
blocks disk -> host -> device on demand, inheriting every streamed op of
the host tier:

* ``host_block(b)`` reads block ``b`` from the memory-mapped file (under
  ``fault_hook("disk_read")`` and ``retry_io``), casts it to
  ``stage_dtype`` and keeps it in an LRU cache of pageable host memory
  bounded by ``host_budget_bytes`` (0 = unbounded);
* ``block(b)`` copies that block into one of two pinned bounce buffers
  and issues the async H2D copy of ``core/staging.py``'s ring; before it
  refills a bounce buffer the host waits for the copy that last read it.
  On the CPU the cached block is the device block.
* ``stage_to_disk`` writes an array to a ``.npy`` file AT the staging
  dtype, block by block, so ``stage_dtype="bfloat16"`` halves the bytes
  of both remaining hops.  numpy has no bf16: the file's elements are
  the bf16 bits as a 2-byte void type, which is what numpy reads back
  from the JAX package's bf16 files too; ``open_matrix_memmap`` views
  them as ``torch.bfloat16``.  Both packages read each other's files.
* per-tier counters, updated at issue time: ``disk_bytes`` read from the
  file, ``h2d_bytes`` staged to the device, ``fetches`` (``passes`` =
  fetches / n_blocks) and ``peak_host_bytes``, the cache's high-water
  mark.
"""
from __future__ import annotations

import collections
import os
import weakref

import numpy as np
import torch

from repro_torch.core import staging
from repro_torch.core.errors import InputError
from repro_torch.core.faults import fault_hook, retry_io
from repro_torch.core.oom import HostBlockedMatrix, _host_tensor, _release
from repro_torch.core.operator import resolve_device
from repro_torch.core.partition import make_batch_plan
from repro_torch.core.precision import resolve_sweep_dtype

__all__ = ["MemmapMatrix", "stage_to_disk", "open_matrix_memmap",
           "write_npy"]

#: rows staged per write when spilling an array to disk (bounds host
#: memory during staging, not during the solve)
_STAGE_ROWS = 1 << 14

#: how a bf16 file stores its elements: the raw 2 bytes
_BF16_FILE = np.dtype("V2")


def _file_dtype(sd: torch.dtype) -> np.dtype:
    return _BF16_FILE if sd == torch.bfloat16 else np.dtype(np.float32)


def _as_tensor(a) -> torch.Tensor:
    """A host matrix (numpy, a memmap of 2-byte void bf16 elements, or a
    torch CPU tensor) as a torch CPU tensor over the same memory."""
    if isinstance(a, torch.Tensor):
        return a
    a = a if isinstance(a, np.ndarray) else np.asarray(a)
    if a.dtype == _BF16_FILE:
        return _host_tensor(a.view(np.int16)).view(torch.bfloat16)
    return _host_tensor(a)


def write_npy(path, shape, sd: torch.dtype, strips) -> None:
    """Write a ``.npy`` matrix of ``shape`` at the dtype ``sd`` from
    ``strips``, pairs of (first row, a host tensor of rows), each cast to
    ``sd`` (round to nearest even) as it is written."""
    out = np.lib.format.open_memmap(os.fspath(path), mode="w+",
                                    dtype=_file_dtype(sd), shape=shape)
    dst = _as_tensor(out)
    for lo, rows in strips:
        dst[lo:lo + rows.shape[0]] = rows.to(torch.float32).to(sd)
    out.flush()
    del dst, out


def stage_to_disk(A, path, *, dtype="float32") -> str:
    """Write ``A`` to ``path`` (``.npy``) at the staging dtype, in strips
    of rows (nothing matrix-sized is resident).  ``dtype="bfloat16"``
    stores 2 bytes an element, rounded to nearest even.  Returns
    ``path``."""
    src = _as_tensor(A)
    m, n = src.shape
    write_npy(path, (m, n), resolve_sweep_dtype(dtype),
              ((lo, src[lo:lo + _STAGE_ROWS])
               for lo in range(0, m, _STAGE_ROWS)))
    return os.fspath(path)


def open_matrix_memmap(path) -> torch.Tensor:
    """Memory-map a ``.npy`` matrix written by either package's
    ``stage_to_disk`` (or ``np.save``) as a torch CPU tensor over the
    mapping; 2-byte void elements (bf16 files) come back as
    ``torch.bfloat16``.  A missing, truncated or non-``.npy`` file raises
    ``InputError`` with the path in the message."""
    p = os.fspath(path)
    try:
        arr = np.load(p, mmap_mode="c")    # copy-on-write: never written
    except (OSError, ValueError, EOFError) as e:
        raise InputError(
            f"{p!r} is not a readable .npy matrix ({type(e).__name__}: "
            f"{e}); re-stage it with repro_torch.core.stage_to_disk() or "
            f"point svd() at an intact file") from e
    if not hasattr(arr, "ndim") or arr.ndim != 2:
        raise InputError(
            f"{p!r} does not hold a 2-D matrix (got "
            f"ndim={getattr(arr, 'ndim', None)}); svd() needs an (m, n) "
            f"array on disk")
    return _as_tensor(arr)


class MemmapMatrix(HostBlockedMatrix):
    """Row-blocked matrix living on DISK, staged disk -> host -> device.

    ``source`` is a path to a ``.npy`` file, an ``np.memmap``, a tensor
    from ``open_matrix_memmap``, or any host array whose row slices are
    views (a transposed memmap for the CSVD orientation too).  The host
    never holds more than ``host_budget_bytes`` of staged blocks (0 =
    unbounded) plus the two pinned bounce buffers.  A file stored at
    ``stage_dtype`` is copied as it is (disk bytes = H2D bytes); a wider
    file is narrowed at the host hop.
    """

    def __init__(self, source, n_blocks: int, stage_dtype="float32",
                 host_budget_bytes: int = 0, device=None):
        if isinstance(source, (str, os.PathLike)):
            source = open_matrix_memmap(source)
        src = _as_tensor(source)
        if src.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape "
                             f"{tuple(src.shape)}")
        if host_budget_bytes < 0:
            raise ValueError("host_budget_bytes must be >= 0 "
                             "(0 = unbounded)")
        # deliberately NOT super().__init__: the parent stages every
        # block into host RAM eagerly — the exact thing this tier avoids
        self.device = resolve_device(device)
        self._mm = src
        self.m, self.n = src.shape
        self.stage_dtype = resolve_sweep_dtype(stage_dtype)
        self.plan = make_batch_plan(self.m, n_blocks, collinear=True)
        self.host_budget_bytes = int(host_budget_bytes)
        self._cache: collections.OrderedDict[int, torch.Tensor] = \
            collections.OrderedDict()
        self._cache_bytes = 0
        self.disk_bytes = 0
        self.h2d_bytes = 0
        self.fetches = 0
        self.peak_host_bytes = 0
        self._res: dict = {"ring": None, "keys": [], "bounce": None}
        self._finalizer = weakref.finalize(self, _release, self._res)
        self.telemetry = None
        self.retry_policy = None

    @property
    def file_dtype(self) -> torch.dtype:
        return self._mm.dtype

    @property
    def disk_bytes_per_pass(self) -> int:
        """File bytes one cold (uncached) full stream reads from disk."""
        return self.m * self.n * self._mm.element_size()

    @property
    def passes(self) -> float:
        """H2D block fetches / n_blocks — the CountingHostMatrix unit."""
        return self.fetches / self.n_blocks

    @property
    def bytes_moved(self) -> dict[str, int]:
        """Actual bytes each tier moved so far (the device reads the
        staged block it was handed, so its tier equals the H2D one)."""
        return {"disk": self.disk_bytes, "host": self.h2d_bytes,
                "device": self.h2d_bytes}

    def reset_counters(self):
        """Zero the tier counters (NOT the cache) before a solve's delta
        accounting; a warm cache shows as fewer disk bytes."""
        self.disk_bytes = 0
        self.h2d_bytes = 0
        self.fetches = 0

    def host_block(self, b: int) -> torch.Tensor:
        blk = self._cache.get(b)
        if blk is not None:
            self._cache.move_to_end(b)
            return blk
        lo, hi = self.plan.bounds(b)

        def _read():
            # a transient OSError here (EIO, an injected fault) is
            # retried under the driver's backoff policy
            fault_hook("disk_read", self.telemetry)
            # the disk read, cast to the staged dtype, contiguous
            return torch.empty((hi - lo, self.n), dtype=self.stage_dtype
                               ).copy_(self._mm[lo:hi])

        blk = retry_io(_read, site="disk_read", policy=self.retry_policy,
                       telemetry=self.telemetry)
        self.disk_bytes += (hi - lo) * self.n * self._mm.element_size()
        nbytes = blk.numel() * blk.element_size()
        budget = self.host_budget_bytes
        if budget == 0 or nbytes <= budget:
            while (budget and self._cache
                   and self._cache_bytes + nbytes > budget):
                _, old = self._cache.popitem(last=False)   # LRU evict
                self._cache_bytes -= old.numel() * old.element_size()
            self._cache[b] = blk
            self._cache_bytes += nbytes
            self.peak_host_bytes = max(self.peak_host_bytes,
                                       self._cache_bytes)
        return blk

    def _to_device(self, blk: torch.Tensor) -> torch.Tensor:
        """Bounce the (pageable) block through a pinned buffer, then the
        async H2D copy."""
        if self.device.type == "cpu":
            return blk
        ring = self._ring()
        if self._res["bounce"] is None:
            self._res["bounce"] = []
            for _ in range(2):
                buf, key = staging.pinned_empty(
                    (self.plan.batch_size, self.n), self.stage_dtype)
                self._res["keys"].append(key)
                self._res["bounce"].append(buf)
        s = ring.next_slot
        ring.copied(s).synchronize()       # its last H2D has read it
        bounce = self._res["bounce"][s][:blk.shape[0]]
        bounce.copy_(blk)
        return ring.put(bounce)

    def block(self, b: int) -> torch.Tensor:
        blk = self.host_block(b)

        def _put():
            fault_hook("h2d", self.telemetry)
            return self._to_device(blk)            # the H2D copy

        dev = retry_io(_put, site="h2d", policy=self.retry_policy,
                       telemetry=self.telemetry)
        self.fetches += 1
        self.h2d_bytes += blk.numel() * blk.element_size()
        return dev
