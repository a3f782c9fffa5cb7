"""The host -> device pipeline of the out-of-core tiers (port only).

The JAX package could only imitate the paper's CUDA streams: its
``HostBlockedMatrix`` issues ``jnp.asarray`` of block ``b + 1`` before
block ``b`` computes and leaves the overlap to async dispatch.  Here the
pipeline is explicit:

* **Pinned host memory, registered in place.**  ``register`` page-locks
  a host tensor's bytes where they lie (``cudaHostRegister`` through
  ``csrc/staging.cu``), so the row blocks of a caller's fp32 array are
  copied without a host copy.  Registrations are counted per range: a
  second matrix over the same array adds a count, and the last
  ``unregister`` undoes it.  A range that something else registered
  (the caller, or a range overlapping another matrix's) is used as it
  is and never unregistered here.  ``pinned_empty`` gives fresh host
  tensors registered the same way (the staged bf16 blocks, a transposed
  or non-contiguous input, the disk tier's bounce buffers); PyTorch's
  ``pin_memory=True`` allocator is not used because it rounds each
  block up to a power of two and keeps freed blocks for the life of the
  process, which a solve of a 32 GiB host matrix cannot afford.  Pinning
  that fails raises: a pageable source would make every
  ``cudaMemcpyAsync`` synchronous and hide the whole pipeline.
* **One copy stream and two device buffers** (``H2DRing``).  ``put``
  copies a block on the ring's own stream into the buffer not handed
  out last, with rows padded to whole 16 bytes (``pitch``: one pitched
  copy, so a TMA tensor map describes the block whatever its width and
  PCIe still moves only the block's bytes).  Before the copy the copy
  stream waits, on the device, on the event the compute stream recorded
  when the buffer's previous block was last read; the compute stream
  waits on the copy's event.  The host never blocks.  A block handed out
  by ``put`` may be read by work enqueued on the current stream before
  the next ``put``: the streamed ops of ``core/oom.py`` fetch, compute
  and fetch again, so the copy of block ``b + 1`` runs while block
  ``b``'s kernels do, and a pass's first copy starts as soon as its
  buffer is free, whatever the host is waiting for.  ``H2DArrays``
  orders the sparse stream's CSR blocks the same way, each array of a
  block in a named 1-D buffer of its slot that grows with the blocks.

Nothing here runs on import; the library is built at first use.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

__all__ = ["H2DArrays", "H2DRing", "copy_h2d", "pitch", "pinned_empty", "register",
           "unregister"]

#: cudaErrorHostMemoryAlreadyRegistered: the range is page-locked already
ALREADY_REGISTERED = 712

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong

_LOCK = threading.Lock()
#: (address, bytes) -> [matrices using the registration, registered here]
_PINNED: dict[tuple[int, int], list] = {}


def _lib() -> ctypes.CDLL:
    lib = build.library("staging")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_h2d_pitched.argtypes = [_P, _I64, _P, _I64, _I64, _I64, _P]
        lib.repro_host_register.argtypes = [_P, _I64]
        lib.repro_host_unregister.argtypes = [_P]
        for fn in (lib.repro_h2d_pitched, lib.repro_host_register,
                   lib.repro_host_unregister):
            fn.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def pitch(n: int, dtype: torch.dtype) -> int:
    """Elements between the rows of a device block: ``n`` rounded up to
    whole 16 bytes."""
    per = 16 // dtype.itemsize
    return -(-n // per) * per


def register(t: torch.Tensor) -> tuple[int, int]:
    """Page-lock the bytes of the contiguous host tensor ``t`` in place;
    returns the key ``unregister`` takes.  Raises if the driver refuses."""
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError("register takes a contiguous host tensor")
    key = (t.data_ptr(), t.numel() * t.element_size())
    with _LOCK:
        entry = _PINNED.get(key)
        if entry is not None:
            entry[0] += 1
            return key
        err = _lib().repro_host_register(key[0], key[1]) if key[1] else 0
        if err == ALREADY_REGISTERED and not _ends_pinned(t):
            raise RuntimeError(
                f"cudaHostRegister of {key[1]} bytes refused: the range "
                f"overlaps one page-locked elsewhere, which does not cover "
                f"it; pass an array of its own")
        if err not in (0, ALREADY_REGISTERED):
            raise RuntimeError(
                f"cudaHostRegister of {key[1]} bytes failed: CUDA error "
                f"{err}; the out-of-core tiers copy from pinned memory "
                f"only (a pageable copy would serialize the pipeline)")
        _PINNED[key] = [1, err == 0]
    return key


def _ends_pinned(t: torch.Tensor) -> bool:
    """Whether the first and the last element of ``t`` lie in page-locked
    memory: a range can only be partly locked at its ends."""
    # is_pinned() reads False until torch has initialised CUDA
    torch.cuda.init()
    last = t.storage_offset() + sum((d - 1) * st for d, st in
                                    zip(t.shape, t.stride()))
    return bool(t.as_strided((1,), (1,)).is_pinned()
                and t.as_strided((1,), (1,), last).is_pinned())


def unregister(key: tuple[int, int]) -> None:
    """Drop one use of a registration; the last use of a range this
    module page-locked unlocks it."""
    with _LOCK:
        entry = _PINNED.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] > 0:
            return
        del _PINNED[key]
        if entry[1]:
            err = _lib().repro_host_unregister(key[0])
            if err != 0:
                raise RuntimeError(f"cudaHostUnregister failed: CUDA error "
                                   f"{err}")


def pinned_empty(shape, dtype: torch.dtype) -> tuple[torch.Tensor, tuple]:
    """A fresh contiguous host tensor, page-locked; and its key."""
    t = torch.empty(shape, dtype=dtype)
    return t, register(t)


def copy_h2d(dst: torch.Tensor, src: torch.Tensor, stream) -> None:
    """One asynchronous copy of the contiguous pinned host tensor ``src``
    into the contiguous device tensor ``dst`` (same bytes) on ``stream``
    (a ``torch.cuda.Stream``); the sparse stream's CSR blocks go so."""
    nbytes = src.numel() * src.element_size()
    if nbytes != dst.numel() * dst.element_size() or not (
            src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("copy_h2d copies whole contiguous tensors of one "
                         "size")
    err = _lib().repro_h2d_pitched(dst.data_ptr(), nbytes, src.data_ptr(),
                                   nbytes, nbytes, 1, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"host -> device copy failed: CUDA error {err}")


class _Ring:
    """The ordering of a ring of two device buffer slots: a copy stream and
    the events between it and the compute stream (see the module
    docstring).  Subclasses hold the buffers and enqueue the copies
    between ``_begin`` and ``_end``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._copied = [torch.cuda.Event(), torch.cuda.Event()]
        self._freed: list = [None, None]
        self._slot = 1                    # the slot handed out last

    @property
    def next_slot(self) -> int:
        return 1 - self._slot

    def copied(self, slot: int) -> torch.cuda.Event:
        return self._copied[slot]

    def copies_done(self) -> torch.cuda.Event:
        """A fresh event after every copy enqueued so far: their host
        sources may be refilled once it has completed."""
        done = torch.cuda.Event()
        done.record(self.stream)
        return done

    def _begin(self) -> tuple[int, torch.cuda.Event]:
        """Order the copy stream after the readers of the next slot's
        previous contents; returns the slot and the event of all compute
        work so far (a buffer allocated now waits on it too)."""
        compute = torch.cuda.current_stream(self.device)
        # every read of the slot handed out last is enqueued by now
        freed = torch.cuda.Event()
        freed.record(compute)
        self._freed[self._slot] = freed
        s = self.next_slot
        if self._freed[s] is not None:     # its previous contents' readers
            self.stream.wait_event(self._freed[s])
        return s, freed

    def _end(self, s: int) -> None:
        """Make the compute stream wait for the copies into slot ``s``."""
        self._copied[s].record(self.stream)
        torch.cuda.current_stream(self.device).wait_event(self._copied[s])
        self._slot = s

    def close(self) -> None:
        self.stream.synchronize()


class H2DRing(_Ring):
    """Two device buffers of ``rows`` x ``pitch(n)`` elements, a copy
    stream and the events that order them (see the module docstring).

    ``put(src)`` copies a host block (``src``: pinned, rows of ``n``
    elements with unit column stride) and returns its ``(rows, n)``
    view on the card; ``copied(slot)`` is the event of the last copy
    into buffer ``slot`` (the disk tier waits on it before it refills
    the bounce buffer that copy read); ``next_slot`` is the buffer the
    next ``put`` fills.  ``close()`` waits for the copy stream, after
    which the buffers may be freed.
    """

    def __init__(self, rows: int, n: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(device)
        self.n, self.dtype = n, dtype
        self.ld = pitch(n, dtype)
        self._bufs = [torch.empty((max(rows, 1), self.ld), dtype=dtype,
                                  device=device) for _ in range(2)]
        for buf in self._bufs:            # the allocator waits for copies
            buf.record_stream(self.stream)

    def put(self, src: torch.Tensor) -> torch.Tensor:
        rows, n = src.shape
        if n != self.n or src.dtype != self.dtype or rows > \
                self._bufs[0].shape[0]:
            raise ValueError(f"H2DRing holds blocks of <= "
                             f"{self._bufs[0].shape[0]} x {self.n} "
                             f"{self.dtype}, got {tuple(src.shape)} "
                             f"{src.dtype}")
        if n > 1 and src.stride(1) != 1:
            raise ValueError("H2DRing copies rows with unit column stride")
        if not _ends_pinned(src):
            raise RuntimeError("H2DRing copies from pinned host memory only "
                               "(a pageable copy would serialize the "
                               "pipeline)")
        s, _ = self._begin()
        size = src.element_size()
        spitch = (src.stride(0) if rows > 1 else n) * size
        err = _lib().repro_h2d_pitched(
            self._bufs[s].data_ptr(), self.ld * size, src.data_ptr(),
            spitch, n * size, rows, self.stream.cuda_stream)
        if err != 0:
            raise RuntimeError(f"host -> device block copy failed: CUDA "
                               f"error {err}")
        self._end(s)
        return self._bufs[s][:rows, :n]


class H2DArrays(_Ring):
    """The ring of ``H2DRing`` over sets of named 1-D arrays of any size:
    each slot holds one device buffer a name, grown when an array
    outgrows it.  ``put(arrays)`` copies the pinned contiguous host
    tensors of ``{name: tensor}`` into the next slot and returns their
    views on the card, of the same names and shapes."""

    def __init__(self, device: torch.device):
        super().__init__(device)
        self._bufs: list[dict] = [{}, {}]

    def put(self, arrays: dict) -> dict:
        for name, src in arrays.items():
            if not src.is_contiguous() or (src.numel() and
                                           not _ends_pinned(src)):
                raise RuntimeError(f"H2DArrays copies contiguous pinned "
                                   f"host tensors only ({name!r} is not)")
        s, now = self._begin()
        out = {}
        for name, src in arrays.items():
            buf = self._bufs[s].get(name)
            if buf is None or buf.numel() < src.numel() or \
                    buf.dtype != src.dtype:
                buf = torch.empty((max(src.numel(), 1),), dtype=src.dtype,
                                  device=self.device)
                buf.record_stream(self.stream)
                # fresh memory may be what the compute stream freed and
                # still reads: the copy waits for all compute work so far
                self.stream.wait_event(now)
                self._bufs[s][name] = buf
            dst = buf[:src.numel()].view(src.shape)
            if src.numel():
                copy_h2d(dst, src, self.stream)
            out[name] = dst
        self._end(s)
        return out
