"""Hopper kernels of the sparse stream: ``Y_b = A_b Q``, ``Z += A_b^T Y_b``
and their chain, on one CSR row block.

Bindings of ``csrc/csr_sweep.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  The
JAX package has no kernel to replace here: its sparse stream sums the
nonzeros on the host with ``np.add.at`` (``repro/core/sparse.py``,
``RowBlockStream``).  The kernels sum in that order, each product
rounded before its add, so every output element is bitwise the
reference's; the source's header says why and what bounds them.

A block is three tensors on the card: ``off`` (int32, rows + 1, from 0),
``col`` (int32, nnz) and ``val`` (fp32 or bf16, nnz), in stream order
(row by row).  ``Q``/``Y``/``Z`` are contiguous fp32, already rounded to
the sweep dtype by the caller.  ``csr_matmat`` spreads a row's k columns
over k lanes, each loading several nonzeros' ``Q`` rows ahead of their
ordered adds.  ``csr_rmatmat`` writes
each nonzero's (row, value) record, partitions the (column, record)
pairs stably on the top ``bucket_bits`` of the ``key_bits(n)`` bits
the columns need (one radix pass of CUB: no sums), sorts each bucket on
its low bits in shared memory, and sums each column's run straight into
``Z``: one thread a run, no atomics in a sum, so the blocks of a pass,
launched in order on one stream, accumulate ``Z`` as ``np.add.at`` does
over the whole stream.

These functions take CUDA tensors that ``kernels/ops.py`` has already
checked; they allocate outputs and scratch with ``torch.empty`` (one
buffer a call, laid out by ``scratch_layout``: the caching allocator
hands the same memory to every block of a pass), launch on the current
stream, and raise if a launch was refused.  Call them through ``ops``,
which also keeps the launch counts.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int

#: ``csr_rmatmat_cuda``'s ``phases``: the records, the sorts and the run
#: list (no sums); the sums into ``Z``
SORT, RUNS = 1, 2
#: entries a bucket block sorts at a time (``CAP`` in ``csr_sweep.cu``)
BUCKET_CAP = 512 * 20
MAX_BUCKET_BITS = 8            # one pass of CUB's onesweep radix sort
_ALIGN = 256                   # bytes: every scratch region starts aligned


def key_bits(n: int) -> int:
    """The bits a column below ``n`` needs: the sort's key width."""
    return max(1, (int(n) - 1).bit_length())


def bucket_bits(nnz: int, bits: int) -> int:
    """The top key bits the partition takes: enough that a bucket
    averages at most half of ``BUCKET_CAP`` entries, at most
    ``MAX_BUCKET_BITS`` (one radix pass), and at least one bit left for
    the sort in shared memory."""
    hi = 0
    while hi < MAX_BUCKET_BITS and hi < bits - 1 and \
            nnz >> hi > BUCKET_CAP // 2:
        hi += 1
    return hi


def scratch_layout(nnz: int, sort_bytes: int) -> tuple[dict, int]:
    """``csr_rmatmat``'s scratch in one buffer: the byte offset of each
    region (sorted columns, records before and after the partition, the
    run starts and their count, the bucket bounds, CUB's temporary
    storage) and the total."""
    sizes = (("skey", 4 * nnz), ("rec_in", 8 * nnz), ("rec_out", 8 * nnz),
             ("starts", 4 * nnz), ("count", 4),
             ("bounds", 4 * ((1 << MAX_BUCKET_BITS) + 1)),
             ("sort", sort_bytes))
    offsets, at = {}, 0
    for name, size in sizes:
        offsets[name] = at
        at += -(-size // _ALIGN) * _ALIGN
    return offsets, at


def _lib() -> ctypes.CDLL:
    lib = build.library("csr_sweep")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_csr_matmat.argtypes = [_P, _P, _P, _INT, _P, _P, _I64, _I64,
                                         _I64, _INT, _P]
        lib.repro_csr_matmat.restype = _INT
        lib.repro_csr_sort_bytes.argtypes = [
            _I64, _INT, _INT, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.repro_csr_sort_bytes.restype = _INT
        lib.repro_csr_bucket_cap.argtypes = []
        lib.repro_csr_bucket_cap.restype = _INT
        lib.repro_csr_rmatmat.argtypes = [
            _P, _P, _P, _INT, _P, _P, _I64, _I64, _I64, _I64, _INT, _INT,
            _P, _P, _P, _P, _P, _P, _P, ctypes.c_ulonglong, _INT, _P]
        lib.repro_csr_rmatmat.restype = _INT
        lib.repro_row_gather.argtypes = [_P, _P, _P, _I64, _I64, _P]
        lib.repro_row_gather.restype = _INT
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def csr_matmat_cuda(off, col, val, Q, out=None, round_out: bool = False):
    """``A_b Q`` on the card -> (rows, k) fp32, into ``out`` when given;
    ``round_out`` rounds each sum to the nearest bf16."""
    rows, (n, k) = off.numel() - 1, Q.shape
    Y = torch.empty((rows, k), dtype=torch.float32, device=Q.device) \
        if out is None else out
    with torch.cuda.device(Q.device):
        err = _lib().repro_csr_matmat(
            off.data_ptr(), col.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Q.data_ptr(), Y.data_ptr(),
            rows, n, k, int(round_out), _stream(Q))
    _check(err, "csr_matmat")
    return Y


@functools.lru_cache(maxsize=64)
def _sort_bytes(device: int, nnz: int, bits: int) -> int:
    """CUB's temporary storage for the partition."""
    out = ctypes.c_ulonglong(0)
    low = bits - bucket_bits(nnz, bits)
    with torch.cuda.device(device):
        _check(_lib().repro_csr_sort_bytes(nnz, bits, low,
                                           ctypes.byref(out)),
               "csr_rmatmat (sort size)")
    return int(out.value)


def bucket_cap() -> int:
    """``CAP`` as the built library has it (``BUCKET_CAP`` mirrors it)."""
    return int(_lib().repro_csr_bucket_cap())


def rmatmat_scratch(nnz: int, n: int, device) -> torch.Tensor:
    """A scratch buffer for ``csr_rmatmat_cuda`` on ``nnz`` nonzeros of
    ``n`` columns (``scratch_layout``'s total bytes)."""
    device = torch.device(device)
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    _, total = scratch_layout(nnz, _sort_bytes(idx, nnz, key_bits(n)))
    return torch.empty((total,), dtype=torch.uint8, device=device)


def csr_rmatmat_cuda(off, col, val, Y, Z, *, scratch=None,
                     phases: int = SORT | RUNS):
    """``Z += A_b^T Y`` on the card, in place; returns ``Z``.  ``scratch``
    (``rmatmat_scratch``) is allocated when not given; ``phases`` runs
    the sort half (``SORT``), the sum half (``RUNS``, on the scratch the
    sort half left) or both."""
    rows, k, nnz, n = off.numel() - 1, Y.shape[1], col.numel(), Z.shape[0]
    if nnz == 0:
        return Z
    if nnz >= 2 ** 31:
        raise ValueError(f"csr_rmatmat: {nnz} nonzeros in one block; int32 "
                         f"offsets hold fewer than 2^31")
    if scratch is None:
        scratch = rmatmat_scratch(nnz, n, Y.device)
    bits = key_bits(n)
    offsets, total = scratch_layout(nnz, _sort_bytes(
        scratch.device.index, nnz, bits))
    if scratch.numel() < total:
        raise ValueError(f"csr_rmatmat: scratch of {scratch.numel()} bytes, "
                         f"needs {total}")
    base = scratch.data_ptr()
    ptr = {name: base + at for name, at in offsets.items()}
    with torch.cuda.device(Y.device):
        err = _lib().repro_csr_rmatmat(
            off.data_ptr(), col.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Y.data_ptr(), Z.data_ptr(),
            rows, nnz, n, k, bits, bits - bucket_bits(nnz, bits),
            ptr["skey"], ptr["rec_in"], ptr["rec_out"], ptr["starts"],
            ptr["count"], ptr["bounds"], ptr["sort"],
            total - offsets["sort"], phases, _stream(Y))
    _check(err, "csr_rmatmat")
    return Z


def csr_gram_chain_cuda(off, col, val, Q, Z, round_y: bool = False):
    """``Z += A_b^T (A_b Q)`` on one copy of the block: ``y`` (rows, k)
    lives in scratch, rounded to bf16 between the halves with
    ``round_y``; returns ``Z``."""
    y = csr_matmat_cuda(off, col, val, Q, round_out=round_y)
    return csr_rmatmat_cuda(off, col, val, y, Z)


def row_gather_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each ``src[idx[i]]`` summed in column order, for a contiguous fp32
    ``src`` (rows of a multiple of 4 floats) and int32 ``idx``: the probe
    of the card's scattered-row read rate that ``chip_smoke.py`` reads
    the sweeps against (4 bytes written a row; no path uses it)."""
    out = torch.empty((idx.numel(),), dtype=torch.float32,
                      device=src.device)
    with torch.cuda.device(src.device):
        err = _lib().repro_row_gather(src.data_ptr(), idx.data_ptr(),
                                      out.data_ptr(), idx.numel(),
                                      src.shape[1], _stream(src))
    _check(err, "row_gather")
    return out
