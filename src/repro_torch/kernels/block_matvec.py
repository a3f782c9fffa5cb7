"""Hopper kernels of the block power step: ``A @ Q`` and ``A^T @ Y``.

Bindings of ``csrc/block_matvec.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  They
replace the Pallas TPU kernels of the JAX package's
``repro/kernels/block_matvec.py``: ``block_matvec`` (``pallas_call`` at
line 81) and ``block_rmatvec`` (``pallas_call`` at line 127).  The
source's header says what bounds them on an H100 and what the design
does about it.

These functions take CUDA tensors that ``kernels/ops.py`` has already
checked (device, dtype, shape, contiguity); they allocate the fp32
output and any scratch with ``torch.empty``, launch on the current
stream, and raise if the launch was refused.  Call them through
``ops``, which also keeps the launch counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: rows of A one block_rmatvec slab sums sequentially: bounds each
#: thread's fp32 running sum, so the rounding error stays ~2e-6 relative
SLAB_MAX_ROWS = 16384
#: blocks block_rmatvec aims to launch (about two per SM of a 132-SM
#: H100); a fixed number, so the slab split (and with it the summation
#: order and the bits of the result) depends on the shape alone
FILL_BLOCKS = 256
#: rows of the reduction one slab holds at least
SLAB_MIN_ROWS = 1024
BM = 256        # output rows per thread block (csrc: TY * TM)
BK = 16         # reduction depth per shared-memory stage (csrc: BK)
KT_MAX = 64     # widest k tile (csrc: TX * 8)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.library("block_matvec")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_block_matvec.argtypes = [_P, _P, _P, _I64, _I64, _I64,
                                           ctypes.c_int, _P]
        lib.repro_block_matvec.restype = ctypes.c_int
        lib.repro_block_rmatvec.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64,
                                            _I64, ctypes.c_int, _P]
        lib.repro_block_rmatvec.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rmatvec_slab_rows(m: int, n: int, k: int) -> int:
    """Rows per slab of ``block_rmatvec``'s split reduction over m: at
    most ``SLAB_MAX_ROWS``, and few enough rows that the launch has about
    ``FILL_BLOCKS`` blocks when n is small.  A multiple of ``BK``."""
    blocks = math.ceil(n / BM) * math.ceil(k / KT_MAX)
    slabs = max(math.ceil(m / SLAB_MAX_ROWS),
                min(math.ceil(FILL_BLOCKS / blocks),
                    math.ceil(m / SLAB_MIN_ROWS)))
    rows = math.ceil(m / max(slabs, 1))
    return max(BK, -(-rows // BK) * BK)


def block_matvec_cuda(A: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``Y = A @ Q`` on the card; A (m, n) and Q (n, k) contiguous, both
    fp32 or both bf16; Y (m, k) fp32."""
    m, n = A.shape
    k = Q.shape[1]
    Y = torch.empty((m, k), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = _lib().repro_block_matvec(
            A.data_ptr(), Q.data_ptr(), Y.data_ptr(), m, n, k,
            int(A.dtype == torch.bfloat16), _stream(A))
    _check(err, "block_matvec")
    return Y


def block_rmatvec_cuda(A: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """``Z = A^T @ Y`` on the card; A (m, n) and Y (m, k) contiguous,
    both fp32 or both bf16; Z (n, k) fp32.  The reduction over m is
    split into slabs whose fp32 partials a second launch sums in order."""
    m, n = A.shape
    k = Y.shape[1]
    rows = rmatvec_slab_rows(m, n, k)
    slabs = math.ceil(m / rows)
    Z = torch.empty((n, k), dtype=torch.float32, device=A.device)
    partial = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    with torch.cuda.device(A.device):
        err = _lib().repro_block_rmatvec(
            A.data_ptr(), Y.data_ptr(), Z.data_ptr(),
            None if partial is None else partial.data_ptr(), m, n, k, rows,
            int(A.dtype == torch.bfloat16), _stream(A))
    _check(err, "block_rmatvec")
    return Z
