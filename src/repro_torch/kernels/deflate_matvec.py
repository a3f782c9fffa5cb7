"""Hopper kernels of the gram-free deflated power step: ``A @ v`` and the
fused reverse sweep ``A^T (Xv - U c)``, ``U^T Xv``.

Bindings of ``csrc/deflate_matvec.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  They
replace the Pallas TPU kernels of the JAX package's
``repro/kernels/deflate_matvec.py``: ``matvec`` (``pallas_call`` at line
55) and ``deflate_rmatvec`` (``pallas_call`` at line 127).  ``trans=True``
applies the same function to ``A^T`` without forming it, for the wide
inputs whose power step runs on the left side.  The source's header says
what bounds them on an H100 and what the design does about it.

These functions take fp32 CUDA tensors that ``kernels/ops.py`` has
already checked; they allocate the outputs and any scratch with
``torch.empty``, launch on the current stream, and raise if a launch was
refused.  Call them through ``ops``, which also keeps the launch counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matvec import FILL_BLOCKS, SLAB_MAX_ROWS

BC = 1024       # columns per block of the column sweeps (csrc: NT * CW)
CHUNK = 64      # rows whose weights a column sweep stages at a time
NT = 256        # threads per block (csrc: NT)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.library("deflate_matvec")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_matvec.argtypes = [_P, _P, _P, _P, _I64, _I64, _I64,
                                     ctypes.c_int, _P]
        lib.repro_matvec.restype = ctypes.c_int
        lib.repro_deflate_rmatvec.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                                              _I64, _I64, _I64, _I64,
                                              ctypes.c_int, _P]
        lib.repro_deflate_rmatvec.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def colsweep_slab_rows(m: int, n: int) -> int:
    """Rows per slab of a column sweep's split reduction over m: at most
    ``SLAB_MAX_ROWS``, and few enough that the launch has about
    ``FILL_BLOCKS`` blocks when n is small.  A multiple of ``CHUNK``; it
    depends on the shape alone, so the summation order (and the bits of
    the result) does too."""
    blocks = math.ceil(n / BC)
    slabs = max(math.ceil(m / SLAB_MAX_ROWS),
                min(math.ceil(FILL_BLOCKS / blocks), math.ceil(m / CHUNK)))
    rows = math.ceil(m / max(slabs, 1))
    return max(CHUNK, -(-rows // CHUNK) * CHUNK)


def matvec_cuda(A: torch.Tensor, v: torch.Tensor, trans: bool = False
                ) -> torch.Tensor:
    """``A @ v`` (or ``A^T @ v`` with ``trans``) on the card; A (m, n)
    and v contiguous fp32."""
    m, n = A.shape
    out_len = n if trans else m
    y = torch.empty((out_len,), dtype=torch.float32, device=A.device)
    rows = colsweep_slab_rows(m, n)
    slabs = math.ceil(m / rows) if trans else 1
    partial = (torch.empty((slabs, n), dtype=torch.float32, device=A.device)
               if slabs > 1 else None)
    with torch.cuda.device(A.device):
        err = _lib().repro_matvec(A.data_ptr(), v.data_ptr(), y.data_ptr(),
                                  _ptr(partial), m, n, rows, int(trans),
                                  _stream(A))
    _check(err, "matvec")
    return y


def deflate_rmatvec_cuda(A: torch.Tensor, U: torch.Tensor, x: torch.Tensor,
                         c: torch.Tensor, trans: bool = False):
    """The fused reverse sweep on the card; all operands contiguous fp32.

    ``trans=False``: A (m, n), U (m, k), x (m,), c (k,) ->
    ``(A^T (x - U c), U^T x)``.  ``trans=True``: U (n, k), x (n,) ->
    ``(A (x - U c), U^T x)``."""
    m, n = A.shape
    k = U.shape[1]
    dev = A.device
    t13 = torch.empty((m if trans else n,), dtype=torch.float32, device=dev)
    utx = torch.empty((k,), dtype=torch.float32, device=dev)
    rows = colsweep_slab_rows(m, n)
    if trans:               # corr (n,) and per-block partials of U^T x
        partial = torch.empty((n,), dtype=torch.float32, device=dev)
        upartial = torch.empty((math.ceil(n / NT), k), dtype=torch.float32,
                               device=dev)
    else:
        slabs = math.ceil(m / rows)
        partial, upartial = ((torch.empty((slabs, n), dtype=torch.float32,
                                          device=dev),
                              torch.empty((slabs, k), dtype=torch.float32,
                                          device=dev))
                             if slabs > 1 else (None, None))
    with torch.cuda.device(dev):
        err = _lib().repro_deflate_rmatvec(
            A.data_ptr(), U.data_ptr(), x.data_ptr(), c.data_ptr(),
            t13.data_ptr(), utx.data_ptr(), _ptr(partial), _ptr(upartial),
            m, n, k, rows, int(trans), _stream(A))
    _check(err, "deflate_rmatvec")
    return t13, utx
