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
the sweep dtype by the caller.  ``csr_rmatmat_cuda`` sorts the block's
columns stably on the card (``torch.sort``: a permutation, no sums) so
each column's nonzeros form one run in row order, and the kernel sums
each run straight into ``Z``: one thread group a run, no atomics, so the
blocks of a pass, launched in order on one stream, accumulate ``Z`` as
``np.add.at`` does over the whole stream.

These functions take CUDA tensors that ``kernels/ops.py`` has already
checked; they allocate outputs and scratch with ``torch.empty``, launch on
the current stream, and raise if a launch was refused.  Call them through
``ops``, which also keeps the launch counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.library("csr_sweep")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_csr_matmat.argtypes = [_P, _P, _P, _INT, _P, _P, _I64, _I64,
                                         _INT, _P]
        lib.repro_csr_matmat.restype = _INT
        lib.repro_csr_rmatmat.argtypes = [_P, _P, _P, _P, _P, _INT, _P, _P,
                                          _I64, _I64, _I64, _P]
        lib.repro_csr_rmatmat.restype = _INT
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
    rows, k = off.numel() - 1, Q.shape[1]
    Y = torch.empty((rows, k), dtype=torch.float32, device=Q.device) \
        if out is None else out
    with torch.cuda.device(Q.device):
        err = _lib().repro_csr_matmat(
            off.data_ptr(), col.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Q.data_ptr(), Y.data_ptr(),
            rows, k, int(round_out), _stream(Q))
    _check(err, "csr_matmat")
    return Y


def csr_rmatmat_cuda(off, col, val, Y, Z):
    """``Z += A_b^T Y`` on the card, in place; returns ``Z``."""
    rows, k, nnz = off.numel() - 1, Y.shape[1], col.numel()
    if nnz == 0:
        return Z
    skey, perm = torch.sort(col, stable=True)     # each column one run
    row_of = torch.empty((nnz,), dtype=torch.int32, device=Y.device)
    with torch.cuda.device(Y.device):
        err = _lib().repro_csr_rmatmat(
            off.data_ptr(), skey.data_ptr(), perm.data_ptr(),
            row_of.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Y.data_ptr(), Z.data_ptr(),
            rows, nnz, k, _stream(Y))
    _check(err, "csr_rmatmat")
    return Z


def csr_gram_chain_cuda(off, col, val, Q, Z, round_y: bool = False):
    """``Z += A_b^T (A_b Q)`` on one copy of the block: ``y`` (rows, k)
    lives in scratch, rounded to bf16 between the halves with
    ``round_y``; returns ``Z``."""
    y = csr_matmat_cuda(off, col, val, Q, round_out=round_y)
    return csr_rmatmat_cuda(off, col, val, y, Z)
