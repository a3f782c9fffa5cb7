"""Hopper kernel of the Gram product ``B = A^T A`` (``method="gram"``).

Binding of ``csrc/gram.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  It
replaces the Pallas TPU kernel of the JAX package's
``repro/kernels/gram.py``: ``gram`` (``pallas_call`` at line 84), with
its reduced-task schedule: the grid enumerates only the upper-triangle
tiles, in the order of ``core/partition.py::symmetric_tasks``, and each
block writes its tile and its mirror.  ``trans=True`` gives ``A A^T``
for wide inputs.  The source's header says what bounds it on an H100 and
what the design does about it.

``gram_cuda`` takes a contiguous fp32 or bf16 CUDA tensor that
``kernels/ops.py`` has already checked, allocates the fp32 output with
``torch.empty``, launches on the current stream, and raises if the
launch was refused.  Call it through ``ops``, which keeps the launch
counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

BN = 128        # output tile edge (csrc: BN)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.library("gram")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_gram.argtypes = [_P, _P, _I64, _I64, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int, _P]
        lib.repro_gram.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def gram_cuda(A: torch.Tensor, *, symmetric: bool = True,
              trans: bool = False) -> torch.Tensor:
    """``A^T A`` (or ``A A^T`` with ``trans``) on the card, fp32 out."""
    m, n = A.shape
    N = m if trans else n
    B = torch.empty((N, N), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        err = _lib().repro_gram(
            A.data_ptr(), B.data_ptr(), m, n, int(trans), int(symmetric),
            int(A.dtype == torch.bfloat16),
            torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed: CUDA error {err}")
    return B
