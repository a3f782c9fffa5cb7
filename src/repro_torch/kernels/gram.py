"""Hopper kernels of the Gram product ``B = A^T A`` (``method="gram"``).

Bindings of ``csrc/gram_tf32.cu`` and ``csrc/gram_bf16.cu`` (CUDA C++
for ``sm_90a``, built by ``kernels/build.py`` at first use and called
through ``ctypes``).  They replace the Pallas TPU kernel of the JAX
package's ``repro/kernels/gram.py``: ``gram`` (``pallas_call`` at line
84), with its reduced-task schedule: the grid enumerates only the
upper-triangle tiles, in the order of
``core/partition.py::symmetric_tasks``, and each block writes its tile
and its mirror, so ``B`` is exactly symmetric.  ``trans=True`` gives
``A A^T`` for wide inputs.  The sources' headers say what bounds them on
an H100 and what each design does about it.

Every kernel reads ``A`` (m, n) row-major with rows ``lda`` elements
apart (``block_matvec.row_stride``), so a view of wider rows is read in
place.  Four routes, chosen by ``route(A)`` from dtype, row stride and
alignment, the same for both orientations:

* ``"tf32x3"`` (``gram_tf32.cu``): fp32 where a TMA tensor map describes
  ``A`` (16-byte-aligned base, ``lda % 4 == 0``).  The tensor cores as
  3xTF32 (never plain TF32): each operand split into a TF32 ``hi`` and
  ``lo``, three products, fp32 sums promoted every 32-deep stage; no
  scratch.
* ``"tf32x3_cpasync"`` (the same file): every other fp32 ``A`` (any
  width, a base 4 or 8 bytes off 16).  The same kernel, the stage of its
  register operand copied by ``cp.async`` of 4 or 8 bytes in place of
  TMA; edges zero-filled, never read.
* ``"wgmma"`` (``gram_bf16.cu``): bf16 where a TMA tensor map describes
  ``A`` (16-byte-aligned base, ``lda % 8 == 0``).  The bf16 tensor
  cores, both operands from shared memory (``A^T A``'s both MN-major,
  through wgmma's transpose bits), the wgmma sums added into rounded
  fp32 sums every 256 rows.  At the gram path's 262144 x 8192 the bound
  is 17.79 ms (m n (n + 1) flop at 989 TFLOP/s), but 128 x 128 tiles
  pull 283 GB of ``A`` through L2 a launch; four blocks of a 2 x 2
  cluster of tiles share each 64-column box by TMA multicast, 142 GB.
  The kernel is held by that staging, and 128 x 128 tiles read 160
  bytes of shared memory a tensor-core clock against the SM's 128, so
  it cannot pass ~80 % of the bound either.
* ``"wgmma_ld"`` (the same file): every other bf16 ``A`` (any
  ``lda >= n``, any 2-byte-aligned base).  The same kernel and the same
  2 x 2 clusters, each block assembling its two 64-column boxes itself
  (each 16-byte chunk by ``cp.async`` of 16, 8 or 4 bytes as its address
  allows, or, where a row starts 2 bytes off a 4-byte boundary, every
  other row of an odd ``lda``, by 4-byte loads into registers shifted by
  a byte permute; edges zero-filled, never read) and pushing each to the
  partner that reads it through distributed shared memory (the TMA
  unit's copy from one block's shared memory into another's).

A launch that the card refuses raises; no route stands in for another.
``gram_cuda`` takes a CUDA tensor that ``kernels/ops.py`` has already
checked, allocates the fp32 output with ``torch.empty``, and launches on
the current stream.  Call it through ``ops``, which keeps the launch
counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.block_matvec import row_stride

#: every route, in the order of ``ops.route_launches``
ROUTES = ("tf32x3", "tf32x3_cpasync", "wgmma", "wgmma_ld")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_ARGS = [_P, _I64, _P, _I64, _I64, ctypes.c_int, ctypes.c_int, _P]


def route(A: torch.Tensor) -> str:
    """The kernel that takes ``A`` (m, n), rows ``row_stride(A)`` apart, in
    either orientation: where a TMA tensor map describes it (base 16-byte
    aligned, rows a multiple of 16 bytes apart) ``"tf32x3"`` for fp32 and
    ``"wgmma"`` for bf16, else ``"tf32x3_cpasync"`` and ``"wgmma_ld"``."""
    lda = row_stride(A)
    fp32 = A.dtype == torch.float32
    mapped = (lda is not None and lda % (4 if fp32 else 8) == 0
              and A.data_ptr() % 16 == 0)
    if fp32:
        return "tf32x3" if mapped else "tf32x3_cpasync"
    return "wgmma" if mapped else "wgmma_ld"


def _bind(name: str, entries) -> ctypes.CDLL:
    lib = build.library(name)
    if not getattr(lib, "_repro_bound", False):
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _ARGS
            fn.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def gram_cuda(A: torch.Tensor, which: str, *, symmetric: bool = True,
              trans: bool = False) -> torch.Tensor:
    """``A^T A`` (or ``A A^T`` with ``trans``) on the card by the kernel of
    route ``which``, fp32 out; A (m, n) fp32 or bf16 with rows
    ``row_stride(A)`` apart."""
    m, n = A.shape
    N = m if trans else n
    B = torch.empty((N, N), dtype=torch.float32, device=A.device)
    if which.startswith("wgmma"):
        lib = _bind("gram_bf16", ("repro_gram_wgmma", "repro_gram_wgmma_ld"))
    else:
        lib = _bind("gram_tf32", ("repro_gram_tf32x3",
                                  "repro_gram_tf32x3_cpasync"))
    fn = getattr(lib, f"repro_gram_{which}")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), row_stride(A), B.data_ptr(), m, n, int(trans),
                 int(symmetric), stream)
    if err != 0:
        raise RuntimeError(f"gram kernel launch failed ({which} route): CUDA "
                           f"error {err}")
    return B
