"""Hopper kernels of the block power step: ``A @ Q`` and ``A^T @ Y``.

Bindings of ``csrc/block_matvec_tf32.cu`` and ``csrc/block_matvec_tc.cu``
(CUDA C++ for ``sm_90a``, built by ``kernels/build.py`` at first use and
called through ``ctypes``).  They replace the Pallas TPU kernels of the
JAX package's ``repro/kernels/block_matvec.py``: ``block_matvec``
(``pallas_call`` at line 81) and ``block_rmatvec`` (``pallas_call`` at
line 127).  The sources' headers say what bounds them on an H100 and
what each design does about it.

Every kernel reads ``A`` (m, n) row-major with rows ``lda`` elements
apart (``row_stride``: ``lda >= n``, unit column stride), so a view of
wider rows is read in place.  Four routes, chosen by ``route(A, k)``
from dtype, row stride and alignment:

* ``"tf32x3"`` (``block_matvec_tf32.cu``): fp32 where a TMA tensor map
  describes ``A`` (16-byte-aligned base, ``lda % 4 == 0``), any k.  The
  tensor cores as 3xTF32 (never plain TF32): each operand split into a
  TF32 ``hi`` and ``lo``, three products, fp32 sums promoted every
  32-deep stage.  ``block_rmatvec`` splits m into slabs of whole 32-row
  stages.
* ``"tf32x3_cpasync"`` (the same file): every other fp32 ``A`` (any
  width, a base 4 or 8 bytes off 16).  The same kernels, their stage
  ring filled by ``cp.async`` copies of 4 or 8 bytes from the producer
  warpgroup in place of TMA; edges zero-filled, never read.
* ``"wgmma"`` (``block_matvec_tc.cu``): bf16 where a TMA tensor map
  describes ``A`` (16-byte-aligned base, ``lda % 8 == 0``; the solver's
  own bf16 copy, whose rows ``DenseOperator`` pads to whole 16 bytes),
  any k.  A ring of TMA-filled shared-memory stages, wgmma with fp32
  sums; ``block_rmatvec`` splits m into slabs of whole 64-row stages.
* ``"wgmma_ld"`` (the same file): every other bf16 ``A`` (any
  ``lda >= n``, any 2-byte-aligned base), which only a caller of ``ops``
  hands in: the same kernels, their stage ring filled by the producer
  warpgroup's own copies (``cp.async`` of 8 or 4 bytes where the rows
  start so aligned; rows 2 bytes off a 4-byte boundary, as an odd
  ``lda`` leaves every other one, by 4-byte loads shifted in registers);
  edges zero-filled, never read.

Every route runs on the tensor cores; the skinny operand is read
transposed (``Q^T``, ``Y^T``: k rows), which any k can be read as.  A
launch that the card refuses raises; no route stands in for another.
These functions take CUDA tensors that ``kernels/ops.py`` has already
checked (device, dtype, shape, layout); they allocate the fp32 output
and any scratch with ``torch.empty``, launch on the current stream, and
raise if the launch was refused.  Call them through ``ops``, which also
keeps the launch counts.
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
BM = 256        # rows of A a block_matvec block, columns a block_rmatvec
                # block (csrc: BM, BN)
KT_MAX = 64     # widest k tile (block_matvec_tc.cu: KT)
TC_BK = 64      # rows of a bf16 stage (block_matvec_tc.cu: BK)
TF32_BK = 32    # rows of a 3xTF32 stage (block_matvec_tf32.cu: BK)
#: rows of block_rmatvec's slabs are a multiple of the route's stage depth
STEP = {"wgmma": TC_BK, "wgmma_ld": TC_BK, "tf32x3": TF32_BK,
        "tf32x3_cpasync": TF32_BK}
#: every route, in the order of ``ops.route_launches``
ROUTES = ("tf32x3", "tf32x3_cpasync", "wgmma", "wgmma_ld")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def row_stride(A: torch.Tensor) -> int | None:
    """The distance ``lda`` between the rows of a 2-D ``A`` as the kernels
    read it: ``A`` row-major with unit column stride and ``lda >= n``;
    ``None`` for any other layout (a transposed view, a column step)."""
    m, n = A.shape
    if n > 1 and A.stride(1) != 1:
        return None
    lda = A.stride(0) if m > 1 else n
    return lda if lda >= n else None


def route(A: torch.Tensor, k: int) -> str:
    """The kernel that takes ``A`` (m, n), rows ``row_stride(A)`` apart,
    with k skinny columns.  fp32: ``"tf32x3"`` where a TMA tensor map
    describes it (base 16-byte aligned, rows a multiple of 16 bytes),
    else ``"tf32x3_cpasync"``; bf16: ``"wgmma"`` where a map describes
    it, else ``"wgmma_ld"``."""
    lda = row_stride(A)
    mapped = A.data_ptr() % 16 == 0 and k >= 1 and lda is not None
    if A.dtype == torch.float32:
        return "tf32x3" if mapped and lda % 4 == 0 else "tf32x3_cpasync"
    return "wgmma" if mapped and lda % 8 == 0 else "wgmma_ld"


def _lib_tc() -> ctypes.CDLL:
    lib = build.library("block_matvec_tc")
    if not getattr(lib, "_repro_bound", False):
        for which in ("wgmma", "wgmma_ld"):
            mv = getattr(lib, f"repro_block_matvec_{which}")
            rmv = getattr(lib, f"repro_block_rmatvec_{which}")
            mv.argtypes = [_P, _I64, _P, _I64, _P, _I64, _I64, _I64, _P]
            rmv.argtypes = [_P, _I64, _P, _P, _P, _I64, _I64, _I64, _I64,
                            _I64, _P]
            mv.restype = rmv.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _lib_tf32() -> ctypes.CDLL:
    lib = build.library("block_matvec_tf32")
    if not getattr(lib, "_repro_bound", False):
        for which in ("tf32x3", "tf32x3_cpasync"):
            mv = getattr(lib, f"repro_block_matvec_{which}")
            rmv = getattr(lib, f"repro_block_rmatvec_{which}")
            mv.argtypes = [_P, _I64, _P, _P, _P, _I64, _I64, _I64, _I64, _P]
            rmv.argtypes = [_P, _I64, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                            _I64, _P]
            mv.restype = rmv.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rmatvec_slab_rows(m: int, n: int, k: int, step: int) -> int:
    """Rows per slab of ``block_rmatvec``'s split reduction over m: at
    most ``SLAB_MAX_ROWS``, and few enough rows that the launch has about
    ``FILL_BLOCKS`` blocks when n is small.  A multiple of the route's
    stage depth ``step`` (``STEP`` by route: the tensor cores' stages
    must not reach into the next slab)."""
    blocks = math.ceil(n / BM) * math.ceil(k / KT_MAX)
    slabs = max(math.ceil(m / SLAB_MAX_ROWS),
                min(math.ceil(FILL_BLOCKS / blocks),
                    math.ceil(m / SLAB_MIN_ROWS)))
    rows = math.ceil(m / max(slabs, 1))
    return max(step, -(-rows // step) * step)


def _tf32_split(k: int, rows: int, device) -> tuple:
    """Scratch for the skinny operand's transposed tf32 halves, (2, k, ld)
    with ``ld`` = ``rows`` rounded up to whole 16-byte rows (a tensor map's
    stride), written by the library; and ``ld``."""
    ld = -(-rows // 4) * 4
    return torch.empty((2, k, ld), dtype=torch.float32, device=device), ld


def _transposed(X: torch.Tensor) -> tuple:
    """The bf16 skinny operand X (rows, k) as X^T (k, rows) with rows
    padded to whole 16 bytes (a tensor map's stride), and that stride."""
    rows, k = X.shape
    ld = -(-rows // 8) * 8
    Xt = torch.empty((k, ld), dtype=X.dtype, device=X.device)
    Xt[:, :rows].copy_(X.mT)
    return Xt, ld


def block_matvec_cuda(A: torch.Tensor, Q: torch.Tensor,
                      which: str) -> torch.Tensor:
    """``Y = A @ Q`` on the card by the kernel of route ``which``; A (m, n)
    with rows ``row_stride(A)`` apart and Q (n, k) contiguous, both fp32
    or both bf16; Y (m, k) fp32."""
    m, n = A.shape
    k = Q.shape[1]
    lda = row_stride(A)
    Y = torch.empty((m, k), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        if which in ("tf32x3", "tf32x3_cpasync"):
            split, ld = _tf32_split(k, n, A.device)
            err = getattr(_lib_tf32(), f"repro_block_matvec_{which}")(
                A.data_ptr(), lda, Q.data_ptr(), split.data_ptr(),
                Y.data_ptr(), m, n, k, ld, _stream(A))
        else:                               # wgmma, wgmma_ld
            Qt, ld = _transposed(Q)         # (k, n): K-major TMA boxes
            err = getattr(_lib_tc(), f"repro_block_matvec_{which}")(
                A.data_ptr(), lda, Qt.data_ptr(), ld, Y.data_ptr(), m, n, k,
                _stream(A))
    _check(err, f"block_matvec ({which} route)")
    return Y


def block_rmatvec_cuda(A: torch.Tensor, Y: torch.Tensor,
                       which: str) -> torch.Tensor:
    """``Z = A^T @ Y`` on the card by the kernel of route ``which``; A
    (m, n) with rows ``row_stride(A)`` apart and Y (m, k) contiguous,
    both fp32 or both bf16; Z (n, k) fp32.  The reduction over m is split
    into slabs whose fp32 partials a second launch sums in order."""
    m, n = A.shape
    k = Y.shape[1]
    lda = row_stride(A)
    rows = rmatvec_slab_rows(m, n, k, STEP[which])
    slabs = math.ceil(m / rows)
    Z = torch.empty((n, k), dtype=torch.float32, device=A.device)
    partial = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    part = None if partial is None else partial.data_ptr()
    with torch.cuda.device(A.device):
        if which in ("tf32x3", "tf32x3_cpasync"):
            split, ld = _tf32_split(k, m, A.device)
            err = getattr(_lib_tf32(), f"repro_block_rmatvec_{which}")(
                A.data_ptr(), lda, Y.data_ptr(), split.data_ptr(),
                Z.data_ptr(), part, m, n, k, ld, rows, _stream(A))
        else:                               # wgmma, wgmma_ld
            Yt, ld = _transposed(Y)         # (k, m): K-major TMA boxes
            err = getattr(_lib_tc(), f"repro_block_rmatvec_{which}")(
                A.data_ptr(), lda, Yt.data_ptr(), Z.data_ptr(), part, m, n,
                k, ld, rows, _stream(A))
    _check(err, f"block_rmatvec ({which} route)")
    return Z
