"""Hopper kernels of the block power step: ``A @ Q`` and ``A^T @ Y``.

Bindings of ``csrc/block_matvec_tc.cu`` and ``csrc/block_matvec.cu``
(CUDA C++ for ``sm_90a``, built by ``kernels/build.py`` at first use and
called through ``ctypes``).  They replace the Pallas TPU kernels of the
JAX package's ``repro/kernels/block_matvec.py``: ``block_matvec``
(``pallas_call`` at line 81) and ``block_rmatvec`` (``pallas_call`` at
line 127).  The sources' headers say what bounds them on an H100 and
what each design does about it.

Two routes, chosen by ``route(A, k)`` from dtype, shape and alignment:

* ``"wgmma"`` (``block_matvec_tc.cu``): bf16 where a TMA tensor map
  describes ``A`` (16-byte-aligned base, ``n % 8 == 0``), any k.  A
  ring of TMA-filled shared-memory stages, wgmma with fp32 sums.  The
  skinny operand is handed over transposed (``Q^T``, ``Y^T``: k rows),
  which any k can be read as; ``block_rmatvec`` splits m into slabs of
  whole 64-row stages.
* ``"ffma"`` (``block_matvec.cu``): fp32 (never TF32), and every other
  bf16 operand.

A launch that the card refuses raises; neither route stands in for the
other.  These functions take CUDA tensors that ``kernels/ops.py`` has
already checked (device, dtype, shape, contiguity); they allocate the
fp32 output and any scratch with ``torch.empty``, launch on the current
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
BM = 256        # output rows per thread block (csrc: TY * TM; the
                # tensor-core kernels' BM and BN are 256 too)
BK = 16         # reduction depth per shared-memory stage (csrc: BK)
KT_MAX = 64     # widest k tile (csrc: TX * 8; block_matvec_tc.cu: KT)
TC_BK = 64      # rows of a tensor-core stage (block_matvec_tc.cu: BK)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def route(A: torch.Tensor, k: int) -> str:
    """The kernel that takes ``A`` (m, n) with k skinny columns:
    ``"wgmma"`` for bf16 that a TMA tensor map can describe (base 16-byte
    aligned, rows of ``2 n`` bytes a multiple of 16), else ``"ffma"``."""
    return ("wgmma" if A.dtype == torch.bfloat16 and A.shape[1] % 8 == 0
            and A.data_ptr() % 16 == 0 and k >= 1 else "ffma")


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


def _lib_tc() -> ctypes.CDLL:
    lib = build.library("block_matvec_tc")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_block_matvec_wgmma.argtypes = [_P, _P, _P, _I64, _I64,
                                                 _I64, _P]
        lib.repro_block_rmatvec_wgmma.argtypes = [_P, _P, _P, _P, _I64, _I64,
                                                  _I64, _I64, _I64, _P]
        for fn in (lib.repro_block_matvec_wgmma,
                   lib.repro_block_rmatvec_wgmma):
            fn.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def rmatvec_slab_rows(m: int, n: int, k: int, step: int = BK) -> int:
    """Rows per slab of ``block_rmatvec``'s split reduction over m: at
    most ``SLAB_MAX_ROWS``, and few enough rows that the launch has about
    ``FILL_BLOCKS`` blocks when n is small.  A multiple of the route's
    stage depth ``step`` (``BK``; ``TC_BK`` on the tensor cores, whose
    stages must not reach into the next slab)."""
    blocks = math.ceil(n / BM) * math.ceil(k / KT_MAX)
    slabs = max(math.ceil(m / SLAB_MAX_ROWS),
                min(math.ceil(FILL_BLOCKS / blocks),
                    math.ceil(m / SLAB_MIN_ROWS)))
    rows = math.ceil(m / max(slabs, 1))
    return max(step, -(-rows // step) * step)


def block_matvec_cuda(A: torch.Tensor, Q: torch.Tensor,
                      which: str) -> torch.Tensor:
    """``Y = A @ Q`` on the card by the kernel of route ``which``; A (m, n)
    and Q (n, k) contiguous, both fp32 or both bf16; Y (m, k) fp32."""
    m, n = A.shape
    k = Q.shape[1]
    Y = torch.empty((m, k), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        if which == "wgmma":
            Qt = Q.mT.contiguous()          # (k, n): K-major TMA boxes
            err = _lib_tc().repro_block_matvec_wgmma(
                A.data_ptr(), Qt.data_ptr(), Y.data_ptr(), m, n, k,
                _stream(A))
        else:
            err = _lib().repro_block_matvec(
                A.data_ptr(), Q.data_ptr(), Y.data_ptr(), m, n, k,
                int(A.dtype == torch.bfloat16), _stream(A))
    _check(err, f"block_matvec ({which} route)")
    return Y


def block_rmatvec_cuda(A: torch.Tensor, Y: torch.Tensor,
                       which: str) -> torch.Tensor:
    """``Z = A^T @ Y`` on the card by the kernel of route ``which``; A
    (m, n) and Y (m, k) contiguous, both fp32 or both bf16; Z (n, k)
    fp32.  The reduction over m is split into slabs whose fp32 partials
    a second launch sums in order."""
    m, n = A.shape
    k = Y.shape[1]
    tc = which == "wgmma"
    rows = rmatvec_slab_rows(m, n, k, TC_BK if tc else BK)
    slabs = math.ceil(m / rows)
    Z = torch.empty((n, k), dtype=torch.float32, device=A.device)
    partial = (torch.empty((slabs, n, k), dtype=torch.float32,
                           device=A.device) if slabs > 1 else None)
    part = None if partial is None else partial.data_ptr()
    with torch.cuda.device(A.device):
        if tc:
            # Y^T (k, m) with rows padded to 16 bytes: K-major TMA boxes
            ld = -(-m // 8) * 8
            Yt = torch.empty((k, ld), dtype=Y.dtype, device=Y.device)
            Yt[:, :m].copy_(Y.mT)
            err = _lib_tc().repro_block_rmatvec_wgmma(
                A.data_ptr(), Yt.data_ptr(), Z.data_ptr(), part, m, n, k, ld,
                rows, _stream(A))
        else:
            err = _lib().repro_block_rmatvec(
                A.data_ptr(), Y.data_ptr(), Z.data_ptr(), part, m, n, k,
                rows, int(A.dtype == torch.bfloat16), _stream(A))
    _check(err, f"block_rmatvec ({which} route)")
    return Z
