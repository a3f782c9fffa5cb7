"""Hopper kernels of the LM's two recurrences: RG-LRU's ``h_t = a_t h_{t-1}
+ b_t`` and RWKV-6's matrix-state scan.

Bindings of ``csrc/rglru_scan.cu`` and ``csrc/wkv6.cu`` (CUDA C++ for
``sm_90a``, built by ``kernels/build.py`` at first use and called through
``ctypes``).  They replace no Pallas kernel: the JAX package runs the two
recurrences as ``jax.lax.associative_scan`` and ``jax.lax.scan``
(``repro/models/recurrent.py:65`` and ``:177``), each compiled by XLA into
one program on the device, where PyTorch would run a loop in Python of
a few launches a step.  Each kernel serves any ``T >= 1``, so a prefill
and a decode step (``T = 1``) share its arithmetic.  The sources' headers
say what bounds them on an H100 and what their designs do about it.

These functions take contiguous fp32 CUDA tensors that ``kernels/ops.py``
has already checked; they allocate the outputs with ``torch.empty``,
launch on the current stream, and raise if a launch was refused.  Call
them through ``ops``, which also keeps the launch counts.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: the RWKV-6 head sizes the kernel is instantiated for (csrc: launch<HD>)
WKV_HEAD_DIMS = (16, 32, 64, 128)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong


def _lib(name: str) -> ctypes.CDLL:
    lib = build.library(name)
    if not getattr(lib, "_repro_bound", False):
        if name == "rglru_scan":
            lib.repro_rglru_scan.argtypes = [_P] * 4 + [_I64] * 3 + [_P]
            lib.repro_rglru_scan.restype = ctypes.c_int
        else:
            lib.repro_wkv6.argtypes = [_P] * 8 + [_I64] * 4 + [_P]
            lib.repro_wkv6.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _aligned(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t``, or a copy of it where its first element is not 16-byte
    aligned: the kernels stage their operands by 16-byte copies."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor,
                    h0: torch.Tensor | None) -> torch.Tensor:
    """h (B, T, R) of ``h_t = a_t h_{t-1} + b_t`` on the card; a, b
    (B, T, R) and h0 (B, R) or None, contiguous fp32."""
    B, T, R = a.shape
    a, b = _aligned(a), _aligned(b)
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        err = _lib("rglru_scan").repro_rglru_scan(
            a.data_ptr(), b.data_ptr(), _ptr(h0), h.data_ptr(), B, T, R,
            torch.cuda.current_stream(a.device).cuda_stream)
    _check(err, "rglru_scan")
    return h


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor | None):
    """(out (B, T, H, hd), S_T (B, H, hd, hd)) of RWKV-6's recurrence on
    the card; r, k, v, w (B, T, H, hd), u (H, hd), S0 (B, H, hd, hd) or
    None, contiguous fp32, hd in ``WKV_HEAD_DIMS``."""
    B, T, H, hd = r.shape
    r, k, v, w, S0 = (_aligned(x) for x in (r, k, v, w, S0))
    out = torch.empty_like(r)
    S_T = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        err = _lib("wkv6").repro_wkv6(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), _ptr(S0), out.data_ptr(), S_T.data_ptr(), B, T, H,
            hd, torch.cuda.current_stream(r.device).cuda_stream)
    _check(err, "wkv6")
    return out, S_T
