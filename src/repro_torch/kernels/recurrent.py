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

The gradients (training) are second kernels of the same sources:
``rglru_scan_bwd_cuda`` (the reverse scan, from the forward's a and h)
and ``wkv6_bwd_cuda`` (from the chunk starts of the state that
``wkv6_cuda(..., states=True)`` also writes, one store a chunk; the
states between them are recomputed in the forward's rounding).

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

#: each C function's arguments (the csrc headers' "C interface")
_ARGTYPES = {
    "repro_rglru_scan": [_P] * 4 + [_I64] * 3 + [_P],
    "repro_rglru_scan_bwd": [_P] * 7 + [_I64] * 3 + [_P],
    "repro_wkv6": [_P] * 8 + [_I64] * 4 + [_P],
    "repro_wkv6_states": [_P] * 9 + [_I64] * 4 + [_P],
    "repro_wkv6_bwd": [_P] * 14 + [_I64] * 4 + [_P],
    "repro_wkv6_chunk": [_I64],
    "repro_wkv6_bwd_parts": [_I64],
    "repro_wkv6_bwd_sub": [_I64],
    "repro_wkv6_bwd_blocks_per_sm": [_I64],
}


def _fn(lib: str, name: str):
    """C function ``name`` of ``csrc/<lib>.cu``'s build, bound at its
    first call."""
    fn = getattr(build.library(lib), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def wkv_chunk(hd: int) -> int:
    """Steps a chunk of the ``wkv6`` forward at head size ``hd`` (csrc:
    Tile<HD>::C), read from the build: where autograd records, the
    forward writes the state at each chunk's start."""
    return _fn("wkv6", "repro_wkv6_chunk")(hd)


def wkv_bwd_parts(hd: int) -> int:
    """Partials of dr, dk and dw the ``wkv6`` backward writes at head
    size ``hd``, one a block's value columns (csrc: HD / BPlan<HD>::JB:
    1 up to hd 64, 2 at hd 128), read from the build."""
    return _fn("wkv6", "repro_wkv6_bwd_parts")(hd)


def wkv_bwd_sub(hd: int) -> int:
    """Steps a sub-chunk of the ``wkv6`` backward at head size ``hd``
    (csrc: BPlan<HD>::U), read from the build: the states of one
    sub-chunk are recomputed into registers and walked back at a time."""
    return _fn("wkv6", "repro_wkv6_bwd_sub")(hd)


def wkv_bwd_blocks_per_sm(hd: int) -> int:
    """Blocks of the ``wkv6`` backward one SM of the current device holds
    at once at head size ``hd`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    on the build's kernel; negative: a CUDA error)."""
    return _fn("wkv6", "repro_wkv6_bwd_blocks_per_sm")(hd)


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
        err = _fn("rglru_scan", "repro_rglru_scan")(
            a.data_ptr(), b.data_ptr(), _ptr(h0), h.data_ptr(), B, T, R,
            torch.cuda.current_stream(a.device).cuda_stream)
    _check(err, "rglru_scan")
    return h


def rglru_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor,
                        h0: torch.Tensor | None, g: torch.Tensor):
    """(da, db (B, T, R), dh0 (B, R) or None) of ``rglru_scan`` on the
    card, from a and the forward's h (B, T, R), h0 (B, R) or None and
    g = dL/dh (B, T, R), contiguous fp32."""
    B, T, R = a.shape
    g, a, h = _aligned(g), _aligned(a), _aligned(h)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    with torch.cuda.device(a.device):
        err = _fn("rglru_scan", "repro_rglru_scan_bwd")(
            g.data_ptr(), a.data_ptr(), h.data_ptr(), _ptr(h0),
            da.data_ptr(), db.data_ptr(), _ptr(dh0), B, T, R,
            torch.cuda.current_stream(a.device).cuda_stream)
    _check(err, "rglru_scan_bwd")
    return da, db, dh0


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor | None,
              states: bool = False):
    """(out (B, T, H, hd), S_T (B, H, hd, hd)) of RWKV-6's recurrence on
    the card; r, k, v, w (B, T, H, hd), u (H, hd), S0 (B, H, hd, hd) or
    None, contiguous fp32, hd in ``WKV_HEAD_DIMS``.  With ``states`` also
    the state at each chunk's start, (B, H, ceil(T / C), hd, hd) with C
    ``wkv_chunk(hd)``: what ``wkv6_bwd_cuda`` starts from."""
    B, T, H, hd = r.shape
    r, k, v, w, S0 = (_aligned(x) for x in (r, k, v, w, S0))
    out = torch.empty_like(r)
    S_T = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        head = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), _ptr(S0), out.data_ptr(), S_T.data_ptr())
        if not states:
            err = _fn("wkv6", "repro_wkv6")(*head, B, T, H, hd, stream)
        else:
            Sc = torch.empty((B, H, -(-T // wkv_chunk(hd)), hd, hd),
                             dtype=torch.float32, device=r.device)
            err = _fn("wkv6", "repro_wkv6_states")(
                *head, Sc.data_ptr(), B, T, H, hd, stream)
    _check(err, "wkv6")
    return (out, S_T, Sc) if states else (out, S_T)


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, Sc: torch.Tensor,
                  dout: torch.Tensor, dS_T: torch.Tensor | None):
    """(dr, dk, dv, dw (B, T, H, hd), du (H, hd), dS0 (B, H, hd, hd)) of
    ``wkv6`` on the card, from its operands, the chunk starts ``Sc`` of
    ``wkv6_cuda(..., states=True)``, dout (B, T, H, hd) and dS_T or None
    (zeros), contiguous fp32.  The kernel writes dr, dk, dw as one partial
    block's value columns (``wkv_bwd_parts``) and du as one a batch row;
    they are summed here by ``torch.sum``, in a fixed order."""
    B, T, H, hd = r.shape
    r, k, v, w, dout, dS_T = (_aligned(x)
                              for x in (r, k, v, w, dout, dS_T))
    parts = wkv_bwd_parts(hd)
    dev = r.device
    dr, dk, dw = (torch.empty((parts, B, T, H, hd), dtype=torch.float32,
                              device=dev) for _ in range(3))
    dv = torch.empty_like(r)
    du = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    dS0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _fn("wkv6", "repro_wkv6_bwd")(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), Sc.data_ptr(), dout.data_ptr(), _ptr(dS_T),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), dS0.data_ptr(), B, T, H, hd,
            torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "wkv6_bwd")
    dr, dk, dw = (x[0] if parts == 1 else x.sum(0) for x in (dr, dk, dw))
    return dr, dk, dv, dw, du.sum(0), dS0
