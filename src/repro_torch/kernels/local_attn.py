"""Hopper kernels of causal sliding-window attention (LM prefill and
training) and of its gradient.

Binding of ``csrc/local_attn.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  It
replaces the Pallas TPU kernel of the JAX package's
``repro/kernels/local_attn.py``: ``local_attention`` (``pallas_call`` at
line 104): causal attention over the keys ``q - window < kv <= q``, GQA
by head index (``h -> h // (H // Hkv)``), optional logit soft-capping,
online softmax in fp32.  The source's header says what bounds it on an
H100 and what each design does about it.

Two routes, one C entry point each, chosen here by ``route(dtype, D)``:

* ``"wgmma"``: bf16 at a head dim in ``WGMMA_HEAD_DIMS`` (those of the
  configured models).  128 query rows a block as two warpgroups of 64,
  scores and P·V on the bf16 tensor cores (``wgmma``) with fp32 sums and
  the fp32 probabilities split into two bf16 terms, K/V tiles of 64 keys
  staged by TMA into a two-stage ring by a producer warpgroup.  TMA reads
  the operands through tensor maps, so every stride along B, H and S of a
  dimension longer than 1 must be nonzero (``tma_describable``).
* ``"ffma"``: fp32 at every head dim of ``HEAD_DIMS``, and bf16 at the
  small ones: 64 query rows a block, fp32 tiles in shared memory, FFMA.

A launch that the card refuses raises; neither route stands in for the
other.  ``local_attention_cuda`` takes CUDA tensors that
``kernels/ops.py`` has already checked, in the layout ``(B, H, S, D)``
with any strides along ``B``, ``H`` and ``S`` that ``readable`` accepts
(unit stride along ``D``, 16-byte alignment).  It allocates the output
with ``torch.empty`` in the memory order ``(B, S, H, D)`` and returns it
as a ``(B, H, S, D)`` view, so the model's next product reads
``(B, S, H * D)`` without a copy; it launches on the current stream.
Call it through ``ops``, which keeps the launch counts.

The gradient (training) is ``csrc/local_attn_bwd.cu``, its own library,
bound by ``local_attention_bwd_cuda``: three kernels in order (the rows'
``sum(dO * O)``, then dK and dV by key tile, then dQ by query tile),
reading the forward's log-sum-exp of each row
(``local_attention_cuda(..., lse=)``), on one of two routes that
``bwd_route(dtype, D)`` picks, one C entry point each:

* ``"wgmma"``: bf16 at a head dim in ``WGMMA_HEAD_DIMS``.  The
  scores and ``dO V^T`` again on the tensor cores (both operands in
  shared memory), the products with P and dS with those in registers,
  each split into two bf16 terms; K/V (dK/dV pass) or Q/dO (dQ pass)
  held, the other pair streamed by TMA through a two-stage ring.  TMA
  reads q, k, v and dO through tensor maps: ``ops`` copies a ``do``
  (or ``o``) that ``tma_describable`` refuses (``bwd_reads_in_place``).
* ``"ffma"``: fp32 at every head dim, and bf16 at the small ones: fp32
  tiles in shared memory, FFMA.

The JAX package has no kernel for it: it differentiates its jnp
attention.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)   # every head dim a route takes
WGMMA_HEAD_DIMS = (64, 128, 256)     # bf16 on the tensor cores (csrc: tc)
BK = 64                              # keys per tile, both routes (csrc)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_STRIDES = _I64 * 12


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that takes (dtype, D): ``"wgmma"`` or ``"ffma"``."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "ffma")


def bwd_route(dtype: torch.dtype, D: int) -> str:
    """The backward kernels that take (dtype, D): ``"wgmma"`` or
    ``"ffma"``, split as the forward's (bf16 at ``WGMMA_HEAD_DIMS`` on the
    tensor cores; D = 256 too: its instances spill nothing)."""
    return ("wgmma" if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS
            else "ffma")


def _lib() -> ctypes.CDLL:
    lib = build.library("local_attn")
    if not getattr(lib, "_repro_bound", False):
        common = [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _STRIDES,
                  _I64, ctypes.c_float, ctypes.c_float, _P]
        lib.repro_local_attention.argtypes = common + [ctypes.c_int, _P]
        lib.repro_local_attention_wgmma.argtypes = common + [_P]
        lib.repro_local_attention_smem.argtypes = [ctypes.c_int, _I64]
        for fn in (lib.repro_local_attention,
                   lib.repro_local_attention_wgmma):
            fn.restype = ctypes.c_int
        lib.repro_local_attention_smem.restype = _I64
        lib._repro_bound = True
    return lib


def smem_bytes(route_name: str, D: int) -> int:
    """Dynamic shared memory of one block of a route's instance."""
    return int(_lib().repro_local_attention_smem(int(route_name == "wgmma"),
                                                 D))


def readable(t: torch.Tensor) -> bool:
    """Whether the kernels' 16-byte loads read ``t`` in place: unit
    stride along D, every other stride and the base 16-byte aligned.
    The model's views always are."""
    per16 = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:3]))


def tma_describable(t: torch.Tensor) -> bool:
    """Whether a TMA tensor map describes ``t`` (on top of ``readable``):
    no zero stride along a dimension longer than 1 (a broadcast view)."""
    return all(s > 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def local_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, softcap: float | None,
                         lse: torch.Tensor | None = None) -> torch.Tensor:
    """Attention on the card; q (B, H, S, D), k/v (B, Hkv, S, D), one
    dtype (fp32 or bf16), D in ``HEAD_DIMS`` -> (B, H, S, D) in q's
    dtype, by the kernel of ``route(q.dtype, D)``.  ``lse``, a contiguous
    (B, H, S) fp32 tensor, receives each row's log-sum-exp of its logits
    (what the backward needs); prefill passes none."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device
                    ).transpose(1, 2)
    strides = _STRIDES(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            Hkv, S, D, strides, window, 1.0 / math.sqrt(D),
            float(softcap or 0.0), None if lse is None else lse.data_ptr())
    which = route(q.dtype, D)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            err = _lib().repro_local_attention_wgmma(*args, stream)
        else:
            err = _lib().repro_local_attention(
                *args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"local_attention kernel launch failed ({which} "
                           f"route): CUDA error {err}")
    return o


#: kernels one backward launches on either route: Dlt = rowsum(dO * O),
#: dK/dV, dQ
BWD_KERNELS = 3


def bwd_reads_in_place(route_name: str, t: torch.Tensor) -> bool:
    """Whether the backward on ``route_name`` reads ``o`` or ``do`` as
    they are (else ``ops`` passes a contiguous copy): ``readable``, and on
    ``"wgmma"`` also ``tma_describable`` (dO goes through a tensor map;
    a broadcast gradient does not)."""
    return readable(t) and (route_name != "wgmma" or tma_describable(t))


def _bwd_lib() -> ctypes.CDLL:
    lib = build.library("local_attn_bwd")
    if not getattr(lib, "_repro_bound", False):
        common = [_P] * 10 + [_I64] * 5 + [_I64 * 24, _I64, ctypes.c_float,
                                            ctypes.c_float]
        lib.repro_local_attention_bwd.argtypes = common + [ctypes.c_int, _P]
        lib.repro_local_attention_bwd_wgmma.argtypes = common + [_P]
        for fn in (lib.repro_local_attention_bwd,
                   lib.repro_local_attention_bwd_wgmma):
            fn.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def bwd_call(q, k, v, o, do, lse, window: int, softcap: float | None):
    """The outputs (dq, dk, dv), each allocated in the memory order (B, S,
    heads, D) and seen as a (B, heads, S, D) view, the arguments both C
    entry points share (their route's own follow), and the fp32 buffer
    they point into for Dlt, to be kept until the launch is queued."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]

    def out(heads):
        return torch.empty((B, S, heads, D), dtype=q.dtype,
                           device=q.device).transpose(1, 2)
    dq, dk, dv = out(H), out(Hkv), out(Hkv)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (_I64 * 24)(*(s for t in (q, k, v, o, do, dq, dk, dv)
                            for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, Hkv, S, D, strides, window,
            1.0 / math.sqrt(D), float(softcap or 0.0))
    return (dq, dk, dv), args, delta


def local_attention_bwd_cuda(q, k, v, o, do, lse, window: int,
                             softcap: float | None):
    """The gradient on the card (``csrc/local_attn_bwd.cu``) by the kernels
    of ``bwd_route(q.dtype, D)``: (dq, dk, dv) in q's dtype, each
    allocated in the memory order (B, S, heads, D) and returned as a (B,
    heads, S, D) view, like the forward's output.  ``lse`` is the
    forward's (B, H, S) fp32 log-sum-exp, contiguous; ``o`` and ``do``
    are as ``bwd_reads_in_place`` takes them, q, k and v as the forward
    on the same route does."""
    grads, args, delta = bwd_call(q, k, v, o, do, lse, window, softcap)
    which = bwd_route(q.dtype, q.shape[3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            err = _bwd_lib().repro_local_attention_bwd_wgmma(*args, stream)
        else:
            err = _bwd_lib().repro_local_attention_bwd(
                *args, int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"local_attention backward kernel launch failed "
                           f"({which} route): CUDA error {err}")
    return grads
