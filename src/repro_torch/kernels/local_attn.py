"""Hopper kernel of causal sliding-window attention (LM prefill).

Binding of ``csrc/local_attn.cu`` (CUDA C++ for ``sm_90a``, built by
``kernels/build.py`` at first use and called through ``ctypes``).  It
replaces the Pallas TPU kernel of the JAX package's
``repro/kernels/local_attn.py``: ``local_attention`` (``pallas_call`` at
line 104): causal attention over the keys ``q - window < kv <= q``, GQA
by head index (``h -> h // (H // Hkv)``), optional logit soft-capping,
online softmax in fp32.  The source's header says what bounds it on an
H100 and what the design does about it.

``local_attention_cuda`` takes CUDA tensors that ``kernels/ops.py`` has
already checked, in the layout ``(B, H, S, D)`` with any strides along
``B``, ``H`` and ``S`` that ``readable`` accepts (unit stride along
``D``, 16-byte alignment).  It allocates the
output with ``torch.empty`` in the memory order ``(B, S, H, D)`` and
returns it as a ``(B, H, S, D)`` view, so the model's next product reads
``(B, S, H * D)`` without a copy; it launches on the current stream and
raises if the launch was refused.  Call it through ``ops``, which keeps
the launch counts.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128, 256)   # template instances (csrc: dispatch)
BQ = BK = 64                         # query rows / keys per tile (csrc)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_STRIDES = _I64 * 12


def _lib() -> ctypes.CDLL:
    lib = build.library("local_attn")
    if not getattr(lib, "_repro_bound", False):
        lib.repro_local_attention.argtypes = [
            _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _STRIDES, _I64,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, _P]
        lib.repro_local_attention.restype = ctypes.c_int
        lib._repro_bound = True
    return lib


def readable(t: torch.Tensor) -> bool:
    """Whether the kernel's 16-byte loads read ``t`` in place: unit
    stride along D, every other stride and the base 16-byte aligned.
    The model's views always are."""
    per16 = 16 // t.element_size()
    return (t.stride(3) == 1 and t.data_ptr() % 16 == 0
            and all(s % per16 == 0 for s in t.stride()[:3]))


def local_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window: int, softcap: float | None) -> torch.Tensor:
    """Attention on the card; q (B, H, S, D), k/v (B, Hkv, S, D), one
    dtype (fp32 or bf16), D in ``HEAD_DIMS`` -> (B, H, S, D) in q's
    dtype."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device
                    ).transpose(1, 2)
    strides = _STRIDES(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib().repro_local_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H,
            Hkv, S, D, strides, window, 1.0 / math.sqrt(D),
            float(softcap or 0.0), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"local_attention kernel launch failed: CUDA error {err}")
    return o
