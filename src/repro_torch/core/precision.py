"""Mixed-precision sweep policy for the block subspace iterate (PyTorch port).

ONE knob, as in the JAX package's ``repro/core/precision.py``:

* ``sweep_dtype`` in {``"float32"``, ``"bfloat16"``}: the dtype the
  A-sized *operands* of the two sweeps are cast to.
* accumulation is pinned to fp32: the sweep kernels
  (``kernels/block_matvec.py``) widen bf16 operands and sum in fp32, and
  their plain versions (``kernels/ref.py``) multiply the bf16-rounded
  operands upcast to fp32, so partial sums never round to bf16.
* QR, Rayleigh–Ritz and every factor stay fp32.

``sweep_dtype="float32"`` is the default; its sweeps run on the tensor
cores as 3xTF32 (each operand split into TF32 halves, three products,
fp32 sums) where a TMA tensor map describes ``A``, else on FFMA, never
plain TF32, and in a fixed order, so fp32 stays within 1e-5 of full
fp32 and bit-stable from run to run.  bf16 sweeps pair with a looser
``eps`` (~1e-4).  Pass accounting is dtype-independent; bf16
changes the bytes per pass, never the number of passes.
"""
from __future__ import annotations

import numpy as np
import torch

SWEEP_DTYPES = ("float32", "bfloat16")

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).rsplit(".", 1)[-1]


def resolve_sweep_dtype(sweep_dtype) -> torch.dtype:
    """Validate + canonicalize the policy knob to a torch dtype.

    Accepts the policy strings (preferred), torch dtypes, or numpy dtype
    spellings; the error messages are the JAX package's.
    """
    if isinstance(sweep_dtype, torch.dtype):
        name = dtype_name(sweep_dtype)
    elif isinstance(sweep_dtype, str) and sweep_dtype in SWEEP_DTYPES:
        name = sweep_dtype
    else:
        try:
            name = np.dtype(sweep_dtype).name
        except TypeError as e:
            raise ValueError(f"unsupported sweep_dtype {sweep_dtype!r}; "
                             f"expected one of {SWEEP_DTYPES}") from e
    if name not in SWEEP_DTYPES:
        raise ValueError(
            f"unsupported sweep_dtype {sweep_dtype!r}; expected one of "
            f"{SWEEP_DTYPES} (accumulation is always float32)")
    return _TORCH_DTYPES[name]
