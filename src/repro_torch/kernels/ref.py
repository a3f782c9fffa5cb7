"""Plain PyTorch versions of the block-sweep kernels.

The counterparts of the JAX package's ``repro/kernels/ref.py`` oracles
for the kernels this port has.  They are what ``kernels/ops.py`` runs
for tensors the caller put on the CPU, and what the CUDA kernels are
held against on the card.

``dtype`` is the sweep dtype of the precision policy: operands are
rounded to it and the contraction accumulates in fp32.  ``torch.matmul``
of two bf16 tensors would return bf16, so the bf16-rounded operands are
upcast to fp32 before the product (exact: a product of two bf16 values
fits in fp32), which is the JAX package's
``preferred_element_type=float32``.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import resolve_sweep_dtype


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    sd = torch.float32 if dtype is None else resolve_sweep_dtype(dtype)
    return x.to(sd).to(torch.float32)


def block_matvec_ref(A: torch.Tensor, Q: torch.Tensor,
                     dtype=None) -> torch.Tensor:
    """``Y = A @ Q`` (multi-vector forward sweep); fp32 accumulation."""
    return _rounded(A, dtype) @ _rounded(Q, dtype)


def block_rmatvec_ref(A: torch.Tensor, Y: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """``Z = A^T @ Y`` (multi-vector reverse sweep); fp32 accumulation."""
    return _rounded(A, dtype).mT @ _rounded(Y, dtype)


def block_gram_chain_ref(A: torch.Tensor, Q: torch.Tensor, dtype=None,
                         trans: bool = False) -> torch.Tensor:
    """``Z = A^T (A Q)`` (block power / range-finder sweep), or with
    ``trans=True`` the chain of the transposed operand, ``A (A^T Q)``.

    The fp32-accumulated intermediate is rounded back to the sweep dtype
    for the second sweep, as the JAX package's chain does.
    """
    if trans:
        return block_matvec_ref(A, block_rmatvec_ref(A, Q, dtype), dtype)
    return block_rmatvec_ref(A, block_matvec_ref(A, Q, dtype), dtype)
