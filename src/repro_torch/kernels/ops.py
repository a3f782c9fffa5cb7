"""Public wrappers of the block-sweep kernels.

``block_matvec`` (``A @ Q``), ``block_rmatvec`` (``A^T @ Y``) and their
composition ``block_gram_chain`` (``A^T (A Q)``) check their operands,
then:

* for tensors on the CPU, run the plain PyTorch version
  (``kernels/ref.py``) — the caller asked for the CPU;
* for CUDA tensors, launch the Hopper kernel (``kernels/block_matvec.py``)
  or raise.  There is no fallback from the card to anything else.

``dtype`` is the sweep dtype of the precision policy (``None`` = A's own
dtype): both operands are cast to it and the sums are fp32, so the
output is always fp32.  A caller that sweeps many times casts ``A``
once itself (``DenseOperator`` does), which makes the cast here a no-op.

``launches`` counts, per kernel, the launches these wrappers made on the
card; the CPU path never touches it.  ``block_rmatvec`` counts one per
call, although a split reduction is a second (summing) launch.

The JAX package's TPU-only wrapper logic has no counterpart here: the
kernels mask ragged edges themselves, so there is no lane padding of k,
no tile padding of ``A`` (a padded copy of a 32 GiB ``A`` would not fit
beside it) and no interpret mode.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.kernels import block_matvec as _bm
from repro_torch.kernels import ref as _ref

#: launches made on the card since the last ``reset_launches()``
launches = {"block_matvec": 0, "block_rmatvec": 0, "block_gram_chain": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _sweep_dtype(A, X, dtype, what: str) -> torch.dtype:
    """Check the operands; the dtype both are read in."""
    if not isinstance(A, torch.Tensor) or not isinstance(X, torch.Tensor):
        raise TypeError(f"{what} takes torch tensors, got "
                        f"{type(A).__name__} and {type(X).__name__}")
    if A.ndim != 2 or X.ndim != 2:
        raise ValueError(f"{what} takes 2-D operands, got shapes "
                         f"{tuple(A.shape)} and {tuple(X.shape)}")
    if A.device != X.device:
        raise ValueError(f"{what}: operands on different devices "
                         f"({A.device} and {X.device})")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cpu' (plain PyTorch) or 'cuda' "
                         f"(the Hopper kernel), got {A.device}")
    sd = A.dtype if dtype is None else resolve_sweep_dtype(dtype)
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} reads float32 or bfloat16 operands, "
                         f"got {sd}")
    return sd


def _on_card(A: torch.Tensor, X: torch.Tensor, sd: torch.dtype):
    """Operands as the kernel reads them: contiguous, in ``sd``.  A
    non-contiguous ``A`` is refused rather than copied."""
    if not A.is_contiguous():
        raise ValueError("the CUDA sweep kernels read A row-major: pass a "
                         "contiguous A (for A^T use the other sweep)")
    return A.to(sd), X.to(sd).contiguous()


def block_matvec(A: torch.Tensor, Q: torch.Tensor, *,
                 dtype=None) -> torch.Tensor:
    """``A @ Q``; A (m, n), Q (n, k) -> (m, k) fp32."""
    sd = _sweep_dtype(A, Q, dtype, "block_matvec")
    if Q.shape[0] != A.shape[1]:
        raise ValueError(f"block_matvec: A {tuple(A.shape)} @ Q "
                         f"{tuple(Q.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.block_matvec_ref(A, Q, sd)
    if A.numel() == 0 or Q.shape[1] == 0:
        return torch.zeros((A.shape[0], Q.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Q = _on_card(A, Q, sd)
    Y = _bm.block_matvec_cuda(A, Q)
    launches["block_matvec"] += 1
    return Y


def block_rmatvec(A: torch.Tensor, Y: torch.Tensor, *,
                  dtype=None) -> torch.Tensor:
    """``A^T @ Y``; A (m, n), Y (m, k) -> (n, k) fp32."""
    sd = _sweep_dtype(A, Y, dtype, "block_rmatvec")
    if Y.shape[0] != A.shape[0]:
        raise ValueError(f"block_rmatvec: A^T {tuple(A.shape)} @ Y "
                         f"{tuple(Y.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.block_rmatvec_ref(A, Y, sd)
    if A.numel() == 0 or Y.shape[1] == 0:
        return torch.zeros((A.shape[1], Y.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Y = _on_card(A, Y, sd)
    Z = _bm.block_rmatvec_cuda(A, Y)
    launches["block_rmatvec"] += 1
    return Z


def block_gram_chain(A: torch.Tensor, X: torch.Tensor, *, dtype=None,
                     trans: bool = False) -> torch.Tensor:
    """``A^T (A X)`` — one block power sweep — or, with ``trans=True``,
    the chain of the transposed operand ``A (A^T X)`` without ever
    forming ``A^T``.  ``A`` is cast once; the fp32 intermediate is
    rounded to the sweep dtype by the second sweep's operand cast, as in
    the JAX package's ``block_gram_chain``."""
    sd = _sweep_dtype(A, X, dtype, "block_gram_chain")
    A = A.to(sd)                          # cast once, both sweeps reuse
    if trans:
        Z = block_matvec(A, block_rmatvec(A, X, dtype=sd), dtype=sd)
    else:
        Z = block_rmatvec(A, block_matvec(A, X, dtype=sd), dtype=sd)
    if A.device.type == "cuda":
        launches["block_gram_chain"] += 1
    return Z


block_matvec_ref = _ref.block_matvec_ref
block_rmatvec_ref = _ref.block_rmatvec_ref
block_gram_chain_ref = _ref.block_gram_chain_ref
