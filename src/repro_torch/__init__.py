"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
it slice by slice with PyTorch around hand-written CUDA kernels, and
never imports JAX or ``repro``.  Ported so far: the dense block t-SVD
(``svd(A, k)`` on a ``torch.Tensor``), whose two A-sized sweeps run on
the ``block_matvec``/``block_rmatvec`` kernels of ``csrc/block_matvec.cu``.

    import torch, repro_torch
    res = repro_torch.svd(A, 32)                  # A on the card
    res = repro_torch.svd(A, 8, device="cpu")     # plain PyTorch on the CPU

Entry points run on the card unless the caller asks for the CPU: with
no ``device`` and no visible CUDA device they raise.
"""
from repro_torch.core import (  # noqa: F401
    DenseOperator,
    InputError,
    LinearOperator,
    SolverState,
    SVDConfig,
    SVDError,
    SVDResult,
    finalize,
    init_state,
    step,
    svd,
    svd_update,
)

__all__ = ["svd", "svd_update", "SVDConfig", "SVDResult", "SolverState",
           "init_state", "step", "finalize", "LinearOperator",
           "DenseOperator", "SVDError", "InputError"]
