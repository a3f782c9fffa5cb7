"""Hand-written Hopper kernels of the port, with their plain versions.

* ``block_matvec``     — multi-vector ``A @ Q`` sweep (CUDA C++,
                         ``csrc/block_matvec.cu``)
* ``block_rmatvec``    — multi-vector ``A^T @ Y`` sweep, reduction over
                         the long m axis in ordered slabs (same source)
* ``block_gram_chain`` — their composition ``A^T (A Q)``

Each kernel has a plain PyTorch version in ``ref.py``; ``ops.py`` holds
the public wrappers (CPU tensors -> plain version, CUDA tensors -> the
kernel) and the launch counts.  ``build.py`` compiles ``csrc/`` at first
use.
"""
from repro_torch.kernels.ops import (  # noqa: F401
    block_matvec,
    block_rmatvec,
    block_gram_chain,
    block_matvec_ref,
    block_rmatvec_ref,
    block_gram_chain_ref,
    launches,
    reset_launches,
)
