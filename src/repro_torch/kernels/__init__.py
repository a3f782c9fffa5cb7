"""Hand-written Hopper kernels of the port, with their plain versions.

* ``block_matvec``     — multi-vector ``A @ Q`` sweep (CUDA C++ on the
                         tensor cores: fp32 as 3xTF32,
                         ``csrc/block_matvec_tf32.cu``, bf16,
                         ``csrc/block_matvec_tc.cu``; the operands no TMA
                         tensor map describes by FFMA,
                         ``csrc/block_matvec.cu``)
* ``block_rmatvec``    — multi-vector ``A^T @ Y`` sweep, reduction over
                         the long m axis in ordered slabs (same sources)
* ``block_gram_chain`` — their composition ``A^T (A Q)``
* ``matvec``           — ``A @ v`` (CUDA C++, ``csrc/deflate_matvec.cu``)
* ``deflate_rmatvec``  — the fused Alg-4 reverse sweep
                         ``A^T (Xv - U c)``, ``U^T Xv`` (same source)
* ``gram``             — ``A^T A``, reduced-task schedule (CUDA C++,
                         ``csrc/gram.cu``)
* ``local_attention``  — causal sliding-window attention with GQA and
                         logit soft-capping, the LM prefill's attention
                         (CUDA C++, ``csrc/local_attn.cu``)

``matvec``, ``deflate_rmatvec`` and ``gram`` take ``trans=True`` for the
same function of ``A^T``.

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
    matvec,
    deflate_rmatvec,
    gram,
    matvec_ref,
    deflate_rmatvec_ref,
    gram_ref,
    local_attention,
    local_attention_ref,
    launches,
    route_launches,
    reset_launches,
)
