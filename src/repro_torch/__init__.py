"""repro_torch — the PyTorch / CUDA (NVIDIA Hopper) port of ``repro``.

The JAX package ``repro`` is the reference; this package re-implements
it slice by slice with PyTorch around hand-written CUDA kernels, and
never imports JAX or ``repro``.  Ported so far, on a ``torch.Tensor``
resident on one device: the dense block t-SVD (``svd(A, k)``), whose two
A-sized sweeps run on the ``block_matvec``/``block_rmatvec`` kernels of
``csrc/block_matvec_tf32.cu`` (fp32, 3xTF32) and
``csrc/block_matvec_tc.cu`` (bf16), and the rank-one deflation engines
(``method="gramfree"`` on the ``matvec``/``deflate_rmatvec`` kernels of
``csrc/deflate_matvec.cu``, ``method="gram"`` on the ``gram`` kernel of
``csrc/gram_tf32.cu``, 3xTF32).  On the LM side, serving (``repro_torch.models``,
``repro_torch.configs``, ``python -m repro_torch.launch.serve``): a
batched prefill whose attention runs on the ``local_attention`` kernel
of ``csrc/local_attn.cu`` (causal sliding-window attention with GQA and
logit soft-capping), then greedy or sampled decode, for the text
architectures built of attention blocks and a dense MLP (gemma2-9b
among them).  The out-of-core tiers (``svd`` of a numpy array, a
``.npy`` path or a memmap: row blocks streamed host -> device), the
paper's sparse stream (``svd`` of a ``SyntheticSparseMatrix``, a scipy
matrix or a ``.npz``/``.mtx`` path: CSR row blocks packed on the host
and swept on the card by the kernels of ``csrc/csr_sweep.cu``) and
checkpoint/resume (``checkpoint_dir=``, the JAX package's format), and
the paper's N-GPU layout (``svd(A, k, mesh=make_host_mesh())``, run by
every rank of a ``torch.distributed`` world: ``A`` row-sharded, one
``(n, k)`` all-reduce a block step, the deflation engines' faithful and
fused schedules).  The SVD service (``repro_torch.serving``; also
exported here: ``SVDService``, ``JobSpec``, ``JobStatus``, ``JobHandle``)
serves many concurrent ``svd()`` jobs from one process on one device:
priority and byte-budget admission, a micro-batcher for bursts of small
solves, streamed partial results, cancellation, deadlines, per-job
checkpoints and metering.

    import torch, repro_torch
    res = repro_torch.svd(A, 32)                      # A on the card
    res = repro_torch.svd(A, 16, method="gramfree")   # Alg 1 around Alg 4
    res = repro_torch.svd(A, 8, method="gram")        # Alg 1 around Alg 2/3
    res = repro_torch.svd(A, 8, device="cpu")         # plain PyTorch, CPU
    sp = repro_torch.SyntheticSparseMatrix(2**25, 2**25, 33, seed=0)
    res = repro_torch.svd(sp, 8)                      # the sparse stream
    mesh = repro_torch.make_host_mesh()               # under torchrun
    res = repro_torch.svd(A, 32, mesh=mesh)           # row-sharded

    with repro_torch.SVDService(max_workers=2) as svc:  # SVD service
        h = svc.submit(A, 32, stream_every=4)
        res = h.result(timeout=600)

    python -m repro_torch.launch.serve --arch gemma2-9b   # LM serving
    python -m repro_torch.serving --smoke                 # SVD service

Entry points run on the card unless the caller asks for the CPU: with
no ``device`` and no visible CUDA device they raise.
"""
from repro_torch.core import (  # noqa: F401
    DenseOperator,
    DenseStreamOperator,
    DistTSVDResult,
    InputError,
    LinearOperator,
    RowBlockStream,
    ScipySparseMatrix,
    ScipySparseOperator,
    ShardedOperator,
    SolverState,
    SparseStreamOperator,
    SparseTSVDResult,
    SVDConfig,
    SVDError,
    SVDResult,
    dist_tsvd,
    finalize,
    init_state,
    make_host_mesh,
    make_production_mesh,
    power_iterate_chain,
    power_iterate_gram,
    step,
    svd_1d,
    svd,
    svd_update,
    sparse_tsvd,
    SyntheticSparseMatrix,
)
from repro_torch.serving import (  # noqa: F401
    JobHandle,
    JobSpec,
    JobStatus,
    SVDService,
)

__all__ = ["svd", "svd_update", "SVDConfig", "SVDResult", "SolverState",
           "init_state", "step", "finalize", "LinearOperator",
           "DenseOperator", "SVDError", "InputError", "svd_1d",
           "power_iterate_gram", "power_iterate_chain",
           "RowBlockStream", "SyntheticSparseMatrix", "ScipySparseMatrix",
           "SparseStreamOperator", "ScipySparseOperator",
           "DenseStreamOperator", "sparse_tsvd", "SparseTSVDResult",
           "ShardedOperator", "dist_tsvd", "DistTSVDResult",
           "make_host_mesh", "make_production_mesh", "SVDService",
           "JobSpec", "JobStatus", "JobHandle"]
