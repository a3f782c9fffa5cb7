"""The analyzer's target registry: the solver's OWN step functions.

One ``StepTarget`` per (backend x config) cell — the functions
``core/svd.py`` actually runs, called at small shapes: the block step IS
the driver's ``core/svd.py::step`` under ``force_iters=True`` (the path
that syncs nothing by design) on a real operator, beside each operator's
``range_sketch`` and ``extract``.  Because the targets ARE the driver's
functions, not copies, a schedule regression in the solver fails the
analyzer by construction.

Alongside the traces, ``AccountingGroup``s pin the measured A-traffic to
the runtime accounting: each group names the step traces whose bytes of
A, summed (x ``replicas`` shards), must equal ``chain_passes *
bytes_per_pass`` (or ``sketch_passes * ...``) of the operator built at
the same shapes.  The group names are the JAX package's
(``repro/analysis/targets.py``); its sparse groups compared metadata
(``nnz * itemsize``), here the sparse streams' sweeps are run and their
bytes counted by the CSR kernels' own tally.

=============  ==========================================================
dense          block step + sketch + extract, fp32/bf16
sharded        block step fp32/bf16 (twin-paired: identical collective
               bytes), sketch, extract, deflation faithful (3
               all-reduces) vs fused (1 of (n + k,)); in a child process
               on a world-1 group (``analysis/sharded.py``)
hostblocked    per-block fused chain steps fp32/bf16 (staged bytes),
               sketch step
memmap         the SAME inherited per-block steps over a real
               ``MemmapMatrix`` on a temp ``.npy``
sparsestream   block step fp32/bf16 + extract over a synthetic stream
scipysparse    block step over a real scipy CSR
kernels        ``ops.block_gram_chain`` under bf16 operands
=============  ==========================================================
"""
from __future__ import annotations

import dataclasses

from repro_torch.analysis.trace_check import StepContract

# Small trace shapes (the JAX package's): M divides the 3-block staging
# plan.
M, N, K = 384, 160, 8
L = K + 8                 # oversampled sketch width (k + default oversample)
N_BLOCKS = 3
SWEEP_DTYPES = (("float32", 4), ("bfloat16", 2))


@dataclasses.dataclass
class StepTarget:
    tag: str                      # "sharded/block/bfloat16"
    fn: object                    # the step, called as fn(*args)
    args: tuple = ()
    contract: StepContract | None = None
    group: str | None = None      # AccountingGroup name
    staged: object = None         # staged mode: () -> bytes handed the step
    note: str = ""


@dataclasses.dataclass
class AccountingGroup:
    name: str                     # "dense/chain/float32"
    mode: str                     # "sweeps" | "staged"
    expected_bytes: int           # passes * bytes_per_pass (live operator)
    source: str                   # where expected_bytes came from
    replicas: int = 1             # sharded: per-shard trace x n shards


def _matrix(device, m=M, n=N, seed=0):
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn((m, n), generator=g).to(device)


def _acct(name, op, passes_attr, mode="sweeps", replicas=1):
    passes = getattr(op, passes_attr)
    return AccountingGroup(
        name, mode, passes * op.bytes_per_pass,
        f"{type(op).__name__}.{passes_attr}({passes}) * "
        f"bytes_per_pass({op.bytes_per_pass})", replicas)


def _block_step(op, sd):
    """The driver's own step on ``op`` (``force_iters``) from a cold
    start, as ``(fn, args)``."""
    from repro_torch.core.config import SVDConfig
    from repro_torch.core.svd import init_state, step
    cfg = SVDConfig(force_iters=True, sweep_dtype=sd, max_iters=1)
    return step, (op, init_state(op, K, cfg), cfg)


def _dense_targets(device):
    from repro_torch.core.operator import DenseOperator

    targets, groups = [], []
    A = _matrix(device)
    for sd, _ in SWEEP_DTYPES:
        op = DenseOperator(A, device=device, sweep_dtype=sd)
        groups.append(_acct(f"dense/chain/{sd}", op, "chain_passes"))
        fn, args = _block_step(op, sd)
        targets.append(StepTarget(
            f"dense/block/{sd}", fn, args,
            StepContract(requires_bf16=(sd == "bfloat16")),
            group=f"dense/chain/{sd}"))
    op32 = DenseOperator(A, device=device)
    groups.append(_acct("dense/sketch/float32", op32, "sketch_passes"))
    targets.append(StepTarget(
        "dense/sketch/warm", op32.range_sketch, (L, 0),
        StepContract(), group="dense/sketch/float32"))
    Q = op32.orth(op32.random_block(K, 0))
    targets.append(StepTarget(
        "dense/extract", op32.extract, (Q,), StepContract(),
        note="fp32 Rayleigh-Ritz extraction pass"))
    return targets, groups, [], []


def _hostblocked_targets(device):
    import torch
    from repro_torch.core.oom import (HostBlockedMatrix,
                                      hostblock_chain_step,
                                      hostblock_sketch_step)
    from repro_torch.core.operator import HostBlockedOperator

    targets, groups = [], []
    A = _matrix("cpu").numpy()
    Q = torch.linalg.qr(_matrix(device, N, K, 1)).Q
    for sd, _ in SWEEP_DTYPES:
        host = HostBlockedMatrix(A, N_BLOCKS, stage_dtype=sd, device=device)
        op = HostBlockedOperator(host)
        groups.append(_acct(f"hostblocked/chain/{sd}", op, "chain_passes",
                            mode="staged"))
        for b in range(host.n_blocks):
            fn, staged = _staged_step(host, b, hostblock_chain_step, Q)
            targets.append(StepTarget(
                f"hostblocked/chain/{sd}/block{b}", fn, (),
                StepContract(requires_bf16=(sd == "bfloat16")),
                group=f"hostblocked/chain/{sd}", staged=staged))
    host = HostBlockedMatrix(A, N_BLOCKS, device=device)
    lo, hi = host.plan.bounds(0)
    om = torch.randn((hi - lo, L), generator=torch.Generator().manual_seed(
        2)).to(device)
    fn, _ = _staged_step(host, 0, hostblock_sketch_step, om, width=L)
    targets.append(StepTarget(
        "hostblocked/sketch/step", fn, (), StepContract(),
        note="one block of the streamed range sketch (Omega on the fly)"))
    return targets, groups, [], []


def _staged_step(host, b, step, X, width=None):
    """``step(acc, host.block(b), X)`` as a target function — the block
    is fetched (its H2D hop) inside the step, as the streamed sweeps
    fetch it — and a reading of the bytes of the block it was handed."""
    import torch
    box = {}

    def fn():
        blk = host.block(b)
        box["staged"] = blk.numel() * blk.element_size()
        acc = torch.zeros((host.n, width or X.shape[1]), dtype=torch.float32,
                          device=host.device)
        return step(acc, blk, X)

    return fn, lambda: box["staged"]


def _memmap_targets(device):
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core.diskio import MemmapMatrix
    from repro_torch.core.oom import hostblock_chain_step
    from repro_torch.core.operator import MemmapOperator

    # A real (tiny, temporary) .npy, so the group pins the ACTUAL
    # MemmapMatrix/MemmapOperator byte arithmetic; the device-side step
    # is inherited from HostBlockedMatrix.
    tmp = tempfile.mkdtemp(prefix="repro_torch_analysis_")
    path = os.path.join(tmp, "a.npy")
    np.save(path, _matrix("cpu").numpy())
    host = MemmapMatrix(path, N_BLOCKS, stage_dtype="bfloat16", device=device)
    op = MemmapOperator(host)
    groups = [_acct("memmap/chain/bfloat16", op, "chain_passes",
                    mode="staged")]
    Q = torch.linalg.qr(_matrix(device, N, K, 1)).Q
    targets = []
    for b in range(host.n_blocks):
        fn, staged = _staged_step(host, b, hostblock_chain_step, Q)
        targets.append(StepTarget(
            f"memmap/chain/bfloat16/block{b}", fn, (),
            StepContract(requires_bf16=True),
            group="memmap/chain/bfloat16", staged=staged,
            note="inherited HostBlockedMatrix step; disk->host staging "
                 "is host-side (covered by the lint pass)"))

    def cleanup():
        host.close()
        shutil.rmtree(tmp, ignore_errors=True)

    return targets, groups, [], [cleanup]


def _sparse_targets(device):
    import numpy as np
    import scipy.sparse

    from repro_torch.core.operator import SparseStreamOperator
    from repro_torch.core.sparse import (ScipySparseMatrix,
                                         ScipySparseOperator,
                                         SyntheticSparseMatrix)

    targets, groups = [], []
    syn = SyntheticSparseMatrix(M, N, 4, seed=0)
    for sd, _ in SWEEP_DTYPES:
        op = SparseStreamOperator(syn, block_rows=M // N_BLOCKS,
                                  sweep_dtype=sd, device=device)
        groups.append(_acct(f"sparsestream/meta/{sd}", op, "chain_passes"))
        fn, args = _block_step(op, sd)
        targets.append(StepTarget(
            f"sparsestream/block/{sd}", fn, args,
            StepContract(requires_bf16=(sd == "bfloat16")),
            group=f"sparsestream/meta/{sd}",
            note="nnz * itemsize of the values, by the CSR sweeps' tally"))
    op = SparseStreamOperator(syn, block_rows=M // N_BLOCKS, device=device)
    Q = op.orth(op.random_block(K, 0))
    targets.append(StepTarget(
        "sparsestream/extract", op.extract, (Q,),
        StepContract(), note="fp32 Rayleigh-Ritz from the streamed A Q"))

    sp = scipy.sparse.random(M, N, density=0.05, format="csr",
                             random_state=0, dtype=np.float32)
    sop = ScipySparseOperator(ScipySparseMatrix(sp, seed=0),
                              block_rows=M // N_BLOCKS, device=device)
    groups.append(_acct("scipysparse/meta/float32", sop, "chain_passes"))
    fn, args = _block_step(sop, "float32")
    targets.append(StepTarget(
        "scipysparse/block/float32", fn, args, StepContract(),
        group="scipysparse/meta/float32"))
    return targets, groups, [], []


def _kernel_targets(device):
    import torch
    from repro_torch.kernels import ops

    A = _matrix(device).to(torch.bfloat16)
    Q = _matrix(device, N, K, 1).to(torch.bfloat16)
    return [StepTarget(
        "kernels/block_gram_chain/bfloat16", ops.block_gram_chain,
        (A, Q), StepContract(requires_bf16=True),
        note="A^T (A Q) on bf16 operands: fp32 sums, bf16 reads")], \
        [], [], []


def sharded_targets(device, group, mesh):
    """The sharded backend's targets on ``mesh`` (whose axes' group is
    ``group``): run by ``analysis/sharded.py`` in a process of its own."""
    import torch
    from repro_torch.core.dist_svd import _deflated_chain_step
    from repro_torch.core.operator import ShardedOperator

    axes = ("data",)
    A = _matrix(device)
    targets, groups = [], []
    for sd, _ in SWEEP_DTYPES:
        op = ShardedOperator(A, mesh, axes, sweep_dtype=sd)
        groups.append(_acct(f"sharded/chain/{sd}", op, "chain_passes",
                            replicas=op.n_shards))
        fn, args = _block_step(op, sd)
        targets.append(StepTarget(
            f"sharded/block/{sd}", fn, args,
            StepContract(all_reduce_payloads=((N, K),),
                         requires_bf16=(sd == "bfloat16")),
            group=f"sharded/chain/{sd}"))
    twins = [("sharded/block/float32", "sharded/block/bfloat16")]

    op32 = ShardedOperator(A, mesh, axes)
    groups.append(_acct("sharded/sketch/float32", op32, "sketch_passes",
                        replicas=op32.n_shards))
    targets.append(StepTarget(
        "sharded/sketch/warm", op32.range_sketch, (L, 0),
        StepContract(all_reduce_payloads=((N, L),)),
        group="sharded/sketch/float32"))
    Q = op32.orth(op32.random_block(K, 0))
    targets.append(StepTarget(
        "sharded/extract", op32.extract, (Q,),
        StepContract(all_reduce_payloads=((K, K),)),
        note="Rayleigh-Ritz via the all-reduced (k, k) Gram"))

    # the deflation engine's power step, paper-faithful (3 all-reduces,
    # Alg 4 lines 6/8/16) vs fused (ONE (n + k,) all-reduce)
    g = torch.Generator().manual_seed(3)
    U = torch.linalg.qr(torch.randn((M, K), generator=g)).Q.to(device)
    S = torch.linspace(2.0, 1.0, K).to(device)
    V = torch.linalg.qr(torch.randn((N, K), generator=g)).Q.to(device)
    v = torch.randn(N, generator=g).to(device)
    A_loc = op32._A

    def deflation_step(faithful):
        def power_step(A_loc, U_loc, S, V, v):
            v1 = _deflated_chain_step(A_loc, U_loc, S, V, v, group,
                                      faithful=faithful)
            return v1 / torch.sqrt(torch.sum(v1 * v1))
        return power_step

    args = (A_loc, U[:A_loc.shape[0]].contiguous(), S, V, v)
    targets.append(StepTarget(
        "sharded/deflation/faithful", deflation_step(True), args,
        StepContract(all_reduce_payloads=((N,), (K,), (N,))),
        note="paper Alg-4 schedule: all-reduces of t1 (n,), UtXv (k,), "
             "t3 (n,)"))
    targets.append(StepTarget(
        "sharded/deflation/opt", deflation_step(False), args,
        StepContract(all_reduce_payloads=((N + K,),)),
        note="fused sweep: ONE concatenated (n+k,) all-reduce a step"))
    return targets, groups, twins, []


def build_targets(device):
    """The in-process targets on ``device`` (everything but the sharded
    backend's): ``(targets, groups, twins, cleanups)``."""
    out = ([], [], [], [])
    for builder in (_dense_targets, _hostblocked_targets, _memmap_targets,
                    _sparse_targets, _kernel_targets):
        for acc, part in zip(out, builder(device)):
            acc.extend(part)
    return out
