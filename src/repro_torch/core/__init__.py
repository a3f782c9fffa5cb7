"""repro_torch.core — the ported front door and block driver.

Mirrors the names of the JAX package's ``repro.core`` for what is
ported: ``svd``/``svd_update``, the ``init_state``/``step``/``finalize``
state machine, ``SVDConfig``/``SVDResult``/``SolverState``, the
``LinearOperator`` protocol with ``DenseOperator``, ``ShardedOperator``,
``HostBlockedOperator``, ``MemmapOperator`` and ``SparseStreamOperator``,
the sharded backend's mesh helpers (``make_host_mesh``,
``make_production_mesh``) and deprecated ``dist_tsvd``, the sparse stream
(``RowBlockStream``, ``SyntheticSparseMatrix``, ``ScipySparseMatrix``,
``ScipySparseOperator``, ``DenseStreamOperator`` and the deprecated
``sparse_tsvd``), the out-of-core tiers (``HostBlockedMatrix``,
``CountingHostMatrix``, ``MemmapMatrix``, ``stage_to_disk``,
``open_matrix_memmap``, the blocked Gram helpers and the deprecated
``oom_tsvd``), the batching plans of ``core/partition.py``, the deflation
engines' power loops (``svd_1d``, ``power_iterate_gram``,
``power_iterate_chain``), the shared numerical helpers, the typed errors
and the fault-injection harness.
"""
from repro_torch.core.config import (  # noqa: F401
    SolverState,
    SVDConfig,
    SVDResult,
)
from repro_torch.core.precision import (  # noqa: F401
    SWEEP_DTYPES,
    resolve_sweep_dtype,
)
from repro_torch.core.tsvd import (  # noqa: F401
    power_iterate_chain,
    power_iterate_gram,
    svd_1d,
    sweep_ops,
    warm_start_width,
    rayleigh_ritz,
    rayleigh_ritz_from_W,
    reconstruct,
    relative_error,
)
from repro_torch.core.operator import (  # noqa: F401
    LinearOperator,
    DenseOperator,
    ShardedOperator,
    HostBlockedOperator,
    MemmapOperator,
    SparseStreamOperator,
)
from repro_torch.core.dist_svd import DistTSVDResult, dist_tsvd  # noqa: F401
from repro_torch.launch.mesh import (  # noqa: F401
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.core.partition import (  # noqa: F401
    BatchPlan,
    Partition,
    make_batch_plan,
    make_partition,
    symmetric_tasks,
)
from repro_torch.core.oom import (  # noqa: F401
    CountingHostMatrix,
    HostBlockedMatrix,
    OOMResult,
    blocked_deflated_matvec,
    blocked_gram,
    oom_tsvd,
    tiled_gram,
)
from repro_torch.core.diskio import (  # noqa: F401
    MemmapMatrix,
    open_matrix_memmap,
    stage_to_disk,
)
from repro_torch.core.sparse import (  # noqa: F401
    DenseStreamOperator,
    RowBlockStream,
    ScipySparseMatrix,
    ScipySparseOperator,
    SparseTSVDResult,
    SyntheticSparseMatrix,
    sparse_tsvd,
)
from repro_torch.core.errors import (  # noqa: F401
    CheckpointCorruptError,
    DeviceOOMFault,
    FaultExhaustedError,
    InputError,
    NumericalHealthError,
    SVDError,
)
from repro_torch.core.faults import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    FaultTelemetry,
    RetryPolicy,
    inject_faults,
)
from repro_torch.core.svd import (  # noqa: F401
    finalize,
    init_state,
    step,
    svd,
    svd_update,
)

__all__ = [
    "svd",
    "svd_update",
    "SVDConfig",
    "SVDResult",
    "SolverState",
    "init_state",
    "step",
    "finalize",
    "LinearOperator",
    "DenseOperator",
    "ShardedOperator",
    "HostBlockedOperator",
    "MemmapOperator",
    "SparseStreamOperator",
    "ScipySparseOperator",
    "HostBlockedMatrix",
    "CountingHostMatrix",
    "MemmapMatrix",
    "stage_to_disk",
    "open_matrix_memmap",
    "RowBlockStream",
    "ScipySparseMatrix",
    "SyntheticSparseMatrix",
    "DenseStreamOperator",
    "sparse_tsvd",
    "SparseTSVDResult",
    "blocked_gram",
    "tiled_gram",
    "blocked_deflated_matvec",
    "oom_tsvd",
    "OOMResult",
    "Partition",
    "make_partition",
    "BatchPlan",
    "make_batch_plan",
    "symmetric_tasks",
    "SWEEP_DTYPES",
    "resolve_sweep_dtype",
    "sweep_ops",
    "svd_1d",
    "power_iterate_gram",
    "power_iterate_chain",
    "warm_start_width",
    "rayleigh_ritz",
    "rayleigh_ritz_from_W",
    "reconstruct",
    "relative_error",
    "SVDError",
    "InputError",
    "FaultExhaustedError",
    "CheckpointCorruptError",
    "NumericalHealthError",
    "DeviceOOMFault",
    "FaultPlan",
    "FaultSpec",
    "FaultTelemetry",
    "RetryPolicy",
    "inject_faults",
    "dist_tsvd",
    "DistTSVDResult",
    "make_host_mesh",
    "make_production_mesh",
]
