"""repro_torch.core — the ported front door and block driver.

Mirrors the names of the JAX package's ``repro.core`` for what is
ported: ``svd``/``svd_update``, the ``init_state``/``step``/``finalize``
state machine, ``SVDConfig``/``SVDResult``/``SolverState``, the
``LinearOperator`` protocol with ``DenseOperator``, the shared numerical
helpers, the typed errors and the fault-injection harness.
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
    "SWEEP_DTYPES",
    "resolve_sweep_dtype",
    "sweep_ops",
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
]
