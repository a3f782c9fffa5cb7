"""Configuration + result types for the SVD front door (PyTorch port).

``SVDConfig``, ``SolverState`` and ``SVDResult`` mirror the JAX
package's ``repro/core/config.py`` field for field, with the same
validation messages and the same ``solver_fingerprint()`` string, so a
config means the same trajectory in both packages.

RNG is one integer ``seed`` everywhere.  The JAX package's
``seed_to_key``/``key_to_seed`` translate that integer to and from jax
PRNG keys; the port seeds a ``torch.Generator`` with it directly, so it
has no counterpart of either.

``SolverState.to_tree``/``from_tree`` keep the JAX package's numpy tree
exactly.  That tree is what carries a trajectory across packages: a
state written by ``repro``'s ``SolverState.to_tree(np.asarray)`` loads
here with ``SolverState.from_tree`` (and the reverse), and the operator's
``from_host`` lifts its iterate onto the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np

from repro_torch.core.errors import InputError
from repro_torch.core.precision import (SWEEP_DTYPES, dtype_name,
                                        resolve_sweep_dtype)

METHODS = ("gram", "gramfree", "block")


@dataclasses.dataclass(frozen=True)
class SVDConfig:
    """All solver knobs, validated once (see the JAX package's
    ``SVDConfig`` for the meaning of each field; the two agree).

    Fields that select paths this port does not run yet (the deflation
    methods, ``checkpoint_dir``) validate exactly as in the JAX package;
    ``repro_torch.svd`` then raises ``NotImplementedError`` naming the
    ROADMAP item that ports them.
    """

    method: str = "block"
    eps: float = 1e-6
    max_iters: int = 200
    force_iters: bool = False
    warmup_q: int = 0
    oversample: int = 8
    sweep_dtype: str = "float32"
    n_blocks: int = 4
    block_rows: int = 1 << 16
    host_budget_bytes: int = 0
    seed: int = 0
    faithful: bool = False
    checkpoint_dir: Any = None
    checkpoint_every: int = 1
    on_iteration: Any = None
    io_retries: int = 3
    io_retry_backoff: float = 0.05
    health_retries: int = 3
    demote_on_oom: bool = True

    def __post_init__(self):
        if self.method not in METHODS:
            raise InputError(f"unknown method {self.method!r}; expected "
                             f"one of {METHODS}")
        if self.eps <= 0:
            raise InputError(f"eps must be > 0, got {self.eps}")
        if self.max_iters < 1:
            raise InputError(f"max_iters must be >= 1, got {self.max_iters}")
        if self.warmup_q < 0:
            raise InputError(f"warmup_q must be >= 0, got {self.warmup_q}")
        if self.oversample < 0:
            raise InputError(
                f"oversample must be >= 0, got {self.oversample}")
        if self.n_blocks < 1:
            raise InputError(f"n_blocks must be >= 1, got {self.n_blocks}")
        if self.block_rows < 1:
            raise InputError(
                f"block_rows must be >= 1, got {self.block_rows}")
        if self.host_budget_bytes < 0:
            raise InputError(f"host_budget_bytes must be >= 0 (0 = "
                             f"unbounded), got {self.host_budget_bytes}")
        if self.checkpoint_every < 1:
            raise InputError(f"checkpoint_every must be >= 1, "
                             f"got {self.checkpoint_every}")
        if self.io_retries < 1:
            raise InputError(f"io_retries must be >= 1 (1 = no retry), "
                             f"got {self.io_retries}")
        if self.io_retry_backoff < 0:
            raise InputError(f"io_retry_backoff must be >= 0 seconds, "
                             f"got {self.io_retry_backoff}")
        if self.health_retries < 0:
            raise InputError(f"health_retries must be >= 0 (0 = fail on "
                             f"the first unhealthy step), "
                             f"got {self.health_retries}")
        if self.checkpoint_dir is not None and self.method != "block":
            raise InputError("checkpoint_dir requires method='block' "
                             "(only the block driver is a resumable "
                             "state machine)")
        if self.on_iteration is not None and self.method != "block":
            raise InputError("on_iteration requires method='block' "
                             "(the deflation engines have no per-"
                             "iteration SolverState to trace)")
        if self.warmup_q and self.method != "block":
            raise InputError("warmup_q > 0 requires method='block' "
                             "(deflation has no block iterate to "
                             "warm-start)")
        sd_name = dtype_name(resolve_sweep_dtype(self.sweep_dtype))
        object.__setattr__(self, "sweep_dtype", sd_name)
        if sd_name != SWEEP_DTYPES[0] and self.method != "block":
            raise InputError("sweep_dtype != 'float32' requires "
                             "method='block' (only the block sweeps have "
                             "the mixed-precision policy; deflation stays "
                             "the fp32 oracle)")
        object.__setattr__(self, "seed", int(self.seed))

    def replace(self, **overrides: Any) -> "SVDConfig":
        """New config with ``overrides`` applied (re-validated)."""
        return dataclasses.replace(self, **overrides)

    def solver_fingerprint(self) -> str:
        """The trajectory-defining knobs, as a stable string — the same
        string the JAX package writes, so checkpoints are shared."""
        return (f"method={self.method};warmup_q={self.warmup_q};"
                f"oversample={self.oversample};"
                f"sweep_dtype={self.sweep_dtype};n_blocks={self.n_blocks};"
                f"block_rows={self.block_rows};seed={self.seed}")


#: fixed tier keys a serialized ``SolverState`` records (absent = 0)
STATE_TIERS = ("disk", "host", "device")


@dataclasses.dataclass(frozen=True, eq=False)
class SolverState:
    """One block-driver iteration as a first-class, serializable value.

    ``Q`` is the (N, l) iterate: a torch tensor on the operator's device
    mid-run, a host numpy array once serialized.  ``prev_gap``/``gap``
    may be unsynced 0-d device tensors mid-run; floats once serialized.
    ``passes``/``bytes_moved`` are cumulative across resumes (each
    phase adds the operator-counter delta it caused).
    """

    Q: Any
    k: int
    it: int = 0
    prev_gap: Any = None
    gap: Any = None
    converged: bool = False
    passes: int = 0
    bytes_moved: Any = None
    config_fp: str = ""
    op_fp: str = ""

    def replace(self, **overrides: Any) -> "SolverState":
        return dataclasses.replace(self, **overrides)

    # -- host serialization (the JAX package's array tree, exactly) ---------

    def to_tree(self, to_host=None) -> dict:
        """All-array tree of numpy leaves (fingerprints ride separately).
        ``to_host`` is the operator's device->numpy hop for the iterate."""
        Qh = to_host(self.Q) if to_host is not None else self.Q
        gap = lambda v: np.asarray(
            np.nan if v is None else float(v), np.float64)
        tree = {
            "Q": np.asarray(Qh, np.float32),
            "k": np.asarray(self.k, np.int64),
            "it": np.asarray(self.it, np.int64),
            "prev_gap": gap(self.prev_gap),
            "gap": gap(self.gap),
            "converged": np.asarray(bool(self.converged)),
            "passes": np.asarray(int(self.passes), np.int64),
        }
        moved = self.bytes_moved or {}
        for tier in STATE_TIERS:
            tree[f"bytes_{tier}"] = np.asarray(
                int(moved.get(tier, 0)), np.int64)
        return tree

    @classmethod
    def from_tree(cls, tree, *, config_fp: str = "",
                  op_fp: str = "") -> "SolverState":
        """Inverse of ``to_tree`` (either package's); ``Q`` stays host-side
        until the driver lifts it with ``op.from_host``."""
        gap = lambda a: None if np.isnan(float(a)) else float(a)
        moved = {t: int(tree[f"bytes_{t}"]) for t in STATE_TIERS
                 if int(tree[f"bytes_{t}"])}
        return cls(Q=np.asarray(tree["Q"], np.float32),
                   k=int(tree["k"]), it=int(tree["it"]),
                   prev_gap=gap(tree["prev_gap"]), gap=gap(tree["gap"]),
                   converged=bool(tree["converged"]),
                   passes=int(tree["passes"]), bytes_moved=moved,
                   config_fp=config_fp, op_fp=op_fp)

    @classmethod
    def host_template(cls) -> dict:
        """A ``like`` tree for a checkpoint restore (dtypes only)."""
        z = lambda dt: np.zeros((), dt)
        tree = {"Q": np.zeros((0, 0), np.float32), "k": z(np.int64),
                "it": z(np.int64), "prev_gap": z(np.float64),
                "gap": z(np.float64), "converged": z(np.bool_),
                "passes": z(np.int64)}
        for tier in STATE_TIERS:
            tree[f"bytes_{tier}"] = z(np.int64)
        return tree


class SVDResult(NamedTuple):
    """Unified SVD result: ``A ~= U @ diag(S) @ V.T`` (torch tensors on
    the solve's device), with the JAX package's fields in its order."""

    U: Any                 # (m, k) left factor
    S: Any                 # (k,) singular values, descending
    V: Any                 # (n, k) right factor
    iters: Any             # (k,) iterations per rank (shared for "block")
    passes_over_A: Any     # A-sized operand sweeps
    bytes_per_pass: int    # bytes one pass moves at the configured dtype
    converged: bool        # criterion met before max_iters
    backend: str           # "dense" (or a custom operator's tag)
    bytes_moved: Any = None  # per-tier total bytes {"device": ...}
    faults: Any = None       # FaultTelemetry snapshot (block driver)
    wall_time_s: Any = None  # end-to-end seconds of the svd() call
