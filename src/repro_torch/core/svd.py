"""The SVD front door, the block driver and the deflation dispatch
(PyTorch port).

The counterpart of the JAX package's ``repro/core/svd.py`` for the
dense in-memory path.  ``svd(A, k)`` on a ``torch.Tensor`` runs, for
``method="block"``, the same three-phase state machine over a
``SolverState`` —

* ``init_state(op, k, cfg)``: cold start ``Q0 = orth(random)``, the
  randomized range-finder warm start ``Q0 = orth((A^T A)^q A^T Omega)``
  (``warmup_q > 0``), or a caller-supplied seed subspace (``svd_update``);
* ``step(op, state, cfg)``: ONE subspace iteration ``Q <- orth(A^T A Q)``
  with the rotation-invariant subspace-gap test, synced one iteration
  late (``lagged_sync``), the synced gap doubling as the numeric health
  guard;
* ``finalize(op, state, cfg)``: Rayleigh–Ritz extraction (one more pass),
  truncating the oversampled columns —

composed by ``_run_block`` into the self-healing loop (health-guard
rollback, OOM demotion down ``op.demote``, fault telemetry), with the
same pass and byte accounting, so ``passes_over_A``, ``bytes_per_pass``,
``bytes_moved`` and ``iters`` under ``force_iters`` equal the JAX
package's exactly.  For the rank-one deflation methods ``"gram"`` and
``"gramfree"`` it calls the engine ``core/tsvd.py::_dense_deflation``
and reports, as the JAX package does, per-rank ``iters``, the schedule's
``passes_over_A``, ``converged`` from ``_deflation_converged`` and no
``bytes_moved``.

The out-of-core tiers, as in the JAX package: a numpy array or a
``HostBlockedMatrix`` runs on the host-blocked tier (row blocks streamed
host -> device over a copy stream, ``core/oom.py``), a ``.npy`` path, an
``np.memmap`` or a ``MemmapMatrix`` on the disk tier
(``core/diskio.py``); both take ``method="block"`` (the shared driver
over ``HostBlockedOperator``/``MemmapOperator``) and ``"gramfree"``
(``core/oom.py::_oom_deflation``).  A device OOM demotes dense ->
host-blocked -> memmap with the warm iterate.

The sparse stream, as in the JAX package: a scipy sparse matrix, a
``ScipySparseMatrix`` or a ``.npz``/``.mtx``/``.mtx.gz`` path
(``ScipySparseOperator``), a ``SyntheticSparseMatrix`` or any object
with the streamed surface (``SparseStreamOperator``), for
``method="block"`` and ``"gramfree"`` (``core/sparse.py``): the row
blocks are packed on the host and swept on the device by the CSR
kernels.

Checkpoint/resume (``checkpoint_dir``): the driver saves the
``SolverState`` every ``checkpoint_every`` iterations and at loop exit
(``checkpoint/manager.py``, the JAX package's on-disk format), and the
next solve in that directory resumes from the newest readable step; a
corrupt or non-finite step is quarantined and the previous one taken.

The sharded backend (``mesh=``, a ``torch.distributed`` device mesh;
every rank of it makes the same call): ``A`` row-sharded over the
product of ``axes`` (wide inputs transposed in, each rank copying only
its column slice, and the factors swapped out), the block method on
``ShardedOperator`` through the same driver (one ``(n, k)`` all-reduce a
step) and the deflation methods on ``core/dist_svd.py``'s engine (the
paper's three all-reduces a power step with ``faithful=True``, one
fused otherwise).  The factor on ``A``'s long side comes back as a
row-sharded ``DTensor``; ``S``, the other factor, ``iters`` and the
accounting are replicated, the same bits on every rank.  With
``checkpoint_dir`` the mesh's first rank writes each step, every rank of
the mesh waits for it, and every rank resumes from the same step.  A
device OOM moves each rank's own rows to its host
(``ShardedHostOperator``), a second one spills them to the rank's own
``.npy`` (``ShardedMemmapOperator``), and the solve goes on with the
same collectives.

Entry points run on the card: ``device=None`` means ``"cuda"`` and
raises when no card is visible; the caller passes ``device="cpu"`` to
run the plain PyTorch versions of the kernels on the CPU.  On a mesh the
device is the mesh's: ``cuda:{local_rank % device_count}``, or the CPU
for a ``"cpu"`` mesh.
"""
from __future__ import annotations

import math
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.core.config import SolverState, SVDConfig, SVDResult
from repro_torch.core.errors import (FaultExhaustedError, InputError,
                                     NumericalHealthError, SVDError,
                                     is_oom_error)
from repro_torch.core.faults import (FaultTelemetry, RetryPolicy, fault_hook,
                                     maybe_corrupt)
from repro_torch.core.operator import (DenseOperator, LinearOperator,
                                       SparseStreamOperator,
                                       host_sync_scalar, resolve_device,
                                       warm_start_width)
from repro_torch.core.precision import dtype_name, resolve_sweep_dtype
from repro_torch.core.tsvd import _dense_deflation

__all__ = ["svd", "svd_update", "init_state", "step", "finalize",
           "SolverState", "SVDConfig", "SVDResult"]


# ---------------------------------------------------------------------------
# Deprecation bookkeeping for the legacy entrypoint shims
# ---------------------------------------------------------------------------

_LEGACY_WARNED: set[str] = set()


def warn_legacy(name: str) -> None:
    """Emit the one-per-process DeprecationWarning for a legacy shim."""
    if name in _LEGACY_WARNED:
        return
    _LEGACY_WARNED.add(name)
    warnings.warn(
        f"repro_torch.core.{name}() is deprecated; call "
        f"repro_torch.core.svd(A, k, config=SVDConfig(...)) instead (the "
        f"old keywords map 1:1 onto SVDConfig fields)",
        DeprecationWarning, stacklevel=3)


def _reset_legacy_warnings() -> None:
    """Test hook: make every shim warn again."""
    _LEGACY_WARNED.clear()


# ---------------------------------------------------------------------------
# The block-iteration driver: init/step/finalize over a SolverState
# ---------------------------------------------------------------------------

def _tier_delta(before: dict, after: dict) -> dict:
    """Per-tier byte delta between two ``bytes_moved`` snapshots."""
    return {t: int(after[t]) - int(before.get(t, 0)) for t in after}


def _tier_merge(acc, delta: dict) -> dict:
    out = dict(acc or {})
    for t, v in delta.items():
        out[t] = out.get(t, 0) + v
    return out


def _stamp(state: SolverState, op: LinearOperator, p0: int,
           b0: dict, **updates) -> SolverState:
    """New state with the operator-counter deltas since (p0, b0) folded
    into the cumulative ``passes``/``bytes_moved`` accounting."""
    return state.replace(
        passes=state.passes + int(op.passes) - int(p0),
        bytes_moved=_tier_merge(state.bytes_moved,
                                _tier_delta(b0, dict(op.bytes_moved))),
        **updates)


def _tol(state: SolverState, cfg: SVDConfig) -> float:
    return cfg.eps * int(state.Q.shape[1])             # eps * l_eff


def init_state(op: LinearOperator, k: int, cfg: SVDConfig,
               warm=None, telemetry: FaultTelemetry | None = None
               ) -> SolverState:
    """Phase 1: the initial iterate — the newest matching checkpoint
    under ``cfg.checkpoint_dir`` (auto-resume; a fingerprint mismatch
    raises), a caller-supplied host seed subspace ``warm`` (aligned to
    the operator, then ``cfg.warmup_q`` refinements), the randomized
    range-finder sketch (``warmup_q > 0``), or a cold Gaussian block."""
    cfp = cfg.solver_fingerprint()
    ofp = op.fingerprint
    if cfg.checkpoint_dir is not None:
        state = _resume_state(op, k, cfg, cfp, ofp, telemetry=telemetry)
        if state is not None:
            return state
    p0, b0 = int(op.passes), dict(op.bytes_moved)
    N = op.shape[1]
    if warm is not None:
        Q = op.orth(op.from_host(_align_seed(warm, N, k, cfg)))
        for _ in range(cfg.warmup_q):                  # optional refinements
            Q = op.orth(op.gram_chain(Q))
    elif cfg.warmup_q > 0:
        l = warm_start_width(k, cfg.oversample, N)
        Q = op.orth(op.range_sketch(l, cfg.seed))      # sketch pass
        for _ in range(cfg.warmup_q):                  # q refinements
            Q = op.orth(op.gram_chain(Q))
    else:
        Q = op.orth(op.random_block(k, cfg.seed))      # cold start: free
    return _stamp(SolverState(Q=Q, k=k, config_fp=cfp, op_fp=ofp),
                  op, p0, b0)


def _check_health(g: float, width: int, where: str) -> None:
    """The numeric health guard's test, applied to a SYNCED gap scalar:
    NaN/Inf anywhere in the iterate poisons the gap, and a finite value
    outside ``[0, l]`` means the bases stopped being orthonormal."""
    if not math.isfinite(g):
        raise NumericalHealthError(
            f"non-finite subspace gap ({g}) {where}: the iterate "
            f"contains NaN/Inf (overflowed sweep, corrupt input, or an "
            f"injected fault)", kind="nonfinite")
    if g < -1e-3 or g > width * 1.001 + 1e-3:
        raise NumericalHealthError(
            f"subspace gap {g} outside [0, {width}] {where}: "
            f"orthogonality loss in the iterate", kind="orth")


def step(op: LinearOperator, state: SolverState,
         cfg: SVDConfig) -> SolverState:
    """Phase 2: ONE subspace iteration — ``Q <- orth(A^T A Q)`` plus the
    convergence bookkeeping.  The only host sync is the lagged
    ``.item()`` of the PREVIOUS gap, issued after this iteration's
    launches are queued; under ``force_iters`` nothing is synced."""
    tol = _tol(state, cfg)
    tel = getattr(op, "_telemetry", None)       # duck-typed operators
    fault_hook("device_oom", tel)               # chaos: OOM on dispatch
    p0, b0 = int(op.passes), dict(op.bytes_moved)
    Z = maybe_corrupt("sweep", op.gram_chain(state.Q), tel)
    Qn = op.orth(Z)
    gap = op.subspace_gap(state.Q, Qn)  # unsynced 0-d tensor
    converged, prev_gap = False, state.prev_gap
    l = int(state.Q.shape[1])
    if not cfg.force_iters:            # benchmark mode: no test
        if op.lagged_sync:
            if prev_gap is not None:
                g = host_sync_scalar(prev_gap)
                _check_health(g, l, f"at iteration {state.it}")
                if g <= tol:
                    converged = True   # this step WAS the overshoot
                else:
                    prev_gap = gap
            else:
                prev_gap = gap
        else:
            g = host_sync_scalar(gap)
            _check_health(g, l, f"at iteration {state.it + 1}")
            if g <= tol:
                converged = True
    return _stamp(state, op, p0, b0, Q=Qn, it=state.it + 1, gap=gap,
                  prev_gap=prev_gap, converged=converged)


def finalize(op: LinearOperator, state: SolverState,
             cfg: SVDConfig) -> SVDResult:
    """Phase 3: Rayleigh–Ritz extraction from the converged basis (one
    more pass), truncating the oversampled columns."""
    converged = state.converged
    if not converged and not cfg.force_iters and state.gap is not None:
        converged = bool(host_sync_scalar(state.gap) <= _tol(state, cfg))
    p0, b0 = int(op.passes), dict(op.bytes_moved)
    k = state.k
    U, S, V = op.extract(state.Q)                      # one more pass
    U, S, V = U[:, :k], S[:k], V[:, :k]                # drop oversampled
    iters = np.full((k,), state.it, np.int32)
    final = _stamp(state, op, p0, b0, converged=converged)
    return SVDResult(U, S, V, iters, int(final.passes), op.bytes_per_pass,
                     converged, op.backend, bytes_moved=final.bytes_moved)


def _align_seed(W, N: int, k: int, cfg: SVDConfig) -> np.ndarray:
    """Align a previous factor to the (N, l) iterate the operator needs:
    zero-pad/truncate rows; use a seed covering ``k`` directions as-is;
    fill a grown rank with ``oversample`` extra seeded-Gaussian columns
    (numpy-seeded exactly as in the JAX package, so both packages build
    the same seed subspace)."""
    W = np.asarray(W, np.float32)
    if W.ndim != 2:
        raise ValueError(f"warm seed must be 2-D, got shape {W.shape}")
    c = min(W.shape[1], N)
    l = c if c >= k else min(k + max(cfg.oversample, 0), N)
    out = np.zeros((N, l), np.float32)
    r = min(N, W.shape[0])
    out[:r, :c] = W[:r, :c]
    if l > c:
        rng = np.random.default_rng((int(cfg.seed) ^ 0x5EED) & (2**63 - 1))
        out[:, c:] = rng.standard_normal((N, l - c)).astype(np.float32)
    return out


def _resume_state(op, k, cfg, cfp: str, ofp: str,
                  telemetry: FaultTelemetry | None = None
                  ) -> SolverState | None:
    """The newest READABLE checkpointed state, or None if the directory
    has none.  A corrupt, torn or non-finite step is quarantined
    (``step_X.corrupt``) and resume falls back to the previous one; an
    INTACT step whose fingerprints or rank differ is a hard
    ``InputError``: continuing another run's trajectory would corrupt the
    accounting and the bitwise-resume contract."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.errors import CheckpointCorruptError
    mgr = CheckpointManager(cfg.checkpoint_dir)
    for step_no in reversed(mgr.all_steps()):
        try:
            extra = mgr.read_meta(step_no).get("extra", {})
            saved_cfp = extra.get("config_fp")
            saved_ofp = extra.get("op_fp")
            if saved_cfp != cfp or saved_ofp != ofp:
                raise InputError(
                    f"checkpoint_dir={cfg.checkpoint_dir!r} step "
                    f"{step_no} was written by a different run: config "
                    f"fingerprint {saved_cfp!r} vs {cfp!r}, operator "
                    f"fingerprint {saved_ofp!r} vs {ofp!r}; point "
                    f"checkpoint_dir at a fresh directory (or delete "
                    f"the stale steps) to start over")
            state = SolverState.from_tree(
                mgr.restore(step_no, SolverState.host_template()),
                config_fp=cfp, op_fp=ofp)
            if not np.all(np.isfinite(state.Q)):
                raise CheckpointCorruptError(
                    f"step {step_no}: non-finite iterate (the state was "
                    f"saved mid-corruption)")
        except CheckpointCorruptError as e:
            # on a mesh one rank renames the step; the others read it as
            # corrupt or no longer see it, and fall back the same way
            if op.writes_checkpoints:
                quarantined = mgr.quarantine(step_no)
                if telemetry is not None:
                    telemetry.record("checkpoint", "quarantine",
                                     step=int(step_no), path=quarantined,
                                     error=str(e))
            continue                    # fall back to the previous step
        if state.k != k:
            raise InputError(
                f"checkpoint at {cfg.checkpoint_dir!r} targets rank "
                f"{state.k}, this call asked for rank {k}")
        return state.replace(Q=op.from_host(state.Q))
    return None


def _save_state(mgr, op, state: SolverState) -> None:
    """Save ``state`` as step ``state.it``; on a mesh one rank writes it
    (``Q`` is replicated) and every rank waits until it is published."""
    tree = state.to_tree(op.to_host)
    if op.writes_checkpoints:
        mgr.save(state.it, tree,
                 extra={"kind": "solver_state", "config_fp": state.config_fp,
                        "op_fp": state.op_fp})
    op.sync_ranks()


def _carry_state(st: SolverState | None, op: LinearOperator,
                 telemetry: FaultTelemetry) -> SolverState | None:
    """Pull the warm iterate off a just-OOM'd operator so the demoted
    tier resumes from it, with the cumulative accounting riding along;
    a cold start (recorded in the telemetry) if even the read fails."""
    if st is None:
        return None
    try:
        return st.replace(Q=op.to_host(st.Q), gap=None, prev_gap=None)
    except Exception as e:             # noqa: BLE001 - device is gone
        telemetry.record("device_oom", "carry_failed", error=str(e))
        return None


def _drive(op: LinearOperator, k: int, cfg: SVDConfig, warm, mgr,
           telemetry: FaultTelemetry, carried: SolverState | None,
           cell: dict) -> SVDResult:
    """One tier's worth of the solve loop: init (or adopt the iterate
    carried down from a demoted tier), iterate with the numeric health
    guard, checkpoint every ``cfg.checkpoint_every`` iterations and at
    loop exit (``mgr``), finalize.  A ``NumericalHealthError`` rolls the
    loop back to the last CONFIRMED-healthy state; the sweeps are
    deterministic, so a transient corruption replays onto the bitwise
    fault-free trajectory.
    """
    if carried is not None:
        state = carried.replace(Q=op.from_host(carried.Q),
                                op_fp=op.fingerprint)
    else:
        state = init_state(op, k, cfg, warm=warm, telemetry=telemetry)
    cell["state"] = state
    good = state                        # last confirmed-healthy state
    health_attempts = 0
    last_saved = state.it if state.it else None         # resumed at it
    while True:
        if state.converged or state.it >= cfg.max_iters:
            # a run that exits on max_iters never synced its final gap
            if (not cfg.force_iters and not state.converged
                    and state.gap is not None):
                try:
                    _check_health(host_sync_scalar(state.gap),
                                  int(state.Q.shape[1]),
                                  f"at iteration {state.it} (final)")
                except NumericalHealthError as err:
                    state, good, health_attempts = _recover(
                        op, cfg, err, good, health_attempts, telemetry)
                    cell["state"] = state
                    continue
            break
        p0 = int(op.passes)
        try:
            new = step(op, state, cfg)
        except NumericalHealthError as err:
            state, good, health_attempts = _recover(
                op, cfg, err, good, health_attempts, telemetry,
                discarded_passes=int(op.passes) - p0)
            cell["state"] = state
            continue
        # with lagged sync the synced gap belonged to the parent, so only
        # the parent is confirmed healthy
        if cfg.force_iters:
            good = new
        elif not op.lagged_sync:
            good, health_attempts = new, 0
        elif state.prev_gap is not None:
            good, health_attempts = state, 0
        state = new
        cell["state"] = state
        if mgr is not None and state.it % cfg.checkpoint_every == 0:
            _save_state(mgr, op, state)                 # syncs the gap
            last_saved = state.it
        fault_hook("kill", telemetry)   # chaos: die AFTER the checkpoint
        if cfg.on_iteration is not None:
            if getattr(cfg.on_iteration, "_wants_operator", False):
                cfg.on_iteration(state, op)
            else:
                cfg.on_iteration(state)
    if mgr is not None and last_saved != state.it:
        _save_state(mgr, op, state)                     # final state
    return finalize(op, state, cfg)


def _recover(op, cfg, err: NumericalHealthError, good: SolverState,
             attempts: int, telemetry: FaultTelemetry,
             discarded_passes: int = 0):
    """Bounded rollback/re-orth to the last confirmed-healthy state, or
    ``FaultExhaustedError`` after ``cfg.health_retries`` in a row."""
    attempts += 1
    if attempts > cfg.health_retries:
        raise FaultExhaustedError(
            f"numeric health guard tripped {attempts} times in a row "
            f"({err}); rollback cannot recover — the input data or the "
            f"sweep_dtype={cfg.sweep_dtype!r} precision is unrecoverably "
            f"ill-conditioned (raise SVDConfig.health_retries only if "
            f"the corruption source is transient)") from err
    if err.kind == "orth":
        action = "reorth"
        state = good.replace(Q=op.orth(good.Q), gap=None, prev_gap=None)
    else:
        action = "rollback"
        state = good
    telemetry.record("health", action, it=int(good.it), kind=err.kind,
                     error=str(err), discarded_passes=int(discarded_passes))
    return state, good, attempts


def _run_block(op: LinearOperator, k: int, cfg: SVDConfig, warm=None):
    """init/step/finalize composed into the self-healing driver loop.

    A device OOM (``torch.cuda.OutOfMemoryError`` or an injected
    ``DeviceOOMFault``) asks ``op.demote(cfg)`` for the next-lower
    memory tier (dense -> host-blocked -> memmap; on a mesh, each rank's
    rows sharded -> host -> disk) and carries the warm iterate there; on
    the disk tier, which has none, an OOM ends the solve with
    ``FaultExhaustedError`` whose ``__cause__`` is the OOM.
    With ``cfg.checkpoint_dir`` the states go through a
    ``CheckpointManager`` there.
    """
    telemetry = FaultTelemetry()
    policy = RetryPolicy(max_attempts=cfg.io_retries,
                         base_delay=cfg.io_retry_backoff)
    mgr = None
    if cfg.checkpoint_dir is not None:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(cfg.checkpoint_dir)
    carried = None
    op.acquire_solve()
    try:
        while True:
            op.reset_counters()
            op.set_resilience(telemetry, policy)
            cell: dict = {"state": None}
            try:
                res = _drive(op, k, cfg, warm, mgr, telemetry, carried,
                             cell)
                return res._replace(faults=telemetry.snapshot())
            except Exception as e:
                if not (cfg.demote_on_oom and is_oom_error(e)):
                    if isinstance(e, SVDError):
                        e.faults = telemetry.snapshot()
                    raise
                new_op = op.demote(cfg)
                if new_op is None:
                    err = FaultExhaustedError(
                        f"device OOM on the {op.backend!r} backend with "
                        f"no lower tier to demote to; shrink the "
                        f"problem, or set demote_on_oom=False to see "
                        f"the raw error")
                    err.faults = telemetry.snapshot()
                    raise err from e
                carried = _carry_state(cell["state"], op, telemetry)
                telemetry.record(
                    "device_oom", "demote", frm=op.backend,
                    to=new_op.backend,
                    it=0 if carried is None else int(carried.it))
                new_op.acquire_solve()
                op.release_solve()
                op, warm = new_op, None  # carried iterate supersedes warm
    finally:
        op.release_solve()


def _deflation_converged(iters, cfg: SVDConfig) -> bool:
    """Conservative, as in the JAX package: True iff every rank stopped
    strictly before ``max_iters`` (a rank meeting the criterion exactly
    on the last allowed step is indistinguishable from one that ran
    out); never under ``force_iters``."""
    if cfg.force_iters:
        return False
    return bool(np.all(np.asarray(iters) < cfg.max_iters))


# ---------------------------------------------------------------------------
# Per-backend assembly
# ---------------------------------------------------------------------------

def _validate_problem(shape, k: int, source=None) -> None:
    """Reject degenerate problems with a typed, actionable error BEFORE
    any operator is built (the JAX package's checks and messages)."""
    m, n = int(shape[0]), int(shape[1])
    what = f" (from {source!r})" if source is not None else ""
    if m < 1 or n < 1:
        raise InputError(
            f"svd() input has shape {(m, n)}{what}: both dimensions must "
            f"be >= 1 — a zero-row/zero-column matrix has no singular "
            f"triplets to compute")
    if not isinstance(k, (int, np.integer)) or isinstance(k, bool):
        raise InputError(
            f"k must be a positive int, got {type(k).__name__} {k!r}")
    if k < 1:
        raise InputError(f"k must be >= 1, got {k}")
    if k > min(m, n):
        raise InputError(
            f"k={k} exceeds min(m, n)={min(m, n)} for input of shape "
            f"{(m, n)}{what}; a rank-{k} truncated SVD does not exist — "
            f"request at most min(m, n) triplets")


def _pick_seed(warm, transposed: bool):
    """The driver iterates in the tall orientation, so the seed subspace
    is the previous V — or the previous U when the input was transposed."""
    if warm is None:
        return None
    U_prev, V_prev = warm
    return U_prev if transposed else V_prev


def _dense_svd(A: torch.Tensor, k: int, cfg: SVDConfig, device,
               warm=None) -> SVDResult:
    """The dense solve of a tensor on ``device``.  Block: a wide input is
    handed to the operator as the transposed view ``A.mT`` — no copy;
    the operator swaps the two kernels — and the factors swap back.
    Deflation: the engine handles both orientations itself."""
    A = A.to(device=device, dtype=torch.float32)
    if A.ndim != 2:
        raise InputError(f"svd() takes a 2-D matrix, got shape "
                         f"{tuple(A.shape)}")
    m, n = A.shape
    _validate_problem((m, n), k)
    bpp = m * n * resolve_sweep_dtype(cfg.sweep_dtype).itemsize
    if cfg.method != "block":
        U, S, V, iters, passes = _dense_deflation(
            A, k, seed=cfg.seed, eps=cfg.eps, max_iters=cfg.max_iters,
            force_iters=cfg.force_iters, method=cfg.method)
        return SVDResult(U, S, V, iters, int(passes), bpp,
                         _deflation_converged(iters, cfg), "dense")
    tall = m >= n
    X = A if tall else A.mT
    op = DenseOperator(X, device=device, sweep_dtype=cfg.sweep_dtype)
    res = _run_block(op, k, cfg, warm=_pick_seed(warm, not tall))
    if not tall:
        res = res._replace(U=res.V, V=res.U)
    return res._replace(bytes_per_pass=bpp)


def _sharded_svd(A, k: int, mesh, axes, cfg: SVDConfig, device,
                 warm=None) -> SVDResult:
    """The solve of ``A`` row-sharded over ``axes`` of ``mesh``, made by
    every rank.  A wide ``A`` is transposed in (each rank copies only its
    column slice) and the factors swapped out, so the factor on the long
    side comes back as the row-sharded ``DTensor``."""
    from repro_torch.core.dist_svd import _dist_deflation
    from repro_torch.core.operator import ShardLayout, ShardedOperator
    layout = ShardLayout(mesh, axes, device)
    if len(A.shape) != 2:
        raise InputError(f"svd() takes a 2-D matrix, got shape "
                         f"{tuple(A.shape)}")
    m, n = (int(d) for d in A.shape)
    transposed = m < n                      # CSVD orientation: swap out
    if transposed:
        A = A.T if isinstance(A, np.ndarray) else A.mT
        m, n = n, m
    _validate_problem((m, n), k)
    layout.check_rows(m)
    bpp = m * n * resolve_sweep_dtype(cfg.sweep_dtype).itemsize
    if cfg.method == "block":
        if cfg.faithful:
            raise ValueError("method='block' has no paper-faithful "
                             "collective schedule (faithful=True applies "
                             "to the deflation methods)")
        # n_blocks is the OOM-staging / in-shard deflation-batching knob;
        # the block step is one fused chain, so it has no batching here
        op = ShardedOperator.on_layout(A, layout,
                                       sweep_dtype=cfg.sweep_dtype)
        res = _run_block(op, k, cfg, warm=_pick_seed(warm, transposed))
        res = res._replace(U=layout.dtensor(res.U, m), bytes_per_pass=bpp)
        return res._replace(U=res.V, V=res.U) if transposed else res
    U, S, V, iters, passes = _dist_deflation(
        layout.local_rows(A), k, layout, method=cfg.method,
        faithful=cfg.faithful, n_blocks=cfg.n_blocks, eps=cfg.eps,
        max_iters=cfg.max_iters, force_iters=cfg.force_iters,
        seed=cfg.seed)
    U = layout.dtensor(U, m)
    if transposed:
        U, V = V, U
    return SVDResult(U, S, V, iters, int(passes), bpp,
                     _deflation_converged(iters, cfg), "sharded",
                     bytes_moved=None)  # as the reference: no tier counters


def _tall_host(A, k: int, source=None):
    """The tall orientation of a host matrix (CSVD: a wide one is
    row-blocked as its transposed view) and whether it was transposed."""
    m, n = A.shape
    _validate_problem((m, n), k, source=source)
    transposed = m < n
    return (A.T if transposed else A), transposed


def _injected(host, sd, device):
    """Check a pre-built (already tall) matrix against the config's
    sweep dtype and the caller's device."""
    if host.stage_dtype != sd:
        raise ValueError(
            f"injected operator staged as {dtype_name(host.stage_dtype)} "
            f"but sweep_dtype={dtype_name(sd)!r}; build the operator with "
            f"stage_dtype={dtype_name(sd)!r}")
    if device is not None and resolve_device(device) != host.device:
        raise ValueError(f"injected operator lives on {host.device}, not "
                         f"on {device}; build it with device={device!r}")


def _streamed_svd(host, op_cls, k: int, cfg: SVDConfig, transposed: bool,
                  warm=None) -> SVDResult:
    """The solve on a host-blocked or disk-tier matrix (tall): the block
    driver over ``op_cls``, or the streamed deflation engine."""
    from repro_torch.core.oom import _oom_deflation
    _validate_problem((host.m, host.n), k)
    if cfg.method == "block":
        res = _run_block(op_cls(host), k, cfg,
                         warm=_pick_seed(warm, transposed))
        if transposed:
            res = res._replace(U=res.V, V=res.U)
        return res._replace(bytes_per_pass=host.bytes_per_pass)
    if cfg.method != "gramfree":
        where = ("disk tier" if op_cls.backend == "memmap"
                 else "out-of-core backend")
        raise ValueError(f"method='gram' is not available on the {where} "
                         f"(the dense residual would defeat the "
                         f"streaming); expected 'gramfree' | 'block'")
    U, S, V, iters, passes = _oom_deflation(
        host, k, eps=cfg.eps, max_iters=cfg.max_iters,
        force_iters=cfg.force_iters, seed=cfg.seed)
    if transposed:
        U, V = V, U
    # plain host matrices keep no tier counters; the disk tier's live on
    # the matrix, so it reports the actual breakdown for both methods
    return SVDResult(U, S, V, np.asarray(iters), passes,
                     host.bytes_per_pass, _deflation_converged(iters, cfg),
                     op_cls.backend,
                     bytes_moved=host.bytes_moved
                     if op_cls.backend == "memmap" else None)


def _hostblocked_svd(A, k: int, cfg: SVDConfig, device,
                     warm=None) -> SVDResult:
    """Host-blocked tier: ``A`` is a numpy array (row blocks streamed
    host -> device) or a pre-built ``HostBlockedMatrix``."""
    from repro_torch.core.oom import HostBlockedMatrix
    from repro_torch.core.operator import HostBlockedOperator
    sd = resolve_sweep_dtype(cfg.sweep_dtype)
    if isinstance(A, HostBlockedMatrix):
        _injected(A, sd, device)
        host, transposed = A, False        # injected ops are already tall
    else:
        tall, transposed = _tall_host(np.asarray(A), k)
        host = HostBlockedMatrix(tall, cfg.n_blocks, stage_dtype=sd,
                                 device=resolve_device(device))
    return _streamed_svd(host, HostBlockedOperator, k, cfg, transposed,
                         warm=warm)


def _memmap_svd(A, k: int, cfg: SVDConfig, device, warm=None) -> SVDResult:
    """Disk tier: ``A`` is a ``.npy`` path, an ``np.memmap`` or a
    pre-built ``MemmapMatrix`` — blocks are staged disk -> host -> device
    under ``cfg.host_budget_bytes`` of host cache."""
    from repro_torch.core.diskio import MemmapMatrix, open_matrix_memmap
    from repro_torch.core.operator import MemmapOperator
    sd = resolve_sweep_dtype(cfg.sweep_dtype)
    if isinstance(A, MemmapMatrix):
        _injected(A, sd, device)
        host, transposed = A, False        # injected ops are already tall
    else:
        source = getattr(A, "filename", None)
        if isinstance(A, (str, os.PathLike)):
            source = os.fspath(A)
            A = open_matrix_memmap(A)
        tall, transposed = _tall_host(A, k, source=source)
        host = MemmapMatrix(tall, cfg.n_blocks, stage_dtype=sd,
                            host_budget_bytes=cfg.host_budget_bytes,
                            device=resolve_device(device))
    return _streamed_svd(host, MemmapOperator, k, cfg, transposed,
                         warm=warm)


#: dataset-file suffixes svd() accepts as path inputs
_PATH_SUFFIXES = (".npy", ".npz", ".mtx", ".mtx.gz")


def _sparsestream_svd(sp, k: int, cfg: SVDConfig, device,
                      op_cls=SparseStreamOperator, warm=None) -> SVDResult:
    """The solve on a streamed sparse matrix: the block driver over
    ``op_cls``, or the streamed deflation engine."""
    from repro_torch.core.sparse import _sparse_deflation
    # duck-typed streamed sources expose either .shape or (.m, .n)
    shape = getattr(sp, "shape", None)
    if shape is None:
        shape = (getattr(sp, "m", 1), getattr(sp, "n", 1))
    _validate_problem(shape, k)
    if cfg.method == "block":
        op = op_cls(sp, block_rows=cfg.block_rows,
                    sweep_dtype=cfg.sweep_dtype, device=device)
        # sparse never transposes in, so the seed is always the prev V
        return _run_block(op, k, cfg, warm=_pick_seed(warm, False))
    if cfg.method != "gramfree":
        raise ValueError("method='gram' is not available on the "
                         "sparse-streamed backend (the Gram matrix would "
                         "densify); expected 'gramfree' | 'block'")
    U, S, V, iters, passes = _sparse_deflation(
        sp, k, eps=cfg.eps, max_iters=cfg.max_iters,
        force_iters=cfg.force_iters, seed=cfg.seed,
        block_rows=cfg.block_rows, device=device)
    # deflation is always fp32; one source of truth for the pass size
    bpp = op_cls(sp, device=device).bytes_per_pass
    return SVDResult(U, S, V, np.asarray(iters), passes, bpp,
                     _deflation_converged(iters, cfg), op_cls.backend,
                     bytes_moved=None)  # the engine streams outside op


def _scipysparse_svd(sp, k: int, cfg: SVDConfig, device,
                     warm=None) -> SVDResult:
    """Real scipy CSR/COO/CSC input on the sparse stream."""
    from repro_torch.core.sparse import ScipySparseMatrix, ScipySparseOperator
    if not isinstance(sp, ScipySparseMatrix):
        sp = ScipySparseMatrix(sp, seed=cfg.seed)
    return _sparsestream_svd(sp, k, cfg, device,
                             op_cls=ScipySparseOperator, warm=warm)


def _path_svd(path, k: int, cfg: SVDConfig, device, warm=None) -> SVDResult:
    """Dispatch a dataset path: ``.npy`` -> the disk tier; scipy ``.npz``
    and MatrixMarket ``.mtx``/``.mtx.gz`` load onto the sparse stream."""
    import zipfile
    p = os.fspath(path)
    low = p.lower()
    if low.endswith(".npy"):
        return _memmap_svd(p, k, cfg, device, warm=warm)
    if low.endswith(".npz"):
        import scipy.sparse
        try:
            sp = scipy.sparse.load_npz(p)
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            raise InputError(
                f"{p!r} is not a readable scipy-sparse .npz "
                f"({type(e).__name__}: {e}); re-save it with "
                f"scipy.sparse.save_npz or point svd() at an intact "
                f"file") from e
        return _scipysparse_svd(sp, k, cfg, device, warm=warm)
    if low.endswith((".mtx", ".mtx.gz")):
        import scipy.io
        try:
            sp = scipy.io.mmread(p).tocsr()
        except (OSError, ValueError, EOFError) as e:
            raise InputError(
                f"{p!r} is not a readable MatrixMarket file "
                f"({type(e).__name__}: {e}); re-export it with "
                f"scipy.io.mmwrite or point svd() at an intact file"
            ) from e
        return _scipysparse_svd(sp, k, cfg, device, warm=warm)
    raise InputError(
        f"svd() path input must end in one of {_PATH_SUFFIXES}, got {p!r}")


def _operator_svd(op: LinearOperator, k: int, cfg: SVDConfig,
                  warm=None) -> SVDResult:
    if cfg.method != "block":
        raise ValueError("custom LinearOperator inputs run the shared "
                         "block driver; method must be 'block'")
    _validate_problem(op.shape, k)
    op_sd = getattr(op, "sweep_dtype", cfg.sweep_dtype)
    if resolve_sweep_dtype(op_sd) != resolve_sweep_dtype(cfg.sweep_dtype):
        raise ValueError(
            f"operator was built with sweep_dtype={op_sd!r} but the "
            f"config says {cfg.sweep_dtype!r}; rebuild one of them")
    return _run_block(op, k, cfg, warm=_pick_seed(warm, False))


# ---------------------------------------------------------------------------
# Front door
# ---------------------------------------------------------------------------

def svd(A, k: int, *, device=None, mesh=None, axes=("data",),
        config: SVDConfig | None = None, _warm=None,
        **overrides) -> SVDResult:
    """Truncated SVD of ``A`` to rank ``k`` — the port's entry point.

    * ``torch.Tensor``      -> dense solve on ``device`` (``None`` = the
      card; ``"cpu"`` runs the plain PyTorch versions): the block driver,
      or the deflation engine for ``method="gram"``/``"gramfree"``;
    * ``np.ndarray`` / ``HostBlockedMatrix`` -> out-of-core: the array
      stays in host memory, split into ``n_blocks`` row blocks streamed
      to ``device`` one at a time over a copy stream;
    * a ``.npy`` path, ``np.memmap`` / ``MemmapMatrix`` -> disk tier:
      row blocks staged disk -> host -> device, the host cache capped at
      ``host_budget_bytes``;
    * a ``scipy.sparse`` matrix, a ``ScipySparseMatrix`` or a
      ``.npz``/``.mtx``/``.mtx.gz`` path -> the sparse stream on real
      data; a ``SyntheticSparseMatrix`` (or any object with the streamed
      ``matmat``/``rmatmat``/``gram_chain``/``range_sketch`` surface)
      -> the sparse stream: row blocks packed on the host, swept on
      ``device`` by the CSR kernels;
    * a ``LinearOperator``  -> the shared block driver on it;
    * any matrix (a tensor, an ndarray or a row-sharded ``DTensor``) plus
      ``mesh=`` (a ``torch.distributed`` ``DeviceMesh``; every rank makes
      the call) -> row-sharded over ``axes`` of the mesh on the mesh's
      devices (the block method: one ``(n, k)`` all-reduce a step; the
      deflation methods: ``core/dist_svd.py``); the long-side factor
      comes back as a row-sharded ``DTensor``.

    ``checkpoint_dir`` saves the solver state there and resumes from it
    (the JAX package's format: either package resumes the other's).

    Solver knobs come from ``config`` and/or keyword ``overrides``, as in
    the JAX package's ``svd``.  Returns an ``SVDResult``.
    """
    t0 = time.perf_counter()
    res = _dispatch(A, k, device=device, mesh=mesh, axes=axes,
                    config=config, _warm=_warm, **overrides)
    return res._replace(wall_time_s=time.perf_counter() - t0)


def _dispatch(A, k: int, *, device=None, mesh=None, axes=("data",),
              config: SVDConfig | None = None, _warm=None,
              **overrides) -> SVDResult:
    cfg = config if config is not None else SVDConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    if _warm is not None and cfg.method != "block":
        raise ValueError("warm restarts (svd_update) seed the block "
                         "iterate; method must be 'block'")
    if mesh is not None:
        return _sharded_svd(A, k, mesh, tuple(axes), cfg, device,
                            warm=_warm)
    if isinstance(A, LinearOperator):
        return _operator_svd(A, k, cfg, warm=_warm)
    if isinstance(A, torch.Tensor):
        return _dense_svd(A, k, cfg, resolve_device(device), warm=_warm)
    if isinstance(A, (str, os.PathLike)):
        return _path_svd(A, k, cfg, device, warm=_warm)
    if _is_scipy_sparse(A):
        return _scipysparse_svd(A, k, cfg, device, warm=_warm)
    # np.memmap subclasses np.ndarray and MemmapMatrix subclasses
    # HostBlockedMatrix: the disk-tier checks must come FIRST
    from repro_torch.core.diskio import MemmapMatrix
    from repro_torch.core.oom import HostBlockedMatrix
    if isinstance(A, (np.memmap, MemmapMatrix)):
        return _memmap_svd(A, k, cfg, device, warm=_warm)
    if isinstance(A, (np.ndarray, HostBlockedMatrix)):
        return _hostblocked_svd(A, k, cfg, device, warm=_warm)
    from repro_torch.core.sparse import ScipySparseMatrix
    if isinstance(A, ScipySparseMatrix):
        return _scipysparse_svd(A, k, cfg, device, warm=_warm)
    if all(hasattr(A, attr) for attr in
           ("matmat", "rmatmat", "gram_chain", "range_sketch")):
        return _sparsestream_svd(A, k, cfg, device, warm=_warm)
    raise InputError(
        f"svd() cannot dispatch on input of type {type(A).__name__}: "
        "expected a torch.Tensor (dense solve), a numpy array or "
        "HostBlockedMatrix (host-blocked tier), a .npy/.npz/.mtx path, "
        "np.memmap or MemmapMatrix (disk tier), a scipy.sparse matrix or "
        "streamed sparse operator, or a LinearOperator")


def svd_update(prev, A, k: int | None = None, *, device=None, mesh=None,
               axes=("data",), config: SVDConfig | None = None,
               **overrides) -> SVDResult:
    """Re-decompose a perturbed ``A`` warm-started from a previous solve:
    ``prev`` is an ``SVDResult`` or a ``SolverState`` (for instance one
    loaded with ``SolverState.from_tree`` from either package).  ``k``
    defaults to the previous rank; everything else works as in ``svd``."""
    def to_np(X):
        if isinstance(X, torch.Tensor):
            # a sharded factor (DTensor) is gathered: every rank calls this
            X = getattr(X, "full_tensor", lambda: X)().detach().cpu()
        return np.asarray(X, np.float32)

    if isinstance(prev, SolverState):
        Q = to_np(prev.Q)
        warm = (Q, Q)     # the iterate is already the tall right side
        if k is None:
            k = int(prev.k)
    elif isinstance(prev, SVDResult):
        warm = (to_np(prev.U), to_np(prev.V))
        if k is None:
            k = int(prev.S.shape[0])
    else:
        raise TypeError(
            f"svd_update() seeds from a previous SVDResult or "
            f"SolverState, got {type(prev).__name__}")
    return svd(A, k, device=device, mesh=mesh, axes=axes, config=config,
               _warm=warm, **overrides)


def _is_scipy_sparse(A) -> bool:
    """True iff ``A`` is a scipy sparse matrix/array (scipy optional)."""
    try:
        import scipy.sparse
    except ImportError:  # pragma: no cover - scipy is optional
        return False
    return scipy.sparse.issparse(A)
