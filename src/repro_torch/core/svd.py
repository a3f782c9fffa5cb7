"""The SVD front door and the block driver (PyTorch port).

The counterpart of the JAX package's ``repro/core/svd.py`` for the
dense in-memory path: ``svd(A, k)`` on a ``torch.Tensor`` runs the same
three-phase state machine over a ``SolverState`` —

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
package's exactly.

Entry points run on the card: ``device=None`` means ``"cuda"`` and
raises when no card is visible; the caller passes ``device="cpu"`` to
run the plain PyTorch versions of the kernels on the CPU.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md queue-1 item: numpy inputs (the host-blocked tier), paths and
``np.memmap`` (the disk tier), scipy sparse inputs, ``mesh=`` (the
sharded backend), the deflation methods ``"gram"``/``"gramfree"``, and
``checkpoint_dir`` (checkpoint/resume).
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from repro_torch.core.config import SolverState, SVDConfig, SVDResult
from repro_torch.core.errors import (FaultExhaustedError, InputError,
                                     NumericalHealthError, SVDError,
                                     is_oom_error)
from repro_torch.core.faults import (FaultTelemetry, RetryPolicy, fault_hook,
                                     maybe_corrupt)
from repro_torch.core.operator import (DenseOperator, LinearOperator,
                                       host_sync_scalar, resolve_device,
                                       warm_start_width)
from repro_torch.core.precision import resolve_sweep_dtype

__all__ = ["svd", "svd_update", "init_state", "step", "finalize",
           "SolverState", "SVDConfig", "SVDResult"]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, queue 1, "
        f"item {item}); use the JAX package (repro.core.svd) for it, or "
        f"pass a torch.Tensor for the dense solve")


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
    """Phase 1: the initial iterate — a caller-supplied host seed
    subspace ``warm`` (aligned to the operator, then ``cfg.warmup_q``
    refinements), the randomized range-finder sketch (``warmup_q > 0``),
    or a cold Gaussian block."""
    if cfg.checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir (checkpoint/resume)", "9")
    cfp = cfg.solver_fingerprint()
    ofp = op.fingerprint
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


def _drive(op: LinearOperator, k: int, cfg: SVDConfig, warm,
           telemetry: FaultTelemetry, carried: SolverState | None,
           cell: dict) -> SVDResult:
    """One tier's worth of the solve loop: init (or adopt the iterate
    carried down from a demoted tier), iterate with the numeric health
    guard, finalize.  A ``NumericalHealthError`` rolls the loop back to
    the last CONFIRMED-healthy state; the sweeps are deterministic, so a
    transient corruption replays onto the bitwise fault-free trajectory.
    """
    if carried is not None:
        state = carried.replace(Q=op.from_host(carried.Q),
                                op_fp=op.fingerprint)
    else:
        state = init_state(op, k, cfg, warm=warm, telemetry=telemetry)
    cell["state"] = state
    good = state                        # last confirmed-healthy state
    health_attempts = 0
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
        fault_hook("kill", telemetry)   # chaos: die after an iteration
        if cfg.on_iteration is not None:
            if getattr(cfg.on_iteration, "_wants_operator", False):
                cfg.on_iteration(state, op)
            else:
                cfg.on_iteration(state)
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
    memory tier and carries the warm iterate there.  ``DenseOperator``
    has no lower tier in this port yet (the host-blocked tier is
    ROADMAP.md, queue 1, item 4), so on it an OOM ends the solve with
    ``FaultExhaustedError`` whose ``__cause__`` is the OOM.
    """
    telemetry = FaultTelemetry()
    policy = RetryPolicy(max_attempts=cfg.io_retries,
                         base_delay=cfg.io_retry_backoff)
    carried = None
    op.acquire_solve()
    try:
        while True:
            op.reset_counters()
            op.set_resilience(telemetry, policy)
            cell: dict = {"state": None}
            try:
                res = _drive(op, k, cfg, warm, telemetry, carried, cell)
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
    """The dense block solve of a tensor on ``device``.  A wide input is
    handed to the operator as the transposed view ``A.mT`` — no copy;
    the operator swaps the two kernels — and the factors swap back."""
    A = A.to(device=device, dtype=torch.float32)
    if A.ndim != 2:
        raise InputError(f"svd() takes a 2-D matrix, got shape "
                         f"{tuple(A.shape)}")
    m, n = A.shape
    _validate_problem((m, n), k)
    bpp = m * n * resolve_sweep_dtype(cfg.sweep_dtype).itemsize
    tall = m >= n
    X = A if tall else A.mT
    op = DenseOperator(X, device=device, sweep_dtype=cfg.sweep_dtype)
    res = _run_block(op, k, cfg, warm=_pick_seed(warm, not tall))
    if not tall:
        res = res._replace(U=res.V, V=res.U)
    return res._replace(bytes_per_pass=bpp)


def _operator_svd(op: LinearOperator, k: int, cfg: SVDConfig,
                  warm=None) -> SVDResult:
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

    * ``torch.Tensor``      -> dense block solve on ``device``
      (``None`` = the card; ``"cpu"`` runs the plain PyTorch versions);
    * a ``LinearOperator``  -> the shared block driver on it;
    * numpy arrays, paths, ``np.memmap``, scipy sparse inputs, ``mesh=``
      and the deflation methods raise ``NotImplementedError`` naming the
      ROADMAP.md item that ports them.

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
    if cfg.method != "block":
        raise _not_ported(f"method={cfg.method!r} (rank-one deflation)",
                          "6")
    if cfg.checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir (checkpoint/resume)", "9")
    if mesh is not None:
        raise _not_ported("mesh= (the sharded backend)", "8")
    if isinstance(A, LinearOperator):
        return _operator_svd(A, k, cfg, warm=_warm)
    if isinstance(A, torch.Tensor):
        return _dense_svd(A, k, cfg, resolve_device(device), warm=_warm)
    if isinstance(A, (str, os.PathLike, np.memmap)):
        raise _not_ported("a dataset path or np.memmap (the disk tier)",
                          "5")
    if isinstance(A, np.ndarray):
        raise _not_ported("a numpy array (the out-of-core host-blocked "
                          "tier)", "4")
    if _is_scipy_sparse(A):
        raise _not_ported("a scipy.sparse matrix (the sparse stream)", "7")
    raise InputError(
        f"svd() cannot dispatch on input of type {type(A).__name__}: "
        "expected a torch.Tensor (dense solve) or a LinearOperator")


def svd_update(prev, A, k: int | None = None, *, device=None, mesh=None,
               axes=("data",), config: SVDConfig | None = None,
               **overrides) -> SVDResult:
    """Re-decompose a perturbed ``A`` warm-started from a previous solve:
    ``prev`` is an ``SVDResult`` or a ``SolverState`` (for instance one
    loaded with ``SolverState.from_tree`` from either package).  ``k``
    defaults to the previous rank; everything else works as in ``svd``."""
    to_np = lambda X: np.asarray(
        X.detach().cpu() if isinstance(X, torch.Tensor) else X, np.float32)
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
