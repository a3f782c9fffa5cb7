"""Deterministic fault injection + the retry/telemetry layer under it.

The PyTorch port of the JAX package's ``repro/core/faults.py``: the
same sites, schedule semantics and telemetry, so a ``FaultPlan``
replays identically in both packages.

Long streamed solves die to transient faults — a disk read returning
EIO, a flaky H2D copy, a bf16 sweep overflowing to Inf, the device
allocator running dry — and a fault that only shows up at hour six is
untestable unless it can be *scheduled*.  This module provides both
halves of that story:

* **Injection** — a ``FaultPlan`` is a set of ``FaultSpec``s, each
  naming an injection *site* and which arrivals at that site should
  fault.  ``inject_faults(plan)`` activates the plan for a ``with``
  block; the instrumented code paths call ``fault_hook(site)`` (or
  ``maybe_corrupt(site, Z)``) at the real operation and the plan
  decides, deterministically, whether THIS arrival fails.  No
  randomness, no monkeypatching: the schedule is the test.

* **Recovery plumbing** — ``retry_io`` wraps the genuinely transient
  hops (disk read, H2D copy) in bounded exponential backoff with
  deterministic jitter; ``FaultTelemetry`` accumulates every injected
  fault, retry, giveup, rollback, demotion and quarantine into the
  ``SVDResult.faults`` dict so a recovered solve *reports* what it
  survived instead of hiding it.

Injection sites (the ``site`` strings a ``FaultSpec`` may name):

===================  ======================================================
``disk_read``        ``MemmapMatrix.host_block``: the memmap -> host read.
                     Arrival = one block read attempt.  Raises
                     ``TransientIOFault`` (an ``OSError``); retried.
``h2d``              the host -> device block copy (``HostBlockedMatrix
                     .block`` / ``MemmapMatrix.block``).  Raises
                     ``H2DCopyFault``; retried.
``sweep``            NaN-corrupts the output of one ``gram_chain`` sweep
                     inside ``core/svd.py::step`` (via ``maybe_corrupt``)
                     — the bf16-overflow drill the health guard catches.
``device_oom``       raises ``DeviceOOMFault`` (RESOURCE_EXHAUSTED) at
                     step dispatch; caught by the tier-demotion ladder.
                     Arrival = one ``step()`` call.
``kill``             kills the driver loop after a completed iteration
                     (arrival = one completed iteration, counted after
                     the checkpoint write).  ``mode="raise"`` raises
                     ``KilledFault`` in-process; ``mode="exit"`` calls
                     ``os._exit(spec.exit_code)`` — the real thing, for
                     the two-process smoke.
``checkpoint_write``  fires inside ``CheckpointManager.save`` after the
                     tmp dir is fully written but BEFORE the atomic
                     publish — the classic torn-write window.  Same
                     ``mode`` semantics as ``kill``.
===================  ======================================================

Determinism contract: a plan's arrival counters advance exactly with
the instrumented operations, so the same (matrix, config, plan) triple
replays the same faults at the same points — the chaos suite asserts
recovered sigmas against the fault-free run, which only means anything
because the schedule is exact.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import time

import numpy as np

import torch

from repro_torch.core.errors import (DeviceOOMFault, FaultExhaustedError,
                                     H2DCopyFault, KilledFault,
                                     TransientIOFault, is_oom_error)

__all__ = [
    "FaultSpec",
    "FaultPlan",
    "inject_faults",
    "active_plan",
    "fault_hook",
    "maybe_corrupt",
    "FaultTelemetry",
    "RetryPolicy",
    "DEFAULT_RETRY_POLICY",
    "retry_io",
    "is_oom_error",
]

#: the injection sites fault_hook()/maybe_corrupt() instrument
SITES = ("disk_read", "h2d", "sweep", "device_oom", "kill",
         "checkpoint_write")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: arrivals ``[at, at + count)`` at ``site``
    fail.  Arrival indices are 0-based and site-wide (shared by every
    spec naming the same site), counting the real operations as
    documented in the site table above — so ``count >= max_attempts``
    turns a transient fault into a permanent one.

    ``mode`` applies to the kill-style sites: ``"raise"`` raises
    ``KilledFault`` (recoverable in-process, for the suite),
    ``"exit"`` calls ``os._exit(exit_code)`` (the two-process smoke).
    """

    site: str
    at: int = 0
    count: int = 1
    mode: str = "raise"
    exit_code: int = 17

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"expected one of {SITES}")
        if self.at < 0 or self.count < 1:
            raise ValueError(f"need at >= 0 and count >= 1, got "
                             f"at={self.at} count={self.count}")
        if self.mode not in ("raise", "exit"):
            raise ValueError(f"mode must be 'raise' or 'exit', "
                             f"got {self.mode!r}")


class FaultPlan:
    """A deterministic fault schedule: specs + per-site arrival counters.

    Mutable on purpose — the counters ARE the schedule's progress.  Use
    a fresh plan per experiment; ``arrivals`` exposes the counters for
    post-mortem assertions.
    """

    def __init__(self, *specs):
        flat: list[FaultSpec] = []
        for s in specs:          # varargs OR a single iterable of specs
            if isinstance(s, FaultSpec):
                flat.append(s)
            else:
                flat.extend(s)
        for s in flat:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"FaultPlan takes FaultSpecs, got "
                                f"{type(s).__name__}")
        self.specs = tuple(flat)
        self.arrivals: dict[str, int] = {}

    def arrive(self, site: str) -> FaultSpec | None:
        """Count one arrival at ``site``; the spec scheduled for this
        arrival, or None for a clean pass-through."""
        i = self.arrivals.get(site, 0)
        self.arrivals[site] = i + 1
        for spec in self.specs:
            if spec.site == site and spec.at <= i < spec.at + spec.count:
                return spec
        return None

    def __repr__(self):
        return f"FaultPlan({', '.join(map(repr, self.specs))})"


_ACTIVE: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


@contextlib.contextmanager
def inject_faults(plan: FaultPlan):
    """Activate ``plan`` for the duration of the ``with`` block (one
    plan at a time; nesting restores the outer plan on exit)."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fault_hook(site: str, telemetry: "FaultTelemetry | None" = None):
    """Injection point: called by instrumented code at the real
    operation.  No active plan (production) = a dict lookup and out."""
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan.arrive(site)
    if spec is None:
        return
    if telemetry is not None:
        telemetry.record(site, "injected")
    if site == "disk_read":
        raise TransientIOFault(f"injected transient disk read error "
                               f"(arrival {plan.arrivals[site] - 1})")
    if site == "h2d":
        raise H2DCopyFault(f"injected H2D copy failure "
                           f"(arrival {plan.arrivals[site] - 1})")
    if site == "device_oom":
        raise DeviceOOMFault("injected on step dispatch")
    # kill-style sites: checkpoint_write and kill
    if spec.mode == "exit":
        os._exit(spec.exit_code)
    raise KilledFault(f"injected kill at site {site!r} "
                      f"(arrival {plan.arrivals[site] - 1})")


def maybe_corrupt(site: str, Z, telemetry: "FaultTelemetry | None" = None):
    """Corruption-style injection: returns ``Z`` with a NaN planted when
    the plan schedules this arrival, ``Z`` unchanged otherwise.  Works
    on numpy arrays and torch tensors (the sweep output's namespace
    varies by backend); the input is never modified in place."""
    plan = _ACTIVE
    if plan is None:
        return Z
    spec = plan.arrive(site)
    if spec is None:
        return Z
    if telemetry is not None:
        telemetry.record(site, "injected")
    if isinstance(Z, np.ndarray):
        Z = Z.copy()
        Z[0, 0] = np.nan
        return Z
    Z = torch.clone(Z)
    Z[0, 0] = float("nan")
    return Z


# ---------------------------------------------------------------------------
# Telemetry: what the solve survived, reported in SVDResult.faults
# ---------------------------------------------------------------------------

class FaultTelemetry:
    """Per-solve fault/recovery ledger.

    ``counters`` maps ``"<site>.<action>"`` to a count; ``events`` keeps
    the ordered detail records.  Actions: ``injected`` (the harness
    fired), ``retry`` (one backoff retry of a transient op), ``giveup``
    (retry budget exhausted), ``rollback`` (health guard rolled the
    iterate back), ``reorth`` (health guard re-orthonormalized in
    place), ``demote`` (OOM tier demotion), ``quarantine`` (corrupt
    checkpoint moved aside), ``discarded`` (passes/bytes of work thrown
    away by a rollback — the "modulo retried work" of the accounting
    contract, so conservation stays auditable).
    """

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.events: list[dict] = []

    def record(self, site: str, action: str, **info):
        key = f"{site}.{action}"
        self.counters[key] = self.counters.get(key, 0) + 1
        self.events.append({"site": site, "action": action, **info})

    def snapshot(self) -> dict:
        """The ``SVDResult.faults`` payload: plain dicts, json-safe."""
        return {"counters": dict(self.counters),
                "events": [dict(e) for e in self.events]}


class _NullTelemetry(FaultTelemetry):
    def record(self, site, action, **info):
        pass


_NULL = _NullTelemetry()


# ---------------------------------------------------------------------------
# Bounded exponential backoff with deterministic jitter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget for transient I/O.

    ``max_attempts`` is the TOTAL number of tries (1 = no retry).
    Backoff before retry ``a`` (1-based) is ``base_delay * 2**(a-1)``
    capped at ``max_delay``, scaled into ``[0.5, 1.0)`` by a jitter
    that is a pure hash of ``(site, a)`` — deterministic, so two runs
    of the same plan sleep the same schedule, but de-synchronized
    across sites, which is what jitter is for.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0

    def delay(self, attempt: int, site: str = "") -> float:
        d = min(self.max_delay, self.base_delay * (2.0 ** (attempt - 1)))
        h = hashlib.blake2b(f"{site}:{attempt}".encode(),
                            digest_size=4).digest()
        frac = int.from_bytes(h, "big") / 2**32
        return d * (0.5 + 0.5 * frac)


DEFAULT_RETRY_POLICY = RetryPolicy()


def retry_io(fn, *, site: str, policy: RetryPolicy | None = None,
             telemetry: FaultTelemetry | None = None,
             retryable=(OSError,)):
    """Run ``fn()`` under the retry policy; the one transient-I/O retry
    loop in the repo.

    Only ``retryable`` exceptions are retried, and an OOM-classified
    error re-raises immediately even when it arrives dressed as a
    retryable type — demotion, not repetition, is the fix for memory
    pressure.  Exhaustion raises ``FaultExhaustedError`` with the last
    failure as ``__cause__``.
    """
    pol = policy if policy is not None else DEFAULT_RETRY_POLICY
    tel = telemetry if telemetry is not None else _NULL
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except retryable as e:
            if is_oom_error(e):
                raise
            if attempt >= pol.max_attempts:
                tel.record(site, "giveup", attempts=attempt,
                           error=type(e).__name__)
                raise FaultExhaustedError(
                    f"{site}: transient I/O still failing after "
                    f"{attempt} attempt(s) ({type(e).__name__}: {e}); "
                    f"raise SVDConfig.io_retries or fix the storage "
                    f"path") from e
            tel.record(site, "retry", attempt=attempt,
                       error=type(e).__name__)
            time.sleep(pol.delay(attempt, site))
