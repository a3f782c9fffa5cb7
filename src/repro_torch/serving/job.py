"""Job model for SVD-as-a-service: spec, status machine, streaming
(PyTorch port of the JAX package's ``repro/serving/job.py``: the same
names, states, edges and 4xx/5xx split).

A served decomposition is a ``JobSpec`` (what to factorize, to what
rank, under which ``SVDConfig``, how urgently) tracked through the
``JobStatus`` state machine::

    QUEUED --> ADMITTED --> RUNNING --> STREAMING --> DONE
       |           |           |            |-------> FAILED
       |           |           |----------------same
       |-----------+--------------------------------> CANCELLED

``STREAMING`` is ``RUNNING`` after the first partial result went out
(block Rayleigh–Ritz refines all k triplets every sweep, so leading
triplets are available long before convergence).  The FAILED boundary
reuses the engine's typed error split: ``InputError`` (a bad request —
the HTTP-4xx class) vs any other ``SVDError`` (an infrastructure/
numeric fault — the 5xx class), and a failed job carries the engine's
``FaultTelemetry`` snapshot so the report says *why* (retries burned,
demotions taken, health rollbacks) without re-running the solve.

This module is pure bookkeeping — no asyncio, no torch — so the queue,
batcher, and runner layers all share it without import cycles.
"""
from __future__ import annotations

import enum
import itertools
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, NamedTuple

from repro_torch.core.config import SVDConfig
from repro_torch.core.errors import InputError, SVDError

__all__ = [
    "JobStatus", "VALID_TRANSITIONS", "JobSpec", "PartialResult", "Job",
    "JobCancelled", "DeadlineExceeded", "classify_error",
]


class JobStatus(enum.Enum):
    QUEUED = "queued"          # accepted by submit(), waiting in the heap
    ADMITTED = "admitted"      # passed priority + byte-budget admission
    RUNNING = "running"        # a runner/batcher thread owns the solve
    STREAMING = "streaming"    # running, >= 1 partial result delivered
    DONE = "done"              # SVDResult available
    FAILED = "failed"          # typed error available (4xx/5xx split)
    CANCELLED = "cancelled"    # cancelled before or during the solve

    @property
    def terminal(self) -> bool:
        return self in (JobStatus.DONE, JobStatus.FAILED,
                        JobStatus.CANCELLED)


#: the legal edges of the lifecycle; ``Job._transition`` enforces them
#: so a scheduler bug surfaces as a loud typed error, not a job stuck
#: half-reported in two states
VALID_TRANSITIONS: dict[JobStatus, tuple[JobStatus, ...]] = {
    JobStatus.QUEUED: (JobStatus.ADMITTED, JobStatus.CANCELLED,
                       JobStatus.FAILED),
    JobStatus.ADMITTED: (JobStatus.RUNNING, JobStatus.CANCELLED,
                         JobStatus.FAILED),
    JobStatus.RUNNING: (JobStatus.STREAMING, JobStatus.DONE,
                        JobStatus.FAILED, JobStatus.CANCELLED),
    JobStatus.STREAMING: (JobStatus.DONE, JobStatus.FAILED,
                          JobStatus.CANCELLED),
    JobStatus.DONE: (),
    JobStatus.FAILED: (),
    JobStatus.CANCELLED: (),
}


class JobCancelled(Exception):
    """Raised inside a runner's iteration hook to abort a cancelled job
    (internal control flow — never surfaces to the client, who sees
    ``JobStatus.CANCELLED``)."""


class DeadlineExceeded(SVDError):
    """The job's deadline passed before it finished (at admission or
    mid-solve).  An ``SVDError`` so the 4xx/5xx classifier files it as
    a service-side failure, with the deadline recorded on the job."""


@dataclass(frozen=True)
class JobSpec:
    """What to solve and how urgently — immutable, hashable by id.

    ``input``         anything ``repro_torch.svd()`` dispatches on: a
                      torch tensor or numpy array, a ``.npy``/``.npz``/``.mtx``
                      path, an ``np.memmap``, a scipy sparse matrix, a
                      pre-built matrix/operator.
    ``k``             target rank.
    ``config``        the solver ``SVDConfig`` (defaults apply if None).
    ``priority``      larger runs first among queued jobs (FIFO within
                      a priority level).
    ``deadline_s``    optional wall-clock budget in seconds from
                      submission; a job that cannot finish in time FAILS
                      with ``DeadlineExceeded`` (checked at admission
                      and between iterations on streamed jobs).
    ``stream_every``  push a ``PartialResult`` (leading triplets + the
                      current subspace gap) every this-many block
                      iterations; 0 disables streaming.  Requires
                      ``method='block'``.
    ``tag``           free-form client label, echoed in cost records.
    """

    input: Any
    k: int
    config: SVDConfig | None = None
    priority: int = 0
    deadline_s: float | None = None
    stream_every: int = 0
    tag: str = ""

    def resolved_config(self) -> SVDConfig:
        return self.config if self.config is not None else SVDConfig()


class PartialResult(NamedTuple):
    """One streamed snapshot of a running solve.

    The factors are Rayleigh–Ritz extractions from the CURRENT iterate
    (one extra pass over A each — metered separately, never billed to
    the solver's own pass accounting), truncated to the leading ``k``
    triplets; ``gap`` is the latest synced subspace gap, the solver's
    own convergence measure, so subscribers can stop listening the
    moment it is good enough for them.  The factors are host copies
    (numpy arrays), so a subscriber's thread never holds device memory.
    """

    job_id: str
    it: int              # block iterations completed when extracted
    gap: float | None    # synced subspace gap (None before first sync)
    S: Any               # (k,) current leading singular values
    U: Any               # (m, k) current left factors
    V: Any               # (n, k) current right factors


_PARTIAL_SENTINEL = object()
_seq = itertools.count()


@dataclass
class Job:
    """One submitted job's mutable service-side record.

    All mutation goes through ``_transition``/``mark_*`` under the
    job's own lock; readers (`status`, `result(...)`) are safe from any
    thread.  Partials land in a thread-safe queue consumed by
    ``stream()`` so a subscriber never races the runner.
    """

    spec: JobSpec
    job_id: str = ""
    submitted_at: float = field(default_factory=time.monotonic)
    admitted_at: float | None = None
    started_at: float | None = None
    finished_at: float | None = None
    cost_bytes: int = 0

    def __post_init__(self):
        if not self.job_id:
            self.job_id = f"job-{next(_seq):06d}"
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._cancel = threading.Event()
        self._status = JobStatus.QUEUED
        self._partials: _queue.Queue = _queue.Queue()
        self.partial_count = 0
        self.result = None           # SVDResult when DONE
        self.error: BaseException | None = None
        self.error_kind: str | None = None   # "input" (4xx) | "internal"
        self.faults: Any = None      # FaultTelemetry snapshot on FAILED
        #: the port's kernel launches of this job's solve, by kernel and
        #: by route (``kernels/ops.thread_launches``; none on the CPU)
        self.launches: dict[str, int] = {}

    # -- state machine ------------------------------------------------------

    @property
    def status(self) -> JobStatus:
        return self._status

    def _transition(self, new: JobStatus) -> None:
        with self._lock:
            if new not in VALID_TRANSITIONS[self._status]:
                raise RuntimeError(
                    f"{self.job_id}: illegal transition "
                    f"{self._status.value} -> {new.value}")
            self._status = new
            if new is JobStatus.ADMITTED:
                self.admitted_at = time.monotonic()
            elif new is JobStatus.RUNNING:
                self.started_at = time.monotonic()
            if new.terminal:
                self.finished_at = time.monotonic()
        if new.terminal:
            self._partials.put(_PARTIAL_SENTINEL)
            self._done.set()

    def mark_admitted(self) -> None:
        self._transition(JobStatus.ADMITTED)

    def mark_running(self) -> None:
        self._transition(JobStatus.RUNNING)

    def mark_done(self, result) -> None:
        self.result = result
        self._transition(JobStatus.DONE)

    def mark_failed(self, exc: BaseException) -> None:
        self.error = exc
        self.error_kind = classify_error(exc)
        self.faults = getattr(exc, "faults", None)
        self._transition(JobStatus.FAILED)

    def mark_cancelled(self) -> None:
        self._transition(JobStatus.CANCELLED)

    # -- cancellation / deadline -------------------------------------------

    def cancel(self) -> bool:
        """Request cancellation.  Queued/admitted jobs are dropped by
        the scheduler; running streamed jobs abort at their next
        iteration hook.  Returns False if the job already finished."""
        with self._lock:
            if self._status.terminal:
                return False
        self._cancel.set()
        return True

    @property
    def cancel_requested(self) -> bool:
        return self._cancel.is_set()

    def deadline_passed(self, now: float | None = None) -> bool:
        if self.spec.deadline_s is None:
            return False
        now = time.monotonic() if now is None else now
        return (now - self.submitted_at) > self.spec.deadline_s

    # -- results ------------------------------------------------------------

    def wait(self, timeout: float | None = None) -> JobStatus:
        self._done.wait(timeout)
        return self._status

    def push_partial(self, partial: PartialResult) -> None:
        if self._status is JobStatus.RUNNING:
            self._transition(JobStatus.STREAMING)
        self.partial_count += 1
        self._partials.put(partial)

    def stream(self, timeout: float | None = None):
        """Yield ``PartialResult``s until the job reaches a terminal
        state (blocking; per-item ``timeout`` raises ``queue.Empty``)."""
        while True:
            item = self._partials.get(timeout=timeout)
            if item is _PARTIAL_SENTINEL:
                # propagate for any concurrent/late subscriber
                self._partials.put(_PARTIAL_SENTINEL)
                return
            yield item


def classify_error(exc: BaseException) -> str:
    """The service's 4xx-vs-5xx boundary, directly off the engine's
    typed hierarchy: ``InputError`` means the CLIENT posed an impossible
    problem (bad shape/rank/file — "input"); any other ``SVDError`` (or
    unexpected exception, ``torch.cuda.OutOfMemoryError`` under
    ``demote_on_oom=False`` among them) is the SERVICE failing to
    complete a valid request ("internal")."""
    return "input" if isinstance(exc, InputError) else "internal"
