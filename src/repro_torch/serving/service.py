"""``SVDService``: the persistent serving process (PyTorch port of the
JAX package's ``repro/serving/service.py``).

One process, three moving parts:

* an **asyncio scheduler loop** on a dedicated thread — the single
  writer of admission state.  It pops jobs off the priority heap
  (``queue.AdmissionQueue``), applies byte-budget backpressure
  (``queue.ByteBudget``), and routes each admitted job either into the
  micro-batcher window or straight to a worker;
* a **micro-batcher window** — admitted small same-key jobs wait up to
  ``batch_window_s`` (or until ``max_batch``) to be stacked into one
  batched dispatch (``batcher.solve_batch``); a flush holding a single
  job falls back to the sequential runner;
* a **worker pool** (``ThreadPoolExecutor``) running the actual solves
  (``runner.run_job``/``run_batch``) on the service's device.  On the
  card each worker runs under ``torch.cuda.device`` (the current device
  is per thread) and launches on the device's default stream, so jobs
  interleave at launch granularity and their results do not change;
  the kernels' ctypes calls and torch's release the GIL, the first-use
  kernel builds are serialized by ``kernels/build.py``, the pinned
  registrations by ``core/staging.py`` and the launch counts by
  ``kernels/ops.py``; every other piece of a solve's state lives on its
  own operator.

The device follows the port's entry-point rule: ``device=None`` means
the card and raises at construction when no CUDA device is visible;
``device="cpu"`` runs every job on the plain PyTorch versions.  The
byte budget is the JAX package's estimate (``queue.estimate_cost_bytes``),
not a device reading.

Clients stay synchronous: ``submit()`` returns a ``JobHandle`` usable
from any thread (``result()``, ``stream()``, ``cancel()``); nothing in
the public surface requires the caller to own an event loop.
"""
from __future__ import annotations

import asyncio
import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import torch

from repro_torch.core.config import SVDConfig
from repro_torch.core.operator import resolve_device
from repro_torch.serving.batcher import batch_key, batchable
from repro_torch.serving.job import (DeadlineExceeded, Job, JobCancelled,
                                     JobSpec, JobStatus)
from repro_torch.serving.metering import CostRecord, Meter
from repro_torch.serving.queue import AdmissionQueue, ByteBudget, \
    estimate_cost_bytes
from repro_torch.serving.runner import run_batch, run_job

__all__ = ["SVDService", "JobHandle"]

#: default admission budget: enough for a handful of mid-sized jobs,
#: small enough that a burst of large ones actually queues
DEFAULT_BYTE_BUDGET = 1 << 30


class JobHandle:
    """Client-side view of one submitted job (thread-safe)."""

    def __init__(self, job: Job):
        self._job = job

    @property
    def job_id(self) -> str:
        return self._job.job_id

    @property
    def status(self) -> JobStatus:
        return self._job.status

    @property
    def partial_count(self) -> int:
        return self._job.partial_count

    @property
    def error(self) -> BaseException | None:
        return self._job.error

    @property
    def error_kind(self) -> str | None:
        """``"input"`` (the 4xx class) or ``"internal"`` (5xx)."""
        return self._job.error_kind

    @property
    def faults(self) -> Any:
        """Engine fault telemetry for FAILED jobs (None otherwise)."""
        return self._job.faults

    def cancel(self) -> bool:
        return self._job.cancel()

    def wait(self, timeout: float | None = None) -> JobStatus:
        return self._job.wait(timeout)

    def result(self, timeout: float | None = None):
        """Block for the ``SVDResult``.  Raises the job's typed error on
        FAILED, ``JobCancelled`` on CANCELLED, ``TimeoutError`` if the
        job is still live after ``timeout``."""
        status = self._job.wait(timeout)
        if status is JobStatus.DONE:
            return self._job.result
        if status is JobStatus.FAILED:
            raise self._job.error
        if status is JobStatus.CANCELLED:
            raise JobCancelled(self._job.job_id)
        raise TimeoutError(
            f"{self._job.job_id} still {status.value} after {timeout}s")

    def stream(self, timeout: float | None = None):
        """Iterate streamed ``PartialResult``s until the job ends."""
        return self._job.stream(timeout=timeout)


class SVDService:
    """The serving front door: submit many ``svd()`` jobs, get handles.

    ::

        with SVDService(max_workers=4) as svc:
            handles = [svc.submit(A_i, k=8) for A_i in burst]
            big = svc.submit("big.npy", k=32, stream_every=1)
            for partial in big.stream():
                ...                      # leading triplets, early
            results = [h.result() for h in handles]
        print(svc.metrics())

    Parameters: ``max_workers`` solve threads; ``byte_budget`` bytes of
    admitted working set allowed in flight (backpressure);
    ``batch_window_s``/``max_batch`` the micro-batcher's flush knobs;
    ``checkpoint_root`` per-job checkpoint directories for resumable
    jobs; ``device`` where every job runs (``None`` = the card, raising
    here without one; ``"cpu"`` the plain PyTorch versions).
    """

    def __init__(self, *, max_workers: int = 2,
                 byte_budget: int = DEFAULT_BYTE_BUDGET,
                 batch_window_s: float = 0.01, max_batch: int = 16,
                 checkpoint_root: str | None = None, device=None):
        self.device = resolve_device(device)
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._max_workers = max_workers
        self._byte_budget = int(byte_budget)
        self._batch_window_s = float(batch_window_s)
        self._max_batch = int(max_batch)
        self._checkpoint_root = checkpoint_root
        self.meter = Meter()
        self._jobs: dict[str, Job] = {}
        self._started = False
        self._closed = False
        self._lock = threading.Lock()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "SVDService":
        with self._lock:
            if self._started:
                return self
            self._started = True
        self._pool = ThreadPoolExecutor(
            max_workers=self._max_workers,
            thread_name_prefix="svd-runner")
        self._loop = asyncio.new_event_loop()
        ready = threading.Event()

        def _loop_main():
            asyncio.set_event_loop(self._loop)
            self._queue = AdmissionQueue(
                on_cancel=lambda job: self.meter.record(
                    CostRecord.from_job(job)))
            self._budget = ByteBudget(self._byte_budget)
            self._pending_batches: dict[tuple, list[Job]] = {}
            self._batch_timers: dict[tuple, asyncio.TimerHandle] = {}
            self._inflight: set = set()
            self._scheduler = self._loop.create_task(self._schedule())
            ready.set()
            self._loop.run_forever()

        self._thread = threading.Thread(target=_loop_main,
                                        name="svd-scheduler", daemon=True)
        self._thread.start()
        ready.wait()
        return self

    def __enter__(self) -> "SVDService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self, drain: bool = True, timeout: float | None = None
              ) -> None:
        """Stop accepting jobs; by default drain everything in flight
        (``drain=False`` cancels still-queued jobs first)."""
        with self._lock:
            if not self._started or self._closed:
                return
            self._closed = True
        if not drain:
            for job in list(self._jobs.values()):
                if job.status is JobStatus.QUEUED:
                    job.cancel()
        done = asyncio.run_coroutine_threadsafe(
            self._shutdown(), self._loop)
        done.result(timeout)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout)
        self._pool.shutdown(wait=True)
        if not self._thread.is_alive():
            self._loop.close()            # its selector and self-pipe

    async def _shutdown(self) -> None:
        self._queue.close()
        await self._scheduler
        # flush any batch windows still waiting, then drain the runners
        for key in list(self._pending_batches):
            self._flush_batch(key)
        while self._inflight:
            await asyncio.gather(*list(self._inflight),
                                 return_exceptions=True)

    # -- client surface -----------------------------------------------------

    def submit(self, input: Any = None, k: int | None = None, *,
               spec: JobSpec | None = None,
               config: SVDConfig | None = None, priority: int = 0,
               deadline_s: float | None = None, stream_every: int = 0,
               tag: str = "", **overrides) -> JobHandle:
        """Queue one decomposition; returns immediately with a handle.

        Either pass a prebuilt ``spec=JobSpec(...)`` or the same
        arguments ``svd()`` takes (``input``, ``k``, ``config=`` and/or
        keyword overrides) plus the serving knobs (``priority``,
        ``deadline_s``, ``stream_every``, ``tag``).
        """
        if not self._started:
            self.start()
        if self._closed:
            raise RuntimeError("SVDService is closed to new jobs")
        if spec is None:
            if input is None or k is None:
                raise TypeError("submit() needs input and k (or spec=)")
            cfg = config if config is not None else SVDConfig()
            if overrides:
                cfg = cfg.replace(**overrides)
            spec = JobSpec(input=input, k=int(k), config=cfg,
                           priority=priority, deadline_s=deadline_s,
                           stream_every=stream_every, tag=tag)
        job = Job(spec=spec)
        self._jobs[job.job_id] = job
        self._loop.call_soon_threadsafe(self._queue.put, job)
        return JobHandle(job)

    def metrics(self) -> dict:
        """Queue-level rollup of every metered job so far."""
        return self.meter.aggregate()

    def job(self, job_id: str) -> JobHandle:
        return JobHandle(self._jobs[job_id])

    # -- scheduler (event-loop side) ----------------------------------------

    def _preflight(self, job: Job) -> bool:
        """Cancel/deadline checks at admission time; False = finalized."""
        if job.cancel_requested:
            job.mark_cancelled()
            self.meter.record(CostRecord.from_job(job))
            return False
        if job.deadline_passed():
            job.mark_failed(DeadlineExceeded(
                f"{job.job_id}: deadline of {job.spec.deadline_s}s "
                f"passed while queued"))
            self.meter.record(CostRecord.from_job(job))
            return False
        return True

    async def _schedule(self) -> None:
        while True:
            job = await self._queue.get()
            if job is None:              # closed and drained
                return
            if not self._preflight(job):
                continue
            # Admission must never park on a popped job: if the budget
            # can't fit it, bounce it back into the heap and re-pop once
            # bytes free up — a higher-priority job submitted during the
            # wait then wins the re-pop instead of rotting behind this
            # one (head-of-line priority inversion).
            cost = self._budget.clamp(estimate_cost_bytes(job.spec))
            while not self._budget.try_acquire(cost):
                seen = self._budget.version
                self._queue.put(job)
                await self._budget.wait_for_release(seen)
                job = await self._queue.get()
                if job is None:
                    return
                if not self._preflight(job):
                    job = None
                    break
                cost = self._budget.clamp(estimate_cost_bytes(job.spec))
            if job is None:
                continue
            job.cost_bytes = cost
            job.mark_admitted()
            if batchable(job.spec):
                self._enqueue_batch(job)
            else:
                self._spawn(run_job, job, self.meter,
                            checkpoint_root=self._checkpoint_root,
                            jobs=(job,))

    def _on_device(self, fn, *args, **kw) -> None:
        """A worker's body: ``fn`` with the service's device current."""
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            fn(*args, device=self.device, **kw)

    def _spawn(self, fn, *args, jobs: tuple, **kw) -> None:
        fut = self._loop.run_in_executor(
            self._pool, lambda: self._on_device(fn, *args, **kw))
        self._inflight.add(fut)

        def _finish(f):
            self._inflight.discard(f)
            for job in jobs:
                self._budget.release(job.cost_bytes)
        fut.add_done_callback(_finish)

    def _enqueue_batch(self, job: Job) -> None:
        key = batch_key(job.spec)
        pend = self._pending_batches.setdefault(key, [])
        pend.append(job)
        if len(pend) >= self._max_batch:
            self._flush_batch(key)
        elif len(pend) == 1:
            self._batch_timers[key] = self._loop.call_later(
                self._batch_window_s, self._flush_batch, key)

    def _flush_batch(self, key: tuple) -> None:
        timer = self._batch_timers.pop(key, None)
        if timer is not None:
            timer.cancel()
        jobs = self._pending_batches.pop(key, [])
        if not jobs:
            return
        if len(jobs) == 1:
            # straggler: nothing to stack with — sequential fallback
            self._spawn(run_job, jobs[0], self.meter,
                        checkpoint_root=self._checkpoint_root,
                        jobs=tuple(jobs))
        else:
            self._spawn(run_batch, jobs, self.meter, jobs=tuple(jobs))
