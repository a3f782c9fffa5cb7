"""Admission queue for the serving loop: priority, backpressure, cost
(PyTorch port of the JAX package's ``repro/serving/queue.py``; the
estimate is the same integer for the same shape and config).

Two pieces, both asyncio-native (they live on the service's scheduler
loop; client threads reach them only through thread-safe wrappers in
``service.py``):

* ``AdmissionQueue`` — a heap-ordered queue (higher ``priority`` first,
  FIFO within a level) the scheduler awaits on.  Cancelled jobs are
  skipped lazily at pop time, so ``cancel()`` never has to fish inside
  the heap.

* ``ByteBudget`` — admission backpressure as an async byte semaphore.
  Each job's working-set estimate (``estimate_cost_bytes``, the same
  A-block + iterate-tails story as the static analyzer's
  ``analysis/memory.py`` peak-live scan and the operator's
  ``bytes_per_pass``) is acquired before the job may run and released
  when it finishes, so a burst of huge jobs queues up instead of
  OOM-ing the process.  Jobs larger than the whole budget are clamped
  to it: they run, but only alone.
"""
from __future__ import annotations

import asyncio
import heapq
import itertools

import numpy as np

from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.serving.job import Job, JobStatus

__all__ = ["AdmissionQueue", "ByteBudget", "estimate_cost_bytes"]

#: working-set guess for inputs whose shape cannot be probed cheaply
#: (duck-typed operators without .shape) — deliberately conservative
DEFAULT_COST_BYTES = 64 << 20

#: iterate tails: Q, the sweep product, the QR workspace, the extract —
#: ~4 max(m,n)-by-l fp32 blocks live at the peak
_TAIL_BLOCKS = 4


def estimate_cost_bytes(spec) -> int:
    """Estimated peak working set (bytes) of one job while it runs.

    Mirrors the static analyzer's peak-live story per backend family:

    * device-resident dense (torch tensors, numpy arrays): the whole A
      at the sweep dtype, plus the iterate tails;
    * staged backends (paths, ``np.memmap``, pre-blocked matrices):
      one staged block (or the configured ``host_budget_bytes``, if
      tighter) plus the tails — the whole point of those tiers is that
      A itself never materializes;
    * unknown shapes: ``DEFAULT_COST_BYTES``.

    An estimate, not a measurement — it feeds admission backpressure,
    while the ground-truth per-tier bytes still come from the
    operator's counters on the result.  A ``torch.Tensor``'s
    ``torch.Size`` reads as a numpy shape does; the port's staged
    matrices (``HostBlockedMatrix``, ``MemmapMatrix``) answer to the
    same ``block``/``host_block`` probe as the JAX package's.
    """
    cfg = spec.resolved_config()
    shape = getattr(spec.input, "shape", None)
    if shape is None or len(shape) != 2:
        return DEFAULT_COST_BYTES
    m, n = int(shape[0]), int(shape[1])
    itemsize = resolve_sweep_dtype(cfg.sweep_dtype).itemsize
    l = min(max(int(spec.k), 1) + max(cfg.oversample, 0), max(m, n))
    tails = _TAIL_BLOCKS * max(m, n) * l * 4          # fp32 iterate blocks
    a_bytes = m * n * itemsize
    staged = isinstance(spec.input, (np.memmap,)) or any(
        hasattr(spec.input, attr) for attr in ("block", "host_block"))
    if staged:
        block = a_bytes // max(cfg.n_blocks, 1) + 1
        if cfg.host_budget_bytes:
            block = min(block, cfg.host_budget_bytes)
        return block + tails
    return a_bytes + tails


class AdmissionQueue:
    """Priority heap the scheduler coroutine pops from.

    ``put`` may be called from the event loop only (the service bridges
    client threads in).  Ordering: higher ``spec.priority`` first, then
    submission order.
    """

    def __init__(self, on_cancel=None):
        self._heap: list = []
        self._seq = itertools.count()
        self._event = asyncio.Event()
        self._closed = False
        #: called with each job finalized by the lazy cancel-skip in
        #: ``get()``, so the service can still meter it
        self._on_cancel = on_cancel

    def __len__(self) -> int:
        return len(self._heap)

    def put(self, job: Job) -> None:
        """Heap a job.  Re-putting (the scheduler bounces a job back
        when the byte budget can't fit it yet) keeps the job's original
        sequence number, so FIFO-within-priority survives the bounce.
        Allowed after ``close()``: drain re-puts are part of shutdown.
        """
        seq = getattr(job, "_heap_seq", None)
        if seq is None:
            seq = job._heap_seq = next(self._seq)
        heapq.heappush(self._heap, (-int(job.spec.priority), seq, job))
        self._event.set()

    def close(self) -> None:
        """No more puts; pending gets drain, then return None."""
        self._closed = True
        self._event.set()

    async def get(self) -> Job | None:
        """Next runnable job by priority, or None once closed+drained.
        Jobs cancelled while queued are finalized here (lazy removal)."""
        while True:
            while self._heap:
                _, _, job = heapq.heappop(self._heap)
                if job.cancel_requested and job.status is JobStatus.QUEUED:
                    job.mark_cancelled()
                    if self._on_cancel is not None:
                        self._on_cancel(job)
                    continue
                return job
            if self._closed:
                return None
            self._event.clear()
            await self._event.wait()


class ByteBudget:
    """Async counting semaphore over bytes, for admission backpressure.

    ``await acquire(n)`` blocks until ``n`` bytes are free (``n`` is
    clamped to the total, so an over-budget job serializes instead of
    deadlocking); ``release(n)`` is plain-callable and loop-safe via
    ``call_soon_threadsafe`` from runner threads (see service.py).
    """

    def __init__(self, total_bytes: int):
        if total_bytes < 1:
            raise ValueError(f"byte budget must be >= 1, got {total_bytes}")
        self.total = int(total_bytes)
        self._free = int(total_bytes)
        self._cond = asyncio.Condition()
        #: bumped on every release; lets the scheduler detect "something
        #: freed up since I last looked" without a lost-wakeup race
        self.version = 0

    @property
    def free(self) -> int:
        return self._free

    def clamp(self, n: int) -> int:
        return max(1, min(int(n), self.total))

    def try_acquire(self, n: int) -> bool:
        """Reserve ``n`` bytes if free right now (no await, no clamp —
        callers clamp first).  Non-blocking so the scheduler can bounce
        an unaffordable job back into the heap instead of parking on it;
        parking would let a later high-priority job rot behind the
        popped one (head-of-line priority inversion)."""
        n = int(n)
        if self._free >= n:
            self._free -= n
            return True
        return False

    async def wait_for_release(self, seen_version: int) -> None:
        """Block until ``release`` has run since ``seen_version`` was
        read.  The version check makes the read-check-wait sequence safe
        even though a release may land between ``try_acquire`` failing
        and this call parking."""
        async with self._cond:
            await self._cond.wait_for(lambda: self.version != seen_version)

    def release(self, n: int) -> None:
        self._free += int(n)
        self.version += 1
        # wake waiters; schedule on the loop if called off-loop
        async def _notify():
            async with self._cond:
                self._cond.notify_all()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            loop = None
        if loop is not None:
            loop.create_task(_notify())
