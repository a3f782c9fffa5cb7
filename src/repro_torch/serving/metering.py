"""Per-job cost records and queue-level metrics for the serving layer
(PyTorch port of the JAX package's ``repro/serving/metering.py``: the
same schema, rollup and JSON).

The engine already accounts for everything a bill needs — ground-truth
``passes_over_A`` from the operator's own counters, per-tier
``bytes_moved``, ``wall_time_s`` stamped by the front door, and the
fault/recovery counters in ``SVDResult.faults`` — so metering is a
straight transcription of the ``SVDResult`` plus queue-side timing
(wait, batching), never a second clock around the driver.

Cost-record schema (one JSON-able dict per job)::

    {
      "job_id": "job-000007", "tag": "", "status": "done",
      "backend": "dense", "shape": [512, 96], "k": 8,
      "priority": 0, "batched": true, "batch_size": 12,
      "queue_wait_s": 0.004, "run_wall_s": 0.031,
      "wall_time_s": 0.029,            # engine-stamped solve wall clock
      "passes_over_A": 14, "bytes_per_pass": 196608,
      "bytes_moved": {"device": 2752512},
      "stream_extracts": 3,            # extra passes spent on partials
      "converged": true,
      "error_kind": null,              # "input" (4xx) | "internal" (5xx)
      "faults": {"counters": {...}}    # recovery telemetry, if any
    }
"""
from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field
from typing import Any

from repro_torch.serving.job import Job

__all__ = ["CostRecord", "Meter"]


@dataclass
class CostRecord:
    job_id: str
    tag: str = ""
    status: str = ""
    backend: str | None = None
    shape: tuple[int, int] | None = None
    k: int = 0
    priority: int = 0
    batched: bool = False
    batch_size: int = 1
    queue_wait_s: float = 0.0        # submit -> runner start
    run_wall_s: float = 0.0          # runner start -> terminal
    wall_time_s: float | None = None  # SVDResult.wall_time_s (engine)
    passes_over_A: int | None = None
    bytes_per_pass: int | None = None
    bytes_moved: dict | None = None
    stream_extracts: int = 0
    converged: bool | None = None
    error_kind: str | None = None
    faults: Any = None

    @classmethod
    def from_job(cls, job: Job, *, batched: bool = False,
                 batch_size: int = 1) -> "CostRecord":
        """Transcribe a TERMINAL job (engine accounting + queue timing)."""
        res = job.result
        started = job.started_at if job.started_at is not None \
            else job.finished_at
        rec = cls(
            job_id=job.job_id, tag=job.spec.tag,
            status=job.status.value, k=int(job.spec.k),
            priority=int(job.spec.priority),
            batched=batched, batch_size=batch_size,
            queue_wait_s=max(0.0, (started or 0.0) - job.submitted_at),
            run_wall_s=max(0.0, (job.finished_at or 0.0) - (started or 0.0)),
            stream_extracts=int(job.partial_count),
            error_kind=job.error_kind,
            faults=job.faults,
        )
        shape = getattr(job.spec.input, "shape", None)
        if shape is not None and len(shape) == 2:
            rec.shape = (int(shape[0]), int(shape[1]))
        if res is not None:
            rec.backend = res.backend
            rec.wall_time_s = res.wall_time_s
            rec.passes_over_A = int(res.passes_over_A)
            rec.bytes_per_pass = int(res.bytes_per_pass)
            rec.bytes_moved = res.bytes_moved
            rec.converged = bool(res.converged)
            if rec.faults is None:
                rec.faults = res.faults
        return rec

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass
class Meter:
    """Thread-safe accumulator of cost records + queue-level rollup."""

    records: list[CostRecord] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    def record(self, rec: CostRecord) -> None:
        with self._lock:
            self.records.append(rec)

    def aggregate(self) -> dict:
        """Queue-level metrics over everything metered so far."""
        with self._lock:
            recs = list(self.records)
        by_status: dict[str, int] = {}
        by_backend: dict[str, int] = {}
        tiers: dict[str, int] = {}
        passes = 0
        batched_jobs = 0
        walls = sorted(r.run_wall_s for r in recs)
        waits = sorted(r.queue_wait_s for r in recs)
        for r in recs:
            by_status[r.status] = by_status.get(r.status, 0) + 1
            if r.backend:
                by_backend[r.backend] = by_backend.get(r.backend, 0) + 1
            if r.passes_over_A:
                passes += r.passes_over_A
            for tier, n in (r.bytes_moved or {}).items():
                tiers[tier] = tiers.get(tier, 0) + int(n)
            if r.batched:
                batched_jobs += 1

        def pct(xs, q):
            return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else 0.0

        return {
            "jobs": len(recs),
            "by_status": by_status,
            "by_backend": by_backend,
            "batched_jobs": batched_jobs,
            "total_passes_over_A": passes,
            "total_bytes_moved": tiers,
            "queue_wait_s": {"p50": pct(waits, 0.5), "max": pct(waits, 1.0)},
            "run_wall_s": {"p50": pct(walls, 0.5), "max": pct(walls, 1.0)},
        }

    def to_json(self, **kw) -> str:
        with self._lock:
            recs = [r.to_dict() for r in self.records]
        return json.dumps({"records": recs, "metrics": self.aggregate()},
                          default=str, **kw)
