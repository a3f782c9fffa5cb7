"""SVD-as-a-service: a job-queue serving layer over ``repro_torch.svd``
(the PyTorch port of the JAX package's ``repro.serving``).

This package serves DECOMPOSITION jobs — many concurrent ``svd()``
requests through one persistent process whose solves run on the port's
kernels on one device:

* ``service.SVDService`` — the front door: ``submit() -> JobHandle``,
  priority + byte-budget admission, a worker pool, metering;
* ``job`` — ``JobSpec``/``JobStatus`` lifecycle, streamed
  ``PartialResult``s, the typed 4xx/5xx failure boundary;
* ``queue`` — the asyncio admission heap + byte-budget backpressure;
* ``batcher`` — small same-shape jobs stacked into one batched solve;
* ``runner`` — per-job execution on the normal driver, with streaming,
  cancellation, deadlines, and per-job checkpoints;
* ``metering`` — per-job cost records off the engine's own accounting.

Not to be confused with ``repro_torch.launch.serve`` — the LM decode
serving CLI.  That one serves token generation; THIS one serves the
factorizations themselves.

Demo/smoke CLI: ``python -m repro_torch.serving --smoke [--device cpu]``.
"""
from repro_torch.serving.job import (DeadlineExceeded, Job, JobCancelled,
                                     JobSpec, JobStatus, PartialResult,
                                     classify_error)
from repro_torch.serving.metering import CostRecord, Meter
from repro_torch.serving.service import JobHandle, SVDService

__all__ = [
    "SVDService", "JobHandle", "JobSpec", "JobStatus", "Job",
    "PartialResult", "JobCancelled", "DeadlineExceeded",
    "classify_error", "CostRecord", "Meter",
]
