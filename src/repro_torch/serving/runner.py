"""Job execution: the normal engine driver, plus streaming/cancel hooks
(PyTorch port of the JAX package's ``repro/serving/runner.py``).

``run_job`` executes ONE job exactly the way a library caller would —
``repro_torch.svd(spec.input, spec.k, device=<the service's device>,
config=...)`` — in a worker thread of the service's pool, so its sweeps
run on the port's kernels, with three pieces of serving plumbing
wrapped around it:

* **streamed partials** — for ``stream_every > 0`` block jobs, an
  ``on_iteration`` hook (marked ``_wants_operator`` so the driver also
  hands it the live operator) runs an extra Rayleigh–Ritz extraction
  every N sweeps and pushes the leading triplets + the synced subspace
  gap to subscribers, as host (numpy) copies (none from a non-finite
  iterate, which the driver's health guard handles).  The extra pass and the
  gap's host read are real work: the pass shows up in the job's cost
  record as ``stream_extracts``, never in the solver's own
  ``passes_over_A`` (which stays the fault-free solve accounting);
* **cancellation + deadlines** — the same hook aborts between sweeps
  via ``JobCancelled``/``DeadlineExceeded``; non-streamed jobs check
  only before the solve starts (the driver loop is not interrupted
  mid-flight);
* **per-job checkpoints** — given a service ``checkpoint_root``, each
  block job writes to ``<root>/<job_id>`` in the JAX package's format,
  so a killed runner process resumes its jobs through the engine's
  fingerprint-gated auto-resume on resubmission (same spec => same
  fingerprint), in either package's service.

``run_batch`` executes a stacked micro-batch (``batcher.solve_batch``)
and fans per-lane results/errors back out to the individual jobs —
a poisoned lane fails its own job while the batchmates complete.
"""
from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from repro_torch.core.operator import host_sync_scalar
from repro_torch.core.svd import svd
from repro_torch.kernels.ops import thread_launches
from repro_torch.serving.batcher import solve_batch
from repro_torch.serving.job import (DeadlineExceeded, Job, JobCancelled,
                                     PartialResult)
from repro_torch.serving.metering import CostRecord, Meter

__all__ = ["run_job", "run_batch", "make_iteration_hook"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def make_iteration_hook(job: Job, *, chain=None):
    """The per-iteration serving hook for one streamed block job.

    Marked ``_wants_operator`` so ``core/svd.py::_drive`` passes the
    live operator: partials need one ``op.extract`` (a real extra pass
    over A, metered as ``stream_extracts``).  ``chain`` is the client's
    own ``on_iteration``, called afterwards with the plain one-argument
    trace signature.
    """
    spec = job.spec
    k = int(spec.k)
    shape = getattr(spec.input, "shape", None)
    # the driver iterates the TALL orientation; wide inputs get their
    # factors swapped on the way out, so partials must swap too
    swapped = shape is not None and len(shape) == 2 \
        and int(shape[0]) < int(shape[1])

    def hook(state, op):
        if job.cancel_requested:
            raise JobCancelled(job.job_id)
        if job.deadline_passed():
            raise DeadlineExceeded(
                f"{job.job_id}: deadline of {spec.deadline_s}s passed "
                f"after {state.it} iterations")
        if spec.stream_every and state.it % spec.stream_every == 0:
            gap = state.gap
            gap = None if gap is None else float(host_sync_scalar(gap))
            # a non-finite iterate has no partial to give (its SVD would
            # raise); the driver's health guard reads the same gap next
            if gap is None or math.isfinite(gap):
                U, S, V = op.extract(state.Q)
                U, S, V = U[:, :k], S[:k], V[:, :k]
                if swapped:
                    U, V = V, U
                job.push_partial(PartialResult(
                    job.job_id, int(state.it), gap,
                    _host(S), _host(U), _host(V)))
        if chain is not None:
            chain(state)

    hook._wants_operator = True
    return hook


def _pre_run(job: Job, meter: Meter) -> bool:
    """Shared pre-flight: cancellation/deadline checks before any work.
    Returns True if the job may run (and is now RUNNING)."""
    if job.cancel_requested:
        job.mark_cancelled()
        meter.record(CostRecord.from_job(job))
        return False
    if job.deadline_passed():
        job.mark_failed(DeadlineExceeded(
            f"{job.job_id}: deadline of {job.spec.deadline_s}s passed "
            f"before the solve started (queue wait)"))
        meter.record(CostRecord.from_job(job))
        return False
    job.mark_running()
    return True


def run_job(job: Job, meter: Meter, *, device: torch.device,
            checkpoint_root: str | None = None) -> None:
    """Execute one job through the normal driver on ``device``
    (worker-thread body)."""
    if not _pre_run(job, meter):
        return
    spec = job.spec
    cfg = spec.resolved_config()
    try:
        if (checkpoint_root is not None and cfg.method == "block"
                and cfg.checkpoint_dir is None):
            cfg = cfg.replace(checkpoint_dir=os.path.join(
                checkpoint_root, job.job_id))
        if (spec.stream_every or spec.deadline_s is not None
                or cfg.on_iteration is not None) and cfg.method == "block":
            cfg = cfg.replace(on_iteration=make_iteration_hook(
                job, chain=cfg.on_iteration))
        with thread_launches() as job.launches:
            res = svd(spec.input, spec.k, device=device, config=cfg)
        job.mark_done(res)
    except JobCancelled:
        job.mark_cancelled()
    except BaseException as e:          # typed split happens in the job
        job.mark_failed(e)
    finally:
        meter.record(CostRecord.from_job(job))


def run_batch(jobs: list[Job], meter: Meter, *,
              device: torch.device) -> None:
    """Execute a stacked micro-batch on ``device`` (worker-thread body):
    one batched dispatch, per-lane fan-out of results/errors."""
    live = [job for job in jobs if _pre_run(job, meter)]
    if not live:
        return
    t0 = time.perf_counter()
    try:
        lanes = solve_batch([job.spec for job in live], device=device)
    except BaseException as e:
        # the batch itself failed to run (a shape bug) — every lane gets
        # the same typed error; the queue keeps serving
        for job in live:
            job.mark_failed(e)
            meter.record(CostRecord.from_job(
                job, batched=True, batch_size=len(live)))
        return
    wall = time.perf_counter() - t0
    for job, (res, err) in zip(live, lanes):
        if err is not None:
            job.mark_failed(err)
        else:
            # the lanes shared one dispatch: each is stamped with the
            # batch's wall clock (the per-job marginal cost is lower —
            # that is the point of batching; see the cost record's
            # batched/batch_size fields)
            job.mark_done(res._replace(wall_time_s=wall))
        meter.record(CostRecord.from_job(
            job, batched=True, batch_size=len(live)))
