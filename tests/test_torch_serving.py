"""The SVD service of the port (``repro_torch.serving``) against the JAX
package's (``repro.serving``), on the CPU.

Counterparts of ``tests/test_serving.py``'s contracts, through the port's
public ``SVDService(device="cpu")`` surface: the job lifecycle state
machine, priority + byte-budget admission, cancellation and deadlines,
the typed 4xx/5xx failure split (with fault telemetry on failed jobs),
streamed partial results, and per-job cost metering.  Then the two
services side by side on the same numpy jobs: sigma within rtol 1e-4 and
subspace cosines > 1 - 1e-3, the integer accounting of ``force_iters``
jobs (``passes_over_A``, ``bytes_per_pass``, ``bytes_moved``), the
admission estimate and the metering rollup exactly equal, the same
4xx/5xx split; a job checkpointed by the JAX service resumes in the
port's; and the entry-point rule (no device and no card: raise).

Every wait carries a timeout of at most 60 s and every service is closed
by its ``with`` block, so a hang fails a test instead of the suite.
"""
import json
import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
from repro.core import SVDConfig as JaxConfig
from repro.serving.queue import estimate_cost_bytes as jax_estimate
from repro_torch import svd
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.config import SVDConfig
from repro_torch.core.errors import InputError, SVDError
from repro_torch.serving import (DeadlineExceeded, Job, JobCancelled,
                                 JobSpec, JobStatus, SVDService,
                                 classify_error)
from repro_torch.serving.job import VALID_TRANSITIONS
from repro_torch.serving.queue import estimate_cost_bytes

from conftest import make_lowrank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 4
SPECTRUM = np.geomspace(10.0, 1e-2, 24)
WAIT = 60.0                 # seconds: every wait, result and stream


def service(**kw):
    return SVDService(device="cpu", **kw)


def small(rng, seed=0):
    return torch.from_numpy(make_lowrank(rng, 48, 24, SPECTRUM)
                            .astype(np.float32))


def slow_cfg(**kw):
    """A config that needs many block iterations (clustered tail +
    tiny eps) so mid-run events (partials, cancels) are observable."""
    return SVDConfig(eps=1e-12, max_iters=400, **kw)


def _cosines(X, Y):
    return np.linalg.svd(np.asarray(X).T @ np.asarray(Y), compute_uv=False)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# state machine
# ---------------------------------------------------------------------------

def test_status_machine_legal_path():
    job = Job(spec=JobSpec(input=np.zeros((4, 4)), k=1))
    assert job.status is JobStatus.QUEUED
    job.mark_admitted()
    job.mark_running()
    job.mark_done(result="r")
    assert job.status is JobStatus.DONE
    assert job.wait(0.1) is JobStatus.DONE


@pytest.mark.parametrize("terminal", [JobStatus.DONE, JobStatus.FAILED,
                                      JobStatus.CANCELLED])
def test_terminal_states_are_absorbing(terminal):
    assert VALID_TRANSITIONS[terminal] == ()


def test_illegal_transition_is_loud():
    job = Job(spec=JobSpec(input=np.zeros((4, 4)), k=1))
    with pytest.raises(RuntimeError, match="illegal transition"):
        job.mark_done(result="r")      # QUEUED -> DONE skips admission
    job.mark_admitted()
    job.mark_running()
    job.mark_cancelled()
    with pytest.raises(RuntimeError, match="illegal transition"):
        job.mark_done(result="r")      # cancelled is terminal


def test_state_machine_equals_the_reference():
    jt = jserving.job.VALID_TRANSITIONS
    assert [s.value for s in JobStatus] == [s.value for s in
                                            jserving.JobStatus]
    assert {s.value: [t.value for t in ts]
            for s, ts in VALID_TRANSITIONS.items()} == \
        {s.value: [t.value for t in ts] for s, ts in jt.items()}


def test_classify_error_is_the_typed_split():
    assert classify_error(InputError("bad k")) == "input"
    assert classify_error(SVDError("infra")) == "internal"
    assert classify_error(DeadlineExceeded("late")) == "internal"
    assert classify_error(RuntimeError("boom")) == "internal"
    # a device OOM that escapes under demote_on_oom=False is the service's
    assert classify_error(torch.cuda.OutOfMemoryError("oom")) == "internal"


# ---------------------------------------------------------------------------
# admission: priority order + byte-budget backpressure
# ---------------------------------------------------------------------------

def _blocking_spec(rng, release: threading.Event, started: threading.Event):
    """A job whose solve parks on `release` at its first iteration, so
    the test controls exactly when its budget frees up."""
    def hold(state):
        started.set()
        release.wait(WAIT)
    return JobSpec(input=small(rng), k=K,
                   config=SVDConfig(eps=1e-8, max_iters=60,
                                    on_iteration=hold))


def test_priority_orders_admission_under_backpressure(rng):
    release, started = threading.Event(), threading.Event()
    blocker = _blocking_spec(rng, release, started)
    # budget sized for ONE job: everything else waits in the heap,
    # where priority (not submission order) decides who goes next
    budget = estimate_cost_bytes(blocker)
    try:
        with service(max_workers=1, byte_budget=budget) as svc:
            hb = svc.submit(spec=blocker)
            assert started.wait(WAIT), "blocker never started"
            lo = svc.submit(small(rng, 1), K, priority=0, tag="lo")
            hi = svc.submit(small(rng, 2), K, priority=5, tag="hi")
            time.sleep(0.05)           # both must be heaped before release
            release.set()
            assert hb.wait(WAIT) is JobStatus.DONE
            assert lo.wait(WAIT) is JobStatus.DONE
            assert hi.wait(WAIT) is JobStatus.DONE
            assert svc._jobs[hi.job_id].admitted_at < \
                svc._jobs[lo.job_id].admitted_at, \
                "higher priority job must be admitted first"
    finally:
        release.set()


def test_byte_budget_serializes_admission(rng):
    specs = [JobSpec(input=small(rng, s), k=K,
                     config=SVDConfig(eps=1e-8, max_iters=100))
             for s in range(3)]
    budget = estimate_cost_bytes(specs[0])   # exactly one job at a time
    peak = 0
    with service(max_workers=2, byte_budget=budget) as svc:
        handles = [svc.submit(spec=s) for s in specs]
        jobs = [svc._jobs[h.job_id] for h in handles]
        # poll the live-job gauge while the queue drains
        deadline = time.time() + WAIT
        while time.time() < deadline:
            live = sum(j.status in (JobStatus.ADMITTED, JobStatus.RUNNING,
                                    JobStatus.STREAMING) for j in jobs)
            peak = max(peak, live)
            if all(j.status.terminal for j in jobs):
                break
            time.sleep(0.001)
        for h in handles:
            assert h.wait(WAIT) is JobStatus.DONE
    assert peak <= 1, \
        f"byte budget for one job admitted {peak} jobs concurrently"


def test_over_budget_job_is_clamped_not_deadlocked(rng):
    # a job whose estimate exceeds the whole budget must still run
    with service(max_workers=1, byte_budget=1024) as svc:
        h = svc.submit(small(rng), K, eps=1e-8, max_iters=100)
        assert h.wait(WAIT) is JobStatus.DONE


# ---------------------------------------------------------------------------
# cancellation + deadlines
# ---------------------------------------------------------------------------

def test_cancel_queued_job(rng):
    release, started = threading.Event(), threading.Event()
    blocker = _blocking_spec(rng, release, started)
    budget = estimate_cost_bytes(blocker)
    try:
        with service(max_workers=1, byte_budget=budget) as svc:
            hb = svc.submit(spec=blocker)
            assert started.wait(WAIT)
            victim = svc.submit(small(rng, 1), K, tag="victim")
            assert victim.cancel()
            release.set()
            assert victim.wait(WAIT) is JobStatus.CANCELLED
            assert hb.wait(WAIT) is JobStatus.DONE
            with pytest.raises(JobCancelled):
                victim.result(1.0)
    finally:
        release.set()


def _gradual(rng):
    return torch.from_numpy(make_lowrank(
        rng, 64, 32, np.geomspace(10, 0.1, 32)).astype(np.float32))


def test_cancel_running_streamed_job(rng):
    A = _gradual(rng)
    gate = threading.Event()

    def pace(state):               # park the solve until the test is ready
        if state.it >= 3:
            gate.wait(WAIT)

    try:
        with service(max_workers=1) as svc:
            h = svc.submit(A, K, config=slow_cfg(on_iteration=pace),
                           stream_every=1)
            p = next(iter(h.stream(timeout=WAIT)))
            assert p.it >= 1
            assert not h.status.terminal   # solver is parked at it >= 3
            assert h.cancel()
            gate.set()                     # next iteration sees the cancel
            assert h.wait(WAIT) is JobStatus.CANCELLED
            with pytest.raises(JobCancelled):
                h.result(1.0)
    finally:
        gate.set()


def test_deadline_exceeded_while_queued(rng):
    release, started = threading.Event(), threading.Event()
    blocker = _blocking_spec(rng, release, started)
    budget = estimate_cost_bytes(blocker)
    try:
        with service(max_workers=1, byte_budget=budget) as svc:
            hb = svc.submit(spec=blocker)
            assert started.wait(WAIT)
            late = svc.submit(small(rng, 1), K, deadline_s=0.01)
            time.sleep(0.05)           # let the deadline lapse in-queue
            release.set()
            assert late.wait(WAIT) is JobStatus.FAILED
            assert isinstance(late.error, DeadlineExceeded)
            assert late.error_kind == "internal"
            assert hb.wait(WAIT) is JobStatus.DONE
    finally:
        release.set()


# ---------------------------------------------------------------------------
# the typed 4xx/5xx failure boundary + fault telemetry
# ---------------------------------------------------------------------------

def test_input_error_is_4xx_and_queue_survives(rng):
    with service(max_workers=1) as svc:
        bad = svc.submit(small(rng), 999)      # k > min(m, n): client bug
        good = svc.submit(small(rng, 1), K, eps=1e-8)
        assert bad.wait(WAIT) is JobStatus.FAILED
        assert isinstance(bad.error, InputError)
        assert bad.error_kind == "input"
        # the failure did not poison the queue
        assert good.wait(WAIT) is JobStatus.DONE
        with pytest.raises(InputError):
            bad.result(1.0)


def _poisoned(rng):
    A = np.asarray(make_lowrank(rng, 80, 30, np.geomspace(10, 0.1, 30)),
                   np.float32)
    A[3, 7] = np.nan                   # poisoned input: health guard trips
    return A


def test_numeric_fault_is_5xx_with_telemetry_and_queue_survives(rng):
    A = _poisoned(rng)
    with service(max_workers=1) as svc:
        # a numpy input runs on the host-blocked tier; stream_every keeps
        # it on the sequential runner
        bad = svc.submit(A, K, stream_every=1,
                         config=SVDConfig(eps=1e-8, max_iters=50,
                                          health_retries=1))
        good = svc.submit(small(rng, 1), K, eps=1e-8)
        assert bad.wait(WAIT) is JobStatus.FAILED
        assert isinstance(bad.error, SVDError)
        assert not isinstance(bad.error, InputError)
        assert bad.error_kind == "internal"
        # the engine's FaultTelemetry snapshot rides the failed job
        assert bad.faults is not None
        assert any(c.startswith("health.")
                   for c in bad.faults["counters"]), bad.faults
        assert good.wait(WAIT) is JobStatus.DONE


# ---------------------------------------------------------------------------
# streamed partial results
# ---------------------------------------------------------------------------

def test_streaming_delivers_partials_before_done(rng):
    # gradual spectrum: tens of iterations, so it=1 partials land long
    # before convergence; a pace hook parks the solve at it=3 until the
    # subscriber has CONSUMED a partial, making "received while still
    # running" deterministic rather than a race
    A = _gradual(rng)
    cfg = SVDConfig(eps=1e-8, max_iters=200)
    ref = svd(A, K, device="cpu", config=cfg)
    gate = threading.Event()

    def pace(state):
        if state.it >= 3:
            gate.wait(WAIT)

    try:
        with service(max_workers=1) as svc:
            h = svc.submit(A, K, config=cfg.replace(on_iteration=pace),
                           stream_every=1)
            stream = h.stream(timeout=WAIT)
            first = next(iter(stream))
            assert not h.status.terminal, \
                "first partial must arrive while the job is still running"
            gate.set()
            partials = [first, *stream]
            assert h.wait(WAIT) is JobStatus.DONE
            res = h.result(WAIT)
    finally:
        gate.set()
    assert len(partials) >= 2
    last = partials[-1]
    assert first.it < int(np.asarray(ref.iters)[0])
    assert first.S.shape == (K,) and first.U.shape == (64, K) \
        and first.V.shape == (32, K)
    # host copies: a subscriber never holds device memory
    assert all(isinstance(x, np.ndarray) for x in (first.S, first.U,
                                                   first.V))
    assert first.gap is None or first.gap >= 0
    # the stream converges onto the final answer (same trajectory as
    # the hook-free reference — hooks never change the math)
    assert np.allclose(last.S, _np(ref.S), rtol=1e-3)
    assert np.allclose(_np(res.S), _np(ref.S))
    # partial extractions are metered, never billed to the solver
    assert int(res.passes_over_A) == int(ref.passes_over_A)
    assert h.partial_count == len(partials)


def test_deadline_exceeded_mid_run(rng):
    A = _gradual(rng)

    def stall(state):              # make one iteration outlast the budget
        if state.it == 1:
            time.sleep(0.3)

    with service(max_workers=1) as svc:
        h = svc.submit(A, K, config=slow_cfg(on_iteration=stall),
                       deadline_s=0.15, stream_every=1)
        assert h.wait(WAIT) is JobStatus.FAILED
        assert isinstance(h.error, DeadlineExceeded)
        assert h.error_kind == "internal"


def test_streamed_wide_input_orients_partials(rng):
    Aw = torch.from_numpy(make_lowrank(rng, 24, 48, SPECTRUM)
                          .astype(np.float32))
    with service(max_workers=1) as svc:
        h = svc.submit(Aw, K, config=slow_cfg(), stream_every=1)
        p = next(iter(h.stream(timeout=WAIT)))
        h.result(WAIT)
    assert p.U.shape == (24, K) and p.V.shape == (48, K)


# ---------------------------------------------------------------------------
# metering
# ---------------------------------------------------------------------------

def test_cost_records_transcribe_engine_accounting(rng):
    A = small(rng)
    ref = svd(A, K, device="cpu", eps=1e-8)
    with service(max_workers=1) as svc:
        h = svc.submit(A, K, eps=1e-8, tag="bill-me")
        res = h.result(WAIT)
        recs = {r.job_id: r for r in svc.meter.records}
        m = svc.metrics()
    rec = recs[h.job_id]
    assert rec.tag == "bill-me" and rec.status == "done"
    assert rec.passes_over_A == int(res.passes_over_A) \
        == int(ref.passes_over_A)
    assert rec.bytes_per_pass == int(res.bytes_per_pass)
    assert rec.bytes_moved == res.bytes_moved
    assert rec.wall_time_s == res.wall_time_s and rec.wall_time_s > 0
    assert rec.shape == (48, 24) and rec.k == K
    assert rec.queue_wait_s >= 0 and rec.run_wall_s > 0
    assert m["jobs"] == 1 and m["by_status"] == {"done": 1}
    assert m["total_passes_over_A"] == rec.passes_over_A


def test_metrics_rollup_counts_every_terminal_state(rng):
    with service(max_workers=2) as svc:
        ok = svc.submit(small(rng), K, eps=1e-8)
        bad = svc.submit(small(rng, 1), 999)
        ok.wait(WAIT), bad.wait(WAIT)
        m = svc.metrics()
    assert m["by_status"].get("done") == 1
    assert m["by_status"].get("failed") == 1
    assert m["jobs"] == 2


def test_meter_json_roundtrips(rng):
    with service(max_workers=1) as svc:
        svc.submit(small(rng), K, eps=1e-8).result(WAIT)
        blob = svc.meter.to_json()
    parsed = json.loads(blob)
    assert parsed["metrics"]["jobs"] == len(parsed["records"]) == 1


# ---------------------------------------------------------------------------
# the two services side by side on the same numpy jobs
# ---------------------------------------------------------------------------

def _both(jobs, **svc_kw):
    """Run ``jobs`` (numpy input, k, config kwargs) through the JAX
    package's service and the port's; returns the two lists of handles'
    results or errors and the two services' meters."""
    out = []
    for pkg in ("jax", "torch"):
        cls = jserving.SVDService if pkg == "jax" else service
        cfg_cls = JaxConfig if pkg == "jax" else SVDConfig
        with cls(**svc_kw) as svc:
            hs = []
            for A, k, kw in jobs:
                X = jnp.asarray(A) if pkg == "jax" else torch.from_numpy(A)
                hs.append(svc.submit(X, k, config=cfg_cls(**kw)))
            for h in hs:
                assert h.wait(WAIT).terminal
            out.append(([(h.status.value, h.error_kind,
                          svc._jobs[h.job_id].result) for h in hs],
                        svc.meter))
    return out


def _jobs(rng):
    A = make_lowrank(rng, 48, 24, SPECTRUM).astype(np.float32)
    W = make_lowrank(rng, 24, 48, SPECTRUM).astype(np.float32)
    nan = A.copy()
    nan[2, 3] = np.nan
    return [
        (A, K, dict(eps=1e-8, max_iters=300, seed=0)),     # batchable
        (A, K, dict(eps=1e-8, max_iters=300, seed=1)),     # its batchmate
        (W, K, dict(eps=1e-8, max_iters=300)),             # wide, straggler
        (A, K, dict(force_iters=True, max_iters=12)),      # accounting
        (W, 3, dict(force_iters=True, max_iters=7, warmup_q=1)),
        (A, K, dict(force_iters=True, max_iters=9, sweep_dtype="bfloat16")),
        (A, 99, dict()),                                   # 4xx
        (nan, K, dict(eps=1e-8, max_iters=300, seed=2)),   # 5xx
        (nan, K, dict(eps=1e-8, max_iters=300, seed=3)),   # 5xx
    ]


def test_the_two_services_agree_on_the_same_jobs(rng):
    jobs = _jobs(rng)
    (jax_out, jax_meter), (t_out, t_meter) = _both(
        jobs, max_workers=2, batch_window_s=0.2)
    for (A, k, kw), (js, jkind, jres), (ts, tkind, tres) in zip(
            jobs, jax_out, t_out):
        assert (ts, tkind) == (js, jkind), (kw, ts, js)
        if tres is None:
            continue
        np.testing.assert_allclose(_np(tres.S), np.asarray(jres.S),
                                   rtol=1e-4)
        for X, Y in ((tres.U, jres.U), (tres.V, jres.V)):
            assert _cosines(_np(X), np.asarray(Y)).min() > 1 - 1e-3
        assert tres.backend == jres.backend
        if kw.get("force_iters"):
            assert int(tres.passes_over_A) == int(jres.passes_over_A)
            assert int(tres.bytes_per_pass) == int(jres.bytes_per_pass)
            assert tres.bytes_moved == jres.bytes_moved
            np.testing.assert_array_equal(tres.iters, np.asarray(jres.iters))
    # the rollups: the same keys, counts and integer accounting
    jm, tm = jax_meter.aggregate(), t_meter.aggregate()
    assert tm.keys() == jm.keys()
    for key in ("jobs", "by_status", "by_backend", "batched_jobs"):
        assert tm[key] == jm[key], key
    assert tm["by_status"] == {"done": 6, "failed": 3}
    jrec = {r.tag or r.job_id: r for r in jax_meter.records}
    assert len(jrec) == len(t_meter.records)
    for field in ("status", "backend", "shape", "k", "batched",
                  "error_kind"):
        assert sorted(str(getattr(r, field)) for r in t_meter.records) == \
            sorted(str(getattr(r, field)) for r in jax_meter.records), field


@pytest.mark.parametrize("shape,kw,kind", [
    ((48, 24), {}, "dense"),
    ((24, 48), dict(oversample=3), "dense"),
    ((4096, 512), dict(sweep_dtype="bfloat16", warmup_q=2), "dense"),
    ((1000, 300), dict(n_blocks=3), "numpy"),
    ((1000, 300), dict(n_blocks=3), "memmap"),
    ((1000, 300), dict(n_blocks=2, host_budget_bytes=4096,
                       sweep_dtype="bfloat16"), "memmap"),
    ((64, 64), {}, "path"),
    ((1000, 300), dict(n_blocks=3), "host-blocked matrix"),
])
def test_admission_estimate_equals_the_reference(shape, kw, kind, tmp_path):
    A = np.zeros(shape, np.float32)
    if kind == "dense":
        jx, tx = jnp.asarray(A), torch.from_numpy(A)
    elif kind == "numpy":
        jx = tx = A
    elif kind == "host-blocked matrix":   # no .shape in either package
        from repro.core.oom import HostBlockedMatrix as JaxHostBlocked
        from repro_torch.core import HostBlockedMatrix
        jx = JaxHostBlocked(A, 3)
        tx = HostBlockedMatrix(A, 3, device="cpu")
    else:
        path = str(tmp_path / "a.npy")
        np.save(path, A)
        jx = tx = path if kind == "path" else np.load(path, mmap_mode="r")
    want = jax_estimate(jserving.JobSpec(input=jx, k=K,
                                         config=JaxConfig(**kw)))
    got = estimate_cost_bytes(JobSpec(input=tx, k=K, config=SVDConfig(**kw)))
    assert got == want


def test_a_job_checkpointed_by_the_reference_resumes_here(rng, tmp_path):
    """Per-job checkpoints are the JAX package's format: a job that the
    JAX service cut at 4 iterations under ``checkpoint_root`` resumes in
    the port's service from that step and finishes at the spectrum."""
    A = make_lowrank(rng, 48, 24, SPECTRUM).astype(np.float32)
    root = str(tmp_path / "jobs")
    with jserving.SVDService(max_workers=1, checkpoint_root=root) as svc:
        h = svc.submit(jnp.asarray(A), K, config=JaxConfig(
            eps=1e-8, max_iters=4, force_iters=True))
        assert h.wait(WAIT) is jserving.JobStatus.DONE
        ckpt = os.path.join(root, h.job_id)
    assert CheckpointManager(ckpt).latest_step() == 4
    seen = []
    with service(max_workers=1) as svc:
        h = svc.submit(torch.from_numpy(A), K, config=SVDConfig(
            eps=1e-8, max_iters=200, checkpoint_dir=ckpt,
            on_iteration=lambda s: seen.append(s.it)))
        res = h.result(WAIT)
    assert seen[0] == 5                 # resumed after the JAX service's 4
    np.testing.assert_allclose(_np(res.S), SPECTRUM[:K], rtol=1e-4)


# ---------------------------------------------------------------------------
# the entry-point rule
# ---------------------------------------------------------------------------

def test_service_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: SVDService() runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SVDService()


def test_smoke_cli_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serving", "--smoke", "--device",
         "cpu", "--small", "6"], capture_output=True, text=True, cwd=ROOT,
        timeout=WAIT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT,
                                                                   "src")))
    assert out.returncode == 0, out.stderr[-3000:]
    metrics = json.loads(out.stdout[out.stdout.index("{"):])
    assert metrics["by_status"] == {"done": 7}
