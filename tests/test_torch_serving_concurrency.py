"""Concurrent-solve safety of the port: the audit behind its SVD service.

Counterparts of ``tests/test_serving_concurrency.py``.  A serving
process runs many ``repro_torch.svd()`` calls from a thread pool, so
per-solve state must be instance state:

* two DIFFERENT inputs solved concurrently give bitwise the same
  answers (and the same pass/byte accounting) as solving them serially,
  by threads and through a two-worker service;
* one SHARED operator instance refuses an overlapping second solve with
  the typed ``InputError`` (the 4xx class) matching "already running",
  and is reusable afterwards — the behaviour the JAX package documents
  for its guard (its own test of it fails on that tree; the port's guard
  is ``LinearOperator.acquire_solve``);
* sequential reuse of the same operator stays legal;
* the batcher's cached builder is race-free (one callable per
  signature, whoever asks first);
* the module-level launch counts of ``kernels/ops.py``, written by every
  thread that launches, lose no update under contention, and each
  thread's own tally (a job's ``Job.launches``) counts only its launches.

Every wait has a timeout.
"""
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from conftest import make_lowrank

from repro_torch import svd
from repro_torch.core import DenseOperator, InputError, SVDConfig
from repro_torch.kernels import ops
from repro_torch.serving import JobStatus, SVDService
from repro_torch.serving.batcher import batched_block_solve_fn

M, N, K = 48, 24, 4
SPECTRUM = np.geomspace(10.0, 1e-2, N)
CFG = SVDConfig(eps=1e-8, max_iters=300)
WAIT = 60.0


def _solve(A, seed):
    return svd(A, K, device="cpu", config=CFG.replace(seed=seed))


def _inputs(rng):
    A = torch.from_numpy(make_lowrank(rng, M, N, SPECTRUM)
                         .astype(np.float32))
    B = torch.from_numpy(make_lowrank(rng, 2 * M, N, SPECTRUM)
                         .astype(np.float32))
    return A, B


def _same(serial, threaded):
    for s, t in zip(serial, threaded):
        for a, b in zip(s[:3], t[:3]):
            assert torch.equal(a, b)
        assert s.passes_over_A == t.passes_over_A
        assert s.bytes_moved == t.bytes_moved
        assert s.iters.tolist() == t.iters.tolist()


def test_two_threaded_jobs_match_serial_bitwise(rng):
    """The regression for the shared-mutable-state audit: concurrent
    solves of independent inputs are bitwise identical to serial."""
    A, B = _inputs(rng)
    serial = [_solve(A, 0), _solve(B, 7)]
    with ThreadPoolExecutor(max_workers=2) as pool:
        fa = pool.submit(_solve, A, 0)
        fb = pool.submit(_solve, B, 7)
        threaded = [fa.result(WAIT), fb.result(WAIT)]
    _same(serial, threaded)


def test_two_service_workers_match_serial_bitwise(rng):
    """The same through a two-worker service: stream_every keeps both on
    the sequential runner, so the jobs run at once on two workers."""
    A, B = _inputs(rng)
    serial = [_solve(A, 0), _solve(B, 7)]
    with SVDService(max_workers=2, device="cpu") as svc:
        hs = [svc.submit(X, K, config=CFG.replace(seed=s), stream_every=5)
              for X, s in ((A, 0), (B, 7))]
        threaded = [h.result(WAIT) for h in hs]
    _same(serial, threaded)


def test_shared_operator_concurrent_reuse_raises_input_error(rng):
    """One operator, two overlapping driver loops: the second must be
    refused with the typed 4xx error, not silently cross-wire state."""
    A, _ = _inputs(rng)
    op = DenseOperator(A, device="cpu")
    inside = threading.Event()
    release = threading.Event()

    def park(state):
        inside.set()
        if not release.wait(WAIT):
            raise TimeoutError("the test never released the first solve")

    def long_solve():
        return svd(op, K, config=CFG.replace(on_iteration=park,
                                             force_iters=True,
                                             max_iters=5))

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(long_solve)
        assert inside.wait(WAIT), "first solve never started iterating"
        try:
            with pytest.raises(InputError, match="already running"):
                svd(op, K, config=CFG)
        finally:
            release.set()
        res = fut.result(WAIT)
    assert res.S.shape == (K,)
    # the guard released: the operator is reusable again afterwards
    res2 = svd(op, K, config=CFG)
    np.testing.assert_allclose(res2.S.numpy(), res.S.numpy(), rtol=1e-4)


def test_sequential_reuse_of_one_operator_stays_legal(rng):
    A, _ = _inputs(rng)
    op = DenseOperator(A, device="cpu")
    r1 = svd(op, K, config=CFG)
    r2 = svd(op, K, config=CFG)
    assert torch.equal(r1.S, r2.S)
    # counters accumulate across solves on a reused operator; each
    # result still reports only its own solve's passes
    assert r1.passes_over_A == r2.passes_over_A


def test_acquire_release_guard_unit(rng):
    A, _ = _inputs(rng)
    op = DenseOperator(A, device="cpu")
    op.acquire_solve()
    with pytest.raises(InputError, match="already running"):
        op.acquire_solve()
    op.release_solve()
    op.release_solve()          # idempotent: double release is a no-op
    op.acquire_solve()          # and the claim cycle works again
    op.release_solve()


def test_guard_lazy_init_on_ducktyped_operator(rng):
    """Operators that skip ``LinearOperator.__init__`` (duck-typed
    subclasses) still get a working lock."""
    A, _ = _inputs(rng)
    op = DenseOperator.__new__(DenseOperator)
    op._A = op._As = A
    op._shape = tuple(A.shape)
    op._trans = False
    op.device = torch.device("cpu")
    op.sweep_dtype = "float32"
    op._passes = 0
    op._telemetry = None
    op._retry_policy = None
    assert "_solve_lock" not in op.__dict__
    op.acquire_solve()
    with pytest.raises(InputError):
        op.acquire_solve()
    op.release_solve()


def test_lru_cached_batch_builder_is_race_free():
    """N threads asking for the same batch signature must all get the
    SAME callable (one cache entry, no duplicate builds)."""
    sig = (M, N, K, K, "float32", 1e-8, 300, 0)
    batched_block_solve_fn.cache_clear()
    barrier = threading.Barrier(4)

    def build():
        barrier.wait(10)
        return batched_block_solve_fn(*sig)

    with ThreadPoolExecutor(max_workers=4) as pool:
        fns = [f.result(WAIT) for f in [pool.submit(build)
                                        for _ in range(4)]]
    assert all(fn is fns[0] for fn in fns)


class _YieldingCounts(dict):
    """A counts dict that lets other threads run between the read and the
    write of ``d[k] += 1``, so an increment outside a lock loses updates."""

    def __getitem__(self, key):
        value = super().__getitem__(key)
        time.sleep(0)
        return value


def test_launch_counts_lose_no_update_under_contention(monkeypatch):
    """The service's workers count their launches into ``ops.launches``
    at once.  With counts that yield between the read and the write of
    each increment, many threads lose no update: the lock holds it."""
    threads, each = 8, 300
    monkeypatch.setattr(ops, "launches", _YieldingCounts(ops.launches))
    monkeypatch.setattr(ops, "route_launches",
                        _YieldingCounts(ops.route_launches))
    ops.reset_launches()
    barrier = threading.Barrier(threads)

    def count():
        barrier.wait(10)
        for _ in range(each):
            ops._count("block_matvec", "block_matvec/tf32x3")

    with ThreadPoolExecutor(max_workers=threads) as pool:
        for f in [pool.submit(count) for _ in range(threads)]:
            f.result(WAIT)
    assert ops.launches["block_matvec"] == threads * each
    assert ops.route_launches["block_matvec/tf32x3"] == threads * each
    ops.reset_launches()


def test_thread_launches_tally_only_their_own_thread():
    """``ops.thread_launches`` (a job's ``Job.launches`` in the service)
    counts the launches of the thread that opened it, by kernel and by
    route, while the module's counts take every thread's."""
    ops.reset_launches()
    barrier = threading.Barrier(2)

    def job(n, name, route):
        with ops.thread_launches() as tally:
            barrier.wait(10)
            for _ in range(n):
                ops._count(name, route)
        return tally

    with ThreadPoolExecutor(max_workers=2) as pool:
        a = pool.submit(job, 5, "block_matvec", "block_matvec/tf32x3")
        b = pool.submit(job, 3, "deflate_rmatvec", None)
        a, b = a.result(WAIT), b.result(WAIT)
    assert a == {"block_matvec": 5, "block_matvec/tf32x3": 5}
    assert b == {"deflate_rmatvec": 3}
    assert ops.launches["block_matvec"] == 5
    assert ops.launches["deflate_rmatvec"] == 3
    ops._count("matvec")                   # no tally open: counts only
    assert ops.launches["matvec"] == 1
    ops.reset_launches()


def test_service_workers_leave_launch_counts_untouched_on_the_cpu(rng):
    """The CPU path never counts: a burst through the service on the CPU
    leaves the card's counts at zero."""
    ops.reset_launches()
    A, B = _inputs(rng)
    with SVDService(max_workers=2, device="cpu") as svc:
        hs = [svc.submit(X, K, config=CFG) for X in (A, B)]
        assert all(h.wait(WAIT) is JobStatus.DONE for h in hs)
        assert all(svc._jobs[h.job_id].launches == {} for h in hs)
    assert not any(ops.launches.values())
