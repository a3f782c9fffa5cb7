"""The port's micro-batcher (``repro_torch.serving.batcher``) against its
per-job solves and the JAX package's batcher, on the CPU.

Counterparts of ``tests/test_serving_batch.py``'s contracts:

* differential — a batch lane agrees with a standalone per-job ``svd()``
  at the same config (sigma rtol 1e-4, subspace cosines > 1 - 1e-3),
  against the dense and the host-blocked per-job baselines of BOTH
  packages; the port's lane draws the same ``Q0`` as the port's per-job
  solve, the JAX package's from another generator (the subspace is the
  contract there);
* isolation — a poisoned lane (NaN input) fails ALONE with the engine's
  typed ``NumericalHealthError``; its batchmates complete, both at the
  ``solve_batch`` level and through the full service;
* honest accounting — per-lane passes/bytes follow the engine's
  counting convention against the lane's own iteration count, and equal
  the JAX package's lane for lane under the same iteration count;
* routing — stragglers fall back to the sequential runner
  (``batched=False`` in the cost record) and ``max_batch`` splits a
  burst into dispatches no larger than the cap;
* bf16 lanes round where ``sweep_ops`` rounds (``X`` once, ``Q`` and
  ``Y`` entering a product, fp32 sums, the extraction on the fp32 ``X``).

Iterations: a lane stops at the first step whose gap is within
``eps * l``; the per-job driver reads that gap one step late (lagged
sync) and stops one step later, and at ``eps = 1e-8`` the fp32 gap is
near its rounding noise, so a lane's count is held within two steps of
the per-job solve's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import make_lowrank

import repro.serving.batcher as jbatcher
from repro.core import SVDConfig as JaxConfig
from repro.core.svd import _dispatch as jax_dispatch
from repro.serving import JobSpec as JaxSpec
from repro_torch.core import NumericalHealthError
from repro_torch.core.config import SVDConfig
from repro_torch.core.svd import _dispatch
from repro_torch.serving import JobSpec, JobStatus, SVDService
from repro_torch.serving.batcher import (MAX_BATCH_ELEMS, _bmm_fp32,
                                         batch_key, batchable, solve_batch)

M, N, K = 48, 24, 4
SPECTRUM = np.geomspace(10.0, 1e-2, N)
WAIT = 60.0


def _spec(rng, *, seed=0, as_numpy=False, warmup_q=0, nan=False,
          **cfg_kw):
    A = make_lowrank(rng, M, N, SPECTRUM).astype(np.float32)
    if nan:
        A = A.copy()
        A[3, 5] = np.nan
    cfg_kw.setdefault("eps", 1e-8)
    cfg_kw.setdefault("max_iters", 300)
    cfg = SVDConfig(seed=seed, warmup_q=warmup_q, **cfg_kw)
    X = A if as_numpy else torch.from_numpy(A)
    return JobSpec(input=X, k=K, config=cfg)


def _jax_spec(spec):
    """The same job for the JAX package (numpy stays numpy, a tensor
    becomes a jax array)."""
    cfg = spec.config
    X = spec.input
    X = np.asarray(X) if isinstance(X, np.ndarray) else jnp.asarray(
        X.numpy())
    return JaxSpec(input=X, k=spec.k, config=JaxConfig(
        **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _aligned(V, Vref, atol=1e-3):
    """Subspaces equal up to rotation: svals of V^T Vref are all ~1."""
    s = np.linalg.svd(_np(V).T @ _np(Vref), compute_uv=False)
    return np.allclose(s, 1.0, atol=atol)


def _per_job(spec):
    """The standalone per-job solves of both packages."""
    return (_dispatch(spec.input, spec.k, device="cpu",
                      config=spec.resolved_config()),
            jax_dispatch(_jax_spec(spec).input, spec.k,
                         config=_jax_spec(spec).config))


# -- batchable / batch_key routing ----------------------------------------


def test_batchable_accepts_small_dense_block_jobs(rng):
    assert batchable(_spec(rng))
    assert batchable(_spec(rng, as_numpy=True, warmup_q=1))


@pytest.mark.parametrize("mut", [
    dict(method="gram"),
    dict(on_iteration=lambda s: None),
    dict(checkpoint_dir="/tmp/nope"),
    dict(force_iters=True),
])
def test_batchable_rejects_scalar_driver_plumbing(rng, mut):
    spec = _spec(rng, **mut)
    assert not batchable(spec)
    assert not jbatcher.batchable(_jax_spec(spec))


def test_batchable_rejects_streaming_memmap_and_big(rng, tmp_path):
    sub = dataclasses.replace
    assert not batchable(sub(_spec(rng), stream_every=1))
    p = tmp_path / "a.npy"
    np.save(p, make_lowrank(rng, M, N, SPECTRUM))
    mm = np.load(p, mmap_mode="r")
    assert not batchable(sub(_spec(rng), input=mm))
    big = np.zeros((MAX_BATCH_ELEMS // 8, 16), np.float32)
    assert not batchable(sub(_spec(rng), input=big))
    assert not batchable(sub(_spec(rng), input=torch.from_numpy(big)))
    assert not batchable(sub(_spec(rng), k=N + 1))
    assert MAX_BATCH_ELEMS == jbatcher.MAX_BATCH_ELEMS


def test_batch_key_groups_by_shape_and_solver_knobs(rng):
    a, b = _spec(rng, seed=0), _spec(rng, seed=7)
    assert batch_key(a) == batch_key(b)  # seed is per-lane, not a key
    assert batch_key(a) != batch_key(_spec(rng, warmup_q=1))
    assert batch_key(a) != batch_key(_spec(rng, eps=1e-4))
    assert batch_key(a) != batch_key(dataclasses.replace(a, k=K + 1))
    assert batch_key(a) == jbatcher.batch_key(_jax_spec(a))


# -- differential contracts -----------------------------------------------


def _check_lanes_match(specs, lanes):
    for s, (res, err) in zip(specs, lanes):
        assert err is None
        ours, theirs = _per_job(s)
        for ref in (ours, theirs):
            np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-4)
            assert _aligned(res.V, ref.V)
            assert _aligned(res.U, ref.U)
        assert res.converged
        # lanes iterate together but stop per-lane: each lane's count
        # follows its own standalone trajectory
        assert abs(int(res.iters[0]) - int(ours.iters[0])) <= 2
    return ours


def test_batch_matches_per_job_dense_baseline(rng):
    specs = [_spec(rng, seed=i) for i in range(5)]
    ref = _check_lanes_match(specs, solve_batch(specs, device="cpu"))
    assert ref.backend == "dense"


def test_batch_matches_per_job_hostblocked_baseline(rng):
    # numpy inputs route the standalone baselines through the host-blocked
    # backend — the batch must agree with THAT too, in both packages
    specs = [_spec(rng, seed=i, as_numpy=True, n_blocks=2)
             for i in range(4)]
    for s, (res, err) in zip(specs, solve_batch(specs, device="cpu")):
        assert err is None
        for per_job in _per_job(s):
            assert per_job.backend == "hostblocked"
            np.testing.assert_allclose(_np(res.S), _np(per_job.S),
                                       rtol=1e-4)
            assert _aligned(res.V, per_job.V)


def test_batch_with_warmup_matches_per_job(rng):
    specs = [_spec(rng, seed=i, warmup_q=1, oversample=4)
             for i in range(3)]
    _check_lanes_match(specs, solve_batch(specs, device="cpu"))


def test_lane_starts_where_the_per_job_solve_starts(rng):
    """A lane draws the port's per-job Q0 for its seed: one forced step
    of each agrees to the products' rounding."""
    specs = [_spec(rng, seed=s, max_iters=1, eps=1e-30) for s in (3, 11)]
    for s, (res, err) in zip(specs, solve_batch(specs, device="cpu")):
        ref = _dispatch(s.input, K, device="cpu", config=s.resolved_config())
        assert int(res.iters[0]) == int(ref.iters[0]) == 1
        np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-5)
        assert _aligned(res.V, ref.V, atol=1e-5)


def test_wide_inputs_stack_transposed_and_swap_factors(rng):
    A = make_lowrank(rng, N, M, SPECTRUM).astype(np.float32)  # 24 x 48
    cfg = SVDConfig(eps=1e-8, max_iters=300)
    specs = [JobSpec(input=torch.from_numpy(A), k=K, config=cfg)]
    (res, err), = solve_batch(specs, device="cpu")
    assert err is None
    assert res.U.shape == (N, K) and res.V.shape == (M, K)
    for ref in _per_job(specs[0]):
        np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-4)
        assert _aligned(res.U, ref.U) and _aligned(res.V, ref.V)


def test_bf16_lanes_round_where_sweep_ops_rounds(rng):
    """bf16 lanes: the products of the rounded operands with fp32 sums,
    which is the port's plain bf16 sweep bit for bit; the lane agrees
    with the port's per-job bf16 solve (same Q0, same rounding points)
    and with the JAX package's bf16 batch (its sweep_ops), and sits off
    the fp32 lane by the rounding of X."""
    from repro_torch.kernels import ref as kref
    X = torch.from_numpy(make_lowrank(rng, M, N, SPECTRUM)
                         .astype(np.float32))
    Q = torch.randn((N, 6), generator=torch.Generator().manual_seed(0))
    Xs, Qs = X.to(torch.bfloat16), Q.to(torch.bfloat16)
    assert torch.equal(_bmm_fp32(Xs[None], Qs[None])[0],
                       kref.block_matvec_ref(X, Q, "bfloat16"))
    specs = [_spec(rng, seed=i, sweep_dtype="bfloat16", eps=1e-5)
             for i in range(3)]
    lanes = solve_batch(specs, device="cpu")
    jlanes = jbatcher.solve_batch([_jax_spec(s) for s in specs])
    f32 = solve_batch([dataclasses.replace(
        s, config=s.config.replace(sweep_dtype="float32")) for s in specs],
        device="cpu")
    for s, (res, err), (jres, jerr), (fres, _) in zip(specs, lanes, jlanes,
                                                       f32):
        assert err is None and jerr is None
        ref = _dispatch(s.input, K, device="cpu", config=s.resolved_config())
        np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-4)
        np.testing.assert_allclose(_np(res.S), np.asarray(jres.S),
                                   rtol=1e-4)
        assert _aligned(res.V, ref.V) and _aligned(res.V, jres.V)
        assert res.bytes_per_pass == jres.bytes_per_pass == M * N * 2
        assert not torch.equal(res.V, fres.V)


# -- isolation: a poisoned lane fails alone -------------------------------


def test_nan_lane_fails_alone_in_solve_batch(rng):
    specs = [_spec(rng, seed=0), _spec(rng, seed=1, nan=True),
             _spec(rng, seed=2)]
    lanes = solve_batch(specs, device="cpu")
    (res0, err0), (resN, errN), (res2, err2) = lanes
    assert err0 is None and err2 is None
    assert resN is None
    assert isinstance(errN, NumericalHealthError)
    assert errN.kind == "nonfinite"
    for res, s in ((res0, specs[0]), (res2, specs[2])):
        for ref in _per_job(s):
            np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-4)
        assert res.converged
    # the JAX package's batch fails the same lane the same way
    jl = jbatcher.solve_batch([_jax_spec(s) for s in specs])
    assert [type(e).__name__ if e is not None else None for _, e in jl] \
        == [type(e).__name__ if e is not None else None for _, e in lanes]


def test_nan_lane_fails_alone_through_the_service(rng):
    good = [make_lowrank(rng, M, N, SPECTRUM).astype(np.float32)
            for _ in range(3)]
    bad = good[0].copy()
    bad[0, 0] = np.nan
    cfg = SVDConfig(eps=1e-8, max_iters=300)
    with SVDService(max_workers=1, max_batch=4, batch_window_s=0.25,
                    device="cpu") as svc:
        hs = [svc.submit(torch.from_numpy(A), K, config=cfg.replace(seed=i))
              for i, A in enumerate(good)]
        hbad = svc.submit(torch.from_numpy(bad), K,
                          config=cfg.replace(seed=9))
        for h in hs:
            assert h.wait(WAIT) is JobStatus.DONE
        assert hbad.wait(WAIT) is JobStatus.FAILED
        assert hbad.error_kind == "internal"       # the 5xx class
        assert isinstance(hbad.error, NumericalHealthError)
        recs = {r.job_id: r for r in svc.meter.records}
    # all four rode the same dispatch — including the failed lane
    assert all(recs[h.job_id].batched for h in hs + [hbad])
    assert recs[hbad.job_id].batch_size == 4


# -- accounting -----------------------------------------------------------


def test_batch_lane_accounting_follows_engine_convention(rng):
    specs = [_spec(rng, seed=i) for i in range(2)]
    for res, err in solve_batch(specs, device="cpu"):
        assert err is None
        it = int(res.iters[0])
        assert res.passes_over_A == 2 * it + 1      # cold start
        assert res.bytes_per_pass == M * N * 4
        assert res.bytes_moved == {
            "device": res.passes_over_A * res.bytes_per_pass}
    (res, _), = solve_batch([_spec(rng, warmup_q=2)], device="cpu")
    it = int(res.iters[0])
    assert res.passes_over_A == (2 * 2 + 1) + 2 * it + 1
    # lane for lane the JAX package's numbers at the same iteration count:
    # max_iters caps both batches at 3 steps
    capped = [_spec(rng, seed=i, warmup_q=1, max_iters=3, eps=1e-30)
              for i in range(2)]
    for (res, _), (jres, _) in zip(
            solve_batch(capped, device="cpu"),
            jbatcher.solve_batch([_jax_spec(s) for s in capped])):
        np.testing.assert_array_equal(res.iters, np.asarray(jres.iters))
        assert (res.passes_over_A, res.bytes_per_pass, res.bytes_moved,
                res.backend, res.converged) == (
            jres.passes_over_A, jres.bytes_per_pass, jres.bytes_moved,
            jres.backend, jres.converged)


# -- service routing: stragglers and max_batch splits ---------------------


def test_straggler_falls_back_to_sequential_runner(rng):
    with SVDService(max_workers=1, max_batch=8, batch_window_s=0.05,
                    device="cpu") as svc:
        h = svc.submit(torch.from_numpy(make_lowrank(rng, M, N, SPECTRUM)
                                        .astype(np.float32)), K,
                       config=SVDConfig(eps=1e-8, max_iters=300))
        assert h.wait(WAIT) is JobStatus.DONE
        rec, = [r for r in svc.meter.records if r.job_id == h.job_id]
    assert rec.batched is False and rec.batch_size == 1
    assert rec.backend == "dense"


def test_max_batch_splits_burst_into_capped_dispatches(rng):
    cfg = SVDConfig(eps=1e-8, max_iters=300)
    with SVDService(max_workers=1, max_batch=4, batch_window_s=0.25,
                    device="cpu") as svc:
        hs = [svc.submit(torch.from_numpy(make_lowrank(rng, M, N, SPECTRUM)
                                          .astype(np.float32)), K,
                         config=cfg.replace(seed=i))
              for i in range(5)]
        for h in hs:
            assert h.wait(WAIT) is JobStatus.DONE
        sizes = sorted(r.batch_size for r in svc.meter.records)
    assert sizes == [1, 4, 4, 4, 4]


def test_different_shapes_never_share_a_dispatch(rng):
    cfg = SVDConfig(eps=1e-8, max_iters=300)
    with SVDService(max_workers=1, max_batch=8, batch_window_s=0.25,
                    device="cpu") as svc:
        a = svc.submit(torch.from_numpy(make_lowrank(rng, M, N, SPECTRUM)
                                        .astype(np.float32)), K, config=cfg)
        b = svc.submit(torch.from_numpy(
            make_lowrank(rng, 32, 16, SPECTRUM[:16]).astype(np.float32)),
            K, config=cfg)
        assert a.wait(WAIT) is JobStatus.DONE
        assert b.wait(WAIT) is JobStatus.DONE
        recs = {r.job_id: r for r in svc.meter.records}
    assert recs[a.job_id].batched is False
    assert recs[b.job_id].batched is False
