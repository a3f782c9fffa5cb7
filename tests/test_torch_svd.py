"""The ported dense block t-SVD against the JAX package, on the CPU.

Every case feeds the same seeded numpy matrix to ``repro.core.svd`` (a
jax array) and to ``repro_torch.svd`` (a torch tensor, ``device="cpu"``,
so the sweeps run the plain PyTorch versions of the Hopper kernels).

Tolerances, from the JAX package's own tests: sigma to rtol 2e-4 in
fp32 (``tests/test_operator_contract.py``) and 1e-2 under bf16 sweeps
(``tests/test_precision.py``); the principal angles of U and V above
1 - 1e-3.  The two packages draw their random start from different
generators (threefry, Philox), so the subspace — not the values — is
compared after convergence; from a SHARED start (the ``svd_update`` /
``SolverState`` path) the per-step gaps are compared directly.  Integer
accounting under ``force_iters`` is exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.core.config import SolverState as JaxState
from repro.core.faults import FaultPlan as JaxPlan
from repro.core.faults import FaultSpec as JaxSpec
from repro.core.faults import inject_faults as jax_inject
from repro.core.operator import DenseOperator as JaxDense
from repro_torch.core import errors
from repro_torch.core.config import SolverState, SVDConfig
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
from repro_torch.core.operator import DenseOperator
from repro_torch.core.svd import finalize, init_state, step
from repro_torch.core.tsvd import relative_error, sweep_ops

K = 6
SPECTRUM = 10.0 * 0.5 ** np.arange(12)


def _matrix(m=96, n=40, seed=0):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(m, len(SPECTRUM))))
    V, _ = np.linalg.qr(rng.normal(size=(n, len(SPECTRUM))))
    A = (U * SPECTRUM) @ V.T + 1e-4 * rng.normal(size=(m, n))
    return A.astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _solve_both(A, **kw):
    jres = jcore.svd(jnp.asarray(A), K, **kw)
    tres = repro_torch.svd(torch.from_numpy(A), K, device="cpu", **kw)
    return jres, tres


def _assert_same_subspaces(jres, tres):
    for Xj, Xt in ((jres.U, tres.U), (jres.V, tres.V)):
        sv = np.linalg.svd(_np(Xj).T @ _np(Xt), compute_uv=False)
        assert sv.min() > 1 - 1e-3, sv


CASES = [(orient, sd, q) for orient in ("tall", "wide")
         for sd in ("float32", "bfloat16") for q in (0, 1)]


@pytest.mark.parametrize("orient,sweep_dtype,warmup_q", CASES)
def test_svd_matches_jax(orient, sweep_dtype, warmup_q):
    A = _matrix()
    A = A if orient == "tall" else np.ascontiguousarray(A.T)
    eps, rtol = (1e-6, 2e-4) if sweep_dtype == "float32" else (1e-4, 1e-2)
    jres, tres = _solve_both(A, sweep_dtype=sweep_dtype, eps=eps,
                             warmup_q=warmup_q)
    assert jres.converged and tres.converged
    assert tres.U.shape == (A.shape[0], K) and tres.V.shape == (A.shape[1], K)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=rtol)
    exact = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:K]
    np.testing.assert_allclose(_np(tres.S), exact, rtol=rtol)
    _assert_same_subspaces(jres, tres)


@pytest.mark.parametrize("orient,sweep_dtype,warmup_q", CASES)
def test_accounting_equal_under_force_iters(orient, sweep_dtype, warmup_q):
    A = _matrix()
    A = A if orient == "tall" else np.ascontiguousarray(A.T)
    jres, tres = _solve_both(A, sweep_dtype=sweep_dtype, warmup_q=warmup_q,
                             force_iters=True, max_iters=4)
    np.testing.assert_array_equal(tres.iters, np.asarray(jres.iters))
    assert tres.passes_over_A == jres.passes_over_A == 2 * 4 + 1 + (
        1 + 2 * warmup_q if warmup_q else 0)
    assert tres.bytes_per_pass == jres.bytes_per_pass
    assert tres.bytes_moved == jres.bytes_moved
    assert tres.backend == jres.backend == "dense"
    assert tres.converged is jres.converged is False
    assert tres.faults == jres.faults


def _shared_start(A, l=K + 2, seed=7):
    rng = np.random.default_rng(seed)
    Q0, _ = np.linalg.qr(rng.normal(size=(A.shape[1], l)))
    return Q0.astype(np.float32)


def test_shared_start_gaps_agree_step_by_step():
    """Fed the same Q0 through the warm path, both packages walk the same
    trajectory: the per-step subspace gaps agree to 1e-4."""
    A = _matrix()
    Q0 = _shared_start(A)
    gaps = {"jax": [], "torch": []}
    kw = dict(force_iters=True, max_iters=6)
    jcore.svd_update(JaxState(Q=Q0, k=K), jnp.asarray(A), **kw,
                     on_iteration=lambda st: gaps["jax"].append(float(st.gap)))
    repro_torch.svd_update(
        SolverState(Q=Q0, k=K), torch.from_numpy(A), device="cpu", **kw,
        on_iteration=lambda st: gaps["torch"].append(float(st.gap)))
    assert len(gaps["jax"]) == len(gaps["torch"]) == 6
    np.testing.assert_allclose(gaps["torch"], gaps["jax"], rtol=0, atol=1e-4)


def _jax_run(A, cfg_kw, steps, state=None, Q0=None):
    op = JaxDense(jnp.asarray(A))
    cfg = jcore.SVDConfig(**cfg_kw)
    if state is None:
        state = jcore.init_state(op, K, cfg, warm=Q0)
    else:
        state = state.replace(Q=op.from_host(state.Q))
    for _ in range(steps):
        state = jcore.step(op, state, cfg)
    return op, cfg, state


def _torch_run(A, cfg_kw, steps, state=None, Q0=None):
    op = DenseOperator(torch.from_numpy(A), device="cpu")
    cfg = SVDConfig(**cfg_kw)
    if state is None:
        state = init_state(op, K, cfg, warm=Q0)
    else:
        state = state.replace(Q=op.from_host(state.Q))
    for _ in range(steps):
        state = step(op, state, cfg)
    return op, cfg, state


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_trajectory_carries_across_packages(first):
    """3 steps in one package, ``to_tree`` -> ``from_tree``, 3 more in the
    other: the result matches 6 steps in the first package, with the
    cumulative pass/byte accounting carried exactly."""
    A = _matrix()
    Q0 = _shared_start(A)
    cfg_kw = dict(force_iters=True, max_iters=50)
    runs = {"jax": (_jax_run, JaxState, jcore.finalize),
            "torch": (_torch_run, SolverState, finalize)}
    second = "torch" if first == "jax" else "jax"
    run1, _, fin1 = runs[first]
    run2, state2_cls, fin2 = runs[second]
    op1, cfg1, st = run1(A, cfg_kw, 3, Q0=Q0)
    tree = st.to_tree(op1.to_host)
    carried = state2_cls.from_tree(tree, config_fp=st.config_fp,
                                   op_fp=st.op_fp)
    op2, cfg2, st2 = run2(A, cfg_kw, 3, state=carried)
    res_cross = fin2(op2, st2, cfg2)
    op_ref, cfg_ref, st_ref = run1(A, cfg_kw, 6, Q0=Q0)
    res_ref = fin1(op_ref, st_ref, cfg_ref)
    assert st2.it == st_ref.it == 6
    assert res_cross.passes_over_A == res_ref.passes_over_A == 13
    assert res_cross.bytes_moved == res_ref.bytes_moved
    np.testing.assert_allclose(_np(res_cross.S), _np(res_ref.S), rtol=2e-4)
    _assert_same_subspaces(res_ref, res_cross)


def test_rerun_is_bitwise_equal():
    A = torch.from_numpy(_matrix())
    r1 = repro_torch.svd(A, K, device="cpu", warmup_q=1)
    r2 = repro_torch.svd(A, K, device="cpu", warmup_q=1)
    for a, b in zip(r1[:3], r2[:3]):
        assert torch.equal(a, b)
    assert r1.iters.tolist() == r2.iters.tolist()


@pytest.mark.parametrize("kw", [
    {}, {"warmup_q": 2, "oversample": 4}, {"sweep_dtype": "bfloat16"},
    {"n_blocks": 7, "block_rows": 1000, "seed": 123},
    {"method": "gramfree", "eps": 1e-3}, {"seed": 2**40, "max_iters": 9},
])
def test_solver_fingerprint_is_the_jax_string(kw):
    assert SVDConfig(**kw).solver_fingerprint() == \
        jcore.SVDConfig(**kw).solver_fingerprint()


@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_operator_fingerprint_is_the_jax_string(sweep_dtype):
    A = _matrix()
    assert DenseOperator(torch.from_numpy(A), device="cpu",
                         sweep_dtype=sweep_dtype).fingerprint == \
        JaxDense(jnp.asarray(A), sweep_dtype=sweep_dtype).fingerprint


def _same_error(call_jax, call_torch):
    with pytest.raises(Exception) as ej:
        call_jax()
    with pytest.raises(Exception) as et:
        call_torch()
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
    assert isinstance(et.value, ValueError)


@pytest.mark.parametrize("kw", [
    {"method": "svd"}, {"eps": 0}, {"max_iters": 0}, {"warmup_q": -1},
    {"oversample": -1}, {"n_blocks": 0}, {"block_rows": 0},
    {"host_budget_bytes": -1}, {"checkpoint_every": 0}, {"io_retries": 0},
    {"io_retry_backoff": -1.0}, {"health_retries": -1},
    {"method": "gram", "warmup_q": 1},
    {"method": "gram", "sweep_dtype": "bfloat16"},
    {"method": "gramfree", "checkpoint_dir": "ckpt"},
    {"method": "gram", "on_iteration": print},
    {"sweep_dtype": "float16"}, {"sweep_dtype": "not-a-dtype"},
])
def test_config_errors_are_the_jax_errors(kw):
    _same_error(lambda: jcore.SVDConfig(**kw), lambda: SVDConfig(**kw))


@pytest.mark.parametrize("shape,k", [((0, 5), 1), ((7, 0), 1), ((9, 4), 5),
                                     ((9, 4), 0), ((9, 4), 2.0),
                                     ((9, 4), True)])
def test_input_errors_are_the_jax_errors(shape, k):
    A = np.ones(shape, np.float32)
    _same_error(lambda: jcore.svd(jnp.asarray(A), k),
                lambda: repro_torch.svd(torch.from_numpy(A), k,
                                        device="cpu"))


def test_solver_state_tree_is_the_jax_tree():
    Q = _shared_start(_matrix())
    kw = dict(k=K, it=4, prev_gap=0.25, gap=None, converged=False,
              passes=9, bytes_moved={"device": 1234})
    tj, tt = JaxState(Q=Q, **kw).to_tree(), SolverState(Q=Q, **kw).to_tree()
    assert tj.keys() == tt.keys()
    for key in tj:
        assert tt[key].dtype == tj[key].dtype, key
        np.testing.assert_array_equal(tt[key], tj[key])
    hj, ht = JaxState.host_template(), SolverState.host_template()
    assert {k: v.dtype for k, v in hj.items()} == \
        {k: v.dtype for k, v in ht.items()}


@pytest.mark.parametrize("call", [
    lambda A: repro_torch.svd(A.numpy(), K, device="cpu"),
    lambda A: repro_torch.svd("A.npy", K, device="cpu"),
    lambda A: repro_torch.svd(A, K, device="cpu", mesh=object()),
    lambda A: repro_torch.svd(A, K, device="cpu", method="gram"),
    lambda A: repro_torch.svd(A, K, device="cpu", method="gramfree"),
    lambda A: repro_torch.svd(A, K, device="cpu", checkpoint_dir="ckpt"),
])
def test_unported_inputs_raise_not_implemented(call):
    with pytest.raises(NotImplementedError, match="ROADMAP.md, queue 1"):
        call(torch.from_numpy(_matrix()))


def test_undispatchable_input_is_an_input_error():
    with pytest.raises(errors.InputError):
        repro_torch.svd([[1.0, 2.0]], 1, device="cpu")


def test_sweep_fault_rolls_back_like_jax():
    """A NaN planted in one sweep is caught by the health guard and the
    solve replays onto the bitwise fault-free result; both packages
    report the same fault telemetry for the same plan."""
    A = _matrix()
    clean = repro_torch.svd(torch.from_numpy(A), K, device="cpu")
    with inject_faults(FaultPlan(FaultSpec("sweep", at=3))):
        hit = repro_torch.svd(torch.from_numpy(A), K, device="cpu")
    with jax_inject(JaxPlan(JaxSpec("sweep", at=3))):
        jhit = jcore.svd(jnp.asarray(A), K)
    for a, b in zip(clean[:3], hit[:3]):
        assert torch.equal(a, b)
    assert hit.passes_over_A == clean.passes_over_A
    assert hit.faults["counters"] == jhit.faults["counters"] == {
        "sweep.injected": 1, "health.rollback": 1}


def test_device_oom_without_lower_tier_is_fault_exhausted():
    A = torch.from_numpy(_matrix())
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=2))):
        with pytest.raises(errors.FaultExhaustedError) as e:
            repro_torch.svd(A, K, device="cpu")
    assert isinstance(e.value.__cause__, errors.DeviceOOMFault)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=0))):
        with pytest.raises(errors.DeviceOOMFault):
            repro_torch.svd(A, K, device="cpu", demote_on_oom=False)
    assert errors.is_oom_error(torch.cuda.OutOfMemoryError("CUDA OOM"))
    assert not errors.is_oom_error(RuntimeError("other"))


@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_sweep_ops_match_jax(sweep_dtype):
    A = _matrix()
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(A.shape[1], 5)).astype(np.float32)
    Y = rng.normal(size=(A.shape[0], 5)).astype(np.float32)
    jmm, jrmm = jcore.sweep_ops(jnp.asarray(A), sweep_dtype)
    tmm, trmm = sweep_ops(torch.from_numpy(A), sweep_dtype)
    np.testing.assert_allclose(tmm(torch.from_numpy(Q)).numpy(),
                               np.asarray(jmm(jnp.asarray(Q))),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(trmm(torch.from_numpy(Y)).numpy(),
                               np.asarray(jrmm(jnp.asarray(Y))),
                               rtol=1e-4, atol=2e-3)


def test_relative_error_matches_jax():
    A = _matrix()
    jres, tres = _solve_both(A)
    want = float(jcore.relative_error(jnp.asarray(A), jres))
    got = float(relative_error(torch.from_numpy(A), tres))
    np.testing.assert_allclose(got, want, rtol=1e-3)


class _DemotingOperator(DenseOperator):
    """A custom operator with a lower tier: the same matrix, fresh."""

    def demote(self, cfg):
        return DenseOperator(self._A, device="cpu")


def test_oom_demotion_carries_the_iterate_and_the_accounting():
    """A device OOM on an operator that has a lower tier continues there
    from the warm iterate; under force_iters the totals are conserved."""
    A = torch.from_numpy(_matrix())
    kw = dict(device="cpu", force_iters=True, max_iters=6)
    clean = repro_torch.svd(A, K, **kw)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3))):
        res = repro_torch.svd(_DemotingOperator(A, device="cpu"), K, **kw)
    assert res.faults["counters"] == {"device_oom.injected": 1,
                                      "device_oom.demote": 1}
    assert res.passes_over_A == clean.passes_over_A == 2 * 6 + 1
    assert res.bytes_moved == clean.bytes_moved
    np.testing.assert_allclose(res.S.numpy(), clean.S.numpy(), rtol=1e-5)
