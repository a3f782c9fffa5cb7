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
import scipy.sparse
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
         for sd in ("float32", "bfloat16") for q in (0, 1)] + [
    # odd width (96 x 43): the bf16 copy's rows are padded to 16 bytes
    ("odd", sd, 0) for sd in ("float32", "bfloat16")]


def _oriented(orient):
    """The case's matrix: 96 x 40, its transpose, or 96 x 43."""
    if orient == "odd":
        return _matrix(n=43)
    A = _matrix()
    return A if orient == "tall" else np.ascontiguousarray(A.T)


@pytest.mark.parametrize("orient,sweep_dtype,warmup_q", CASES)
def test_svd_matches_jax(orient, sweep_dtype, warmup_q):
    A = _oriented(orient)
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
    A = _oriented(orient)
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


@pytest.fixture
def world1(tmp_path):
    """A world-1 gloo group and a (1,) "cpu" mesh in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("call", [
    lambda A: repro_torch.svd(A, K, device="cpu", mesh=object()),
])
def test_unported_inputs_raise_not_implemented(call):
    """``mesh=`` (once unported) takes a ``DeviceMesh``; any other object
    is the typed ``InputError``."""
    with pytest.raises(errors.InputError, match="DeviceMesh"):
        call(torch.from_numpy(_matrix()))


def test_mesh_names_its_roadmap_item(world1):
    """``mesh=`` (ROADMAP.md item 8, once refused) on a world-1 mesh: the
    dense solve's chain (the same start, sweeps and QR: equal iterations
    and passes), sigma to the extraction's rounding, row-sharded U."""
    A = torch.from_numpy(_matrix())
    sharded = repro_torch.svd(A, K, mesh=world1)
    dense = repro_torch.svd(A, K, device="cpu")
    assert sharded.backend == "sharded"
    np.testing.assert_array_equal(sharded.iters, dense.iters)
    assert sharded.passes_over_A == dense.passes_over_A
    np.testing.assert_allclose(_np(sharded.S), _np(dense.S), rtol=2e-4)
    U = sharded.U.full_tensor()
    assert tuple(U.shape) == tuple(dense.U.shape)
    for X, Y in ((U, dense.U), (sharded.V, dense.V)):
        assert np.linalg.svd(_np(X).T @ _np(Y), compute_uv=False).min() > \
            1 - 1e-3


def _dense_reference():
    return repro_torch.svd(torch.from_numpy(_matrix()), K, device="cpu")


def test_scipy_input_runs_the_sparse_stream():
    """A scipy matrix (once refused) runs on the sparse stream and finds
    the dense solve's spectrum and subspaces."""
    res = repro_torch.svd(scipy.sparse.csr_matrix(_matrix()), K,
                          device="cpu")
    dense = _dense_reference()
    assert res.backend == "scipysparse" and res.converged
    np.testing.assert_allclose(_np(res.S), _np(dense.S), rtol=2e-4)
    for X, Y in ((res.U, dense.U), (res.V, dense.V)):
        assert np.linalg.svd(_np(X).T @ _np(Y), compute_uv=False).min() > \
            1 - 1e-3


def test_npz_path_runs_the_sparse_stream(tmp_path):
    """A ``.npz`` path (once refused) loads onto the sparse stream: the
    same solve as the in-memory scipy matrix, bitwise."""
    path = str(tmp_path / "A.npz")
    scipy.sparse.save_npz(path, scipy.sparse.csr_matrix(_matrix()))
    got = repro_torch.svd(path, K, device="cpu")
    want = repro_torch.svd(scipy.sparse.load_npz(path), K, device="cpu")
    assert got.backend == "scipysparse"
    torch.testing.assert_close(got.S, want.S, rtol=0, atol=0)


def test_checkpoint_dir_saves_and_resumes(tmp_path):
    """``checkpoint_dir`` (once refused) writes the solver state every
    iteration and resumes a capped solve onto the uncapped one's bits."""
    A = torch.from_numpy(_matrix())
    ck = str(tmp_path / "ckpt")
    ref = repro_torch.svd(A, K, device="cpu")
    first = repro_torch.svd(A, K, device="cpu", max_iters=2,
                            checkpoint_dir=ck)
    assert int(first.iters[0]) == 2 and not first.converged
    again = repro_torch.svd(A, K, device="cpu", checkpoint_dir=ck)
    torch.testing.assert_close(again.S, ref.S, rtol=0, atol=0)
    assert again.passes_over_A == ref.passes_over_A


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


def test_device_oom_without_lower_tier_is_fault_exhausted(tmp_path):
    """The disk tier is the bottom of the ladder: a device OOM there ends
    the solve with the JAX package's error (tests/test_faults.py:290)."""
    from repro_torch.core import stage_to_disk
    p = stage_to_disk(_matrix(), tmp_path / "a.npy")
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=2))):
        with pytest.raises(errors.FaultExhaustedError,
                           match="no lower tier") as e:
            repro_torch.svd(p, K, device="cpu")
    assert isinstance(e.value.__cause__, errors.DeviceOOMFault)
    assert e.value.faults["counters"] == {"device_oom.injected": 1}
    A = torch.from_numpy(_matrix())
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=0))):
        with pytest.raises(errors.DeviceOOMFault):
            repro_torch.svd(A, K, device="cpu", demote_on_oom=False)
    assert errors.is_oom_error(torch.cuda.OutOfMemoryError("CUDA OOM"))
    assert not errors.is_oom_error(RuntimeError("other"))


def test_oom_demotes_dense_to_hostblocked():
    """A device OOM on the dense tier pulls A back to the host and
    finishes on the host-blocked tier from the warm iterate, as the JAX
    package does (tests/test_faults.py:255)."""
    A = _matrix()
    ref = repro_torch.svd(torch.from_numpy(A), K, device="cpu", seed=1)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3))):
        res = repro_torch.svd(torch.from_numpy(A), K, device="cpu", seed=1)
    with jax_inject(JaxPlan(JaxSpec("device_oom", at=3))):
        jres = jcore.svd(jnp.asarray(A), K, seed=1)
    assert res.backend == jres.backend == "hostblocked"
    assert res.converged
    np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-4)
    assert res.faults["counters"] == jres.faults["counters"] == {
        "device_oom.injected": 1, "device_oom.demote": 1}
    ev = [e for e in res.faults["events"] if e["action"] == "demote"]
    assert ev[0]["frm"] == "dense" and ev[0]["to"] == "hostblocked"


@pytest.mark.parametrize("orient", ["tall", "wide"])
def test_oom_demotes_hostblocked_to_memmap_conserving_passes(orient):
    """Under force_iters both streamed tiers cost one pass an iteration
    plus the extraction: demotion loses and double-counts none, and the
    spilled file keeps the block plan (tests/test_faults.py:270)."""
    A = _matrix() if orient == "tall" else np.ascontiguousarray(_matrix().T)
    iters = 10
    kw = dict(seed=1, n_blocks=4, force_iters=True, max_iters=iters)
    ref = repro_torch.svd(A, K, device="cpu", **kw)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=4))):
        res = repro_torch.svd(A, K, device="cpu", **kw)
    with jax_inject(JaxPlan(JaxSpec("device_oom", at=4))):
        jres = jcore.svd(A, K, **kw)
    assert res.backend == jres.backend == "memmap"
    assert ref.passes_over_A == iters + 1
    assert res.passes_over_A == jres.passes_over_A == ref.passes_over_A
    np.testing.assert_allclose(_np(res.S), _np(ref.S), rtol=1e-3)
    ev = [e for e in res.faults["events"] if e["action"] == "demote"]
    assert ev[0]["frm"] == "hostblocked" and ev[0]["to"] == "memmap"
    assert ev[0]["it"] == 4


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


# ---------------------------------------------------------------------------
# svd_update: the torch counterparts of tests/test_solver_state.py's warm
# restarts, each seeded from an SVDResult of the CPU solve and held to the
# JAX package's update of the same input (the host-blocked backend is not
# ported)
# ---------------------------------------------------------------------------

def _full_spectrum(rng, m, n, top=5.0, bottom=1.0):
    """Full-rank matrix with a gently decaying spectrum (as in
    tests/test_solver_state.py): cold block iteration needs tens of
    iterations at eps=1e-6."""
    L = rng.standard_normal((m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(L, full_matrices=False)
    return (U * np.linspace(top, bottom, n).astype(np.float32)) @ Vt


def _prev_both(A, k, **kw):
    """The previous block solve of ``A`` in both packages (the torch one
    on the CPU)."""
    kw = dict(method="block", warmup_q=1, **kw)
    return (jcore.svd(jnp.asarray(A), k, **kw),
            repro_torch.svd(torch.from_numpy(A), k, device="cpu", **kw))


def _update_both(prevs, A, *args, **kw):
    """``svd_update`` of ``A`` from each package's previous result."""
    A = np.ascontiguousarray(A)
    jprev, tprev = prevs
    return (jcore.svd_update(jprev, jnp.asarray(A), *args, **kw),
            repro_torch.svd_update(tprev, torch.from_numpy(A), *args,
                                   device="cpu", **kw))


def test_update_row_append_matches_jax():
    """New rows arrive: the previous V still seeds the same width and the
    update converges in O(1), to the new spectrum and to JAX's."""
    rng = np.random.default_rng(11)
    A = _full_spectrum(rng, 70, 20)
    prevs = _prev_both(A, 4)
    B = np.vstack([A, 0.05 * rng.standard_normal((6, 20)).astype(np.float32)])
    jw, tw = _update_both(prevs, B)
    assert tw.iters[0] <= 3 and tw.converged
    assert tw.U.shape == (76, 4)
    s_ref = np.linalg.svd(B, compute_uv=False)[:4]
    np.testing.assert_allclose(_np(tw.S), s_ref, rtol=1e-3)
    np.testing.assert_allclose(_np(tw.S), _np(jw.S), rtol=1e-3)


def test_update_wide_matrix_orientation_matches_jax():
    """A wide input is solved transposed: the previous U seeds the
    solver's right side, and U and V come back in the input's
    orientation."""
    rng = np.random.default_rng(12)
    A = np.ascontiguousarray(_full_spectrum(rng, 64, 20).T)    # (20, 64)
    prevs = _prev_both(A, 4)
    jw, tw = _update_both(prevs, A + 1e-4)
    assert tw.iters[0] <= 3
    assert tw.U.shape == (20, 4) and tw.V.shape == (64, 4)
    np.testing.assert_allclose(_np(tw.S), _np(prevs[1].S), rtol=1e-3)
    np.testing.assert_allclose(_np(tw.S), _np(jw.S), rtol=1e-3)


@pytest.mark.parametrize("k", [8, 1])               # rank +4 and -3
def test_update_rank_change_matches_jax(k):
    """A grown rank appends seeded directions (the same in both packages);
    a smaller one keeps the previous seed's leading directions."""
    rng = np.random.default_rng(13)
    A = _full_spectrum(rng, 80, 24)
    prevs = _prev_both(A, 4)
    jw, tw = _update_both(prevs, A, k)
    assert _np(tw.S).shape == _np(jw.S).shape == (k,)
    s_ref = np.linalg.svd(A, compute_uv=False)[:k]
    np.testing.assert_allclose(_np(tw.S), s_ref, rtol=1e-3)
    np.testing.assert_allclose(_np(tw.S), _np(jw.S), rtol=1e-3)


def test_update_default_rank_is_previous_rank():
    rng = np.random.default_rng(14)
    A = _full_spectrum(rng, 50, 14)
    jw, tw = _update_both(_prev_both(A, 3), A)
    assert _np(tw.S).shape == _np(jw.S).shape == (3,)


def test_update_rejects_bad_prev_and_bad_method():
    """The same errors as the JAX package's."""
    rng = np.random.default_rng(15)
    A = _full_spectrum(rng, 40, 12)
    jprev, tprev = _prev_both(A, 3)
    for update, prev, X in (
            (jcore.svd_update, jprev, jnp.asarray(A)),
            (lambda *a, **kw: repro_torch.svd_update(*a, device="cpu", **kw),
             tprev, torch.from_numpy(A))):
        with pytest.raises(TypeError, match="SVDResult or"):
            update(np.eye(3), X)
        with pytest.raises(ValueError, match="method must be 'block'"):
            update(prev, X, method="gram")


def test_update_pass_accounting_stays_ground_truth():
    """The warm path's reported passes are the operator's own counter, and
    under a fixed iteration count the JAX package's."""
    rng = np.random.default_rng(16)
    A = _full_spectrum(rng, 60, 18)
    jprev, tprev = _prev_both(A, 4)
    kw = dict(force_iters=True, max_iters=3)
    op = DenseOperator(torch.from_numpy(A + 1e-4), device="cpu")
    warm = repro_torch.svd_update(tprev, op, **kw)
    jw = jcore.svd_update(jprev, jnp.asarray(A + 1e-4), **kw)
    assert warm.passes_over_A == op.passes == jw.passes_over_A
    np.testing.assert_array_equal(warm.iters, np.asarray(jw.iters))
