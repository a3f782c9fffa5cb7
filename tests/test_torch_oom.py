"""The ported host-blocked tier against the JAX package, on the CPU.

Every case feeds the same seeded numpy input to ``repro.core`` and to
``repro_torch.core`` with ``device="cpu"`` (the blocks are the host
tensors themselves and the kernels' plain versions run), mirroring
``tests/test_oom.py``, the host-blocked cases of
``tests/test_operator_contract.py`` and ``tests/test_solver_state.py``.

Tolerances: the streamed products to 1e-5 relative Frobenius error (the
same fp32 sums in another order), the bf16 chain to 1e-3 (its fp32
intermediate rounded to bf16, where the two packages can land on
neighbouring bf16 values); sigma to rtol 2e-4 and the principal angles
above 1 - 1e-3, as ``tests/test_torch_svd.py``.  Integer accounting
(``passes_over_A``, ``bytes_per_pass``, ``bytes_moved``, ``backend``,
fetches, ``iters`` under ``force_iters``) is exactly equal.  The bf16
staging is bitwise the JAX package's.
"""
import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from repro.core.config import SolverState as JaxState
from repro.core.oom import _oom_deflation as jax_oom_deflation
from repro_torch.core.config import SolverState, SVDConfig
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
from repro_torch.core.oom import _oom_deflation
from repro_torch.kernels import ops

tsvd_mod = importlib.import_module("repro_torch.core.svd")

RAGGED_CASES = [(70, 20, 4), (67, 13, 5), (10, 4, 4), (13, 5, 13)]
SPECTRUM = 10.0 * 0.5 ** np.arange(10)
K = 4


def _lowrank(m=72, n=24, seed=0):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(m, len(SPECTRUM))))
    V, _ = np.linalg.qr(rng.normal(size=(n, len(SPECTRUM))))
    A = (U * SPECTRUM) @ V.T + 1e-4 * rng.normal(size=(m, n))
    return A.astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _bits(x):
    """The bf16 bits of a staged block of either package."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _same_subspaces(jres, tres):
    for Xj, Xt in ((jres.U, tres.U), (jres.V, tres.V)):
        sv = np.linalg.svd(_np(Xj).T @ _np(Xt), compute_uv=False)
        assert sv.min() > 1 - 1e-3, sv


# ---------------------------------------------------------------------------
# Blocked Gram, Alg-3 tiles, one Alg-4 step
# ---------------------------------------------------------------------------

def test_blocked_gram_matches_jax():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(64, 24)).astype(np.float32)
    got = tcore.blocked_gram(torch.from_numpy(A.reshape(8, 8, 24)))
    want = jcore.blocked_gram(jnp.asarray(A.reshape(8, 8, 24)))
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("nb,n,m,seed", [(1, 8, 8, 0), (3, 40, 48, 1),
                                         (4, 13, 20, 2), (7, 33, 9, 3),
                                         (5, 10, 31, 4)])
def test_tiled_gram_any_batching_matches_jax(nb, n, m, seed):
    """Paper Alg-3 invariant: the tile/batch decomposition never changes
    B, in either package."""
    A = np.random.default_rng(seed).normal(size=(m, n)).astype(np.float32)
    got = tcore.tiled_gram(torch.from_numpy(A), nb)
    assert _rel(got, jcore.tiled_gram(jnp.asarray(A), nb)) <= 1e-5
    assert _rel(got, A.T @ A) <= 1e-5


def test_blocked_deflated_matvec_matches_jax():
    rng = np.random.default_rng(1)
    m, n, k, nb = 48, 20, 3, 4
    A = rng.normal(size=(m, n)).astype(np.float32)
    U, _ = np.linalg.qr(rng.normal(size=(m, k)).astype(np.float32))
    V, _ = np.linalg.qr(rng.normal(size=(n, k)).astype(np.float32))
    S = np.array([5.0, 3.0, 1.0], np.float32)
    v = rng.normal(size=(n,)).astype(np.float32)
    args = (A.reshape(nb, m // nb, n), U.reshape(nb, m // nb, k), S, V, v)
    got = tcore.blocked_deflated_matvec(*map(torch.from_numpy, args))
    want = jcore.blocked_deflated_matvec(*map(jnp.asarray, args))
    assert _rel(got, want) <= 1e-5
    X = A - (U * S) @ V.T
    assert _rel(got, X.T @ (X @ v)) <= 1e-5


# ---------------------------------------------------------------------------
# HostBlockedMatrix: staging and the streamed ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,nb", RAGGED_CASES)
@pytest.mark.parametrize("stage_dtype", ["float32", "bfloat16"])
def test_streamed_ops_match_jax(m, n, nb, stage_dtype):
    rng = np.random.default_rng(m * 31 + nb)
    A = rng.normal(size=(m, n)).astype(np.float32)
    jh = jcore.HostBlockedMatrix(A, nb, stage_dtype=stage_dtype)
    th = tcore.HostBlockedMatrix(A, nb, stage_dtype=stage_dtype,
                                 device="cpu")
    assert [th.plan.bounds(b) for b in range(th.n_blocks)] == \
        [jh.plan.bounds(b) for b in range(jh.n_blocks)]
    assert th.bytes_per_pass == jh.bytes_per_pass
    Q = rng.normal(size=(n, 3)).astype(np.float32)
    Y = rng.normal(size=(m, 3)).astype(np.float32)
    v = rng.normal(size=(n,)).astype(np.float32)
    chain_tol = 1e-3 if stage_dtype == "bfloat16" else 1e-5
    for name, arg, tol in (("matmat", Q, 1e-5), ("rmatmat", Y, 1e-5),
                           ("gram_chain", Q, chain_tol), ("matvec", v, 1e-5)):
        got = getattr(th, name)(torch.from_numpy(arg))
        want = getattr(jh, name)(jnp.asarray(arg))
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        assert _rel(got, want) <= tol, name
    assert _rel(th.gram(), jh.gram()) <= 1e-5


@pytest.mark.parametrize("m,n,nb", RAGGED_CASES)
def test_host_blocks_tile_the_input(m, n, nb):
    """fp32 C-contiguous input: the blocks are row views of the caller's
    array (no copy), tiling [0, m) exactly."""
    A = np.random.default_rng(m).normal(size=(m, n)).astype(np.float32)
    th = tcore.HostBlockedMatrix(A, nb, device="cpu")
    rec = torch.cat([th.host_block(b) for b in range(th.n_blocks)])
    np.testing.assert_array_equal(rec.numpy(), A)
    assert th.host_block(0).data_ptr() == A.ctypes.data


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "float64",
                                    "strided"])
def test_bf16_staged_blocks_are_bitwise_the_jax_blocks(layout):
    rng = np.random.default_rng(5)
    base = rng.normal(size=(67, 13)) * 3.0
    A = {"contiguous": base.astype(np.float32),
         "transposed": np.ascontiguousarray(base.T.astype(np.float32)).T,
         "float64": base,
         "strided": base.astype(np.float32)[::2]}[layout]
    jh = jcore.HostBlockedMatrix(A, 5, stage_dtype="bfloat16")
    th = tcore.HostBlockedMatrix(A, 5, stage_dtype="bfloat16", device="cpu")
    for b in range(jh.n_blocks):
        tb = th.host_block(b)
        assert tb.dtype == torch.bfloat16 and tb.is_contiguous()
        np.testing.assert_array_equal(_bits(tb), _bits(jh.host_block(b)))


# ---------------------------------------------------------------------------
# svd() of a numpy array: results and exact accounting
# ---------------------------------------------------------------------------

CASES = [(orient, sd, q) for orient in ("tall", "wide")
         for sd in ("float32", "bfloat16") for q in (0, 1)]


def _oriented(orient):
    A = _lowrank()
    return A if orient == "tall" else np.ascontiguousarray(A.T)


@pytest.mark.parametrize("orient,sweep_dtype,warmup_q", CASES)
def test_svd_of_numpy_matches_jax(orient, sweep_dtype, warmup_q):
    A = _oriented(orient)
    eps, rtol = (1e-6, 2e-4) if sweep_dtype == "float32" else (1e-4, 1e-2)
    kw = dict(sweep_dtype=sweep_dtype, eps=eps, warmup_q=warmup_q,
              n_blocks=3)
    jres = jcore.svd(A, K, **kw)
    tres = repro_torch.svd(A, K, device="cpu", **kw)
    assert jres.backend == tres.backend == "hostblocked"
    assert jres.converged and tres.converged
    assert tres.U.shape == (A.shape[0], K) and tres.V.shape == (A.shape[1], K)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=rtol)
    exact = np.linalg.svd(A.astype(np.float64), compute_uv=False)[:K]
    np.testing.assert_allclose(_np(tres.S), exact, rtol=rtol)
    _same_subspaces(jres, tres)


@pytest.mark.parametrize("orient,sweep_dtype,warmup_q", CASES)
def test_accounting_equal_under_force_iters(orient, sweep_dtype, warmup_q):
    A = _oriented(orient)
    kw = dict(sweep_dtype=sweep_dtype, warmup_q=warmup_q, n_blocks=3,
              force_iters=True, max_iters=4)
    jres = jcore.svd(A, K, **kw)
    tres = repro_torch.svd(A, K, device="cpu", **kw)
    np.testing.assert_array_equal(tres.iters, np.asarray(jres.iters))
    assert tres.passes_over_A == jres.passes_over_A == 4 + 1 + (
        1 + warmup_q if warmup_q else 0)
    assert tres.bytes_per_pass == jres.bytes_per_pass
    assert tres.bytes_moved == jres.bytes_moved == {
        "host": tres.passes_over_A * tres.bytes_per_pass,
        "device": tres.passes_over_A * tres.bytes_per_pass}
    assert tres.backend == jres.backend == "hostblocked"
    assert tres.converged is jres.converged is False


@pytest.mark.parametrize("method,kw", [
    ("block", dict(force_iters=True, max_iters=5)),
    ("block", dict(force_iters=True, max_iters=3, warmup_q=2)),
    ("gramfree", dict(force_iters=True, max_iters=6)),
    ("gramfree", dict(eps=1e-6))])
def test_fetches_are_passes_times_blocks(method, kw):
    """The reported passes_over_A IS the counting matrix's fetches /
    n_blocks, in both packages and for both methods."""
    A = _lowrank()
    jh = jcore.CountingHostMatrix(A, 4)
    th = tcore.CountingHostMatrix(A, 4, device="cpu")
    jres = jcore.svd(jh, 2, method=method, **kw)
    tres = repro_torch.svd(th, 2, method=method, **kw)
    assert th.fetches == tres.passes_over_A * th.n_blocks
    assert jh.fetches == jres.passes_over_A * jh.n_blocks
    if kw.get("force_iters"):
        assert th.fetches == jh.fetches
        assert tres.passes_over_A == jres.passes_over_A
        np.testing.assert_array_equal(tres.iters, np.asarray(jres.iters))
    if method == "gramfree":
        assert tres.passes_over_A == int(np.sum(2 * tres.iters + 1))
        assert tres.bytes_moved is jres.bytes_moved is None


def test_gramfree_from_a_shared_start_matches_jax():
    """Fed the JAX package's own start vectors, the streamed deflation
    engines agree per rank within one step (ROADMAP section 3: at eps
    1e-6 the stop step depends on summation order) and in sigma."""
    import jax
    A = _lowrank(60, 20)
    k = 3
    jh = jcore.HostBlockedMatrix(A, 4)
    ju, js, jv, jit, jp = jax_oom_deflation(jh, k, eps=1e-6, max_iters=200,
                                            force_iters=False, seed=0)
    key = jcore.config.seed_to_key(0)
    x0 = []
    for _ in range(k):                     # the engine's draws, in order
        key, sub = jax.random.split(key)
        x0.append(np.asarray(jax.random.normal(sub, (20,), jnp.float32)))
    th = tcore.HostBlockedMatrix(A, 4, device="cpu")
    tu, ts, tv, tit, tp = _oom_deflation(th, k, eps=1e-6, max_iters=200,
                                         force_iters=False, seed=0,
                                         x0=np.stack(x0))
    assert np.all(np.abs(tit - np.asarray(jit)) <= 4)   # CHECK_EVERY
    np.testing.assert_allclose(_np(ts), _np(js), rtol=2e-4)
    for Xj, Xt in ((ju, tu), (jv, tv)):
        cos = np.abs(np.sum(_np(Xj) * _np(Xt), axis=0))
        assert cos.min() > 1 - 1e-3


def test_wide_gramfree_swaps_the_factors():
    A = np.ascontiguousarray(_lowrank().T)           # (24, 72)
    jres = jcore.svd(A, 3, method="gramfree", n_blocks=3)
    tres = repro_torch.svd(A, 3, method="gramfree", n_blocks=3, device="cpu")
    assert tres.U.shape == (24, 3) and tres.V.shape == (72, 3)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=2e-4)
    _same_subspaces(jres, tres)


def _same_error(call_jax, call_torch):
    with pytest.raises(Exception) as ej:
        call_jax()
    with pytest.raises(Exception) as et:
        call_torch()
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)


def test_method_gram_is_the_jax_error():
    A = _lowrank()
    _same_error(lambda: jcore.svd(A, 2, method="gram"),
                lambda: repro_torch.svd(A, 2, method="gram", device="cpu"))


def test_stage_dtype_mismatch_is_the_jax_error():
    A = _lowrank()
    _same_error(
        lambda: jcore.svd(jcore.HostBlockedMatrix(A, 4), 2,
                          sweep_dtype="bfloat16"),
        lambda: repro_torch.svd(tcore.HostBlockedMatrix(A, 4, device="cpu"),
                                2, sweep_dtype="bfloat16"))


def test_shared_start_trajectory_matches_jax():
    """Fed the same Q0 through the warm path, both packages walk the same
    trajectory on the host-blocked tier: per-step gaps within 1e-4."""
    A = _lowrank()
    Q0, _ = np.linalg.qr(np.random.default_rng(7).normal(size=(24, K + 2)))
    Q0 = Q0.astype(np.float32)
    gaps = {"jax": [], "torch": []}
    kw = dict(force_iters=True, max_iters=6, n_blocks=3)
    jres = jcore.svd_update(
        JaxState(Q=Q0, k=K), A, **kw,
        on_iteration=lambda st: gaps["jax"].append(float(st.gap)))
    tres = repro_torch.svd_update(
        SolverState(Q=Q0, k=K), A, device="cpu", **kw,
        on_iteration=lambda st: gaps["torch"].append(float(st.gap)))
    assert jres.backend == tres.backend == "hostblocked"
    assert len(gaps["torch"]) == 6
    np.testing.assert_allclose(gaps["torch"], gaps["jax"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=2e-4)


def test_manual_phases_match_svd_bitwise():
    """init_state/step/finalize by hand reproduce svd() on the
    host-blocked tier bit for bit (the state machine IS the driver)."""
    A = _lowrank(48, 16)
    cfg = SVDConfig(method="block", n_blocks=3, eps=1e-5)
    ref = repro_torch.svd(A, 3, config=cfg, device="cpu")
    op = tcore.HostBlockedOperator(tcore.HostBlockedMatrix(A, 3,
                                                           device="cpu"))
    state = tsvd_mod.init_state(op, 3, cfg)
    while not state.converged and state.it < cfg.max_iters:
        state = tsvd_mod.step(op, state, cfg)
    res = tsvd_mod.finalize(op, state, cfg)
    for a, b in zip(res[:3], ref[:3]):
        assert torch.equal(a, b)
    assert res.passes_over_A == ref.passes_over_A
    assert res.bytes_moved == ref.bytes_moved


def test_rerun_is_bitwise_equal():
    A = _lowrank()
    r1 = repro_torch.svd(A, K, device="cpu", n_blocks=3)
    r2 = repro_torch.svd(A, K, device="cpu", n_blocks=3)
    for a, b in zip(r1[:3], r2[:3]):
        assert torch.equal(a, b)


def test_update_hostblocked_backend():
    """A perturbed matrix warm-started from the previous host-blocked
    result converges in O(1) iterations where a cold start needs tens,
    as in the JAX package (tests/test_solver_state.py)."""
    rng = np.random.default_rng(3)
    L = rng.standard_normal((90, 30)).astype(np.float32)
    U, _, Vt = np.linalg.svd(L, full_matrices=False)
    A = (U * np.linspace(5.0, 1.0, 30).astype(np.float32)) @ Vt
    B = A + 1e-3 * rng.standard_normal(A.shape).astype(np.float32)
    kw = dict(method="block", warmup_q=1, n_blocks=3)
    prev = repro_torch.svd(A, 5, device="cpu", **kw)
    cold = repro_torch.svd(B, 5, device="cpu", **kw)
    warm = repro_torch.svd_update(prev, B, device="cpu", n_blocks=3)
    jwarm = jcore.svd_update(jcore.svd(A, 5, **kw), B, n_blocks=3)
    assert warm.backend == "hostblocked"
    assert warm.iters[0] <= 3 < cold.iters[0]
    np.testing.assert_allclose(_np(warm.S), _np(cold.S), rtol=1e-4)
    np.testing.assert_allclose(_np(warm.S), _np(jwarm.S), rtol=1e-4)


def test_h2d_fault_is_retried_onto_the_clean_result():
    """An injected H2D fault is retried under the backoff policy and the
    solve lands on the fault-free bits, with the same telemetry as the
    JAX package."""
    A = _lowrank()
    kw = dict(n_blocks=3, io_retry_backoff=0.0)
    clean = repro_torch.svd(A, K, device="cpu", **kw)
    with inject_faults(FaultPlan(FaultSpec("h2d", at=5))):
        hit = repro_torch.svd(A, K, device="cpu", **kw)
    from repro.core.faults import FaultPlan as JP, FaultSpec as JS
    from repro.core.faults import inject_faults as jinject
    with jinject(JP(JS("h2d", at=5))):
        jhit = jcore.svd(A, K, **kw)
    for a, b in zip(clean[:3], hit[:3]):
        assert torch.equal(a, b)
    assert hit.faults["counters"] == jhit.faults["counters"] == {
        "h2d.injected": 1, "h2d.retry": 1}


def test_oom_tsvd_shim_warns_once_and_equals_svd():
    A = _lowrank()
    tsvd_mod._reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        r1 = tcore.oom_tsvd(A, 2, n_blocks=3, device="cpu")
        tcore.oom_tsvd(A, 2, n_blocks=3, device="cpu")
    assert [w.category for w in seen] == [DeprecationWarning]
    r2 = repro_torch.svd(A, 2, method="gramfree", n_blocks=3, device="cpu")
    for a, b in zip(r1[:3], r2[:3]):
        assert torch.equal(a, b)
    assert tcore.OOMResult is repro_torch.SVDResult


def test_tier_names_are_the_jax_names():
    names = ["HostBlockedMatrix", "CountingHostMatrix", "HostBlockedOperator",
             "MemmapMatrix", "MemmapOperator", "stage_to_disk",
             "open_matrix_memmap", "blocked_gram", "tiled_gram",
             "blocked_deflated_matvec", "oom_tsvd", "OOMResult", "Partition",
             "make_partition", "BatchPlan", "make_batch_plan",
             "symmetric_tasks"]
    for name in names:
        assert name in jcore.__all__ and name in tcore.__all__, name
        assert getattr(tcore, name) is not None


def test_host_blocked_operator_protocol_matches_jax():
    """Operator-level view: one pass per fused chain, the host tier in
    bytes_moved, the same fingerprint string."""
    A = _lowrank()
    jop = jcore.HostBlockedOperator(jcore.HostBlockedMatrix(A, 4))
    top = tcore.HostBlockedOperator(tcore.HostBlockedMatrix(A, 4,
                                                            device="cpu"))
    assert top.fingerprint == jop.fingerprint
    assert top.chain_passes == jop.chain_passes == 1
    Q = np.zeros((24, 3), np.float32)
    top.gram_chain(torch.from_numpy(Q))
    jop.gram_chain(jnp.asarray(Q))
    assert top.passes == jop.passes == 1
    assert top.bytes_moved == jop.bytes_moved == {
        "host": top.bytes_per_pass, "device": top.bytes_per_pass}


def test_streamed_launches_are_blocks_times_passes_on_cpu_zero():
    """On the CPU the plain versions run: no launch is counted."""
    ops.reset_launches()
    repro_torch.svd(_lowrank(), 2, device="cpu", force_iters=True,
                    max_iters=2)
    assert not any(ops.launches.values())
