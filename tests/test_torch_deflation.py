"""The ported rank-one deflation engines against the JAX package, on the CPU.

Every case feeds the same seeded numpy inputs to the JAX package and to
``repro_torch`` (``device="cpu"``, so the port's wrappers run the plain
PyTorch versions of the Hopper kernels).

Tolerances, from the JAX package's own tests:

* kernels (``tests/test_kernels.py``): ``gram`` 1e-3 fp32 and 2e-2 bf16
  (atol scaled by the largest entry), ``matvec`` rtol 1e-4 / atol 1e-3,
  ``deflate_rmatvec`` and the fused step rtol 1e-3 / atol 5e-2;
* solves (``tests/test_tsvd.py``): sigma within rtol 2e-3 of numpy and of
  the JAX result, singular vectors ``|dot| > 0.999``; integer accounting
  under ``force_iters`` exactly equal.

From a shared start (the JAX package's own threefry draws, fed through
``x0=``) the two engines take the same steps, and sigma agrees to rtol
1e-4.  The per-rank ``iters`` may differ by one step: the stop test
``|v . v1| >= 1 - eps`` is taken on fp32 sums that the two packages add
in different orders, so a rank that lands on the threshold can stop one
step earlier or later.  The test allows exactly that.
"""
import dataclasses

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro.core import partition as jpart
from repro.core.config import seed_to_key
from repro.core.operator import DenseOperator as JaxDense
from repro.kernels import ops as jax_ops
from repro_torch.core import errors
from repro_torch.core import partition as tpart
from repro_torch.core.config import SVDConfig
from repro_torch.core.operator import DenseOperator
from repro_torch.kernels import ops

# the module: ``repro_torch.core.tsvd`` is the legacy function, as
# ``repro.core.tsvd`` is
ttsvd = importlib.import_module("repro_torch.core.tsvd")

SPECTRUM = np.linspace(20, 2, 10)


def _lowrank(m, n, seed=0, spectrum=SPECTRUM):
    """A matrix with a prescribed spectrum (``tests/conftest.py``)."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    s = np.zeros(min(m, n), np.float32)
    s[:len(spectrum)] = spectrum
    return ((U * s) @ Vt).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _jax_starts(seed, k, kdim):
    """The JAX engine's start vectors (``core/tsvd.py:248-254``)."""
    keys = jax.random.split(seed_to_key(seed), k)
    return np.stack([np.asarray(jax.random.normal(keys[l], (kdim,),
                                                  jnp.float32))
                     for l in range(k)])


# ---------------------------------------------------------------------------
# kernels: the port's wrappers vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n", [(128, 128), (256, 128), (384, 256),
                                 (130, 70), (512, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_gram_matches_jax_kernel(m, n, dtype, symmetric):
    rng = np.random.default_rng(m * 1000 + n)
    A = rng.normal(size=(m, n)).astype(np.float32)
    tol = 1e-3 if dtype == "float32" else 2e-2
    At = _t(A).to(getattr(torch, dtype))
    for trans, Aj in ((False, A), (True, A.T)):
        want = np.asarray(jax_ops.gram(jnp.asarray(Aj, getattr(jnp, dtype)),
                                       bn=128, bk=128, symmetric=symmetric))
        got = _np(ops.gram(At, symmetric=symmetric, trans=trans))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=tol,
                                   atol=tol * float(np.abs(want).max()))


def test_gram_symmetric_equals_full():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(256, 256)).astype(np.float32)
    full = np.asarray(jax_ops.gram(jnp.asarray(A), symmetric=False, bn=128,
                                   bk=128))
    for sym in (True, False):
        np.testing.assert_allclose(_np(ops.gram(_t(A), symmetric=sym)), full,
                                   atol=1e-3)


@pytest.mark.parametrize("m,n", [(128, 128), (200, 300), (512, 130)])
@pytest.mark.parametrize("trans", [False, True])
def test_matvec_matches_jax_kernel(m, n, trans):
    rng = np.random.default_rng(m + n)
    A = rng.normal(size=(m, n)).astype(np.float32)
    v = rng.normal(size=(m if trans else n,)).astype(np.float32)
    Aj = A.T if trans else A
    want = np.asarray(jax_ops.matvec(jnp.asarray(Aj), jnp.asarray(v),
                                     bm=128, bn=128))
    got = _np(ops.matvec(_t(A), _t(v), trans=trans))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("m,n,k", [(256, 128, 4), (300, 200, 8),
                                   (128, 128, 1)])
@pytest.mark.parametrize("trans", [False, True])
def test_deflate_rmatvec_matches_jax_kernel(m, n, k, trans):
    rng = np.random.default_rng(m + n + k)
    A = rng.normal(size=(m, n)).astype(np.float32)
    side = n if trans else m
    U = rng.normal(size=(side, k)).astype(np.float32)
    x = rng.normal(size=(side,)).astype(np.float32)
    c = rng.normal(size=(k,)).astype(np.float32)
    Aj = A.T if trans else A
    want = jax_ops.deflate_rmatvec(jnp.asarray(Aj), jnp.asarray(U),
                                   jnp.asarray(x), jnp.asarray(c),
                                   bm=128, bn=128)
    got = ops.deflate_rmatvec(_t(A), _t(U), _t(x), _t(c), trans=trans)
    for g, w in zip(got, want):
        assert _np(g).shape == np.asarray(w).shape
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-3,
                                   atol=5e-2)


@pytest.mark.parametrize("left", [False, True])
def test_fused_step_equals_paper_schedule(left):
    """The engine's fused step == the paper's four-term Eq. 2/3 chain, in
    numpy and in the port's own ``_deflated_matvec``/``_left``."""
    rng = np.random.default_rng(9)
    m, n, k = 256, 128, 4
    A = rng.normal(size=(m, n)).astype(np.float32)
    U, _ = np.linalg.qr(rng.normal(size=(m, k)).astype(np.float32))
    V, _ = np.linalg.qr(rng.normal(size=(n, k)).astype(np.float32))
    S = np.linspace(5, 1, k).astype(np.float32)
    if left:                       # the X X^T chain, u (m,)
        u = rng.normal(size=(m,)).astype(np.float32)
        Atu = A.T @ u
        paper = (A @ Atu - U @ (S * (V.T @ Atu))
                 - A @ (V @ (S * (U.T @ u))) + U @ (S * S * (U.T @ u)))
        t13, vtx = ops.deflate_rmatvec(_t(A), _t(V), _t(Atu),
                                       _t(S * (U.T @ u)), trans=True)
        fused = (_np(t13) - U @ (S * _np(vtx)) + U @ (S * S * (U.T @ u)))
        chain = ttsvd._deflated_matvec_left(_t(A), _t(U), _t(S), _t(V),
                                            _t(u))
    else:
        v = rng.normal(size=(n,)).astype(np.float32)
        Xv = A @ v
        paper = (A.T @ Xv - V @ (S * (U.T @ Xv))
                 - A.T @ (U @ (S * (V.T @ v))) + V @ (S * S * (V.T @ v)))
        t13, utx = ops.deflate_rmatvec(_t(A), _t(U), _t(Xv),
                                       _t(S * (V.T @ v)))
        fused = (_np(t13) - V @ (S * _np(utx)) + V @ (S * S * (V.T @ v)))
        chain = ttsvd._deflated_matvec(_t(A), _t(U), _t(S), _t(V), _t(v))
    np.testing.assert_allclose(fused, paper, rtol=1e-3, atol=5e-2)
    np.testing.assert_allclose(_np(chain), paper, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("call", [
    lambda: ops.matvec(torch.ones(4, 3), torch.ones(4)),
    lambda: ops.matvec(torch.ones(4, 3), torch.ones(3), trans=True),
    lambda: ops.deflate_rmatvec(torch.ones(4, 3), torch.ones(4, 2),
                                torch.ones(4), torch.ones(3)),
    lambda: ops.deflate_rmatvec(torch.ones(4, 3), torch.ones(4, 2),
                                torch.ones(4), torch.ones(2), trans=True),
    lambda: ops.gram(torch.ones(4, 3, dtype=torch.float64)),
    lambda: ops.gram(torch.ones(3)),
])
def test_wrappers_refuse_bad_operands(call):
    with pytest.raises(ValueError):
        call()


# ---------------------------------------------------------------------------
# solves: repro_torch.svd vs repro.core.svd
# ---------------------------------------------------------------------------

SHAPES = [(96, 40), (40, 96), (64, 64)]


@pytest.mark.parametrize("method", ["gram", "gramfree"])
@pytest.mark.parametrize("shape", SHAPES)
def test_deflation_solve_matches_jax(method, shape):
    A = _lowrank(*shape)
    kw = dict(method=method, eps=1e-10, max_iters=800)
    jres = jcore.svd(jnp.asarray(A), 5, **kw)
    tres = repro_torch.svd(_t(A), 5, device="cpu", **kw)
    exact = np.linalg.svd(A, compute_uv=False)[:5]
    np.testing.assert_allclose(_np(tres.S), exact, rtol=2e-3)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=2e-3)
    assert tres.U.shape == (shape[0], 5) and tres.V.shape == (shape[1], 5)
    for Xj, Xt in ((jres.U, tres.U), (jres.V, tres.V)):
        dots = np.abs(np.sum(_np(Xj) * _np(Xt), axis=0))
        assert dots.min() > 0.999, dots
    np.testing.assert_allclose(_np(tres.U).T @ _np(tres.U), np.eye(5),
                               atol=5e-3)
    assert tres.converged == jres.converged
    assert tres.backend == jres.backend == "dense"


@pytest.mark.parametrize("method", ["gram", "gramfree"])
@pytest.mark.parametrize("shape", [(96, 40), (40, 96)])
@pytest.mark.parametrize("force", [True, False])
def test_deflation_accounting_is_jax_accounting(method, shape, force):
    """Under force_iters every integer field is equal; with a cap of 3
    steps and no force, neither package claims convergence."""
    A = _lowrank(*shape, seed=1)
    kw = dict(method=method, max_iters=7 if force else 3, force_iters=force)
    jres = jcore.svd(jnp.asarray(A), 4, **kw)
    tres = repro_torch.svd(_t(A), 4, device="cpu", **kw)
    np.testing.assert_array_equal(tres.iters, np.asarray(jres.iters))
    assert tres.iters.dtype == np.int32
    assert tres.passes_over_A == int(jres.passes_over_A)
    assert tres.bytes_per_pass == jres.bytes_per_pass == A.nbytes
    assert tres.backend == jres.backend
    assert tres.bytes_moved is None and jres.bytes_moved is None
    assert tres.faults is None
    assert tres.converged is jres.converged is False
    want = 3 * 4 if method == "gram" else 3 * int(tres.iters.sum()) + 4
    assert tres.passes_over_A == want


@pytest.mark.parametrize("method", ["gram", "gramfree"])
@pytest.mark.parametrize("shape", SHAPES)
def test_shared_start_takes_the_jax_steps(method, shape):
    A = _lowrank(*shape, seed=2)
    k, seed = 5, 3
    jres = jcore.svd(jnp.asarray(A), k, method=method, seed=seed)
    x0 = _jax_starts(seed, k, min(shape))
    U, S, V, iters, passes = ttsvd._dense_deflation(
        _t(A), k, eps=1e-6, max_iters=200, force_iters=False,
        method=method, x0=x0)
    jit = np.asarray(jres.iters)
    assert np.abs(iters.astype(int) - jit).max() <= 1, (iters, jit)
    np.testing.assert_allclose(_np(S), _np(jres.S), rtol=1e-4)
    assert abs(passes - int(jres.passes_over_A)) <= (
        0 if method == "gram" else 3 * k)


def test_engine_launch_counts_follow_the_pass_accounting(monkeypatch):
    """The card's launch counts: matvec sum(iters) + k and
    deflate_rmatvec sum(iters) for gramfree; gram k and matvec k for
    gram.  Counted here on the wrappers the engine calls."""
    calls = {}
    for name in ("matvec", "deflate_rmatvec", "gram"):
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    for shape in ((96, 40), (40, 96)):
        A = _t(_lowrank(*shape, seed=4))
        for method in ("gramfree", "gram"):
            calls.clear()
            res = repro_torch.svd(A, 4, method=method, device="cpu")
            it = int(res.iters.sum())
            want = ({"matvec": it + 4, "deflate_rmatvec": it}
                    if method == "gramfree" else {"gram": 4, "matvec": 4})
            assert calls == want, (shape, method)


def test_transposed_view_input_takes_no_copy_and_same_answer():
    A = _lowrank(40, 96, seed=5)
    x0 = _jax_starts(0, 3, 40)
    for method in ("gram", "gramfree"):
        a = ttsvd._dense_deflation(_t(A), 3, eps=1e-6, max_iters=200,
                                   force_iters=False, method=method, x0=x0)
        b = ttsvd._dense_deflation(_t(A.T).mT, 3, eps=1e-6, max_iters=200,
                                   force_iters=False, method=method, x0=x0)
        np.testing.assert_allclose(_np(b[1]), _np(a[1]), rtol=1e-4)


def test_gramfree_rerun_is_bitwise_equal():
    A = _t(_lowrank(80, 50, seed=6))
    r1 = repro_torch.svd(A, 4, method="gramfree", device="cpu")
    r2 = repro_torch.svd(A, 4, method="gramfree", device="cpu")
    for x, y in zip(r1[:3], r2[:3]):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(r1.iters, r2.iters)


# ---------------------------------------------------------------------------
# power loops
# ---------------------------------------------------------------------------

def _gram_problem(seed=7, n=48):
    rng = np.random.default_rng(seed)
    X = _lowrank(90, n, seed=seed)
    v0 = rng.normal(size=(n,)).astype(np.float32)
    return X, X.T @ X, v0 / np.linalg.norm(v0)


@pytest.mark.parametrize("force", [False, True])
def test_power_iterate_gram_matches_jax(force):
    _, B, v0 = _gram_problem()
    kw = dict(eps=1e-6, max_iters=60, force_iters=force)
    vj, ij = jcore.power_iterate_gram(jnp.asarray(B), jnp.asarray(v0), **kw)
    vt, it = repro_torch.power_iterate_gram(_t(B), _t(v0), **kw)
    assert abs(it - int(ij)) <= (0 if force else 1)
    if force:
        assert it == 60
    assert abs(float(np.dot(_np(vt), np.asarray(vj)))) > 0.9999


def test_power_iterate_chain_matches_jax():
    X, _, v0 = _gram_problem(seed=8)
    Xj, Xt = jnp.asarray(X), _t(X)
    vj, ij = jcore.power_iterate_chain(lambda v: Xj.T @ (Xj @ v),
                                       jnp.asarray(v0), eps=1e-6)
    vt, it = repro_torch.power_iterate_chain(
        lambda v: ops.matvec(Xt, ops.matvec(Xt, v), trans=True), _t(v0),
        eps=1e-6)
    assert abs(it - int(ij)) <= 1
    assert abs(float(np.dot(_np(vt), np.asarray(vj)))) > 0.9999


@pytest.mark.parametrize("shape", [(90, 48), (48, 90)])
def test_svd_1d_matches_jax(shape):
    X = _lowrank(*shape, seed=9)
    key = jax.random.PRNGKey(4)
    x0 = np.asarray(jax.random.normal(key, (min(shape),), jnp.float32))
    vj, ij = jcore.svd_1d(jnp.asarray(X), key, eps=1e-6)
    vt, it = repro_torch.svd_1d(_t(X), x0=x0, eps=1e-6)
    assert abs(it - int(ij)) <= 1
    assert vt.shape == (min(shape),)
    assert abs(float(np.dot(_np(vt), np.asarray(vj)))) > 0.9999


# ---------------------------------------------------------------------------
# partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,w", [(100, 40, 4), (40, 100, 4), (64, 64, 8),
                                   (7, 3, 5), (1, 1, 1), (1000, 999, 3)])
@pytest.mark.parametrize("force_row", [None, True, False])
def test_partition_matches_jax(m, n, w, force_row):
    pj = jpart.make_partition(m, n, w, force_row=force_row)
    pt = tpart.make_partition(m, n, w, force_row=force_row)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)
    for prop in ("local_rows", "local_cols", "dist_dim", "repl_dim"):
        assert getattr(pt, prop) == getattr(pj, prop)


@pytest.mark.parametrize("total,nb", [(100, 4), (7, 3), (5, 9), (1, 1),
                                      (1024, 5), (33, 33)])
@pytest.mark.parametrize("queue,collinear", [(2, False), (4, True)])
def test_batch_plan_matches_jax(total, nb, queue, collinear):
    bj = jpart.make_batch_plan(total, nb, queue_size=queue,
                               collinear=collinear)
    bt = tpart.make_batch_plan(total, nb, queue_size=queue,
                               collinear=collinear)
    assert dataclasses.asdict(bt) == dataclasses.asdict(bj)
    assert [bt.bounds(b) for b in range(bt.n_batches)] == \
        [bj.bounds(b) for b in range(bj.n_batches)]


def test_partition_errors_and_symmetric_tasks_match_jax():
    for n in range(0, 12):
        assert tpart.symmetric_tasks(n) == jpart.symmetric_tasks(n)
    with pytest.raises(ValueError, match="n_batches must be >= 1"):
        tpart.make_batch_plan(10, 0)
    with pytest.raises(ValueError, match="n_batches must be >= 1"):
        jpart.make_batch_plan(10, 0)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    dict(sweep_dtype="bfloat16"), dict(warmup_q=1),
    dict(on_iteration=print), dict(checkpoint_dir="ckpt")])
@pytest.mark.parametrize("method", ["gram", "gramfree"])
def test_deflation_config_errors_are_the_jax_errors(bad, method):
    with pytest.raises(jcore.InputError) as ej:
        jcore.SVDConfig(method=method, **bad)
    with pytest.raises(errors.InputError) as et:
        SVDConfig(method=method, **bad)
    assert str(et.value) == str(ej.value)
    with pytest.raises(errors.InputError):
        repro_torch.svd(torch.ones(6, 4), 2, device="cpu", method=method,
                        **bad)


@pytest.mark.parametrize("method", ["gram", "gramfree"])
def test_custom_operator_with_deflation_raises_value_error(method):
    A = _lowrank(20, 10)
    with pytest.raises(ValueError, match="method must be 'block'") as ej:
        jcore.svd(JaxDense(jnp.asarray(A)), 2, method=method)
    with pytest.raises(ValueError, match="method must be 'block'") as et:
        repro_torch.svd(DenseOperator(_t(A), device="cpu"), 2,
                        method=method)
    assert str(et.value) == str(ej.value)
