"""The ported sparse stream against the JAX package, on the CPU.

Every case feeds the same seeded input to ``repro.core`` and to
``repro_torch.core`` with ``device="cpu"``, where the CSR sweeps run
their plain versions (``index_add_`` in stream order, each product
rounded before its add).  What must hold:

* the procedural nonzeros are bitwise the JAX package's, under any
  blocking (``tests/test_sparse.py``), and so are the scipy row blocks;
* every streamed op (``matvec``, ``rmatvec``, ``matmat``, ``rmatmat``,
  ``gram_chain``, ``range_sketch``), fp32 and bf16, synthetic and scipy,
  is bitwise the JAX package's ``np.add.at`` (same operands, same order,
  same rounding);
* the operator surface at ``tests/test_operator_contract.py``'s limits
  against the dense oracle (rtol 1e-4, atol 2e-3; the chain atol 5e-2;
  the extraction's sigma rtol 2e-4 and principal angles > 1 - 1e-3);
* ``svd()`` from the shared cold start (numpy ``default_rng(seed)`` in
  both packages): equal ``iters``, ``passes_over_A``, ``bytes_moved``,
  ``bytes_per_pass`` and ``backend``; sigma to rtol 2e-4 (1e-2 under
  bf16 sweeps, ``tests/test_precision.py``); principal angles above
  1 - 1e-3.  The QR differs (numpy's LAPACK against torch's), so the
  iterates agree to fp32 rounding, not bitwise: problems have a clear
  spectral gap, so both packages cross the tolerance on the same step.
  The gram-free engine at eps = 1e-6 sits near the fp32 floor of its
  stopping test, so each rank's iteration count may differ by one.
"""
import gzip
import importlib
import shutil
import warnings

import numpy as np
import pytest
import scipy.io
import scipy.sparse
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from repro.core.sparse import ScipySparseMatrix as JaxScipy
from repro.core.sparse import SyntheticSparseMatrix as JaxSynthetic
from repro_torch.core import errors
from repro_torch.core.operator import SparseStreamOperator
from repro_torch.core.sparse import (DenseStreamOperator, ScipySparseMatrix,
                                     SyntheticSparseMatrix, _bf16_bits,
                                     _round_to)

DTYPES = ("float32", "bfloat16")
OPS = ("matmat", "rmatmat", "gram_chain", "range_sketch", "matvec",
       "rmatvec")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scipy_input(m=210, n=96, density=0.06, seed=1):
    return scipy.sparse.random(m, n, density=density, random_state=seed,
                               format="coo", dtype=np.float64)


def _sources(kind):
    """The same matrix in both packages: (jax stream, port stream)."""
    if kind == "synthetic":
        return (JaxSynthetic(301, 70, 4, seed=5, chunk=32),
                SyntheticSparseMatrix(301, 70, 4, seed=5, chunk=32))
    A = _scipy_input()
    return JaxScipy(A, seed=2), ScipySparseMatrix(A, seed=2)


def _spectral_sparse(m=400, n=120, n_spec=20, seed=0):
    """A sparse matrix with a known spectrum: 1e-3-scaled synthetic
    nonzeros plus ``n_spec`` entries 10 * 0.8^i at distinct rows and
    columns (the shape of ``chip_smoke.py``'s phase 9 input)."""
    noise = JaxSynthetic(m, n, 3, seed=seed + 1)
    rows, cols, vals = noise.row_block_coo(0, m)
    rng = np.random.default_rng(seed)
    r = rng.choice(m, n_spec, replace=False)
    c = rng.choice(n, n_spec, replace=False)
    s = 10.0 * 0.8 ** np.arange(n_spec)
    A = scipy.sparse.coo_matrix(
        (np.concatenate([1e-3 * vals, s]), (np.concatenate([rows, r]),
                                            np.concatenate([cols, c]))),
        shape=(m, n)).tocsr()
    return A, s


def _angles_ok(X, Y):
    sv = np.linalg.svd(_np(X).T @ _np(Y), compute_uv=False)
    return sv.min() > 1 - 1e-3


# ---------------------------------------------------------------------------
# the nonzeros
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0, 301), (0, 32), (7, 100), (31, 33),
                                   (250, 301), (300, 301), (5, 5)])
def test_synthetic_nonzeros_are_the_jax_packages(lo, hi):
    j, t = _sources("synthetic")
    for a, b in zip(j.row_block_coo(lo, hi), t.row_block_coo(lo, hi)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    off, cols, vals = t._csr_block(lo, hi)        # the packed CSR
    rows, c, v = j.row_block_coo(lo, hi)
    np.testing.assert_array_equal(np.repeat(np.arange(lo, hi), np.diff(off)),
                                  rows)
    np.testing.assert_array_equal(cols, c)
    np.testing.assert_array_equal(vals, v)


@pytest.mark.parametrize("lo,hi", [(0, 210), (13, 77), (200, 210)])
def test_scipy_row_blocks_are_the_jax_packages(lo, hi):
    j, t = _sources("scipy")
    for a, b in zip(j.row_block_coo(lo, hi), t.row_block_coo(lo, hi)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(j.row_block_dense(lo, hi),
                                  t.row_block_dense(lo, hi))


@settings(max_examples=10, deadline=None)
@given(block=st.integers(17, 200))
def test_blocking_invariance(block):
    """The operator is identical under ANY blocking: the port's products
    are bitwise equal across blockings and to the JAX package's."""
    j = JaxSynthetic(m=300, n=64, nnz_per_row=4, seed=5, chunk=32)
    t = SyntheticSparseMatrix(m=300, n=64, nnz_per_row=4, seed=5, chunk=32)
    v = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    u = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    whole = t.matvec(v, 300, device="cpu")
    torch.testing.assert_close(t.matvec(v, block, device="cpu"), whole,
                               rtol=0, atol=0)
    np.testing.assert_array_equal(_np(whole), j.matvec(v, block))
    np.testing.assert_array_equal(_np(t.rmatvec(u, block, device="cpu")),
                                  j.rmatvec(u, block))


def test_bf16_rounding_is_round_to_nearest_even():
    x = np.array([1.0, 1.00390625, 1.01171875, -3.0e38, 3.4e38, np.inf,
                  -np.inf, np.nan, 1e-40, -0.0, 65504.0],
                 np.float32)
    x = np.concatenate([x, np.random.default_rng(0).standard_normal(
        1000).astype(np.float32)])
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    got = _bf16_bits(x).view(np.int16)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(got[finite], want[finite])
    np.testing.assert_array_equal(np.isnan(_round_to(x, "bfloat16")),
                                  np.isnan(x))
    assert _round_to(x, "float32") is not None
    np.testing.assert_array_equal(_round_to(x, "float32"), x)


# ---------------------------------------------------------------------------
# the streamed ops, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op,dtype", [
    (op, dt) for op in OPS for dt in DTYPES
    if dt == "float32" or op not in ("matvec", "rmatvec")])  # fp32 only
@pytest.mark.parametrize("kind", ["synthetic", "scipy"])
def test_streamed_op_is_bitwise_the_jax_packages(kind, op, dtype):
    j, t = _sources(kind)
    rng = np.random.default_rng(3)
    block = 64
    if op == "range_sketch":
        want = j.range_sketch(6, seed=4, block_rows=block, dtype=dtype)
        got = t.range_sketch(6, seed=4, block_rows=block, dtype=dtype,
                             device="cpu")
    elif op in ("matvec", "rmatvec"):
        x = rng.standard_normal(t.n if op == "matvec" else t.m).astype(
            np.float32)
        want, got = getattr(j, op)(x, block), \
            getattr(t, op)(x, block, device="cpu")
    else:
        x = rng.standard_normal(
            (t.m if op == "rmatmat" else t.n, 5)).astype(np.float32)
        want = getattr(j, op)(x, block, dtype=dtype)
        got = getattr(t, op)(torch.from_numpy(x), block, dtype=dtype)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(_np(got), want)


def test_streamed_ops_take_the_device_of_their_operand():
    t = SyntheticSparseMatrix(64, 16, 3, seed=0)
    Q = torch.ones((16, 2))
    assert t.matmat(Q).device.type == "cpu"         # a CPU tensor: the CPU
    with pytest.raises(ValueError):
        t.matmat(Q, block_rows=0)


class _HugeBlock(tcore.RowBlockStream):
    """A stream whose one row block claims 2^31 nonzeros: the count is
    stubbed, nothing of that size is made."""
    m, n, seed = 2, 8, 0

    def _csr_block(self, lo, hi):
        return (np.array([0, 2**31 - 1, 2**31][:hi - lo + 1], np.int64),
                np.zeros(0, np.int64), np.zeros(0, np.float32))


@pytest.mark.parametrize("op", ["matmat", "rmatmat"])
def test_block_beyond_int32_nonzeros_is_refused(op):
    """A block's offsets are int32 on the way to the sweeps: one that
    holds 2^31 nonzeros is refused, never wrapped."""
    s = _HugeBlock()
    X = torch.zeros((s.n if op == "matmat" else s.m, 1))
    with pytest.raises(ValueError, match="int32.*block_rows"):
        getattr(s, op)(X, block_rows=2)
    assert int(s._csr_block32(0, 1)[0][-1]) == 2**31 - 1   # the last int32


# ---------------------------------------------------------------------------
# the operator surface against the dense oracle
# ---------------------------------------------------------------------------

def _operator(kind, A):
    if kind == "scipy":
        return tcore.ScipySparseOperator(scipy.sparse.csr_matrix(A),
                                         device="cpu")
    return SparseStreamOperator(DenseStreamOperator(A), device="cpu")


@pytest.mark.parametrize("kind", ["scipy", "densestream"])
def test_matmat_rmatmat_gram_chain_match_oracle(kind, rng):
    A = rng.normal(size=(37, 17)).astype(np.float32)
    op = _operator(kind, A)
    assert op.shape == A.shape
    Q = rng.normal(size=(17, 5)).astype(np.float32)
    Y = rng.normal(size=(37, 5)).astype(np.float32)
    np.testing.assert_allclose(_np(op.matmat(torch.from_numpy(Q))), A @ Q,
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(_np(op.rmatmat(torch.from_numpy(Y))), A.T @ Y,
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(_np(op.gram_chain(torch.from_numpy(Q))),
                               A.T @ (A @ Q), rtol=1e-4, atol=5e-2)
    assert op.passes == 3


@pytest.mark.parametrize("kind", ["scipy", "densestream"])
def test_extract_matches_oracle(kind, rng):
    from conftest import make_lowrank
    A = make_lowrank(rng, 41, 19, spectrum=np.linspace(8, 2, 6))
    Q, _ = np.linalg.qr(rng.normal(size=(19, 6)).astype(np.float32))
    Q = Q.astype(np.float32)
    W = A @ Q
    Uw, So, Vt = np.linalg.svd(W, full_matrices=False)
    U, S, V = (_np(x) for x in _operator(kind, A).extract(
        torch.from_numpy(Q)))
    np.testing.assert_allclose(S, So, rtol=2e-4, atol=2e-3)
    assert _angles_ok(U, Uw) and _angles_ok(V, Q @ Vt.T)


def test_accounting_is_the_jax_packages():
    j, t = _sources("synthetic")
    for sd in DTYPES:
        jo = jcore.SparseStreamOperator(j, block_rows=64, sweep_dtype=sd)
        to = SparseStreamOperator(t, block_rows=64, sweep_dtype=sd,
                                  device="cpu")
        Q = np.ones((t.n, 3), np.float32)
        jo.gram_chain(Q)
        to.gram_chain(torch.from_numpy(Q))
        jo.matmat(Q)
        to.matmat(torch.from_numpy(Q))
        assert (to.passes, to.bytes_per_pass, to.bytes_moved, to.backend,
                to.chain_passes, to.lagged_sync, to.fingerprint) == (
            jo.passes, jo.bytes_per_pass, jo.bytes_moved, jo.backend,
            jo.chain_passes, jo.lagged_sync, jo.fingerprint)
        np.testing.assert_array_equal(_np(to.random_block(4, 7)),
                                      jo.random_block(4, 7))


# ---------------------------------------------------------------------------
# svd() from the shared cold start
# ---------------------------------------------------------------------------

def _same_solve(rj, rt, rtol=2e-4, backend=None):
    assert (int(rt.iters[0]), rt.passes_over_A, rt.bytes_per_pass,
            rt.bytes_moved, rt.converged) == (
        int(rj.iters[0]), rj.passes_over_A, rj.bytes_per_pass,
        rj.bytes_moved, rj.converged)
    assert rt.backend == (rj.backend if backend is None else backend)
    np.testing.assert_allclose(_np(rt.S), np.asarray(rj.S), rtol=rtol)
    assert _angles_ok(rt.U, np.asarray(rj.U))
    assert _angles_ok(rt.V, np.asarray(rj.V))


@pytest.mark.parametrize("kw", [
    {},
    {"warmup_q": 1},
    {"sweep_dtype": "bfloat16", "eps": 1e-4},
    {"block_rows": 37},
], ids=["cold", "warm", "bf16", "ragged-blocks"])
def test_scipy_block_solve_matches_jax(kw):
    A, s = _spectral_sparse()
    rj = jcore.svd(A, 4, **kw)
    rt = repro_torch.svd(A, 4, device="cpu", **kw)
    assert rt.backend == "scipysparse" and rt.converged
    _same_solve(rj, rt, rtol=1e-2 if "sweep_dtype" in kw else 2e-4)
    np.testing.assert_allclose(_np(rt.S), s[:4], rtol=1e-3)


@pytest.mark.parametrize("sd", DTYPES)
def test_synthetic_forced_solve_matches_jax(sd):
    """The paper's benchmark mode: ``force_iters`` pins the trajectory
    length, so the integer accounting is equal whatever the spectrum."""
    kw = dict(force_iters=True, max_iters=6, sweep_dtype=sd, block_rows=100)
    rj = jcore.svd(JaxSynthetic(600, 40, 8, seed=3), 4, **kw)
    rt = repro_torch.svd(SyntheticSparseMatrix(600, 40, 8, seed=3), 4,
                         device="cpu", **kw)
    assert rt.passes_over_A == 7 and rt.backend == "sparsestream"
    assert (list(rt.iters), rt.bytes_moved, rt.bytes_per_pass) == (
        list(rj.iters), rj.bytes_moved, rj.bytes_per_pass)
    np.testing.assert_allclose(_np(rt.S), np.asarray(rj.S),
                               rtol=2e-4 if sd == "float32" else 1e-2)


def test_scipy_sparse_matrix_input_matches_jax():
    A, _ = _spectral_sparse()
    rj = jcore.svd(JaxScipy(A, seed=0), 4)
    rt = repro_torch.svd(ScipySparseMatrix(A, seed=0), 4, device="cpu")
    _same_solve(rj, rt)


def test_dense_stream_operator_solve_matches_jax(rng):
    from conftest import make_lowrank
    A = make_lowrank(rng, 90, 30, spectrum=10.0 * 0.6 ** np.arange(8))
    for kw in ({}, {"warmup_q": 1}):
        rj = jcore.svd(jcore.DenseStreamOperator(A), 4, **kw)
        rt = repro_torch.svd(DenseStreamOperator(A), 4, device="cpu", **kw)
        _same_solve(rj, rt)
    np.testing.assert_allclose(
        _np(DenseStreamOperator(A).range_sketch(5, seed=2, device="cpu")),
        jcore.DenseStreamOperator(A).range_sketch(5, seed=2),
        rtol=1e-4, atol=1e-4)


def test_foreign_stream_keeps_the_numpy_contract():
    """An object that is not the port's own (here the JAX package's numpy
    stream) gets numpy in and gives numpy out; the solve still runs, on
    the duck-typed operator."""
    A, _ = _spectral_sparse()
    rj = jcore.svd(JaxScipy(A), 4)
    rt = repro_torch.svd(JaxScipy(A), 4, device="cpu")
    _same_solve(rj, rt, backend="sparsestream")


def test_gramfree_within_one_step_per_rank():
    A, s = _spectral_sparse()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = jcore.svd(A, 3, method="gramfree", eps=1e-6, max_iters=400)
    rt = repro_torch.svd(A, 3, method="gramfree", eps=1e-6, max_iters=400,
                         device="cpu")
    assert rt.backend == "scipysparse" and rt.bytes_moved is None
    assert np.all(np.abs(np.asarray(rt.iters) - np.asarray(rj.iters)) <= 1)
    assert rt.passes_over_A == int(sum(2 * i + 1 for i in rt.iters))
    assert rt.bytes_per_pass == rj.bytes_per_pass
    np.testing.assert_allclose(_np(rt.S), np.asarray(rj.S), rtol=2e-4)
    np.testing.assert_allclose(_np(rt.S), s[:3], rtol=2e-3)


def test_gram_method_is_refused_like_jax():
    A, _ = _spectral_sparse()
    with pytest.raises(ValueError, match="Gram matrix would densify"):
        repro_torch.svd(A, 2, method="gram", device="cpu")


def test_sparse_tsvd_shim_warns_and_delegates():
    importlib.import_module("repro_torch.core.svd")._reset_legacy_warnings()
    sp = SyntheticSparseMatrix(200, 30, 5, seed=1)
    with pytest.warns(DeprecationWarning, match="sparse_tsvd"):
        res = tcore.sparse_tsvd(sp, 2, max_iters=5, device="cpu")
    assert res.backend == "sparsestream" and tcore.SparseTSVDResult is \
        tcore.SVDResult
    assert list(res.iters) == [5, 5] or res.converged


# ---------------------------------------------------------------------------
# dataset files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".npz", ".mtx", ".mtx.gz"])
def test_dataset_paths_match_the_in_memory_solve(suffix, tmp_path):
    A, _ = _spectral_sparse()
    path = str(tmp_path / f"A{suffix}")
    if suffix == ".npz":
        scipy.sparse.save_npz(path, A, compressed=False)
    else:
        plain = str(tmp_path / "A.mtx")
        scipy.io.mmwrite(plain, A.astype(np.float32))
        if suffix == ".mtx.gz":
            with open(plain, "rb") as f, gzip.open(path, "wb") as g:
                shutil.copyfileobj(f, g)
    want = repro_torch.svd(scipy.sparse.csr_matrix(
        scipy.io.mmread(path) if suffix != ".npz" else A), 4, device="cpu")
    got = repro_torch.svd(path, 4, device="cpu")
    assert got.backend == "scipysparse"
    torch.testing.assert_close(got.S, want.S, rtol=0, atol=0)
    ref = jcore.svd(path, 4)
    assert (int(got.iters[0]), got.passes_over_A) == (int(ref.iters[0]),
                                                      ref.passes_over_A)


@pytest.mark.parametrize("suffix,text", [
    (".npz", "is not a readable scipy-sparse .npz"),
    (".mtx", "is not a readable MatrixMarket file"),
])
def test_corrupt_dataset_files_are_input_errors(suffix, text, tmp_path):
    path = str(tmp_path / f"bad{suffix}")
    with open(path, "wb") as f:
        f.write(b"PK\x03\x04 truncated" if suffix == ".npz"
                else b"%%MatrixMarket matrix coordinate real general\n3 x\n")
    for svd in (jcore.svd, lambda p, k: repro_torch.svd(p, k,
                                                        device="cpu")):
        with pytest.raises(errors.InputError if svd is not jcore.svd
                           else ValueError, match=text):
            svd(path, 2)


def test_unknown_path_suffix_is_an_input_error():
    with pytest.raises(errors.InputError, match="must end in one of"):
        repro_torch.svd("A.csv", 2, device="cpu")
