"""The ported disk tier against the JAX package, on the CPU.

Mirrors ``tests/test_disk_tier.py``: files staged by either package's
``stage_to_disk`` are read by the other (fp32 and bf16: numpy stores the
bf16 bits as a 2-byte void type, which both packages view back as bf16),
and the disk tier's counters (``disk_bytes``, ``h2d_bytes``, fetches,
``peak_host_bytes``) and the reported ``bytes_moved`` equal the JAX
package's exactly under ``force_iters``: one cold file read with an
unbounded host budget, one file read a pass with a capped one, half the
bytes with bf16 staging.  Sigma to rtol 2e-3 against numpy, as the JAX
package's test (2e-2 under bf16).
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
import repro_torch.core as tcore
from repro_torch.core.errors import InputError


def _lowrank(m=60, n=24, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    s = np.zeros(min(m, n), np.float32)
    s[:6] = np.linspace(9, 3, 6)
    return (U * s) @ Vt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _stage(pkg, tmp_path, A, dtype):
    path = os.path.join(str(tmp_path), f"{pkg}_{dtype}.npy")
    stager = jcore.stage_to_disk if pkg == "jax" else tcore.stage_to_disk
    return stager(A, path, dtype=dtype)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_cross_between_packages(tmp_path, writer, dtype):
    """A file staged by either package is read by both, bit for bit."""
    A = np.random.default_rng(1).normal(size=(50, 11)).astype(np.float32)
    path = _stage(writer, tmp_path, A, dtype)
    tmm = tcore.open_matrix_memmap(path)
    jmm = jcore.open_matrix_memmap(path)
    assert tuple(tmm.shape) == jmm.shape == (50, 11)
    assert tmm.dtype == (torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32)
    assert tmm.element_size() == jmm.dtype.itemsize
    np.testing.assert_array_equal(_bits(tmm), _bits(jmm))
    want = A.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else A
    np.testing.assert_array_equal(_bits(tmm), _bits(want))


def test_memmap_matrix_rejects_bad_inputs():
    with pytest.raises(ValueError, match="2-D"):
        tcore.MemmapMatrix(np.zeros((3,), np.float32), 2, device="cpu")
    with pytest.raises(ValueError, match="host_budget_bytes"):
        tcore.MemmapMatrix(np.zeros((4, 4), np.float32), 2,
                           host_budget_bytes=-1, device="cpu")


def test_unreadable_file_is_an_input_error(tmp_path):
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"not a numpy file")
    with pytest.raises(InputError, match="not a readable .npy"):
        tcore.open_matrix_memmap(bad)
    np.save(tmp_path / "vec.npy", np.zeros(5, np.float32))
    with pytest.raises(InputError, match="2-D"):
        tcore.open_matrix_memmap(tmp_path / "vec.npy")


def _both(tmp_path, A, n_blocks, k, file_dtype="float32", stage=None,
          budget=0, **kw):
    """The same solve on each package's MemmapMatrix of one file."""
    path = _stage("torch", tmp_path, A, file_dtype)
    stage = stage or file_dtype
    jh = jcore.MemmapMatrix(path, n_blocks, stage_dtype=stage,
                            host_budget_bytes=budget)
    th = tcore.MemmapMatrix(path, n_blocks, stage_dtype=stage,
                            host_budget_bytes=budget, device="cpu")
    kw.setdefault("sweep_dtype", stage)
    return (jh, jcore.svd(jh, k, **kw)), (th, repro_torch.svd(th, k, **kw))


def test_unbounded_budget_reads_disk_once(tmp_path):
    A = _lowrank()
    (jh, jres), (th, tres) = _both(tmp_path, A, 4, 3, method="block",
                                   force_iters=True, max_iters=9)
    assert th.disk_bytes == jh.disk_bytes == A.size * 4
    assert tres.bytes_moved == jres.bytes_moved
    assert tres.bytes_moved["host"] == tres.passes_over_A * \
        tres.bytes_per_pass
    assert tres.bytes_moved["device"] == th.h2d_bytes
    assert tres.backend == "memmap"


def test_capped_budget_reads_disk_every_pass(tmp_path):
    A = _lowrank()
    budget = A.size * 4 // 4                  # below the working set
    (jh, jres), (th, tres) = _both(tmp_path, A, 4, 3, budget=budget,
                                   method="block", force_iters=True,
                                   max_iters=14)
    assert tres.bytes_moved == jres.bytes_moved
    assert tres.bytes_moved["disk"] == tres.passes_over_A * A.size * 4
    assert 0 < th.peak_host_bytes == jh.peak_host_bytes <= budget
    s_ref = np.linalg.svd(A, compute_uv=False)[:3]
    np.testing.assert_allclose(_np(tres.S), s_ref, rtol=2e-3)


def test_svd_on_path_larger_than_budget(tmp_path):
    """Front door, path input, budget from the config: a file 4x the host
    cache factorizes with the JAX package's accounting."""
    A = _lowrank(96, 20, seed=2)
    path = _stage("jax", tmp_path, A, "float32")
    kw = dict(force_iters=True, max_iters=10, n_blocks=6,
              host_budget_bytes=A.size * 4 // 4)
    jres = jcore.svd(path, 3, **kw)
    tres = repro_torch.svd(path, 3, device="cpu", **kw)
    assert tres.backend == jres.backend == "memmap"
    assert tres.bytes_moved == jres.bytes_moved
    assert tres.passes_over_A == jres.passes_over_A
    s_ref = np.linalg.svd(A, compute_uv=False)[:3]
    np.testing.assert_allclose(_np(tres.S), s_ref, rtol=2e-3)


@pytest.mark.parametrize("method,kw", [
    ("block", dict(force_iters=True, max_iters=7)),
    ("block", dict(force_iters=True, max_iters=7, warmup_q=2)),
    ("gramfree", dict(force_iters=True, max_iters=5)),
    ("gramfree", dict(max_iters=40))])
def test_passes_match_instrumented_fetches(tmp_path, method, kw):
    """The reported passes_over_A IS the matrix's own fetch counter, for
    both methods; under force_iters equal to the JAX package's."""
    A = _lowrank()
    (jh, jres), (th, tres) = _both(tmp_path, A, 4, 2, method=method, **kw)
    assert tres.passes_over_A == th.passes
    assert th.fetches == th.passes * th.n_blocks
    if kw.get("force_iters"):
        assert tres.passes_over_A == jres.passes_over_A
        assert th.fetches == jh.fetches
        assert tres.bytes_moved == jres.bytes_moved
    if method == "block":
        assert tres.passes_over_A == kw["max_iters"] + 1 + (
            1 + kw["warmup_q"] if "warmup_q" in kw else 0)


def test_bf16_staging_halves_disk_and_h2d(tmp_path):
    A = _lowrank()
    kw = dict(method="block", force_iters=True, max_iters=8)
    (_, j32), (_, t32) = _both(tmp_path, A, 4, 2, **kw)
    (_, j16), (_, t16) = _both(tmp_path, A, 4, 2, file_dtype="bfloat16",
                               **kw)
    assert t16.passes_over_A == t32.passes_over_A
    assert t16.bytes_per_pass * 2 == t32.bytes_per_pass
    assert t16.bytes_moved["disk"] * 2 == t32.bytes_moved["disk"]
    assert t16.bytes_moved["host"] * 2 == t32.bytes_moved["host"]
    assert t16.bytes_moved == j16.bytes_moved
    s_ref = np.linalg.svd(A, compute_uv=False)[:2]
    np.testing.assert_allclose(_np(t16.S), s_ref, rtol=2e-2)


def test_wide_file_narrow_staging_accounts_both_widths(tmp_path):
    """fp32 file + bf16 staging: disk reads move 4-byte elements, the
    H2D hop the narrowed 2-byte blocks; the staged blocks are bitwise
    the JAX package's."""
    A = _lowrank()
    (jh, jres), (th, tres) = _both(tmp_path, A, 4, 2, stage="bfloat16",
                                   method="block", force_iters=True,
                                   max_iters=6)
    assert tres.bytes_moved == jres.bytes_moved
    assert tres.bytes_moved["disk"] == A.size * 4
    assert tres.bytes_moved["host"] == tres.passes_over_A * A.size * 2
    for b in range(th.n_blocks):
        np.testing.assert_array_equal(_bits(th.host_block(b)),
                                      _bits(jh.host_block(b)))


def test_wide_matrix_on_disk_is_row_blocked_transposed(tmp_path):
    """A wide file runs as its transposed view (CSVD), the factors
    swapped back, as in the JAX package."""
    A = np.ascontiguousarray(_lowrank().T)           # (24, 60)
    path = _stage("torch", tmp_path, A, "float32")
    jres = jcore.svd(path, 3, n_blocks=3)
    tres = repro_torch.svd(path, 3, n_blocks=3, device="cpu")
    assert tres.U.shape == (24, 3) and tres.V.shape == (60, 3)
    np.testing.assert_allclose(_np(tres.S), _np(jres.S), rtol=2e-4)
    mm = np.load(path, mmap_mode="r")
    tres2 = repro_torch.svd(mm, 3, n_blocks=3, device="cpu")
    assert tres2.backend == "memmap"
    assert torch.equal(tres2.S, tres.S)


def test_injected_matrix_stage_dtype_must_match_config(tmp_path):
    A = _lowrank()
    path = _stage("torch", tmp_path, A, "float32")
    with pytest.raises(ValueError, match="staged as float32"):
        repro_torch.svd(tcore.MemmapMatrix(path, 4, device="cpu"), 2,
                        sweep_dtype="bfloat16")


def test_memmap_operator_protocol_counters(tmp_path):
    A = _lowrank()
    path = _stage("torch", tmp_path, A, "float32")
    host = tcore.MemmapMatrix(path, 4, device="cpu")
    op = tcore.MemmapOperator(host)
    assert op.backend == "memmap" and op.demote(None) is None
    assert op.bytes_per_pass == host.bytes_per_pass
    op.gram_chain(torch.zeros((A.shape[1], 3)))
    assert op.passes == 1
    assert op.bytes_moved == host.bytes_moved
    assert op.bytes_moved["host"] == host.bytes_per_pass


def test_disk_read_fault_is_retried(tmp_path):
    """An injected disk-read fault is retried and counted like the JAX
    package's; the result is the fault-free one."""
    from repro.core.faults import FaultPlan as JP, FaultSpec as JS
    from repro.core.faults import inject_faults as jinject
    from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
    A = _lowrank()
    path = _stage("torch", tmp_path, A, "float32")
    kw = dict(n_blocks=4, io_retry_backoff=0.0, host_budget_bytes=A.size)
    clean = repro_torch.svd(path, 2, device="cpu", **kw)
    with inject_faults(FaultPlan(FaultSpec("disk_read", at=6))):
        hit = repro_torch.svd(path, 2, device="cpu", **kw)
    with jinject(JP(JS("disk_read", at=6))):
        jhit = jcore.svd(path, 2, **kw)
    for a, b in zip(clean[:3], hit[:3]):
        assert torch.equal(a, b)
    assert hit.faults["counters"] == jhit.faults["counters"] == {
        "disk_read.injected": 1, "disk_read.retry": 1}
