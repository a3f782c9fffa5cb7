"""Checkpoint/resume through the port's ``svd()`` front door, on the CPU.

All of ``tests/test_resume.py`` on the port's dense (a torch tensor),
host-blocked (a numpy array), memmap and sparse backends: a run capped
by ``max_iters`` (or killed) and resumed from ``checkpoint_dir``
reproduces the uninterrupted run's factors EXACTLY (the same fp32 bits:
the state machine replays the same sweeps from the same state), with
``passes_over_A``/``bytes_moved`` conserved across the restart; stale
and foreign checkpoints are refused; a corrupt, torn or non-finite step
is quarantined and the previous one taken.  Then the two packages
against each other: a checkpoint directory written by ``repro.core.svd``
resumes in ``repro_torch.svd(device="cpu")`` and the reverse.  Across
packages the sweeps are not bitwise alike (QR and summation orders
differ), so the resumed solve is held to the uninterrupted one of the
other package at ``tests/test_torch_svd.py``'s limits: sigma rtol 2e-4,
principal angles above 1 - 1e-3, and the iteration count within one.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (CountingHostMatrix, MemmapMatrix,
                              SyntheticSparseMatrix, stage_to_disk)
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults

KW = dict(method="block", warmup_q=1, eps=1e-7, n_blocks=3)


def _spectrum_matrix(rng, m=80, n=24):
    L = rng.standard_normal((m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(L, full_matrices=False)
    return (U * np.linspace(6, 1, n).astype(np.float32)) @ Vt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _input(backend, A, tmp_path):
    """A fresh input of ``backend`` over the same matrix (a fresh process
    would build a fresh one)."""
    if backend == "dense":
        return torch.from_numpy(A.copy())
    if backend == "hostblocked":
        return A
    if backend == "memmap":
        path = str(tmp_path / "A.npy")
        stage_to_disk(A, path)
        return MemmapMatrix(path, 3, device="cpu")
    return SyntheticSparseMatrix(600, 40, 8, seed=3)


BACKENDS = ["dense", "hostblocked", "memmap", "sparse"]


def _svd(X, k, **kw):
    return repro_torch.svd(X, k, device="cpu", **{**KW, **kw})


@pytest.mark.parametrize("backend", BACKENDS)
def test_capped_run_resumes_to_identical_sigmas(backend, rng, tmp_path):
    """Budget-capped run 1 + uncapped resumed run 2 == one uninterrupted
    run, bitwise, with pass/byte accounting conserved."""
    A = _spectrum_matrix(rng)
    ref = _svd(_input(backend, A, tmp_path), 4)
    assert ref.iters[0] > 5                    # the cap actually bites
    ck = str(tmp_path / "ck")
    r1 = _svd(_input(backend, A, tmp_path), 4, max_iters=3,
              checkpoint_dir=ck)
    assert not r1.converged and r1.iters[0] == 3
    r2 = _svd(_input(backend, A, tmp_path), 4, checkpoint_dir=ck)
    assert r2.converged and r2.backend == ref.backend
    for a, b in zip(r2[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert r2.iters[0] == ref.iters[0]
    assert r2.passes_over_A == ref.passes_over_A     # conserved, not reset
    if backend == "memmap":
        # the restart loses run 1's host cache: one more cold file read
        assert r2.bytes_moved["host"] == ref.bytes_moved["host"]
        assert r2.bytes_moved["disk"] == 2 * ref.bytes_moved["disk"]
    else:
        assert r2.bytes_moved == ref.bytes_moved


def test_kill_mid_run_conserves_pass_accounting(rng, tmp_path):
    """Kill the loop via a raising trace hook (the checkpoint for that
    iteration is already on disk), resume on a FRESH instrumented matrix:
    the two processes' physical passes sum exactly to the uninterrupted
    run's."""
    A = _spectrum_matrix(rng)
    m_ref = CountingHostMatrix(A, 3, device="cpu")
    ref = _svd(m_ref, 4)

    class Killed(RuntimeError):
        pass

    def kill_at_5(state):
        if state.it == 5:
            raise Killed()

    ck = str(tmp_path / "ck")
    m1 = CountingHostMatrix(A, 3, device="cpu")
    with pytest.raises(Killed):
        _svd(m1, 4, checkpoint_dir=ck, on_iteration=kill_at_5)
    m2 = CountingHostMatrix(A, 3, device="cpu")
    r2 = _svd(m2, 4, checkpoint_dir=ck)
    torch.testing.assert_close(r2.S, ref.S, rtol=0, atol=0)
    assert m1.passes + m2.passes == m_ref.passes     # split exactly
    assert r2.passes_over_A == ref.passes_over_A     # and summed exactly
    assert r2.bytes_moved == ref.bytes_moved


@pytest.mark.parametrize("backend", ["dense", "sparse"])
def test_injected_kill_resumes_bitwise(backend, rng, tmp_path):
    """The harness's ``kill`` site fires after the iteration's save."""
    A = _spectrum_matrix(rng)
    ref = _svd(_input(backend, A, tmp_path), 4)
    ck = str(tmp_path / "ck")
    with inject_faults(FaultPlan(FaultSpec("kill", at=4))):
        with pytest.raises(RuntimeError, match="injected kill"):
            _svd(_input(backend, A, tmp_path), 4, checkpoint_dir=ck)
    assert CheckpointManager(ck).latest_step() == 5
    r2 = _svd(_input(backend, A, tmp_path), 4, checkpoint_dir=ck)
    torch.testing.assert_close(r2.S, ref.S, rtol=0, atol=0)
    assert r2.passes_over_A == ref.passes_over_A


def test_checkpoint_every_and_final_state_always_saved(rng, tmp_path):
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    res = _svd(A, 4, checkpoint_dir=ck, checkpoint_every=4, eps=1e-6)
    mgr = CheckpointManager(ck)
    steps = mgr.all_steps()
    assert steps[-1] == res.iters[0]           # loop exit state saved
    assert all(s % 4 == 0 for s in steps[:-1])
    meta = mgr.read_meta(steps[-1])
    assert meta["extra"]["kind"] == "solver_state"
    assert "config_fp" in meta["extra"] and "op_fp" in meta["extra"]


def test_resume_refuses_config_fingerprint_mismatch(rng, tmp_path):
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    _svd(A, 4, max_iters=2, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        _svd(A, 4, checkpoint_dir=ck, warmup_q=2)
    with pytest.raises(ValueError, match="different run"):
        _svd(A, 4, checkpoint_dir=ck, seed=1)


def test_resume_refuses_operator_fingerprint_mismatch(rng, tmp_path):
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    _svd(A, 4, max_iters=2, checkpoint_dir=ck)
    B = _spectrum_matrix(rng, 96, 24)          # different shape
    with pytest.raises(ValueError, match="different run"):
        _svd(B, 4, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="different run"):
        _svd(torch.from_numpy(A), 4, checkpoint_dir=ck)  # other backend


def test_resume_refuses_rank_mismatch(rng, tmp_path):
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    _svd(A, 4, max_iters=2, checkpoint_dir=ck)
    with pytest.raises(ValueError, match="rank"):
        _svd(A, 5, checkpoint_dir=ck)


def test_budget_knobs_excluded_from_fingerprint(rng, tmp_path):
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    _svd(A, 4, max_iters=2, checkpoint_dir=ck)
    assert _svd(A, 4, checkpoint_dir=ck, eps=1e-5).converged


def test_fresh_checkpoint_dir_starts_cold(rng, tmp_path):
    A = _spectrum_matrix(rng)
    plain = _svd(A, 4)
    ck = _svd(A, 4, checkpoint_dir=str(tmp_path / "new"))
    torch.testing.assert_close(ck.S, plain.S, rtol=0, atol=0)
    assert ck.passes_over_A == plain.passes_over_A


def test_already_converged_checkpoint_finalizes_without_stepping(
        rng, tmp_path):
    """Re-running a finished solve from its checkpoint dir does ZERO new
    block iterations — only the extraction pass."""
    A = _spectrum_matrix(rng)
    ck = str(tmp_path / "ck")
    first = _svd(A, 4, checkpoint_dir=ck)
    m2 = CountingHostMatrix(A, 3, device="cpu")
    again = _svd(m2, 4, checkpoint_dir=ck)
    torch.testing.assert_close(again.S, first.S, rtol=0, atol=0)
    assert m2.passes == 1                      # just the extract pass
    assert again.passes_over_A == first.passes_over_A


@pytest.mark.parametrize("damage", ["truncated", "nonfinite", "torn-meta"])
def test_damaged_newest_step_is_quarantined(damage, rng, tmp_path):
    """A step that cannot be read (or holds NaN) is renamed
    ``.corrupt`` and resume falls back to the previous step: the result
    is still the uninterrupted run's, bitwise."""
    A = _spectrum_matrix(rng)
    ref = _svd(A, 4)
    ck = str(tmp_path / "ck")
    _svd(A, 4, max_iters=4, checkpoint_dir=ck)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 3, 4]
    step = tmp_path / "ck" / "step_00000004"
    if damage == "truncated":
        (step / "arrays.npz").write_bytes(b"PK\x03\x04 truncated")
    elif damage == "torn-meta":
        (step / "meta.json").write_text('{"step": 4, "ke')
    else:
        tree = mgr.restore(4, repro_torch.SolverState.host_template())
        tree["Q"][0, 0] = np.nan
        mgr.save(4, tree, extra=mgr.read_meta(4)["extra"])
    r2 = _svd(A, 4, checkpoint_dir=ck)
    assert (tmp_path / "ck" / "step_00000004.corrupt").is_dir()
    events = [e for e in r2.faults["events"] if e["site"] == "checkpoint"]
    assert [(e["action"], e["step"]) for e in events] == [("quarantine", 4)]
    torch.testing.assert_close(r2.S, ref.S, rtol=0, atol=0)
    assert r2.passes_over_A == ref.passes_over_A


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _gapped(rng, m=80, n=24):
    """A matrix whose spectrum halves at every step, so the two packages'
    iterates cross the tolerance on the same step (sigma 10 * 0.5^i)."""
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return ((U * (10.0 * 0.5 ** np.arange(n))) @ V.T).astype(np.float32)


def _pair(backend, A):
    """The same input for (the JAX package, the port)."""
    import jax.numpy as jnp
    import scipy.sparse
    if backend == "dense":
        return jnp.asarray(A), torch.from_numpy(A.copy())
    if backend == "hostblocked":
        return A, A
    return scipy.sparse.csr_matrix(A), scipy.sparse.csr_matrix(A)


def _close(got, want):
    np.testing.assert_allclose(_np(got.S), np.asarray(want.S), rtol=2e-4)
    for X, Y in ((got.U, want.U), (got.V, want.V)):
        sv = np.linalg.svd(_np(X).T @ np.asarray(Y), compute_uv=False)
        assert sv.min() > 1 - 1e-3
    assert abs(int(got.iters[0]) - int(want.iters[0])) <= 1


CROSS = ["dense", "hostblocked", "scipysparse"]


@pytest.mark.parametrize("backend", CROSS)
def test_jax_checkpoint_resumes_in_the_port(backend, rng, tmp_path):
    A = _gapped(rng)
    ck = str(tmp_path / "ck")
    r1 = jcore.svd(_pair(backend, A)[0], 4, max_iters=3, checkpoint_dir=ck,
                   **KW)
    assert r1.iters[0] == 3
    got = _svd(_pair(backend, A)[1], 4, checkpoint_dir=ck)
    want = jcore.svd(_pair(backend, A)[0], 4, **KW)
    assert got.converged and got.backend == want.backend == r1.backend
    _close(got, want)
    # the accounting continues from the JAX package's three iterations
    per_iter = 2 if backend == "dense" else 1
    assert got.passes_over_A - want.passes_over_A == \
        (int(got.iters[0]) - int(want.iters[0])) * per_iter


@pytest.mark.parametrize("backend", CROSS)
def test_port_checkpoint_resumes_in_jax(backend, rng, tmp_path):
    A = _gapped(rng)
    ck = str(tmp_path / "ck")
    r1 = _svd(_pair(backend, A)[1], 4, max_iters=3, checkpoint_dir=ck)
    assert r1.iters[0] == 3
    got = jcore.svd(_pair(backend, A)[0], 4, checkpoint_dir=ck, **KW)
    want = _svd(_pair(backend, A)[1], 4)
    assert got.converged and got.backend == want.backend == r1.backend
    _close(want, got)
