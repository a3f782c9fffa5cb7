"""The sharded backend of the port (``svd(A, k, mesh=...)``,
``ShardedOperator``, ``launch/mesh.py``, ``core/collectives.py``) against
the JAX package, on the CPU with gloo.

Two kinds of cases:

* **one rank, in process**: a world-1 gloo group and a ``(1,)`` "cpu"
  mesh in the pytest process, beside the JAX package's
  ``make_mesh((1,), ("data",))`` (``tests/test_operator_contract.py``'s
  and ``tests/test_unified_api.py``'s "sharded" case);
* **four ranks, in children**: ``torchrun --standalone`` starts four gloo
  ranks on the CPU that run all of ``tests/test_distributed.py``'s
  ``DIST_SVD_CHECKS`` (both deflation methods faithful and fused, the
  wide input, ``n_blocks=4``, ``U`` orthonormal, a ("pod", "data")
  2 x 2 mesh, block at k = 8, the rank-deficient block, the warm start
  on real sharding), plus checkpoints on a mesh that replicates the rows
  over a dim outside the axes and planted device OOMs down to the host
  and the disk tiers, and save what they got; the parent compares the ranks bit for bit and the results
  with the JAX package's sharded solve of the same matrix.  The children
  import no JAX.  Every child runs under a timeout, and a rank that fails
  ends them all.

Tolerances are the reference's: block sigma rtol 2e-3
(``tests/test_distributed.py``), ``extract`` sigma rtol 2e-4 and
principal-angle cosines > 1 - 1e-3 (``tests/test_operator_contract.py``),
deflation rtol 2e-3; integer accounting under ``force_iters`` exactly
equal.
"""
import os
import signal
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jcore
import repro_torch
from repro.compat import make_mesh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import collectives
from repro_torch.core.errors import InputError
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
from repro_torch.core.operator import (HostBlockedOperator,
                                       ShardedMemmapOperator, ShardedOperator)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECTRUM = np.concatenate([np.linspace(20, 2, 8), 2 * 0.75 ** np.arange(1, 9)])
K = 8
RANK_TIMEOUT = 240          # seconds for one torchrun of four CPU ranks


def _lowrank(m, n, seed=0, spectrum=SPECTRUM):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    s = np.zeros(min(m, n), np.float32)
    s[:len(spectrum)] = spectrum
    return ((U * s) @ Vt).astype(np.float32)


def _np(x):
    if hasattr(x, "full_tensor"):
        x = x.full_tensor()
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _cosines(X, Y):
    return np.linalg.svd(_np(X).T @ _np(Y), compute_uv=False)


def run_ranks(script: str, world: int, tmp_path, *args) -> str:
    """Run ``script`` on ``world`` gloo ranks of this host (``torchrun
    --standalone``: a free port each time, so files running at once do
    not collide) under ``RANK_TIMEOUT``; every rank is killed when one
    fails or time runs out.  Returns the output."""
    path = tmp_path / "ranks.py"
    path.write_text(script)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={world}", str(path), *map(str, args)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=RANK_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
        pytest.fail(f"ranks timed out after {RANK_TIMEOUT} s:\n{out[-4000:]}")
    assert proc.returncode == 0, f"ranks failed:\n{out[-6000:]}"
    return out


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A world-1 gloo group and a (1,) "cpu" mesh in this process."""
    from torch.distributed.device_mesh import init_device_mesh
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    finally:
        dist.destroy_process_group()


def _jax_sharded(A, k, **kw):
    return jcore.svd(jnp.asarray(A), k, mesh=make_mesh((1,), ("data",)),
                     **kw)


# ---------------------------------------------------------------------------
# one rank, in process
# ---------------------------------------------------------------------------

def test_block_matches_the_jax_sharded_solve(mesh1):
    A = _lowrank(128, 64)
    kw = dict(method="block", eps=1e-8, max_iters=300, warmup_q=1)
    got, want = repro_torch.svd(A, K, mesh=mesh1, **kw), _jax_sharded(A, K,
                                                                      **kw)
    s_np = np.linalg.svd(A, compute_uv=False)[:K]
    assert got.backend == want.backend == "sharded" and got.converged
    assert got.bytes_per_pass == want.bytes_per_pass == A.size * 4
    assert isinstance(got.U, torch.distributed.tensor.DTensor)
    np.testing.assert_allclose(_np(got.S), s_np, rtol=2e-3)
    np.testing.assert_allclose(_np(got.S), np.asarray(want.S), rtol=2e-3)
    for X, Y in ((got.U, want.U), (got.V, want.V)):
        assert _cosines(X, np.asarray(Y)).min() > 1 - 1e-3
    np.testing.assert_allclose(_np(got.U).T @ _np(got.U), np.eye(K),
                               atol=5e-3)


@pytest.mark.parametrize("method,faithful", [
    ("block", False), ("gramfree", False), ("gramfree", True),
    ("gram", False), ("gram", True)])
@pytest.mark.parametrize("wide", [False, True])
def test_force_iters_accounting_equals_jax(mesh1, method, faithful, wide):
    """passes_over_A, iters, bytes_per_pass, backend and bytes_moved
    equal the JAX package's exactly under force_iters."""
    A = _lowrank(96, 40, seed=3)
    A = A.T.copy() if wide else A
    kw = dict(method=method, faithful=faithful, force_iters=True,
              max_iters=5)
    got, want = repro_torch.svd(A, 3, mesh=mesh1, **kw), _jax_sharded(A, 3,
                                                                     **kw)
    assert got.passes_over_A == int(want.passes_over_A)
    np.testing.assert_array_equal(np.asarray(got.iters),
                                  np.asarray(want.iters))
    assert got.bytes_per_pass == int(want.bytes_per_pass)
    assert got.backend == want.backend == "sharded"
    assert (got.bytes_moved is None) == (want.bytes_moved is None)
    if want.bytes_moved is not None:
        assert got.bytes_moved == {k: int(v) for k, v in
                                   want.bytes_moved.items()}
    assert tuple(_np(got.U).shape) == tuple(np.asarray(want.U).shape)
    assert tuple(_np(got.V).shape) == tuple(np.asarray(want.V).shape)


def test_extract_matches_the_jax_operator(mesh1):
    A = _lowrank(120, 48, seed=5)
    Q = np.linalg.qr(np.random.default_rng(1).normal(
        size=(48, 12)).astype(np.float32))[0].astype(np.float32)
    jop = jcore.ShardedOperator(jnp.asarray(A), make_mesh((1,), ("data",)),
                                ("data",))
    top = ShardedOperator(A, mesh1)
    Uj, Sj, Vj = (np.asarray(x) for x in jop.extract(jnp.asarray(Q)))
    Ut, St, Vt = top.extract(torch.from_numpy(Q))
    np.testing.assert_allclose(_np(St)[:8], Sj[:8], rtol=2e-4)
    for X, Y in ((Ut[:, :8], Uj[:, :8]), (Vt[:, :8], Vj[:, :8])):
        assert _cosines(X, Y).min() > 1 - 1e-3
    assert top.passes == 1 and int(jop.passes) == 1


def test_operator_contract(mesh1):
    """The protocol surface beside the JAX package's: shape, fingerprint,
    bytes, lagged sync, one pass a product, the local rows, demotion to
    the host-blocked tier on the same matrix."""
    A = _lowrank(70, 30, seed=2)
    jop = jcore.ShardedOperator(jnp.asarray(A), make_mesh((1,), ("data",)),
                                ("data",), sweep_dtype="bfloat16")
    top = ShardedOperator(A, mesh1, sweep_dtype="bfloat16")
    assert top.shape == tuple(jop.shape) and top.backend == jop.backend
    assert top.fingerprint == jop.fingerprint
    assert top.fingerprint.endswith(":shards=1")
    assert top.bytes_per_pass == jop.bytes_per_pass == 70 * 30 * 2
    assert top.lagged_sync and top.writes_checkpoints
    Q = torch.from_numpy(np.random.default_rng(0).normal(
        size=(30, 4)).astype(np.float32))
    np.testing.assert_allclose(_np(top.matmat(Q)), A @ _np(Q), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_np(top.rmatmat(top.matmat(Q))),
                               A.T @ (A @ _np(Q)), rtol=1e-4, atol=1e-3)
    assert top.passes == 3
    top.gram_chain(Q)
    assert top.passes == 3 + top.chain_passes
    assert top.bytes_moved == {"device": 5 * top.bytes_per_pass}
    low = top.demote(repro_torch.SVDConfig())
    assert isinstance(low, HostBlockedOperator)
    assert low.shape == top.shape and low.sweep_dtype == "bfloat16"
    assert low.bytes_per_pass == top.bytes_per_pass
    assert low.fingerprint.endswith(":shards=1")
    disk = low.demote(repro_torch.SVDConfig())
    assert isinstance(disk, ShardedMemmapOperator)
    assert disk.backend == "memmap" and disk.shape == top.shape
    assert disk.bytes_per_pass == top.bytes_per_pass
    assert disk.fingerprint.endswith(":shards=1") and disk.demote(None) is None
    os.remove(disk.spill_path)
    staged = torch.cat([low.host.host_block(b)
                        for b in range(low.host.n_blocks)])
    np.testing.assert_array_equal(_np(staged.float()), _np(
        torch.from_numpy(A).bfloat16().float()))


def test_one_all_reduce_of_n_by_k_per_block_step(mesh1):
    A = _lowrank(64, 24, seed=4)
    collectives.reset_record()
    res = repro_torch.svd(A, 4, mesh=mesh1, force_iters=True, max_iters=5)
    steps = [(c["op"], c["shape"], c["dtype"]) for c in collectives.record]
    # five chain steps, then the extraction's (l, l) Gram
    assert steps == [("all_reduce", (24, 4), "float32")] * 5 + \
        [("all_reduce", (4, 4), "float32")]
    assert collectives.record[0]["bytes"] == 24 * 4 * 4
    assert collectives.record[0]["group_size"] == 1
    assert res.passes_over_A == 2 * 5 + 1


def test_mesh_solve_equals_the_dense_solve(mesh1):
    """One rank: the same chain as the dense tier (the same Q0, sweeps and
    QR), so iterations are equal and sigma agrees to the extraction's
    rounding (eigh of W^T W there, QR + SVD of W here)."""
    A = _lowrank(100, 40, seed=6)
    kw = dict(eps=1e-6, max_iters=100)
    sh = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    de = repro_torch.svd(torch.from_numpy(A), 4, device="cpu", **kw)
    np.testing.assert_array_equal(sh.iters, de.iters)
    assert sh.passes_over_A == de.passes_over_A
    np.testing.assert_allclose(_np(sh.S), _np(de.S), rtol=2e-4)
    assert _cosines(sh.V, de.V).min() > 1 - 1e-3


def test_inputs_dtensor_and_wide(mesh1):
    """A DTensor row-sharded over the axes, the same matrix as a tensor
    and as an ndarray, and their transposes (the factors swap out: the
    long side stays the DTensor) give the same solve."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    A = _lowrank(80, 36, seed=7)
    kw = dict(force_iters=True, max_iters=8)
    base = repro_torch.svd(A, 3, mesh=mesh1, **kw)
    for X in (torch.from_numpy(A),
              distribute_tensor(torch.from_numpy(A), mesh1, [Shard(0)])):
        r = repro_torch.svd(X, 3, mesh=mesh1, **kw)
        for a, b in zip(r[:3], base[:3]):
            np.testing.assert_array_equal(_np(a), _np(b))
    w = repro_torch.svd(A.T.copy(), 3, mesh=mesh1, **kw)
    assert isinstance(w.V, DTensor) and not isinstance(w.U, DTensor)
    assert tuple(w.U.shape) == (36, 3) and tuple(w.V.shape) == (80, 3)
    np.testing.assert_allclose(_np(w.S), _np(base.S), rtol=1e-5)


def test_typed_errors(mesh1):
    A = _lowrank(40, 16)
    with pytest.raises(ValueError, match="no paper-faithful"):
        repro_torch.svd(A, 2, mesh=mesh1, faithful=True)
    with pytest.raises(InputError, match="DeviceMesh"):
        repro_torch.svd(A, 2, mesh=object())
    with pytest.raises(InputError, match="exceeds"):
        repro_torch.svd(A, 17, mesh=mesh1)
    with pytest.raises(ValueError, match="not dims of the mesh"):
        repro_torch.svd(A, 2, mesh=mesh1, axes=("model",))
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        repro_torch.svd(A, 2, mesh=mesh1, device="cuda")
    with pytest.raises(ValueError, match="method must be 'block'"):
        repro_torch.svd_update(repro_torch.svd(A, 2, mesh=mesh1), A,
                               mesh=mesh1, method="gram")


def test_no_card_means_no_mesh(monkeypatch):
    """Without a card and without device='cpu', a mesh is refused rather
    than built on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.make_host_mesh()


def test_mesh_builders(mesh1, monkeypatch):
    """make_host_mesh over the world (here one rank) as ("data",
    "model"); make_production_mesh asks for the reference's shapes and
    names (the world here is too small to build them)."""
    from repro_torch.launch import mesh as tmesh
    host = repro_torch.make_host_mesh(device="cpu")
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.mesh.shape) == (1, 1) and host.device_type == "cpu"
    asked = []
    monkeypatch.setattr(tmesh, "init_device_mesh",
                        lambda kind, shape, mesh_dim_names: asked.append(
                            (kind, shape, mesh_dim_names)))
    repro_torch.make_production_mesh(device="cpu")
    repro_torch.make_production_mesh(multi_pod=True, device="cpu")
    assert asked == [("cpu", (16, 16), ("data", "model")),
                     ("cpu", (2, 16, 16), ("pod", "data", "model"))]


def test_checkpoint_resume_on_a_mesh(mesh1, tmp_path):
    """A solve cut at 4 iterations resumes from its checkpoint, bitwise
    the uncut solve, with the passes conserved."""
    A = _lowrank(90, 30, seed=8)
    kw = dict(eps=1e-7, max_iters=60)
    full = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    d = str(tmp_path / "ck")
    repro_torch.svd(A, 4, mesh=mesh1, eps=1e-7, max_iters=4,
                    checkpoint_dir=d)
    assert CheckpointManager(d).latest_step() == 4
    res = repro_torch.svd(A, 4, mesh=mesh1, checkpoint_dir=d, **kw)
    for a, b in zip(res[:3], full[:3]):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(res.iters, full.iters)
    assert res.passes_over_A == full.passes_over_A


def test_planted_oom_demotes_to_host_blocks(mesh1):
    A = _lowrank(96, 32, seed=9)
    kw = dict(force_iters=True, max_iters=10)
    clean = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3))):
        res = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    assert res.backend == "hostblocked"
    assert res.faults["counters"]["device_oom.demote"] == 1
    np.testing.assert_array_equal(res.iters, clean.iters)
    np.testing.assert_allclose(_np(res.S), _np(clean.S), rtol=1e-4)
    assert isinstance(res.U, torch.distributed.tensor.DTensor)


def test_planted_oom_twice_reaches_the_sharded_disk_tier(mesh1):
    """Two planted device OOMs take the sharded solve down the whole
    ladder, sharded -> host blocks -> the rank's rows on disk, as the
    reference's world-1 sharded solve under the same plan goes down to
    its memmap: the same backend, iterations, passes and bytes, sigma
    within the limits of the one-demotion case."""
    from repro.core.faults import FaultPlan as JaxPlan
    from repro.core.faults import FaultSpec as JaxSpec
    from repro.core.faults import inject_faults as jax_inject
    A = _lowrank(96, 32, seed=9)
    kw = dict(force_iters=True, max_iters=10)
    clean = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3),
                                 FaultSpec("device_oom", at=6))):
        res = repro_torch.svd(A, 4, mesh=mesh1, **kw)
    with jax_inject(JaxPlan(JaxSpec("device_oom", at=3),
                            JaxSpec("device_oom", at=6))):
        ref = _jax_sharded(A, 4, **kw)
    assert res.backend == ref.backend == "memmap"
    assert res.faults["counters"] == ref.faults["counters"] == {
        "device_oom.injected": 2, "device_oom.demote": 2}
    np.testing.assert_array_equal(res.iters, clean.iters)
    np.testing.assert_array_equal(res.iters, np.asarray(ref.iters))
    # three steps on the card (two passes a chain), three on host blocks
    # and four on disk (one pass a chain), the extraction
    assert res.passes_over_A == int(ref.passes_over_A) == 3 * 2 + 3 + 4 + 1
    assert res.bytes_per_pass == int(ref.bytes_per_pass) == 96 * 32 * 4
    assert res.bytes_moved == ref.bytes_moved
    np.testing.assert_allclose(_np(res.S), _np(clean.S), rtol=1e-4)
    np.testing.assert_allclose(_np(res.S), np.asarray(ref.S), rtol=1e-4)
    assert isinstance(res.U, torch.distributed.tensor.DTensor)


def test_svd_update_on_a_mesh(mesh1):
    A = _lowrank(128, 48, seed=10)
    rng = np.random.default_rng(2)
    A2 = (A + 1e-3 * rng.normal(size=A.shape)).astype(np.float32)
    kw = dict(eps=1e-6, max_iters=300)
    prev = repro_torch.svd(A, K, mesh=mesh1, **kw)
    cold = repro_torch.svd(A2, K, mesh=mesh1, **kw)
    warm = repro_torch.svd_update(prev, A2, mesh=mesh1, **kw)
    assert warm.backend == "sharded"
    assert int(warm.iters[0]) < int(cold.iters[0])
    np.testing.assert_allclose(_np(warm.S), _np(cold.S), rtol=1e-3)


def test_dist_tsvd_warns_once_and_equals_svd(mesh1):
    from repro_torch.core.svd import _reset_legacy_warnings
    A = _lowrank(64, 24, seed=11)
    _reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        r1 = repro_torch.dist_tsvd(A, 3, mesh1, max_iters=50)
        r2 = repro_torch.dist_tsvd(A, 3, mesh1, max_iters=50)
    dep = [w for w in seen if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "dist_tsvd" in str(dep[0].message)
    want = repro_torch.svd(A, 3, mesh=mesh1, method="gramfree",
                           max_iters=50, n_blocks=1)
    for a, b, c in zip(r1[:3], r2[:3], want[:3]):
        np.testing.assert_array_equal(_np(a), _np(c))
        np.testing.assert_array_equal(_np(b), _np(c))
    assert r1.passes_over_A == want.passes_over_A
    assert repro_torch.DistTSVDResult is repro_torch.SVDResult
    with pytest.raises(ValueError, match="n_blocks > 1"):
        repro_torch.dist_tsvd(A, 3, mesh1, method="block", n_blocks=2)


def test_exports_match_the_reference():
    for name in ("ShardedOperator", "dist_tsvd", "DistTSVDResult"):
        assert name in repro_torch.core.__all__ and name in jcore.__all__
        assert name in repro_torch.__all__
    for name in ("make_host_mesh", "make_production_mesh"):
        assert name in repro_torch.core.__all__
        assert name in repro_torch.__all__


# ---------------------------------------------------------------------------
# four ranks, in children
# ---------------------------------------------------------------------------

#: ``tests/test_distributed.py::DIST_SVD_CHECKS`` on four gloo ranks (the
#: reference runs eight fake devices), plus what the parent compares:
#: every case's S, V, iters and passes, U gathered, the collectives
RANKS = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

dist.init_process_group("gloo")
import repro_torch
from repro_torch.core import collectives

out = sys.argv[1]
rank = dist.get_rank()
mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
rng = np.random.default_rng(0)
U0, _, Vt0 = np.linalg.svd(rng.normal(size=(128, 48)).astype(np.float32),
                           full_matrices=False)
s0 = np.linspace(20, 1, 48).astype(np.float32)
A = (U0 * s0) @ Vt0
saved = {}


def full(X):
    return (X.full_tensor() if hasattr(X, "full_tensor") else X).numpy()


def run(name, X, k, m=mesh, **kw):
    collectives.reset_record()
    r = repro_torch.svd(X, k, mesh=m, **kw)
    saved[name + "/S"] = r.S.numpy()
    saved[name + "/U"] = full(r.U)
    saved[name + "/V"] = full(r.V)
    saved[name + "/iters"] = np.asarray(r.iters)
    saved[name + "/passes"] = np.asarray(r.passes_over_A)
    saved[name + "/backend"] = np.asarray(r.backend)
    saved[name + "/bytes_moved"] = np.asarray(
        sorted((r.bytes_moved or {}).items()))
    saved[name + "/collectives"] = np.asarray(
        [[c["op"] == "all_reduce", int(np.prod(c["shape"])),
          c["group_size"]] for c in collectives.record])
    return r


for method in ["gram", "gramfree"]:
    for faithful in [True, False]:
        r = run(f"{method}/{faithful}", A, 4, method=method,
                faithful=faithful, eps=1e-10, max_iters=500)
        np.testing.assert_allclose(r.S.numpy(), s0[:4], rtol=2e-3)
# wide input (CSVD orientation)
r = run("wide/gramfree", A.T.copy(), 4, method="gramfree", eps=1e-10,
        max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:4], rtol=2e-3)
# in-shard batching (the paper's n_b): 32 rows a shard, blocks of 6 + 2
r = run("nblocks", A, 4, method="gramfree", n_blocks=5, eps=1e-10,
        max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:4], rtol=2e-3)
# U row-sharded coherently: U^T U = I globally
r = run("orth", A, 4, method="gramfree", eps=1e-10, max_iters=500)
U = full(r.U)
np.testing.assert_allclose(U.T @ U, np.eye(4), atol=5e-3)
# two-axis distribution (pod x data)
r = run("pod/gramfree", A, 3, m=mesh2, axes=("pod", "data"),
        method="gramfree", eps=1e-10, max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:3], rtol=2e-3)
r = run("pod/gram", A, 3, m=mesh2, axes=("pod", "data"), method="gram",
        eps=1e-10, max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:3], rtol=2e-3)
# block subspace iteration: one fused (n, k) all-reduce a step
r = run("block", A, 8, method="block", eps=1e-8, max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:8], rtol=2e-3)
U = full(r.U)
np.testing.assert_allclose(U.T @ U, np.eye(8), atol=5e-3)
r = run("wide/block", A.T.copy(), 4, method="block", eps=1e-8,
        max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:4], rtol=2e-3)
r = run("pod/block", A, 3, m=mesh2, axes=("pod", "data"), method="block",
        eps=1e-8, max_iters=500)
np.testing.assert_allclose(r.S.numpy(), s0[:3], rtol=2e-3)
# rank-deficient block: extras ~0 and every factor entry stays finite
s_def = np.zeros(48, np.float32); s_def[:4] = [9, 7, 5, 3]
A_def = (U0 * s_def) @ Vt0
r = run("deficient", A_def, 6, method="block", eps=1e-6, max_iters=300)
np.testing.assert_allclose(r.S.numpy()[:4], s_def[:4], rtol=2e-3)
assert np.all(r.S.numpy()[4:] < 1e-3 * s_def[0])
assert np.all(np.isfinite(full(r.U))) and np.all(np.isfinite(full(r.V)))
# the range-finder warm start on real sharding: each shard sketches its
# own Omega row block; same answer, >= 3x fewer block iterations, and
# the pass accounting shows the saving
s_sep = np.zeros(48, np.float32)
s_sep[:16] = np.concatenate([np.linspace(20, 2, 8),
                             2 * 0.75 ** np.arange(1, 9)])
A_sep = (U0 * s_sep) @ Vt0
rc = run("cold", A_sep, 8, method="block", eps=1e-6, max_iters=300)
rw = run("warm", A_sep, 8, method="block", eps=1e-6, max_iters=300,
         warmup_q=1)
np.testing.assert_allclose(rw.S.numpy(), s_sep[:8], rtol=2e-3)
np.testing.assert_allclose(full(rw.U).T @ full(rw.U), np.eye(8), atol=5e-3)
assert int(rw.iters[0]) * 3 <= int(rc.iters[0]), (rw.iters, rc.iters)
assert int(rw.passes_over_A) < int(rc.passes_over_A)
# rows that do not divide over the shards: the reference's error
try:
    repro_torch.svd(A[:126], 4, mesh=mesh)
except ValueError as e:
    assert "m=126 not divisible by shards=4" in str(e)
else:
    raise AssertionError("m=126 over 4 shards was accepted")
# one group over the product of the axes, in row-major mesh order; one
# axis of two is the ranks that share the other coordinate
from repro_torch.launch.mesh import axes_group
flat = dist.get_process_group_ranks(axes_group(mesh2, ("pod", "data")))
assert flat == [0, 1, 2, 3], flat
pod = dist.get_process_group_ranks(axes_group(mesh2, ("pod",)))
assert pod == [rank % 2, rank % 2 + 2], pod
# a wide DTensor (the transpose of a row-sharded one): each rank's
# transposed-in rows are its own, the same bits as the wide ndarray
from torch.distributed.tensor import DTensor, Shard
DA = DTensor.from_local(torch.from_numpy(A[rank * 32:(rank + 1) * 32]),
                        mesh, [Shard(0)], run_check=False)
wide = repro_torch.svd(DA.mT, 4, mesh=mesh, method="block", eps=1e-8,
                       max_iters=500)
np.testing.assert_array_equal(wide.S.numpy(), saved["wide/block/S"])
assert isinstance(wide.V, DTensor) and not isinstance(wide.U, DTensor)
# checkpoints on a mesh: the first rank writes each step, every rank
# waits for it, and a killed solve resumes bitwise the uncut one
import os
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.errors import KilledFault
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults
ck = os.path.join(out, "ck")
try:
    with inject_faults(FaultPlan(FaultSpec("kill", at=4))):
        repro_torch.svd(A_sep, 8, mesh=mesh, eps=1e-6, max_iters=300,
                        checkpoint_dir=ck)
except KilledFault:
    pass
else:
    raise AssertionError("the planted kill did not fire")
assert CheckpointManager(ck).latest_step() == 5
resumed = repro_torch.svd(A_sep, 8, mesh=mesh, eps=1e-6, max_iters=300,
                          checkpoint_dir=ck)
for a, b in zip(resumed[:3], rc[:3]):
    np.testing.assert_array_equal(full(a), full(b))
assert resumed.passes_over_A == rc.passes_over_A
# a mesh that replicates the rows over a dim outside the axes: ("data",
# "model") 2 x 2 sharded over "data" has a shard 0 for each "model"
# coordinate, but only the mesh's first rank writes a step, every rank
# waits for it, and the killed solve resumes bitwise the uncut one
mesh_dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
saves = []
_save = CheckpointManager.save


def counted_save(self, step, *a, **kw):
    saves.append(int(step))
    return _save(self, step, *a, **kw)


CheckpointManager.save = counted_save
rep = run("replicated", A_sep, 8, m=mesh_dm, method="block", eps=1e-6,
          max_iters=300)
np.testing.assert_allclose(rep.S.numpy(), s_sep[:8], rtol=2e-3)
ck2 = os.path.join(out, "ck_replicated")
try:
    with inject_faults(FaultPlan(FaultSpec("kill", at=4))):
        repro_torch.svd(A_sep, 8, mesh=mesh_dm, eps=1e-6, max_iters=300,
                        checkpoint_dir=ck2)
except KilledFault:
    pass
else:
    raise AssertionError("the planted kill did not fire")
resumed = repro_torch.svd(A_sep, 8, mesh=mesh_dm, eps=1e-6, max_iters=300,
                          checkpoint_dir=ck2)
CheckpointManager.save = _save
for a, b in zip(resumed[:3], rep[:3]):
    np.testing.assert_array_equal(full(a), full(b))
assert resumed.passes_over_A == rep.passes_over_A
writers = [None] * 4
dist.all_gather_object(writers, saves)
assert writers[0] and not any(writers[1:]), writers
assert CheckpointManager(ck2).latest_step() == int(rep.iters[0])
# a planted device OOM: each rank's own rows move to its host and the
# solve goes on with the same one all-reduce a step
from repro_torch.core.operator import (ShardedHostOperator,
                                       ShardedMemmapOperator, ShardedOperator)
low = ShardedOperator(A, mesh).demote(repro_torch.SVDConfig())
assert isinstance(low, ShardedHostOperator) and low.host.m == 32
assert low.shape == (128, 48)
disk = low.demote(repro_torch.SVDConfig())
assert isinstance(disk, ShardedMemmapOperator) and disk.host.m == 32
assert disk.shape == (128, 48) and disk.demote(None) is None
os.remove(disk.spill_path)
with inject_faults(FaultPlan(FaultSpec("device_oom", at=3))):
    dm = run("demoted", A, 4, method="block", force_iters=True,
             max_iters=10)
clean = repro_torch.svd(A, 4, mesh=mesh, method="block", force_iters=True,
                        max_iters=10)
assert dm.backend == "hostblocked", dm.backend
assert dm.faults["counters"]["device_oom.demote"] == 1
np.testing.assert_array_equal(dm.iters, clean.iters)
# three steps on the card (two passes a chain), seven on the host (one
# pass a chain: a block is copied once for both halves), the extraction
assert dm.passes_over_A == 3 * 2 + 7 * 1 + 1, dm.passes_over_A
np.testing.assert_allclose(dm.S.numpy(), clean.S.numpy(), rtol=1e-4)
np.testing.assert_allclose(full(dm.U).T @ full(dm.U), np.eye(4), atol=5e-3)
# two planted device OOMs: each rank's rows go on from its host to its
# own .npy, with the same one all-reduce a step; an explicit host budget
# is shared out, each rank caching a quarter of it
for budget in DISK_BUDGETS:
    with inject_faults(FaultPlan(FaultSpec("device_oom", at=3),
                                 FaultSpec("device_oom", at=6))):
        dd = run(f"disk/{budget}", A, 4, method="block", force_iters=True,
                 max_iters=10, host_budget_bytes=budget)
    assert dd.backend == "memmap", dd.backend
    assert dd.faults["counters"]["device_oom.demote"] == 2
    np.testing.assert_array_equal(dd.iters, clean.iters)
    assert dd.passes_over_A == 3 * 2 + 3 + 4 + 1, dd.passes_over_A
    np.testing.assert_allclose(dd.S.numpy(), clean.S.numpy(), rtol=1e-4)
# a rerun is bitwise equal
r2 = run("block2", A, 8, method="block", eps=1e-8, max_iters=500)
np.testing.assert_array_equal(saved["block2/S"], saved["block/S"])
np.testing.assert_array_equal(saved["block2/U"], saved["block/U"])
np.savez(f"{out}/rank{rank}.npz", **saved)
# every rank is done with its pairs before any rank tears its own down
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank)
'''

#: the four-rank disk tier's host budgets: the default (half the file)
#: and a quarter of ``A``'s 128 x 48 fp32 bytes, one of the four blocks
#: of the whole matrix, which each rank's whole share of ``A`` would fit
DISK_BUDGETS = (0, 128 * 48 * 4 // 4)
RANKS = f"DISK_BUDGETS = {DISK_BUDGETS}\n" + RANKS

CASES = {   # name -> (k, input, JAX kwargs): the parent's reference solves
    "gram/True": (4, "A", dict(method="gram", faithful=True, eps=1e-10,
                               max_iters=500)),
    "gram/False": (4, "A", dict(method="gram", eps=1e-10, max_iters=500)),
    "gramfree/True": (4, "A", dict(method="gramfree", faithful=True,
                                   eps=1e-10, max_iters=500)),
    "gramfree/False": (4, "A", dict(method="gramfree", eps=1e-10,
                                    max_iters=500)),
    "wide/gramfree": (4, "AT", dict(method="gramfree", eps=1e-10,
                                    max_iters=500)),
    "nblocks": (4, "A", dict(method="gramfree", n_blocks=5, eps=1e-10,
                             max_iters=500)),
    "block": (8, "A", dict(method="block", eps=1e-8, max_iters=500)),
    "wide/block": (4, "AT", dict(method="block", eps=1e-8, max_iters=500)),
}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The four ranks' saved results, one dict a rank."""
    d = tmp_path_factory.mktemp("ranks")
    out = run_ranks(RANKS, 4, d, d)
    assert out.count("RANK_OK") == 4, out[-3000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_four_ranks_agree_bitwise(four_ranks):
    """S, V, iters and passes are the same bits on every rank, and so is
    the gathered U (the DTensor's full_tensor)."""
    for key in four_ranks[0]:
        for r in range(1, 4):
            np.testing.assert_array_equal(four_ranks[r][key],
                                          four_ranks[0][key], err_msg=key)


def _ranks_A():
    """The four-rank child's ``A``."""
    rng = np.random.default_rng(0)
    U0, _, Vt0 = np.linalg.svd(rng.normal(size=(128, 48)).astype(np.float32),
                               full_matrices=False)
    return (U0 * np.linspace(20, 1, 48).astype(np.float32)) @ Vt0


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_ranks_match_the_jax_sharded_solve(four_ranks, name):
    k, which, kw = CASES[name]
    A = _ranks_A()
    want = _jax_sharded(A if which == "A" else A.T.copy(), k, **kw)
    got = four_ranks[0]
    np.testing.assert_allclose(got[name + "/S"], np.asarray(want.S),
                               rtol=2e-3)
    for side in ("U", "V"):
        assert got[name + "/" + side].shape == np.asarray(
            getattr(want, side)).shape
        assert _cosines(got[name + "/" + side],
                        np.asarray(getattr(want, side))).min() > 1 - 2e-3


@pytest.mark.parametrize("budget", DISK_BUDGETS)
def test_four_ranks_reach_the_sharded_disk_tier(four_ranks, budget):
    """Two planted device OOMs on four ranks against the JAX package's
    sharded solve under the same plan, whose disk tier is one memmap of
    the gathered matrix: the same backend, iterations, passes and bytes
    moved per tier (the four ranks' files together, each rank caching its
    share of the host budget).  Sigma is held in the child to the ranks'
    clean solve: ten forced steps from another ``Q0`` than the JAX
    package's do not converge this spectrum's close top values."""
    from repro.core.faults import FaultPlan as JaxPlan
    from repro.core.faults import FaultSpec as JaxSpec
    from repro.core.faults import inject_faults as jax_inject
    with jax_inject(JaxPlan(JaxSpec("device_oom", at=3),
                            JaxSpec("device_oom", at=6))):
        want = _jax_sharded(_ranks_A(), 4, method="block", force_iters=True,
                            max_iters=10, host_budget_bytes=budget)
    got, name = four_ranks[0], f"disk/{budget}"
    assert str(got[name + "/backend"]) == want.backend == "memmap"
    np.testing.assert_array_equal(got[name + "/iters"], np.asarray(want.iters))
    assert int(got[name + "/passes"]) == int(want.passes_over_A)
    assert {t: int(b) for t, b in got[name + "/bytes_moved"]} == {
        t: int(b) for t, b in want.bytes_moved.items()}


def test_four_ranks_collective_schedule(four_ranks):
    """Group size 4 throughout; one (n, k) all-reduce a block step, plus
    the extraction's (l, l); fused deflation one (n + k,) a power step,
    faithful three; the fused Gram path a reduce-scatter of B, then one
    gather a step."""
    got = four_ranks[0]
    n = 48
    for name in ("block", "gramfree/False", "gramfree/True", "gram/False"):
        assert set(got[name + "/collectives"][:, 2]) == {4}, name
    it = int(got["block/iters"][0])
    block = [tuple(c[:2]) for c in got["block/collectives"]]
    assert block == [(1, n * 8)] * it + [(1, 64)]
    for faithful, per_step in ((False, [(1, n + 4)]),
                               (True, [(1, n), (1, 4), (1, n)])):
        name = f"gramfree/{faithful}"
        c = [tuple(x[:2]) for x in got[name + "/collectives"]]
        want = []
        for its in got[name + "/iters"]:
            want += per_step * int(its) + [(1, 1)]     # + sigma's norm
        assert c == want, name
    c = [tuple(x[:2]) for x in got["gram/False/collectives"]]
    want = []
    for its in got["gram/False/iters"]:
        want += [(0, n * n)] + [(0, n // 4)] * int(its) + [(1, 1)]
    assert c == want
    # demoted to the host at step 3: still one (n, k) all-reduce a step
    # over the four ranks, and nothing gathered
    c = [tuple(x) for x in got["demoted/collectives"]]
    assert c == [(1, n * 4, 4)] * 10 + [(1, 16, 4)]
    # and on down to disk at step 6
    for budget in DISK_BUDGETS:
        c = [tuple(x) for x in got[f"disk/{budget}/collectives"]]
        assert c == [(1, n * 4, 4)] * 10 + [(1, 16, 4)], budget
