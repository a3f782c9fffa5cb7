"""The port's distributed deflation engine (``core/dist_svd.py``) against
the JAX package's, on the CPU with gloo.

* the power step ``_deflated_chain_step``, faithful (Alg 4's three
  all-reduces) and fused (one ``(n + k,)`` all-reduce; ``n_blocks`` row
  blocks of the shard and a ragged tail), against the JAX step run in a
  one-device ``shard_map``: kernel tolerances of ``tests/test_kernels.py``
  (rtol 1e-3, atol 5e-2);
* whole solves started from the JAX package's own draws (``x0=``, the
  reference's ``fold_in(PRNGKey(0), seed)`` split into k keys) at
  ``eps=1e-6``: sigma rtol 1e-4, singular vectors ``|dot| > 0.999``,
  per-rank ``iters`` within one step (the stop test is taken on fp32
  sums the two packages add in different orders, as
  ``tests/test_torch_deflation.py`` explains); ``passes_over_A`` under
  ``force_iters`` exactly equal;
* the collective record: one ``(n + k,)`` all-reduce a fused power
  step, three (``(n,)``, ``(k,)``, ``(n,)``) a faithful one, the fused
  Gram path's reduce-scatter and one all-gather a step;
* four gloo ranks in children (``torchrun``, under a timeout), the same
  starts: bitwise the same on every rank, and the JAX package's answer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.core as jcore
from repro.compat import make_mesh, shard_map
from repro.core import dist_svd as jdist
from repro_torch.core import collectives
from repro_torch.core import dist_svd as tdist
from repro_torch.core.operator import ShardLayout

from test_torch_sharded import run_ranks

SPECTRUM = np.linspace(20, 2, 10)


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


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def jax_starts(seed, k, n):
    """The reference engine's start vectors
    (``repro/core/dist_svd.py:184-192``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(0),
                             np.uint32(seed & 0xFFFFFFFF))
    keys = jax.random.split(key, k)
    return np.stack([np.asarray(jax.random.normal(keys[l], (n,),
                                                  jnp.float32))
                     for l in range(k)])


def _jax_solve(A, k, **kw):
    return jcore.svd(jnp.asarray(A), k, mesh=make_mesh((1,), ("data",)),
                     **kw)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """A world-1 gloo group, a (1,) "cpu" mesh and its ShardLayout."""
    from torch.distributed.device_mesh import init_device_mesh
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield ShardLayout(init_device_mesh("cpu", (1,),
                                           mesh_dim_names=("data",)))
    finally:
        dist.destroy_process_group()


def _step_inputs(m=130, n=70, k=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).astype(np.float32)
    U = np.linalg.qr(rng.normal(size=(m, k)))[0].astype(np.float32)
    V = np.linalg.qr(rng.normal(size=(n, k)))[0].astype(np.float32)
    S = np.abs(rng.normal(size=k)).astype(np.float32) * 5
    v = rng.normal(size=n).astype(np.float32)
    return A, U, S, V, v / np.linalg.norm(v)


@pytest.mark.parametrize("faithful,n_blocks", [(True, 1), (False, 1),
                                               (False, 4), (False, 7)])
def test_chain_step_matches_jax(layout, faithful, n_blocks):
    """130 rows in 4 blocks of 32 and a tail of 2; in 7 of 18 and 4."""
    A, U, S, V, v = _step_inputs()
    jmesh = make_mesh((1,), ("data",))
    f = shard_map(
        lambda a, u, s, vv, x: jdist._deflated_chain_step(
            a, u, s, vv, x, ("data",), faithful=faithful, n_blocks=n_blocks),
        mesh=jmesh, in_specs=(P("data", None), P("data", None), P(None),
                              P(None, None), P(None)), out_specs=P(None))
    want = np.asarray(jax.jit(f)(*(jnp.asarray(x) for x in (A, U, S, V, v))))
    got = tdist._deflated_chain_step(_t(A), _t(U), _t(S), _t(V), _t(v),
                                     layout.group, faithful=faithful,
                                     n_blocks=n_blocks)
    np.testing.assert_allclose(_np(got), want, rtol=1e-3, atol=5e-2)


def test_faithful_matvec_equals_the_fused_step(layout):
    A, U, S, V, v = _step_inputs(seed=1)
    args = [_t(x) for x in (A, U, S, V, v)]
    faithful = tdist.deflated_matvec_faithful(*args, layout.group)
    for n_blocks in (1, 4):
        fused = tdist._deflated_chain_step(*args, layout.group,
                                           faithful=False, n_blocks=n_blocks)
        np.testing.assert_allclose(_np(fused), _np(faithful), rtol=1e-4,
                                   atol=1e-3)


@pytest.mark.parametrize("method,faithful,n_blocks", [
    ("gramfree", False, 1), ("gramfree", True, 1), ("gramfree", False, 4),
    ("gram", False, 1), ("gram", True, 1)])
def test_engine_from_the_jax_starts(layout, method, faithful, n_blocks):
    A = _lowrank(130, 60, seed=2)
    k, seed = 4, 3
    x0 = jax_starts(seed, k, A.shape[1])
    U, S, V, iters, passes = tdist._dist_deflation(
        layout.local_rows(A), k, layout, method=method, faithful=faithful,
        n_blocks=n_blocks, eps=1e-6, max_iters=300, force_iters=False,
        x0=x0)
    want = _jax_solve(A, k, method=method, faithful=faithful,
                      n_blocks=n_blocks, eps=1e-6, max_iters=300, seed=seed)
    np.testing.assert_allclose(_np(S), np.asarray(want.S), rtol=1e-4)
    np.testing.assert_allclose(_np(S), SPECTRUM[:k], rtol=2e-3)
    assert np.all(np.abs(iters - np.asarray(want.iters)) <= 1), \
        (iters, want.iters)
    for X, Y in ((U, want.U), (V, want.V)):
        dots = np.abs(np.sum(_np(X) * np.asarray(Y), axis=0))
        assert dots.min() > 0.999, dots
    per_step = 0 if method == "gram" else (3 if faithful else 2)
    assert passes == (3 * k if method == "gram"
                      else per_step * int(iters.sum()) + k)


@pytest.mark.parametrize("method,faithful,n_blocks", [
    ("gramfree", False, 1), ("gramfree", True, 1), ("gramfree", False, 3),
    ("gram", False, 1), ("gram", True, 1)])
def test_force_iters_passes_equal_jax(layout, method, faithful, n_blocks):
    import repro_torch
    A = _lowrank(61, 30, seed=4)          # ragged blocks of 20 and a tail
    kw = dict(method=method, faithful=faithful, n_blocks=n_blocks,
              force_iters=True, max_iters=6)
    got = repro_torch.svd(A, 3, mesh=layout.mesh, **kw)
    want = _jax_solve(A, 3, **kw)
    assert got.passes_over_A == int(want.passes_over_A)
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    assert got.bytes_per_pass == int(want.bytes_per_pass)
    assert got.bytes_moved is None and want.bytes_moved is None
    assert not got.converged and not want.converged


@pytest.mark.parametrize("method,faithful", [
    ("gramfree", False), ("gramfree", True), ("gram", False),
    ("gram", True)])
def test_collective_record(layout, method, faithful):
    """Under force_iters (5 steps a rank, k = 2): the fused chain one
    (n + k,) all-reduce a step, the faithful three; the Gram path a
    reduce-scatter (fused) or all-reduce (faithful) of B a rank, then on
    the fused path one all-gather of B_loc v a step; every rank one
    scalar all-reduce for sigma."""
    A = _lowrank(50, 20, seed=5)
    n, k = 20, 2
    collectives.reset_record()
    tdist._dist_deflation(layout.local_rows(A), k, layout, method=method,
                          faithful=faithful, n_blocks=1, eps=1e-6,
                          max_iters=5, force_iters=True)
    got = [(c["op"], c["shape"]) for c in collectives.record]
    per_step = {("gramfree", False): [("all_reduce", (n + k,))],
                ("gramfree", True): [("all_reduce", (n,)),
                                     ("all_reduce", (k,)),
                                     ("all_reduce", (n,))],
                ("gram", False): [("all_gather", (n,))],
                ("gram", True): []}[method, faithful]
    first = {("gram", False): [("reduce_scatter", (n, n))],
             ("gram", True): [("all_reduce", (n, n))]}.get((method, faithful),
                                                           [])
    assert got == (first + per_step * 5 + [("all_reduce", ())]) * k
    assert all(c["dtype"] == "float32" and c["group_size"] == 1
               for c in collectives.record)


def test_start_vectors_are_checked(layout):
    A = _lowrank(40, 12, seed=6)
    with pytest.raises(ValueError, match="x0 must have shape"):
        tdist._dist_deflation(layout.local_rows(A), 2, layout,
                              method="gramfree", faithful=False, n_blocks=1,
                              eps=1e-6, max_iters=5, force_iters=True,
                              x0=np.zeros((2, 11), np.float32))


# ---------------------------------------------------------------------------
# four ranks, in children
# ---------------------------------------------------------------------------

RANKS = r'''
import sys
import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

dist.init_process_group("gloo")
from repro_torch.core import collectives
from repro_torch.core.dist_svd import _dist_deflation
from repro_torch.core.operator import ShardLayout

out = sys.argv[1]
data = np.load(f"{out}/inputs.npz")
A, x0 = data["A"], data["x0"]
layout = ShardLayout(init_device_mesh("cpu", (4,), mesh_dim_names=("data",)))
saved = {}
for method, faithful, n_blocks in (("gramfree", False, 1),
                                   ("gramfree", True, 1),
                                   ("gramfree", False, 4),
                                   ("gram", False, 1), ("gram", True, 1)):
    name = f"{method}/{faithful}/{n_blocks}"
    collectives.reset_record()
    U, S, V, iters, passes = _dist_deflation(
        layout.local_rows(A), x0.shape[0], layout, method=method,
        faithful=faithful, n_blocks=n_blocks, eps=1e-6, max_iters=300,
        force_iters=False, x0=x0)
    saved[name + "/n_collectives"] = np.asarray(
        [sum(c["op"] == op for c in collectives.record)
         for op in ("all_reduce", "reduce_scatter", "all_gather")])
    saved[name + "/group_sizes"] = np.asarray(
        sorted({c["group_size"] for c in collectives.record}))
    saved[name + "/U"] = collectives.all_gather(U, layout.group).numpy()
    saved[name + "/S"] = S.numpy()
    saved[name + "/V"] = V.numpy()
    saved[name + "/iters"] = iters
    saved[name + "/passes"] = np.asarray(passes)
# the fused Gram path row-shards B: n must divide over the shards
try:
    _dist_deflation(layout.local_rows(A[:, :-2]), 2, layout, method="gram",
                    faithful=False, n_blocks=1, eps=1e-6, max_iters=5,
                    force_iters=True)
except ValueError as e:
    assert "not divisible by shards=4" in str(e)
else:
    raise AssertionError("n=58 over 4 shards was accepted")
np.savez(f"{out}/rank{dist.get_rank()}.npz", **saved)
dist.destroy_process_group()
print("RANK_OK")
'''

FOUR_RANK_CASES = ["gramfree/False/1", "gramfree/True/1", "gramfree/False/4",
                   "gram/False/1", "gram/True/1"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("ranks")
    A = _lowrank(136, 60, seed=7)        # 34 rows a rank: blocks of 8 + 2
    np.savez(d / "inputs.npz", A=A, x0=jax_starts(5, 4, 60))
    out = run_ranks(RANKS, 4, d, d)
    assert out.count("RANK_OK") == 4, out[-3000:]
    return A, [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]


def test_four_ranks_agree_bitwise(four_ranks):
    _, ranks = four_ranks
    for key in ranks[0]:
        for r in range(1, 4):
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key],
                                          err_msg=key)


@pytest.mark.parametrize("name", FOUR_RANK_CASES)
def test_four_ranks_match_jax_from_its_starts(four_ranks, name):
    A, ranks = four_ranks
    got = ranks[0]
    method, faithful, n_blocks = name.split("/")
    faithful, n_blocks = faithful == "True", int(n_blocks)
    want = _jax_solve(A, 4, method=method, faithful=faithful,
                      n_blocks=n_blocks, eps=1e-6, max_iters=300, seed=5)
    np.testing.assert_allclose(got[name + "/S"], np.asarray(want.S),
                               rtol=1e-4)
    assert np.all(np.abs(got[name + "/iters"] - np.asarray(want.iters))
                  <= 1)
    for side in ("U", "V"):
        dots = np.abs(np.sum(got[f"{name}/{side}"] *
                             np.asarray(getattr(want, side)), axis=0))
        assert dots.min() > 0.999, (side, dots)
    its = int(got[name + "/iters"].sum())
    all_reduce, scatter, gather = got[name + "/n_collectives"]
    if method == "gramfree":
        assert (all_reduce, scatter, gather) == \
            ((3 if faithful else 1) * its + 4, 0, 0)
        assert int(got[name + "/passes"]) == (3 if faithful else 2) * its + 4
    else:
        assert (all_reduce, scatter, gather) == \
            ((8, 0, 0) if faithful else (4, 4, its))
        assert int(got[name + "/passes"]) == 12
    np.testing.assert_array_equal(got[name + "/group_sizes"], [4])
