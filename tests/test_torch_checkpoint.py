"""The ported ``CheckpointManager`` against the JAX package's, on the CPU.

The solver-state cases of ``tests/test_checkpoint.py`` (lines 112-180:
round trips that keep values, containers and dtypes, the ``extra``
metadata, pruning, a torn write), with torch tensors where the JAX
package has jax arrays; the atomicity, retention and corruption rules of
the manager; and the on-disk format: the JAX package's manager and the
port's write the same keys and metadata, and each restores the other's
step directories bitwise.
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxManager
from repro.core.config import SolverState as JaxState
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.config import SolverState
from repro_torch.core.errors import CheckpointCorruptError, KilledFault
from repro_torch.core.faults import FaultPlan, FaultSpec, inject_faults


def _solver_tree():
    """A mixed tree shaped like SolverState.to_tree: numpy leaves (the
    host backends), a torch leaf and a bf16 torch leaf."""
    rng = np.random.default_rng(0)
    return {
        "Q": rng.standard_normal((24, 5)).astype(np.float32),
        "Qj": torch.from_numpy(rng.standard_normal((8, 3)).astype(
            np.float32)),
        "Qb": torch.from_numpy(rng.standard_normal((8, 3))).to(
            torch.bfloat16),
        "it": np.asarray(7, np.int64),
        "gap": np.asarray(3.5e-7, np.float64),
        "passes": np.asarray(19, np.int64),
        "converged": np.asarray(False),
    }


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x)


def test_solver_state_tree_roundtrip_preserves_values_and_containers(
        tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _solver_tree()
    mgr.save(3, tree)
    out = mgr.restore(3, tree)
    for key in tree:
        np.testing.assert_array_equal(_as_np(out[key]), _as_np(tree[key]),
                                      err_msg=key)
    assert isinstance(out["Q"], np.ndarray)          # container preserved
    assert isinstance(out["Qj"], torch.Tensor)
    assert out["Qb"].dtype == torch.bfloat16
    assert out["it"].dtype == np.int64               # 64-bit survives
    assert out["gap"].dtype == np.float64


def test_solver_state_extra_meta_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    extra = {"kind": "solver_state", "config_fp": "method=block;seed=0",
             "op_fp": "dense:64x16:float32:float32"}
    mgr.save(4, _solver_tree(), extra=extra)
    meta = mgr.read_meta(4)
    assert meta["step"] == 4
    assert meta["extra"] == extra
    assert mgr.read_meta(4).get("extra", {}) == extra


def test_solver_state_keep_pruning(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _solver_tree()
    for it in (1, 2, 3, 4, 5):
        mgr.save(it, tree, extra={"it": it})
    assert mgr.all_steps() == [4, 5]
    assert mgr.read_meta(5)["extra"]["it"] == 5


def test_solver_state_resume_after_partial_write(tmp_path):
    """A crash mid-save leaves step_XXXX.tmp; latest_step() skips it, the
    previous state restores bitwise, and the next save clobbers it."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _solver_tree()
    mgr.save(6, tree)
    tmp7 = tmp_path / "step_00000007.tmp"
    os.makedirs(tmp7)
    (tmp7 / "arrays.npz").write_bytes(b"PK\x03\x04 truncated")
    assert mgr.latest_step() == 6
    np.testing.assert_array_equal(mgr.restore(6, tree)["Q"], tree["Q"])
    mgr.save(7, tree)
    assert mgr.latest_step() == 7


def test_atomic_publish_leaves_no_tmp_and_resaves_a_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _solver_tree())
    mgr.save(1, {"Q": np.zeros((2, 2), np.float32)})   # replace in place
    names = os.listdir(tmp_path)
    assert names == ["step_00000001"]
    assert mgr.restore(1, {"Q": np.ones((1, 1), np.float32)})["Q"].shape \
        == (2, 2)


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"x": np.arange(3)})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        {"x": np.arange(3)}) == (None, None)


def test_torn_publish_keeps_the_previous_step(tmp_path):
    """The ``checkpoint_write`` fault fires between the fsynced tmp dir
    and its publish: the old step stays the newest intact one."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": np.arange(4)})
    with inject_faults(FaultPlan(FaultSpec("checkpoint_write", at=0))):
        with pytest.raises(KilledFault):
            mgr.save(2, {"x": np.arange(4) + 1})
    assert mgr.all_steps() == [1]
    np.testing.assert_array_equal(mgr.restore(1, {"x": np.arange(4)})["x"],
                                  np.arange(4))


def test_corrupt_files_raise_and_quarantine(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": np.arange(4)})
    mgr.save(2, {"x": np.arange(4)})
    (tmp_path / "step_00000002" / "arrays.npz").write_bytes(b"PK\x03\x04")
    with pytest.raises(CheckpointCorruptError, match="arrays.npz"):
        mgr.restore(2, {"x": np.arange(4)})
    (tmp_path / "step_00000001" / "meta.json").write_text("{torn")
    with pytest.raises(CheckpointCorruptError, match="meta.json"):
        mgr.read_meta(1)
    (tmp_path / "step_00000001" / "meta.json").write_text("[1, 2]")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        mgr.read_meta(1)
    assert mgr.quarantine(2).endswith("step_00000002.corrupt")
    mgr.save(2, {"x": np.arange(4)})
    assert mgr.quarantine(2).endswith("step_00000002.corrupt1")
    assert mgr.all_steps() == [1]


def test_restore_onto_a_mesh_is_not_ported(tmp_path):
    """``restore(shardings=)`` (once unported) places each leaf as its
    pair says: a ``(mesh, placements)`` pair gives a DTensor, ``None`` a
    plain leaf, for a leaf or a whole subtree; a pair on a subtree or a
    tree that does not match is refused."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    tree = {"Q": np.arange(12, dtype=np.float32).reshape(6, 2),
            "S": torch.arange(3, dtype=torch.float32),
            "meta": {"it": np.asarray(4, np.int64)}}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, tree)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        got = mgr.restore(1, tree, shardings={
            "Q": (mesh, [Shard(0)]), "S": (mesh, [Replicate()]),
            "meta": None})
        assert isinstance(got["Q"], DTensor) and isinstance(got["S"], DTensor)
        assert got["Q"].placements == (Shard(0),)
        np.testing.assert_array_equal(got["Q"].full_tensor().numpy(),
                                      tree["Q"])
        np.testing.assert_array_equal(got["S"].full_tensor().numpy(),
                                      tree["S"].numpy())
        assert isinstance(got["meta"]["it"], np.ndarray)
        assert int(got["meta"]["it"]) == 4
        with pytest.raises(ValueError, match="one leaf"):
            mgr.restore(1, tree, shardings={"Q": None, "S": None,
                                            "meta": (mesh, [Replicate()])})
        with pytest.raises(ValueError, match="does not match"):
            mgr.restore(1, tree, shardings={"Q": None})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the on-disk format is the JAX package's
# ---------------------------------------------------------------------------

def _nested():
    rng = np.random.default_rng(1)
    return {"b": [rng.standard_normal(3).astype(np.float32),
                  (np.asarray(2, np.int64), None)],
            "a": {"z": np.asarray(True), "y": rng.standard_normal(
                (2, 2))}, "c": None}


@pytest.mark.parametrize("tree", [_solver_tree, _nested],
                         ids=["solver-state", "nested"])
def test_both_packages_write_the_same_keys_and_meta(tree, tmp_path):
    t = tree()
    if tree is _solver_tree:
        t = {k: v for k, v in t.items() if not isinstance(v, torch.Tensor)}
    JaxManager(str(tmp_path / "j")).save(2, t, extra={"e": 1})
    CheckpointManager(str(tmp_path / "t")).save(2, t, extra={"e": 1})
    metas = [json.loads((tmp_path / d / "step_00000002" / "meta.json")
                        .read_text()) for d in ("j", "t")]
    assert metas[0] == metas[1]
    files = [np.load(tmp_path / d / "step_00000002" / "arrays.npz")
             for d in ("j", "t")]
    assert files[0].files == files[1].files
    for key in files[0].files:
        np.testing.assert_array_equal(files[0][key], files[1][key])


def test_each_package_restores_the_others_solver_state(tmp_path):
    Q = np.random.default_rng(2).standard_normal((30, 4)).astype(np.float32)
    kw = dict(k=4, it=5, prev_gap=1.5e-3, gap=2.5e-4, converged=False,
              passes=11, bytes_moved={"host": 77, "device": 99})
    JaxManager(str(tmp_path / "j")).save(5, JaxState(Q=Q, **kw).to_tree())
    CheckpointManager(str(tmp_path / "t")).save(
        5, SolverState(Q=torch.from_numpy(Q), **kw).to_tree(
            lambda X: X.numpy()))
    from_jax = SolverState.from_tree(CheckpointManager(
        str(tmp_path / "j")).restore(5, SolverState.host_template()))
    from_port = JaxState.from_tree(JaxManager(str(tmp_path / "t")).restore(
        5, JaxState.host_template()))
    for st in (from_jax, from_port):
        np.testing.assert_array_equal(np.asarray(st.Q), Q)
        assert (st.k, st.it, st.prev_gap, st.gap, st.converged, st.passes,
                st.bytes_moved) == (4, 5, 1.5e-3, 2.5e-4, False, 11,
                                    {"host": 77, "device": 99})
