"""The sharded LM (``make_train_step(cfg, tc, mesh)``) on four gloo CPU
ranks, against the JAX package's sharded step.

One ``torchrun`` of four ranks (as ``tests/test_torch_sharded.py::
run_ranks``) runs every case in turn, each on a mesh built over the same
world, while two JAX children (``--xla_force_host_platform_device_count
=4``, as ``tests/test_distributed.py::run_child``; the cases split
between them) run the JAX package's ``jit(make_train_step(cfg, tc,
mesh))`` under ``use_mesh`` on a mesh of the same shape, the state
replicated in and out so each case compiles once.  Both start from the port's one-process init (the JAX
child gets it through ``models.convert.leaf_layout``) and take the same
``(seed, step)``-pure batches.

* Configs: the dense, MoE and hybrid configs of ``tests/test_distributed.
  py:133-141``, rwkv6-1.6b's smoke config, and a dense config whose 3
  heads do not divide ``model`` (attention whole on every model rank);
  meshes ``(2, 2)`` data x model and ``(2, 1, 2)`` pod x data x model;
  the MoE also at microbatches 2; the dense config also under
  ``remat_policy="full"`` (the others run the default "minimal", whose
  recompute re-issues the same collectives).  Three steps each: every loss within
  1e-5 relative and every parameter within 1e-4 of the JAX package's
  (``tests/test_torch_training.py``'s tolerances); the MoE follows the
  JAX package's per-shard capacity.  The dense config also against the
  port's one-process step, ``grad_norm`` included.
* The sharded init is bitwise the one-process init, and so is
  ``convert.shard_params`` of the one-process model; every step's
  ``collectives.record`` equals ``training/schedule.py``'s schedule on
  every rank; ranks that hold the same shard hold the same bits.
* The ten archs' smoke configs (the VLM and audio front ends among them)
  take a step on ``(2, 2)``: the non-MoE ones within the same tolerances
  of the one-process step.
* Checkpoints (``TrainingRunner`` with a mesh): saved on ``(2, 2)``,
  restored bitwise on ``(2, 2)``, ``(1, 4)`` and ``(4, 1)``; the resumed
  step on ``(2, 2)`` is bitwise the uninterrupted run's, on the others
  within 1e-4.  ``python -m repro_torch.launch.train --mesh 2,2`` trains.
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import gather, leaf_layout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import TrainConfig, init_train_state, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400               # seconds for the ranks and for the JAX child
JAX_PARTS = 2               # JAX children, the cases split between them
TOL_LOSS = 1e-5
TOL_PARAMS = 1e-4
STEPS = 3
BATCH, SEQ = 8, 32
BASE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=64, dtype="float32")
CONFIGS = {
    "dense": dict(name="d", family="dense", **BASE),
    "dense_full": dict(name="d", family="dense", remat_policy="full",
                       **BASE),
    "moe": dict(name="m", family="moe", num_experts=4, experts_per_token=2,
                **BASE),
    "hybrid": dict(name="h", family="hybrid", block_pattern=(
        "rglru", "rglru", "local"), window=8, **{**BASE, "num_layers": 6}),
    "rwkv": "rwkv6-1.6b",
    "odd_heads": dict(name="o", family="dense", num_layers=2, d_model=48,
                      num_heads=3, num_kv_heads=1, d_ff=96, vocab_size=64,
                      dtype="float32"),
}
CASES = {f"{c}/{'x'.join(map(str, shape))}/mb{mb}": (c, shape, mb)
         for c, shape, mb in [
             ("dense", (2, 2), 1), ("dense", (2, 1, 2), 1),
             ("dense_full", (2, 2), 1),
             ("moe", (2, 2), 1), ("moe", (2, 1, 2), 1), ("moe", (2, 2), 2),
             ("hybrid", (2, 2), 1), ("hybrid", (2, 1, 2), 1),
             ("rwkv", (2, 2), 1), ("rwkv", (2, 1, 2), 1),
             ("odd_heads", (2, 2), 1)]}

COMMON = r"""
import dataclasses, json, os, sys
import numpy as np
CONFIGS = __CONFIGS__
CASES = __CASES__
STEPS, BATCH, SEQ = __STEPS__, __BATCH__, __SEQ__
OUT = sys.argv[1]

def config(pkg_configs, ModelConfig, key):
    c = CONFIGS[key]
    if isinstance(c, str):
        return pkg_configs.smoke_config(pkg_configs.get_config(c))
    return ModelConfig(**c)

def names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
"""

JAX_CHILD = COMMON + r"""
import jax, jax.numpy as jnp
from repro import configs as jcfgs
from repro.compat import make_mesh
from repro import sharding as Sh
from repro.data import DataConfig, SyntheticLMDataset
from repro.models import transformer as JT
from repro.models.config import ModelConfig
from repro.optim.adamw import AdamWConfig, init_opt_state
from repro.training import TrainConfig, TrainState, make_train_step

part, parts = int(sys.argv[2]), int(sys.argv[3])
for case, (key, shape, mb) in list(CASES.items())[part::parts]:
    cfg = config(jcfgs, ModelConfig, key)
    mesh = make_mesh(tuple(shape), names(shape))
    tag = case.replace("/", "_")
    with np.load(os.path.join(OUT, key + "_init.npz")) as z:
        leaves = [z[str(i)] for i in range(len(z.files))]
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-2), microbatches=mb)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SEQ, global_batch=BATCH))
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    assert [l.shape for l in jax.tree.leaves(shapes)] == \
        [l.shape for l in leaves], case
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(a) for a in leaves])
    # the state and the batches replicated on the mesh, in and out, so
    # the step compiles once (the layout inside is GSPMD's, as ever)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    st = jax.device_put(TrainState(
        params=params, opt=init_opt_state(params, tc.adamw), comp=None,
        step=jnp.zeros((), jnp.int32)), rep)
    with Sh.use_mesh(mesh):
        step = jax.jit(make_train_step(cfg, tc, mesh), out_shardings=rep)
        out = {"loss": [], "grad_norm": []}
        for i in range(STEPS):
            st, m = step(st, jax.device_put(ds.batch(i), rep))
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
    np.savez(os.path.join(OUT, tag + "_jax.npz"),
             **{str(i): np.asarray(a)
                for i, a in enumerate(jax.tree.leaves(st.params))})
    with open(os.path.join(OUT, tag + "_jax.json"), "w") as f:
        json.dump(out, f)
print("JAX_OK", part)
"""

RANKS = COMMON + r"""
import shutil
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs as pcfgs, sharding
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import collectives as coll
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import gather_params, shard_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.training import (TrainConfig, init_train_state,
                                  make_train_step)
from repro_torch.training.runner import RunnerConfig, TrainingRunner
from repro_torch.training.schedule import record_counter, step_collectives

dist.init_process_group("gloo")
rank = dist.get_rank()
meshes = {}

def mesh_of(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = init_device_mesh("cpu", shape,
                                         mesh_dim_names=names(shape))
    return meshes[shape]

def rows(shape, mb):
    nb = shape[0] * (shape[1] if len(shape) == 3 else 1)
    return BATCH // (nb * mb)

def sched_diff(cfg, shape, mb):
    want = step_collectives(cfg, dict(zip(names(shape), shape)),
                            rows(shape, mb), SEQ, mb)
    got = record_counter(coll.record)
    return "" if got == want else (f"extra {dict(got - want)} "
                                   f"missing {dict(want - got)}")

def save_full(path, state):
    full = gather_params(state.model, state.plan)
    if rank == 0:
        np.savez(path, **{n: t.numpy() for n, t in full.items()})

out = {"rank": rank, "cases": {}}
for case, (key, shape, mb) in CASES.items():
    cfg = config(pcfgs, ModelConfig, key)
    mesh = mesh_of(shape)
    tag = case.replace("/", "_")
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-2), microbatches=mb)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SEQ, global_batch=BATCH))
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh)
    save_full(os.path.join(OUT, tag + "_init_port.npz"), st)
    # shard_params of the one-process model: the sharded init, bitwise
    one = init_train_state(cfg, tc, device="cpu").model.state_dict()
    cut = shard_params(one, cfg, mesh)
    row_cut = all(torch.equal(cut[n], p.detach())
                  for n, p in st.model.named_parameters())
    step = make_train_step(cfg, tc, mesh)
    row = {"loss": [], "grad_norm": [], "schedule": [], "cut": row_cut,
           "coord": dict(zip(names(shape), mesh.get_coordinate()))}
    for i in range(STEPS):
        coll.reset_record()
        st, m = step(st, ds.batch(i))
        row["schedule"].append(sched_diff(cfg, shape, mb))
        row["loss"].append(float(m["loss"]))
        row["grad_norm"].append(float(m["grad_norm"]))
    save_full(os.path.join(OUT, tag + "_port.npz"), st)
    local = {n: p.detach().numpy() for n, p in st.model.named_parameters()}
    row["specs"] = {n: p.spec for n, p in st.model.named_parameters()}
    np.savez(os.path.join(OUT, f"{tag}_local{rank}.npz"), **local)
    out["cases"][case] = row

# the ten archs' smoke configs, one step on (2, 2)
out["archs"] = {}
for arch in pcfgs.list_archs():
    cfg = pcfgs.smoke_config(pcfgs.get_config(arch))
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-2))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                    global_batch=4, family=cfg.family,
                    num_codebooks=cfg.num_codebooks,
                    patch_positions=cfg.patch_positions, d_model=cfg.d_model)
    batch = SyntheticLMDataset(dc).batch(0)
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh_of((2, 2)))
    coll.reset_record()
    st, m = make_train_step(cfg, tc, mesh_of((2, 2)))(st, batch)
    want = step_collectives(cfg, {"data": 2, "model": 2}, 2, 16)
    row = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "schedule": record_counter(coll.record) == want}
    full = gather_params(st.model, st.plan)
    if rank == 0:
        one = init_train_state(cfg, tc, device="cpu")
        _, m1 = make_train_step(cfg, tc)(one, batch)
        ref = dict(one.model.named_parameters())
        row["one_loss"] = float(m1["loss"])
        row["one_grad_norm"] = float(m1["grad_norm"])
        row["param_err"] = max(float((full[n] - ref[n].detach()).abs().max())
                               for n in ref)
    out["archs"][arch] = row

# checkpoints through the runner: save on (2, 2) after 2 steps, resume
cfg = config(pcfgs, ModelConfig, "dense")
tc = TrainConfig(adamw=AdamWConfig(lr=1e-2))
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
base = os.path.join(OUT, "ck_base")
TrainingRunner(cfg, tc, RunnerConfig(total_steps=2, ckpt_every=2,
                                     ckpt_dir=base, max_restarts=0), dc,
               mesh=mesh_of((2, 2))).run()
with np.load(os.path.join(base, "step_00000002", "arrays.npz")) as z:
    saved = {k: z[k] for k in z.files}
out["ckpt"] = {}
for shape in ((2, 2), (1, 4), (4, 1)):
    tag = "x".join(map(str, shape))
    d = os.path.join(OUT, "ck_" + tag)
    if rank == 0:
        shutil.copytree(base, d)
    dist.barrier()
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh_of(shape))
    st.load_tree(CheckpointManager(d).restore(2, st.like()))
    tree = st.tree()
    keys, leaves = __import__("repro_torch.checkpoint.manager",
                              fromlist=["_flatten"])._flatten(tree)
    same = all(np.array_equal(saved[k], np.asarray(
        v.to(torch.float32) if v.dtype == torch.bfloat16 else v))
        for k, v in zip(keys, leaves))
    runner = TrainingRunner(cfg, tc, RunnerConfig(
        total_steps=3, ckpt_every=10, ckpt_dir=d, max_restarts=0), dc,
        mesh=mesh_of(shape))
    st = runner.run()
    save_full(os.path.join(OUT, f"resumed_{tag}.npz"), st)
    out["ckpt"][tag] = {"restored_bitwise": bool(same),
                        "steps_run": [h["step"] for h in runner.history]}

# the launcher, on the world torchrun made
res = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                         "--mesh", "2,2", "--steps", "2", "--batch", "4",
                         "--seq", "16", "--ckpt-dir",
                         os.path.join(OUT, "ck_launch")])
out["launch_losses"] = res["losses"]

with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK")
"""


def _script(body: str) -> str:
    return (body.replace("__CONFIGS__", repr(CONFIGS))
            .replace("__CASES__", repr(CASES))
            .replace("__STEPS__", str(STEPS))
            .replace("__BATCH__", str(BATCH))
            .replace("__SEQ__", str(SEQ)))


def _config(key: str) -> ModelConfig:
    c = CONFIGS[key]
    if isinstance(c, str):
        return configs.smoke_config(configs.get_config(c))
    return ModelConfig(**c)


def _start(cmd, env, log):
    return subprocess.Popen(cmd, env=env, stdout=log,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)


def _wait(proc, log_path, what):
    try:
        proc.wait(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        pytest.fail(f"{what} timed out after {TIMEOUT} s:\n"
                    f"{open(log_path).read()[-4000:]}")
    out = open(log_path).read()
    assert proc.returncode == 0, f"{what} failed:\n{out[-6000:]}"
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' results: ``(ranks, d)``, one json dict a rank and the
    directory of the saved arrays."""
    d = tmp_path_factory.mktemp("sharded_lm")
    for key in CONFIGS:                  # the one-process init, JAX order
        cfg = _config(key)
        model = T.init_model(cfg, seed=0, device="cpu")
        named = {n: p.detach() for n, p in model.named_parameters()}
        np.savez(d / f"{key}_init.npz", **{
            str(i): gather(leaf, named).numpy()
            for i, leaf in enumerate(leaf_layout(model))})
    src = os.path.join(REPO, "src")
    (d / "jax_child.py").write_text(_script(JAX_CHILD))
    (d / "ranks.py").write_text(_script(RANKS))
    jax_procs = [_start(
        [sys.executable, str(d / "jax_child.py"), str(d), str(part),
         str(JAX_PARTS)],
        dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
             XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        open(d / f"jax{part}.log", "w")) for part in range(JAX_PARTS)]
    rank_proc = _start(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=4", str(d / "ranks.py"), str(d)],
        dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
        open(d / "ranks.log", "w"))
    out = _wait(rank_proc, d / "ranks.log", "the four ranks")
    assert out.count("RANK_OK") == 4, out[-3000:]
    for part, proc in enumerate(jax_procs):
        assert "JAX_OK" in _wait(proc, d / f"jax{part}.log",
                                 f"JAX child {part}")
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    return ranks, d


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _leaves(path):
    with np.load(path) as z:
        return [z[str(i)] for i in range(len(z.files))]


def _port_leaves(path, cfg):
    """A saved port state dict as the JAX package's leaves."""
    with np.load(path) as z:
        named = {k: torch.from_numpy(z[k]) for k in z.files}
    layout = leaf_layout(T.Transformer(cfg, torch.device("meta")))
    return [gather(leaf, named).numpy() for leaf in layout]


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_equal_the_jax_sharded_step(runs, case):
    ranks, d = runs
    want = json.loads((d / (case.replace("/", "_") + "_jax.json"))
                      .read_text())
    for r in ranks:
        got = r["cases"][case]
        for i in range(STEPS):
            assert _rel(got["loss"][i], want["loss"][i]) <= TOL_LOSS, (
                case, i, got["loss"], want["loss"])
            assert _rel(got["grad_norm"][i], want["grad_norm"][i]) <= \
                TOL_LOSS, (case, i, got["grad_norm"], want["grad_norm"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_parameters_equal_the_jax_sharded_step(runs, case):
    _, d = runs
    tag = case.replace("/", "_")
    cfg = _config(CASES[case][0])
    got = _port_leaves(d / f"{tag}_port.npz", cfg)
    want = _leaves(d / f"{tag}_jax.npz")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL_PARAMS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_init_is_bitwise_the_one_process_init(runs, case):
    _, d = runs
    key = CASES[case][0]
    got = _port_leaves(d / (case.replace("/", "_") + "_init_port.npz"),
                       _config(key))
    for g, w in zip(got, _leaves(d / f"{key}_init.npz")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_shard_params_cuts_the_one_process_model(runs, case):
    """``convert.shard_params`` of the one-process state dict is each
    rank's shards of the sharded init, bitwise (``gather_params``, its
    inverse, gave ``*_init_port.npz``)."""
    ranks, _ = runs
    assert all(r["cases"][case]["cut"] for r in ranks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_equal_the_schedule(runs, case):
    ranks, _ = runs
    for r in ranks:
        assert r["cases"][case]["schedule"] == [""] * STEPS, (
            r["rank"], r["cases"][case]["schedule"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicas_are_bitwise(runs, case):
    """Ranks at the same coordinates on every axis a parameter's spec
    shards hold the same bits of it."""
    ranks, d = runs
    tag = case.replace("/", "_")
    local = []
    for r in range(4):
        with np.load(d / f"{tag}_local{r}.npz") as z:
            local.append({k: z[k] for k in z.files})
    specs = ranks[0]["cases"][case]["specs"]
    pairs = 0
    for name, spec in specs.items():
        axes = {a for e in spec if e for a in ([e] if isinstance(e, str)
                                                else e)}
        key = lambda r: tuple(ranks[r]["cases"][case]["coord"][a]
                              for a in sorted(axes))
        for a in range(4):
            for b in range(a + 1, 4):
                if key(a) == key(b):
                    np.testing.assert_array_equal(local[a][name],
                                                  local[b][name], name)
                    pairs += 1
    assert pairs > 0


def test_dense_equals_the_one_process_step(runs):
    """The dense config on (2, 2) against the port's one-process step on
    the same weights and batches: losses, grad norms and parameters."""
    ranks, d = runs
    cfg = _config("dense")
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-2))
    state = init_train_state(cfg, tc, device="cpu")
    step = make_train_step(cfg, tc)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SEQ, global_batch=BATCH))
    got = ranks[0]["cases"]["dense/2x2/mb1"]
    for i in range(STEPS):
        state, m = step(state, ds.batch(i))
        assert _rel(got["loss"][i], float(m["loss"])) <= TOL_LOSS
        assert _rel(got["grad_norm"][i], float(m["grad_norm"])) <= TOL_LOSS
    with np.load(d / "dense_2x2_mb1_port.npz") as z:
        for n, p in state.model.named_parameters():
            np.testing.assert_allclose(z[n], p.detach().numpy(), rtol=0,
                                       atol=TOL_PARAMS, err_msg=n)


@pytest.mark.parametrize("arch", configs.list_archs())
def test_smoke_configs_train_on_a_mesh(runs, arch):
    ranks, _ = runs
    row = ranks[0]["archs"][arch]
    assert all(r["archs"][arch]["schedule"] for r in ranks), arch
    assert np.isfinite(row["loss"])
    assert all(r["archs"][arch]["loss"] == row["loss"] for r in ranks)
    if configs.get_config(arch).is_moe:
        return                  # per-shard capacity: not the one-process MoE
    assert _rel(row["loss"], row["one_loss"]) <= TOL_LOSS
    assert _rel(row["grad_norm"], row["one_grad_norm"]) <= TOL_LOSS
    assert row["param_err"] <= TOL_PARAMS


@pytest.mark.parametrize("mesh", ["2x2", "1x4", "4x1"])
def test_checkpoint_restores_bitwise_on_another_mesh(runs, mesh):
    ranks, d = runs
    for r in ranks:
        assert r["ckpt"][mesh] == {"restored_bitwise": True,
                                   "steps_run": [2]}
    with np.load(d / f"resumed_{mesh}.npz") as got, \
            np.load(d / "dense_2x2_mb1_port.npz") as want:
        for n in want.files:
            if mesh == "2x2":
                np.testing.assert_array_equal(got[n], want[n], n)
            else:
                np.testing.assert_allclose(got[n], want[n], rtol=0,
                                           atol=TOL_PARAMS, err_msg=n)


def test_launcher_trains_on_a_mesh(runs):
    ranks, _ = runs
    losses = ranks[0]["launch_losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(r["launch_losses"] == losses for r in ranks)
