"""Compressed training over a mesh (``make_train_step(cfg, tc, mesh)``
with ``tc.compression``) on four gloo CPU ranks, against the JAX
package's compressed step.

One ``torchrun`` of four ranks runs every case in turn (as
``tests/test_torch_sharded_lm.py``), while two JAX children
(``--xla_force_host_platform_device_count=4``) run the JAX package's
``jit(make_train_step(cfg, tc, mesh))`` on a mesh of the same shape: on
``(2, 2)`` data x model its single-program compression of the synced
gradients, on ``(2, 1, 2)`` and ``(2, 2, 1)`` pod x data x model its
cross-pod mode: per-pod gradients and error buffers, ``pmean`` of the
factors over ``pod`` (how the children run it, and the MoE there, is
told above ``POD_BY_VMAP``).  Both start from the port's
one-process init and its ``Q0``, the error buffers at zero, and take
the same ``(seed, step)``-pure batches; rank 8, ``min_size`` 512, so
every smoke leaf of 512 elements or more compresses (the MoE's router,
4 wide, at rank 4).

A compressed trajectory amplifies rounding (a 1e-7 relative gradient
perturbation moves one by ~1e-2 of a norm, ``tests/
test_torch_recurrent_bwd.py``), so each step is held one at a time: the
ranks save their whole state before every step (``TrainState.tree``),
and the JAX children take one step from each of those states as they
appear.  Held: the loss within 1e-5 relative and ``compress_ratio``
equal; each compressed leaf's decompressed gradient ``M_hat = P Qn^T``
(read off the first moment, ``m' - b1 m = (1 - b1) clip M_hat``) and
each pod's new error buffer against the JAX package's ``err[p]``, within
``TOL_FACTOR`` of ``||M||``; the new ``Q`` within ``TOL_Q``; every
parameter within 1e-4.  The dense config also as a whole trajectory: three steps
from the init, every parameter within 1e-4 of the JAX package's.

On the ranks: ``Q`` bitwise on every rank after every step; every
step's ``collectives.record`` equal to ``training/schedule.py``'s, and
nothing larger than a rank-r factor or an uncompressed leaf on a group
spanning ``pod``; the two pods' error buffers differ.  Checkpoints: a
compressed run saved on ``(2, 1, 2)`` restores bitwise on ``(2, 1, 2)``
and ``(2, 2, 1)`` (its ``comp`` shapes those of the JAX package's
``init_train_state(..., mesh)``), resumes there, and raises on another
pod count; ``python -m repro_torch.launch.train --mesh 2,1,2 --compress``
trains and resumes after a relaunch.
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
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import leaf_layout
from repro_torch.optim import compression as comp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400               # seconds for the ranks and for the JAX children
JAX_PARTS = 2
TOL_LOSS = 1e-5
TOL_PARAMS = 1e-4
# one step from one state, against the JAX package's: M_hat and the new
# error buffers of ||M|| (readings <= 1.44e-6), Q's entries (<= 6.55e-6;
# the hybrid's RG-LRU leaves); a sign flip or a wrong sum moves them O(1)
TOL_FACTOR = 1e-5
TOL_Q = 3e-5
STEPS = 3
BATCH, SEQ = 8, 32
LR, B1 = 1e-2, 0.9
RANK, MIN_SIZE = 8, 512
BASE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=64, dtype="float32")
CONFIGS = {
    "dense": dict(name="d", family="dense", **BASE),
    "moe": dict(name="m", family="moe", num_experts=4, experts_per_token=2,
                **BASE),
    "hybrid": dict(name="h", family="hybrid", block_pattern=(
        "rglru", "rglru", "local"), window=8, **{**BASE, "num_layers": 6}),
    "rwkv": "rwkv6-1.6b",
}
CASES = {f"{c}/{'x'.join(map(str, shape))}/mb{mb}": (c, shape, mb)
         for c, shape, mb in [
             (c, s, 1) for c in CONFIGS
             for s in ((2, 2), (2, 1, 2), (2, 2, 1))]
         + [("dense", (2, 1, 2), 2)]}
TRAJECTORY = [c for c in CASES if CASES[c][0] == "dense"]
# No installed jax runs the JAX package's cross-pod mode as its docstring
# describes it (each pod its own gradient and error buffers).  On jax
# 0.4.x (no partial-manual shard_map) ``train.py:142-148`` degrades it to
# single-program compression, one error buffer for every pod; on jax 0.9
# its shard_map's vma-typed autodiff sums each pod's gradient of a
# pod-replicated parameter over ``pod`` (the transpose of the implicit
# ``pvary``), so the pods' buffers come out the same.  The children reach
# the described semantics by running that one shard_map, the cross-pod
# step's own in ``repro/training/train.py``, with ``check_vma=False``;
# every other shard_map (the MoE's ``_moe_local`` in the ``(2, 2)``
# cases) runs as the JAX package has it.
# The MoE's ``_moe_local`` (a shard_map manual over ``data``) inside the
# pod shard_map fails this jax's shardy verifier ("manual axis 'data'
# after free axis 'pod'").  So for the cross-pod MoE the children take
# each pod's gradient from the JAX package's ``_grads_and_metrics`` on
# the pod's rows over a ``(data, model)`` mesh of the pod's shape (no pod
# shard_map), then run its ``compress_grads(..., axis_name="pod")`` under
# ``jax.vmap(axis_name="pod")`` and its ``apply_updates``
POD_BY_VMAP = [c for c in CASES if CASES[c][0] == "moe" and
               len(CASES[c][1]) == 3]

COMMON = r"""
import json, os, sys, time
import numpy as np
CONFIGS = __CONFIGS__
CASES = __CASES__
TRAJECTORY = __TRAJECTORY__
POD_BY_VMAP = __POD_BY_VMAP__
STEPS, BATCH, SEQ, LR = __STEPS__, __BATCH__, __SEQ__, __LR__
RANK, MIN_SIZE = __RANK__, __MIN_SIZE__
OUT = sys.argv[1]

def config(pkg_configs, ModelConfig, key):
    c = CONFIGS[key]
    if isinstance(c, str):
        return pkg_configs.smoke_config(pkg_configs.get_config(c))
    return ModelConfig(**c)

def names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")

def tag(case):
    return case.replace("/", "_")
"""

JAX_CHILD = COMMON + r"""
import types
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro import compat
from repro import configs as jcfgs
from repro.compat import make_mesh
from repro import sharding as Sh
from repro.data import DataConfig, SyntheticLMDataset
from repro.models.config import ModelConfig
from repro.optim import adamw as jopt
from repro.optim import compression as jcomp
from repro.optim.adamw import AdamWConfig
from repro.optim.compression import CompressionConfig
from repro.training import train as jtrain
from repro.training import (TrainConfig, TrainState, init_train_state,
                            make_train_step)

# the cross-pod step's own shard_map, and no other, unchecked
jtrain.compat = types.SimpleNamespace(**{
    **vars(compat),
    "shard_map": lambda f, **kw: compat.shard_map(
        f, **{"check_vma": False, **kw})})

part, parts = int(sys.argv[2]), int(sys.argv[3])
leaves = lambda t: jax.tree.leaves(t)

def wait(path, seconds=360):
    t = time.time()
    while not os.path.exists(path):
        if time.time() - t > seconds:
            raise TimeoutError(path)
        time.sleep(0.1)

def load(path, like):
    '''The state a rank saved (``tree()`` as the JAX package's leaves)
    in ``like``'s structure.'''
    with np.load(path) as z:
        get = lambda key, n: [jnp.asarray(z[f"{key}{i}"]) for i in range(n)]
        un = lambda t, key: jax.tree.unflatten(jax.tree.structure(t),
                                               get(key, len(leaves(t))))
        return TrainState(
            params=un(like.params, "p"),
            opt={"m": un(like.opt["m"], "m"), "v": un(like.opt["v"], "v"),
                 "count": jnp.asarray(z["count"], jnp.int32)},
            comp={"Q": un(like.comp["Q"], "q"),
                  "err": un(like.comp["err"], "e")},
            step=jnp.asarray(z["step"], jnp.int32))

def save(path, st, metrics=None):
    arrays = {}
    for key, tree in (("p", st.params), ("m", st.opt["m"]),
                      ("q", st.comp["Q"]), ("e", st.comp["err"])):
        arrays.update({f"{key}{i}": np.asarray(a)
                       for i, a in enumerate(leaves(tree))})
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)
    if metrics is not None:
        with open(path + ".json", "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)

def pod_by_vmap(cfg, tc, shape):
    '''The cross-pod step with each pod's gradient taken on its own
    (data, model) mesh and the compression vmapped over ``pod``.'''
    npods, rows = shape[0], BATCH // shape[0]
    sub = jax.make_mesh(tuple(shape[1:]), ("data", "model"),
                        axis_types=(AxisType.Auto,) * 2,
                        devices=jax.devices()[:shape[1] * shape[2]])
    rep = NamedSharding(sub, PartitionSpec())
    grads_of = jax.jit(lambda p, b: jtrain._grads_and_metrics(
        p, cfg, b, tc.microbatches), out_shardings=rep)
    compress = jax.vmap(
        lambda g, e, q: jcomp.compress_grads(
            g, {"Q": q, "err": e}, tc.compression, axis_name="pod"),
        in_axes=(0, 0, None), axis_name="pod")
    first = lambda t: jax.tree.map(lambda x: x[0], t)

    @jax.jit
    def finish(st, grads, loss):
        g, c, cs = compress(grads, st.comp["err"], st.comp["Q"])
        params, ostate, om = jopt.apply_updates(st.params, first(g),
                                                st.opt, tc.adamw)
        return TrainState(params=params, opt=ostate,
                          comp={"Q": first(c["Q"]), "err": c["err"]},
                          step=st.step + 1), {"loss": loss, **first(cs), **om}

    def step(st, batch):
        pods = []
        with Sh.use_mesh(sub):
            for p in range(npods):
                b = {k: v[p * rows:(p + 1) * rows] for k, v in batch.items()}
                g, m = grads_of(jax.device_put(st.params, rep),
                                jax.device_put(b, rep))
                pods.append((jax.tree.map(np.asarray, g), float(m["loss"])))
        grads = jax.tree.map(lambda *g: jnp.asarray(np.stack(g)),
                             *[g for g, _ in pods])
        return finish(st, grads,
                      jnp.float32(np.mean([l for _, l in pods])))
    return step

mine = list(CASES.items())[part::parts]
steps, likes = {}, {}
for case, (key, shape, mb) in mine:
    cfg = config(jcfgs, ModelConfig, key)
    mesh = make_mesh(tuple(shape), names(shape))
    tc = TrainConfig(adamw=AdamWConfig(lr=LR),
                     compression=CompressionConfig(rank=RANK,
                                                   min_size=MIN_SIZE),
                     microbatches=mb)
    like = init_train_state(jax.random.PRNGKey(0), cfg, tc, mesh=mesh)
    with open(os.path.join(OUT, tag(case) + "_jax_shapes.json"), "w") as f:
        json.dump({k: [list(a.shape) for a in leaves(like.comp[k])]
                   for k in ("Q", "err")}, f)
    rep = NamedSharding(mesh, PartitionSpec())
    if case in POD_BY_VMAP:
        steps[case] = (None, None, pod_by_vmap(cfg, tc, shape))
    else:
        with Sh.use_mesh(mesh):
            steps[case] = (mesh, rep, jax.jit(make_train_step(cfg, tc, mesh),
                                              out_shardings=rep))
    likes[case] = (like, SyntheticLMDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)))

def run(case, st, i):
    mesh, rep, step = steps[case]
    if mesh is None:
        return step(st, likes[case][1].batch(i))
    with Sh.use_mesh(mesh):
        return step(jax.device_put(st, rep),
                    jax.device_put(likes[case][1].batch(i), rep))

# the dense trajectories first: three steps from the init, no waiting
for case, _ in mine:
    if case not in TRAJECTORY:
        continue
    path = os.path.join(OUT, tag(case) + "_s0.npz")
    wait(path)
    st = load(path, likes[case][0])
    losses = []
    for i in range(STEPS):
        st, m = run(case, st, i)
        losses.append(float(m["loss"]))
    save(os.path.join(OUT, tag(case) + "_jax_traj.npz"), st,
         {f"loss{i}": x for i, x in enumerate(losses)})

# one step from each state the ranks saved, as they appear
for i in range(STEPS):
    for case, _ in mine:
        path = os.path.join(OUT, f"{tag(case)}_s{i}.npz")
        wait(path)
        st, m = run(case, load(path, likes[case][0]), i)
        save(os.path.join(OUT, f"{tag(case)}_ref{i + 1}.npz"), st, m)
print("JAX_OK", part)
"""

RANKS = COMMON + r"""
import hashlib, shutil
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs as pcfgs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.core import collectives as coll
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import gather, leaf_layout
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.training import (TrainConfig, init_train_state,
                                  make_train_step)
from repro_torch.training.runner import RunnerConfig, TrainingRunner
from repro_torch.training.schedule import (pod_bytes, record_counter,
                                           step_collectives)

dist.init_process_group("gloo")
rank = dist.get_rank()
meshes = {}

def mesh_of(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = init_device_mesh("cpu", shape,
                                         mesh_dim_names=names(shape))
    return meshes[shape]

def train_config(mb=1):
    return TrainConfig(adamw=AdamWConfig(lr=LR),
                       compression=CompressionConfig(rank=RANK,
                                                     min_size=MIN_SIZE),
                       microbatches=mb)

def save_state(path, st):
    '''``tree()`` (a collective) as the JAX package's leaves, rank 0
    writing.'''
    tree = st.tree()
    if rank != 0:
        return
    layout = leaf_layout(st.model)
    arrays = {"count": tree["opt"]["count"].numpy(),
              "step": tree["step"].numpy()}
    for key, named in (("p", tree["params"]), ("m", tree["opt"]["m"]),
                       ("v", tree["opt"]["v"])):
        named = {n: t.detach() for n, t in named.items()}
        arrays.update({f"{key}{i}": gather(leaf, named).numpy()
                       for i, leaf in enumerate(layout)})
    for key, d in (("q", tree["comp"]["Q"]), ("e", tree["comp"]["err"])):
        arrays.update({f"{key}{i}": t.numpy()
                       for i, t in enumerate(d.values())})
    np.savez(path + ".tmp.npz", **arrays)
    os.replace(path + ".tmp.npz", path)

def pod_limit(layout, st):
    '''The largest payload allowed across pods: a whole rank-r factor
    or a whole uncompressed leaf.'''
    big = 0
    for leaf in layout:
        if leaf.path in st.comp["Q"]:
            r = st.comp["Q"][leaf.path].shape[1]
            big = max(big, r * max(leaf.size // leaf.shape[-1],
                                   leaf.shape[-1]) * 4)
        else:
            big = max(big, leaf.size * 4)
    return big

out = {"rank": rank, "cases": {}}
for case, (key, shape, mb) in CASES.items():
    cfg = config(pcfgs, ModelConfig, key)
    mesh = mesh_of(shape)
    sizes = dict(zip(names(shape), shape))
    tc = train_config(mb)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=SEQ, global_batch=BATCH))
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh)
    one = init_train_state(cfg, tc, device="cpu")
    q0 = all(torch.equal(st.comp["Q"][p], q)
             for p, q in one.comp["Q"].items())
    nb = shape[0] * (shape[1] if len(shape) == 3 else 1)
    want = step_collectives(cfg, sizes, BATCH // (nb * mb), SEQ, mb,
                            tc.compression)
    plain = step_collectives(cfg, sizes, BATCH // (nb * mb), SEQ, mb)
    layout = leaf_layout(st.model)
    limit = pod_limit(layout, st)
    step = make_train_step(cfg, tc, mesh)
    row = {"q0_is_one_process": q0, "loss": [], "ratio": [], "grad_norm": [],
           "schedule": [], "q_sha": [], "pod_payload": [],
           "pod_limit": limit, "pod_bytes": pod_bytes(want),
           "plain_pod_bytes": pod_bytes(plain), "err_pods_differ": None}
    for i in range(STEPS):
        save_state(os.path.join(OUT, f"{tag(case)}_s{i}.npz"), st)
        coll.reset_record()
        st, m = step(st, ds.batch(i))
        got = record_counter(coll.record)
        row["schedule"].append("" if got == want else
                               f"extra {dict(got - want)} "
                               f"missing {dict(want - got)}")
        row["pod_payload"].append(max(
            [c["bytes"] for c in coll.record
             if "pod" in c.get("axes", "").split("+")] + [0]))
        row["loss"].append(float(m["loss"]))
        row["ratio"].append(float(m["compress_ratio"]))
        row["grad_norm"].append(float(m["grad_norm"]))
        row["q_sha"].append({p: hashlib.sha1(q.numpy().tobytes()).hexdigest()
                             for p, q in st.comp["Q"].items()})
    save_state(os.path.join(OUT, f"{tag(case)}_s{STEPS}.npz"), st)
    if "pod" in sizes:
        # this rank's buffers against the other pod's rank at its place
        mine = torch.cat([e.flatten() for e in st.comp["err"].values()])
        got = coll.all_gather(mine[None], st.plan.group(("pod",)),
                              axes="pod")
        row["err_pods_differ"] = not torch.equal(got[0], got[1])
    out["cases"][case] = row

# checkpoints: a compressed run on (2, 1, 2), saved after 2 steps
cfg = config(pcfgs, ModelConfig, "dense")
tc = train_config()
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH)
base = os.path.join(OUT, "ck_base")
TrainingRunner(cfg, tc, RunnerConfig(total_steps=2, ckpt_every=2,
                                     ckpt_dir=base, max_restarts=0), dc,
               mesh=mesh_of((2, 1, 2))).run()
with np.load(os.path.join(base, "step_00000002", "arrays.npz")) as z:
    saved = {k: z[k] for k in z.files}
out["ckpt"] = {"comp_shapes": {
    k.split("/", 1)[1]: list(v.shape) for k, v in saved.items()
    if k.startswith("['comp']")}}
for shape in ((2, 1, 2), (2, 2, 1)):
    name = "x".join(map(str, shape))
    d = os.path.join(OUT, "ck_" + name)
    if rank == 0:
        shutil.copytree(base, d)
    dist.barrier()
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh_of(shape))
    st.load_tree(CheckpointManager(d).restore(2, st.like()))
    keys, vals = _flatten(st.tree())
    same = sorted(keys) == sorted(saved) and all(
        np.array_equal(saved[k], np.asarray(v)) for k, v in zip(keys, vals))
    runner = TrainingRunner(cfg, tc, RunnerConfig(
        total_steps=3, ckpt_every=10, ckpt_dir=d, max_restarts=0), dc,
        mesh=mesh_of(shape))
    st = runner.run()
    save_state(os.path.join(OUT, f"resumed_{name}.npz"), st)
    out["ckpt"][name] = {"restored_bitwise": bool(same),
                         "steps_run": [h["step"] for h in runner.history]}
for shape in ((1, 2, 2), (2, 2)):
    st = init_train_state(cfg, tc, device="cpu", mesh=mesh_of(shape))
    try:
        st.load_tree(CheckpointManager(base).restore(2, st.like()))
        msg = None
    except ValueError as e:
        msg = str(e)
    out["ckpt"]["refused_" + "x".join(map(str, shape))] = msg

# the launcher, on the world torchrun made: 3 steps, then a relaunch to 5
ck = os.path.join(OUT, "ck_launch")
args = ["--smoke", "--device", "cpu", "--mesh", "2,1,2", "--compress",
        "--batch", "4", "--seq", "16",
        "--ckpt-dir", ck, "--ckpt-every", "3"]
first = launch_train.main(args + ["--steps", "3"])
again = launch_train.main(args + ["--steps", "5"])
out["launch"] = {"losses": first["losses"], "resumed": again["losses"],
                 "latest": CheckpointManager(ck).latest_step()}

with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK")
"""


def _script(body: str) -> str:
    for key, value in (("CONFIGS", CONFIGS), ("CASES", CASES),
                       ("TRAJECTORY", TRAJECTORY),
                       ("POD_BY_VMAP", POD_BY_VMAP), ("STEPS", STEPS),
                       ("BATCH", BATCH), ("SEQ", SEQ), ("LR", LR),
                       ("RANK", RANK), ("MIN_SIZE", MIN_SIZE)):
        body = body.replace(f"__{key}__", repr(value))
    return body


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
    directory of the saved states."""
    d = tmp_path_factory.mktemp("sharded_compression")
    src = os.path.join(REPO, "src")
    (d / "jax_child.py").write_text(_script(JAX_CHILD))
    (d / "ranks.py").write_text(_script(RANKS))
    rank_proc = _start(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=4", str(d / "ranks.py"), str(d)],
        dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1"),
        open(d / "ranks.log", "w"))
    jax_procs = [_start(
        [sys.executable, str(d / "jax_child.py"), str(d), str(part),
         str(JAX_PARTS)],
        dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu",
             XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        open(d / f"jax{part}.log", "w")) for part in range(JAX_PARTS)]
    try:
        out = _wait(rank_proc, d / "ranks.log", "the four ranks")
        assert out.count("RANK_OK") == 4, out[-3000:]
        for part, proc in enumerate(jax_procs):
            assert "JAX_OK" in _wait(proc, d / f"jax{part}.log",
                                     f"JAX child {part}")
    finally:
        for proc in [rank_proc] + jax_procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    return ranks, d


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _compressed(case):
    """(layout index, leaf) of each compressed leaf, in ``Q`` order."""
    cfg = _config(CASES[case][0])
    layout = leaf_layout(T.Transformer(cfg, torch.device("meta")))
    cc = comp.CompressionConfig(rank=RANK, min_size=MIN_SIZE)
    return [(i, leaf) for i, leaf in enumerate(layout)
            if comp.compressed(leaf, cc)]


def _tag(case):
    return case.replace("/", "_")


@pytest.mark.parametrize("case", sorted(CASES))
def test_losses_and_ratio_equal_the_jax_step(runs, case):
    ranks, d = runs
    for i in range(STEPS):
        want = json.loads((d / f"{_tag(case)}_ref{i + 1}.npz.json")
                          .read_text())
        for r in ranks:
            got = r["cases"][case]
            assert _rel(got["loss"][i], want["loss"]) <= TOL_LOSS, (
                case, i, got["loss"][i], want["loss"])
            assert got["ratio"][i] == want["compress_ratio"], (
                case, got["ratio"][i], want["compress_ratio"])
            assert _rel(got["grad_norm"][i], want["grad_norm"]) <= \
                TOL_LOSS, (case, i, got["grad_norm"][i], want["grad_norm"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_factors_and_error_buffers_equal_the_jax_step(runs, case):
    """One step from each saved state: each compressed leaf's ``M_hat``
    (off the first moment), each pod's new error buffer and the new
    ``Q``, against the JAX package's, relative to ``||M||``."""
    ranks, d = runs
    worst = 0.0
    for i in range(STEPS):
        old = _load(d / f"{_tag(case)}_s{i}.npz")
        got = _load(d / f"{_tag(case)}_s{i + 1}.npz")
        want = _load(d / f"{_tag(case)}_ref{i + 1}.npz")
        gn = json.loads((d / f"{_tag(case)}_ref{i + 1}.npz.json")
                        .read_text())["grad_norm"]
        clip = min(1.0, 1.0 / (gn + 1e-9))
        for j, (k, leaf) in enumerate(_compressed(case)):
            m_hat = lambda z: (z[f"m{k}"] - B1 * old[f"m{k}"]) / (
                (1 - B1) * clip)
            hat = m_hat(want)
            err_j, err_p = want[f"e{j}"], got[f"e{j}"]
            pods = err_j.reshape(-1, *leaf.shape) if err_j.ndim > \
                leaf.ndim else err_j[None]
            norm = max(float(np.linalg.norm(e + hat)) for e in pods)
            rels = [np.linalg.norm(m_hat(got) - hat) / norm,
                    np.linalg.norm(err_p - err_j) / norm,
                    np.abs(got[f"q{j}"] - want[f"q{j}"]).max()]
            worst = max(worst, *rels)
            assert max(rels[:2]) <= TOL_FACTOR and rels[2] <= TOL_Q, (
                case, i, leaf.path, rels)
        for k in range(sum(key.startswith("p") for key in got)):
            np.testing.assert_allclose(got[f"p{k}"], want[f"p{k}"], rtol=0,
                                       atol=TOL_PARAMS, err_msg=f"{case} {i}")
    assert worst > 0


@pytest.mark.parametrize("case", TRAJECTORY)
def test_dense_trajectory_equals_the_jax_package(runs, case):
    """The dense config, three steps from the init on each side: every
    loss, every parameter and each pod's error buffer."""
    ranks, d = runs
    got = _load(d / f"{_tag(case)}_s{STEPS}.npz")
    want = _load(d / f"{_tag(case)}_jax_traj.npz")
    losses = json.loads((d / f"{_tag(case)}_jax_traj.npz.json").read_text())
    for i in range(STEPS):
        assert _rel(ranks[0]["cases"][case]["loss"][i],
                    losses[f"loss{i}"]) <= TOL_LOSS
    for k in range(sum(key.startswith("p") for key in got)):
        np.testing.assert_allclose(got[f"p{k}"], want[f"p{k}"], rtol=0,
                                   atol=TOL_PARAMS)
    for j in range(len(_compressed(case))):
        scale = float(np.abs(want[f"e{j}"]).max())
        np.testing.assert_allclose(got[f"e{j}"], want[f"e{j}"], rtol=0,
                                   atol=TOL_PARAMS * max(scale, 1.0))


@pytest.mark.parametrize("case", sorted(CASES))
def test_q_is_bitwise_on_every_rank(runs, case):
    ranks, _ = runs
    assert all(r["cases"][case]["q0_is_one_process"] for r in ranks)
    for i in range(STEPS):
        shas = [r["cases"][case]["q_sha"][i] for r in ranks]
        assert all(s == shas[0] for s in shas), (case, i)
        assert shas[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_equal_the_schedule(runs, case):
    """Every step's record is the schedule on every rank, and nothing
    larger than a rank-r factor or an uncompressed leaf spans ``pod``;
    with pods, fewer bytes cross them than the plain step's."""
    ranks, _ = runs
    for r in ranks:
        row = r["cases"][case]
        assert row["schedule"] == [""] * STEPS, (r["rank"], row["schedule"])
        assert max(row["pod_payload"]) <= row["pod_limit"]
        if len(CASES[case][1]) == 3:
            assert 0 < row["pod_bytes"] < row["plain_pod_bytes"]
            assert max(row["pod_payload"]) > 0
        else:
            assert row["pod_bytes"] == row["plain_pod_bytes"] == 0


@pytest.mark.parametrize("case", [c for c in sorted(CASES)
                                  if len(CASES[c][1]) == 3])
def test_each_pod_keeps_its_own_error_buffers(runs, case):
    """The saved buffers are stacked over the two pods, which differ
    after step 1 (and on every rank's shards after the last step)."""
    ranks, d = runs
    assert all(r["cases"][case]["err_pods_differ"] for r in ranks)
    z = _load(d / f"{_tag(case)}_s1.npz")
    for j, (_, leaf) in enumerate(_compressed(case)):
        assert z[f"e{j}"].shape == (2, *leaf.shape)
        assert not np.array_equal(z[f"e{j}"][0], z[f"e{j}"][1]), leaf.path


def test_checkpoint_restores_bitwise_on_the_same_pod_count(runs):
    ranks, d = runs
    for r in ranks:
        for mesh in ("2x1x2", "2x2x1"):
            assert r["ckpt"][mesh] == {"restored_bitwise": True,
                                       "steps_run": [2]}, (r["rank"], mesh)
    with np.load(d / "resumed_2x1x2.npz") as got, \
            np.load(d / "dense_2x1x2_mb1_s3.npz") as want:
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], k)
    with np.load(d / "resumed_2x2x1.npz") as got, \
            np.load(d / "dense_2x1x2_mb1_s3.npz") as want:
        for k in want.files:
            if k.startswith("p"):
                np.testing.assert_allclose(got[k], want[k], rtol=0,
                                           atol=TOL_PARAMS, err_msg=k)


def test_checkpoint_comp_shapes_are_the_jax_packages(runs):
    ranks, d = runs
    want = json.loads((d / f"{_tag('dense/2x1x2/mb1')}_jax_shapes.json")
                      .read_text())
    saved = ranks[0]["ckpt"]["comp_shapes"]
    for key in ("Q", "err"):
        got = [saved[k] for k in sorted(saved)
               if k.startswith(f"['{key}']")]
        assert sorted(map(tuple, got)) == sorted(map(tuple, want[key]))
    leaves = [leaf for _, leaf in _compressed("dense/2x1x2/mb1")]
    assert [tuple(s) for s in want["err"]] == [(2, *leaf.shape)
                                               for leaf in leaves]


@pytest.mark.parametrize("mesh", ["1x2x2", "2x2"])
def test_restore_onto_another_pod_count_raises(runs, mesh):
    ranks, _ = runs
    for r in ranks:
        msg = r["ckpt"]["refused_" + mesh]
        assert msg is not None and "2 pods" in msg, msg
        assert ("1 pod" if mesh == "1x2x2" else "no pod axis") in msg, msg


def test_launcher_trains_compressed_on_a_mesh_and_resumes(runs):
    ranks, _ = runs
    got = ranks[0]["launch"]
    assert len(got["losses"]) == 3 and all(np.isfinite(got["losses"]))
    assert len(got["resumed"]) == 2 and all(np.isfinite(got["resumed"]))
    assert got["latest"] == 5
    assert all(r["launch"] == got for r in ranks)
