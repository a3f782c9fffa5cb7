"""Sharded prefill and decode (``transformer.prefill`` / ``decode_step``
on a model built with a mesh) on four gloo CPU ranks, against the JAX
package's sharded serving step and the port's one process.

One ``torchrun`` of four ranks (as ``tests/test_torch_sharded_lm.py``)
runs every case in turn, while JAX children
(``--xla_force_host_platform_device_count=4``, the cases split between
them) run the JAX package's ``jit(T.prefill)`` and ``jit(T.decode_step)``
under ``use_mesh``, the parameters placed by ``model_specs``, the cache
by ``cache_specs`` and the tokens by ``"batch"``, as
``repro/launch/dryrun.py:224-265`` lowers them, but executed.  Both
start from the port's one-process init (the JAX side through
``models.convert.leaf_layout``) and take the same prompt, VLM patches and
decode tokens; the pytest process runs the port's one process on them
meanwhile.

* Configs: the dense, MoE and hybrid configs of
  ``tests/test_torch_sharded_lm.py`` (the hybrid's ``window`` 8 under the
  prompt and steps, so the local ring wraps on the ranks), rwkv6-1.6b's
  smoke config, the 3-head dense config (attention whole on every model
  rank) and the VLM and audio smoke configs, fp32; meshes ``(2, 2)``,
  ``(2, 1, 2)`` and ``(1, 4)`` (the last splits every cache four ways);
  the dense config also with a 29-slot cache, which no ``model`` of 2
  divides (``resolve_spec`` keeps it whole).  A prompt of 18 tokens and 6
  decode steps.
* Against the JAX package's sharded step: the prefill's last-position
  logits, every step's logits and the gathered cache (``unshard_cache``,
  ``to_jax_cache``) within ``tests/test_torch_lm.py``'s 2e-3.
* Against the port's one process (not the MoE: the sharded MoE routes and
  drops per shard, as the JAX package's does): every logit within 1e-4,
  and the greedy tokens (``launch/serve.py``'s ``serve_prefill`` /
  ``serve_decode``) equal.
* Each rank's cache holds the local shapes ``cache_specs`` gives (K/V the
  whole cache's bytes over ``|pod data| |model|``); ranks holding the same
  shard hold the same bits; ``shard_cache`` of the gathered cache gives
  each rank's back bitwise; every prefill's and step's
  ``collectives.record`` equals ``training/schedule.py``'s
  ``prefill_collectives`` / ``decode_collectives`` on every rank.
* ``python -m repro_torch.launch.serve --mesh 2,2`` prints the tokens of
  the one-process launcher.
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
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import (from_jax_cache, gather, leaf_layout,
                                        to_jax_cache)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 400               # seconds for the ranks and for each JAX child
JAX_PARTS = 3               # JAX children, the cases split between them
TOL = 2e-3                  # against the JAX package (tests/test_torch_lm.py)
TOL_ONE = 1e-4              # against the port's one process
BATCH, PROMPT, STEPS, MAX_SEQ = 4, 18, 6, 32
BASE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
            d_ff=128, vocab_size=64, dtype="float32")
CONFIGS = {
    "dense": dict(name="d", family="dense", **BASE),
    "moe": dict(name="m", family="moe", num_experts=4, experts_per_token=2,
                **BASE),
    "hybrid": dict(name="h", family="hybrid", block_pattern=(
        "rglru", "rglru", "local"), window=8, **{**BASE, "num_layers": 6}),
    "rwkv": "rwkv6-1.6b",
    "odd_heads": dict(name="o", family="dense", num_layers=2, d_model=48,
                      num_heads=3, num_kv_heads=1, d_ff=96, vocab_size=64,
                      dtype="float32"),
    "vlm": "llava-next-34b",
    "audio": "musicgen-large",
}
CASES = {f"{c}/{'x'.join(map(str, shape))}/L{L}": (c, shape, L)
         for c, shape, L in [
             ("dense", (2, 2), MAX_SEQ), ("dense", (2, 1, 2), MAX_SEQ),
             ("dense", (1, 4), MAX_SEQ), ("dense", (2, 2), 29),
             ("moe", (2, 2), MAX_SEQ), ("moe", (2, 1, 2), MAX_SEQ),
             ("moe", (1, 4), MAX_SEQ),
             ("hybrid", (2, 2), MAX_SEQ), ("hybrid", (2, 1, 2), MAX_SEQ),
             ("hybrid", (1, 4), MAX_SEQ),
             ("rwkv", (2, 2), MAX_SEQ), ("rwkv", (2, 1, 2), MAX_SEQ),
             ("rwkv", (1, 4), MAX_SEQ),
             ("odd_heads", (2, 2), MAX_SEQ), ("vlm", (2, 2), MAX_SEQ),
             ("audio", (2, 2), MAX_SEQ)]}
LAUNCH = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--batch",
          "4", "--prompt-len", "16", "--tokens", "8"]

COMMON = r"""
import json, os, sys
import numpy as np
CONFIGS = __CONFIGS__
CASES = __CASES__
BATCH, PROMPT, STEPS = __BATCH__, __PROMPT__, __STEPS__
OUT = sys.argv[1]

def config(pkg_configs, ModelConfig, key):
    c = CONFIGS[key]
    if isinstance(c, str):
        return pkg_configs.smoke_config(pkg_configs.get_config(c))
    return ModelConfig(**c)

def names(shape):
    return ("data", "model") if len(shape) == 2 else ("pod", "data", "model")

def inputs(key):
    with np.load(os.path.join(OUT, key + "_inputs.npz")) as z:
        return {k: z[k] for k in z.files}

def patches(cfg):
    return cfg.patch_positions if cfg.family == "vlm" else 0
"""

JAX_CHILD = COMMON + r"""
import jax, jax.numpy as jnp
from repro import configs as jcfgs
from repro.compat import make_mesh
from repro import sharding as Sh
from repro.models import transformer as JT
from repro.models.config import ModelConfig

def placed(tree, specs, mesh):
    return jax.tree.map(
        lambda x, s: jax.device_put(x, Sh.named_sharding(tuple(s), mesh,
                                                         x.shape)),
        tree, specs, is_leaf=lambda x: isinstance(x, tuple))

def batched(x, mesh):
    return jax.device_put(jnp.asarray(x), Sh.named_sharding(
        ("batch",) + (None,) * (x.ndim - 1), mesh, x.shape))

part, parts = int(sys.argv[2]), int(sys.argv[3])
for case, (key, shape, L) in list(CASES.items())[part::parts]:
    cfg = config(jcfgs, ModelConfig, key)
    mesh = make_mesh(tuple(shape), names(shape))
    tag = case.replace("/", "_")
    with np.load(os.path.join(OUT, key + "_init.npz")) as z:
        leaves = [z[str(i)] for i in range(len(z.files))]
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    params = jax.tree.unflatten(jax.tree.structure(shapes),
                                [jnp.asarray(a) for a in leaves])
    params = placed(params, JT.model_specs(cfg), mesh)
    cache = placed(JT.init_cache(cfg, BATCH, L + patches(cfg)),
                   JT.cache_specs(cfg), mesh)
    x = inputs(key)
    batch = {"tokens": batched(x["prompt"], mesh)}
    if "patches" in x:
        batch["patch_embeds"] = batched(x["patches"], mesh)
    out = {}
    with Sh.use_mesh(mesh):
        pre = jax.jit(lambda p, b, c: JT.prefill(p, cfg, b, c))
        dec = jax.jit(lambda p, c, t, pos: JT.decode_step(p, cfg, c, t, pos))
        logits, cache = pre(params, batch, cache)
        out["logits0"] = np.asarray(logits)
        start = PROMPT + patches(cfg)
        for i in range(STEPS):
            logits, cache = dec(params, cache,
                                batched(x["steps"][..., i:i + 1], mesh),
                                jnp.int32(start + i))
            out[f"logits{i + 1}"] = np.asarray(logits)
    flat = jax.tree_util.tree_flatten_with_path(cache)[0]
    for path, leaf in flat:
        out["cache/" + jax.tree_util.keystr(path)] = np.asarray(leaf)
    np.savez(os.path.join(OUT, tag + "_jax.npz"), **out)
print("JAX_OK", part)
"""

RANKS = COMMON + r"""
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs as pcfgs, sharding
from repro_torch.core import collectives as coll
from repro_torch.core.parallel import Plan
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import shard_cache, to_jax_cache, unshard_cache
from repro_torch.training.schedule import (decode_collectives,
                                           prefill_collectives,
                                           record_counter)

dist.init_process_group("gloo")
rank = dist.get_rank()
meshes = {}

def plan_of(shape):
    shape = tuple(shape)
    if shape not in meshes:
        meshes[shape] = Plan(init_device_mesh("cpu", shape,
                                              mesh_dim_names=names(shape)))
    return meshes[shape]

def diff(want):
    got = record_counter(coll.record)
    return "" if got == want else (f"extra {dict(got - want)} "
                                   f"missing {dict(want - got)}")

def whole_rows(plan, t):
    return plan.unshard(t, sharding.resolve_spec(("batch",), plan.mesh,
                                                 (BATCH,)))

out = {"rank": rank, "cases": {}}
for case, (key, shape, L) in CASES.items():
    cfg = config(pcfgs, ModelConfig, key)
    plan = plan_of(shape)
    sizes = dict(zip(names(shape), shape))
    tag = case.replace("/", "_")
    x = {k: torch.from_numpy(v) for k, v in inputs(key).items()}
    r0, r1 = T.batch_rows(plan, BATCH)
    model = T.init_model(cfg, seed=0, plan=plan)
    Lc = L + patches(cfg)
    cache = T.init_cache(cfg, BATCH, Lc, plan=plan)
    specs = T.resolved_cache_specs(cfg, plan.mesh, BATCH, Lc)
    whole = T.cache_shapes(cfg, BATCH, Lc)
    local_ok, kv_split = True, True
    for c, spec, w in zip(cache, specs, whole):
        for n, t in c.items():
            local_ok &= tuple(t.shape) == sharding.local_shape(
                w[n][0], spec[n], sizes)
            if n in ("k", "v"):
                full = int(np.prod(w[n][0])) * t.element_size()
                split = (BATCH % plan.n_batch == 0 and Lc % plan.tp == 0)
                kv_split &= (t.numel() * t.element_size() == full //
                             (plan.n_batch * plan.tp)) if split else \
                    t.shape[1] == Lc
    row = {"coord": dict(zip(names(shape), plan.mesh.get_coordinate())),
           "local_shapes": local_ok, "kv_bytes": kv_split, "schedule": [],
           "specs": specs}
    coll.reset_record()
    logits, cache = T.prefill(model, x["prompt"][r0:r1], cache,
                              patch_embeds=x["patches"][r0:r1]
                              if "patches" in x else None)
    row["schedule"].append(diff(prefill_collectives(
        cfg, sizes, r1 - r0, PROMPT, Lc)))
    got = {"logits0": whole_rows(plan, logits)}
    start = PROMPT + patches(cfg)
    for i in range(STEPS):
        coll.reset_record()
        logits, cache = T.decode_step(model, cache,
                                      x["steps"][r0:r1, ..., i:i + 1],
                                      start + i)
        row["schedule"].append(diff(decode_collectives(cfg, sizes, r1 - r0,
                                                       Lc)))
        got[f"logits{i + 1}"] = whole_rows(plan, logits)
    full = unshard_cache(cache, cfg, plan, BATCH, Lc)
    row["shard_cache"] = all(
        torch.equal(a[n], b[n]) for a, b in
        zip(shard_cache(full, cfg, plan), cache) for n in a)
    np.savez(os.path.join(OUT, f"{tag}_local{rank}.npz"), **{
        f"{i}.{n}": t.numpy() for i, c in enumerate(cache)
        for n, t in c.items()})
    if rank == 0:
        tree = to_jax_cache(full, cfg)
        flat = {}
        for g, d in tree.get("groups", {}).items():
            for n, t in d.items():
                flat[f"cache/['groups']['{g}']['{n}']"] = t.numpy()
        for j, d in enumerate(tree.get("tail", [])):
            for n, t in d.items():
                flat[f"cache/['tail'][{j}]['{n}']"] = t.numpy()
        np.savez(os.path.join(OUT, tag + "_port.npz"), **flat,
                 **{k: v.numpy() for k, v in got.items()})
    # greedy, through the launcher's phases: every rank its rows
    logits, cache, _ = launch_serve.serve_prefill(
        model, x["prompt"], L,
        patch_embeds=x["patches"] if "patches" in x else None)
    tokens, _, _ = launch_serve.serve_decode(model, cache, logits, start,
                                             STEPS)
    row["greedy"] = whole_rows(plan, tokens).tolist()
    out["cases"][case] = row

res = launch_serve.main(__LAUNCH__ + ["--mesh", "2,2"])
out["launch_tokens"] = res["tokens"].tolist()
with open(os.path.join(OUT, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK")
"""


def _script(body: str) -> str:
    return (body.replace("__CONFIGS__", repr(CONFIGS))
            .replace("__CASES__", repr(CASES))
            .replace("__BATCH__", str(BATCH))
            .replace("__PROMPT__", str(PROMPT))
            .replace("__STEPS__", str(STEPS))
            .replace("__LAUNCH__", repr(LAUNCH)))


def _config(key: str) -> ModelConfig:
    c = CONFIGS[key]
    if isinstance(c, str):
        return configs.smoke_config(configs.get_config(c))
    return ModelConfig(**c)


def _patches(cfg) -> int:
    return cfg.patch_positions if cfg.family == "vlm" else 0


def _inputs(cfg, seed: int) -> dict:
    """The prompt (B, P) (audio (B, K, P)), the decode steps' tokens and
    the VLM's patch embeddings, from ``seed``."""
    rng = np.random.default_rng(seed)
    lead = (BATCH, cfg.num_codebooks) if cfg.family == "audio" else (BATCH,)
    out = {"prompt": rng.integers(0, cfg.vocab_size, lead + (PROMPT,)),
           "steps": rng.integers(0, cfg.vocab_size, lead + (STEPS,))}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.patch_positions, cfg.d_model)).astype(np.float32)
    return out


def _one_process(cfg, x: dict, L: int) -> dict:
    """The port's one process on the same weights and inputs: the
    logits of the prefill and every step, and the greedy tokens."""
    model = T.init_model(cfg, seed=0, device="cpu")
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    start = PROMPT + _patches(cfg)
    cache = T.init_cache(cfg, BATCH, L + _patches(cfg), device="cpu")
    logits, _ = T.prefill(model, t["prompt"], cache,
                          patch_embeds=t.get("patches"))
    out = {"logits0": logits.numpy()}
    for i in range(STEPS):
        logits, _ = T.decode_step(model, cache, t["steps"][..., i:i + 1],
                                  start + i)
        out[f"logits{i + 1}"] = logits.numpy()
    logits, cache, _ = launch_serve.serve_prefill(
        model, t["prompt"], L, patch_embeds=t.get("patches"))
    out["greedy"] = launch_serve.serve_decode(model, cache, logits, start,
                                              STEPS)[0].numpy()
    return out


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
    """``(ranks, d, one)``: one json dict a rank, the directory of the
    saved arrays, and the port's one-process results by case."""
    d = tmp_path_factory.mktemp("sharded_serve")
    for i, key in enumerate(CONFIGS):   # the one-process init, JAX order
        cfg = _config(key)
        model = T.init_model(cfg, seed=0, device="cpu")
        named = {n: p.detach() for n, p in model.named_parameters()}
        np.savez(d / f"{key}_init.npz", **{
            str(j): gather(leaf, named).numpy()
            for j, leaf in enumerate(leaf_layout(model))})
        np.savez(d / f"{key}_inputs.npz", **_inputs(cfg, 100 + i))
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
    one = {}
    for case, (key, _, L) in CASES.items():       # meanwhile, one process
        with np.load(d / f"{key}_inputs.npz") as z:
            x = {k: z[k] for k in z.files}
        one[case] = _one_process(_config(key), x, L)
    one["launch"] = launch_serve.main(LAUNCH)["tokens"].numpy()
    out = _wait(rank_proc, d / "ranks.log", "the four ranks")
    assert out.count("RANK_OK") == 4, out[-3000:]
    for part, proc in enumerate(jax_procs):
        assert "JAX_OK" in _wait(proc, d / f"jax{part}.log",
                                 f"JAX child {part}")
    ranks = [json.loads((d / f"rank{r}.json").read_text()) for r in range(4)]
    return ranks, d, one


def _saved(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tag(case: str) -> str:
    return case.replace("/", "_")


@pytest.mark.parametrize("case", sorted(CASES))
def test_logits_equal_the_jax_sharded_serve(runs, case):
    _, d, _ = runs
    got, want = _saved(d / f"{_tag(case)}_port.npz"), \
        _saved(d / f"{_tag(case)}_jax.npz")
    for i in range(STEPS + 1):
        np.testing.assert_allclose(got[f"logits{i}"], want[f"logits{i}"],
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_equals_the_jax_sharded_cache(runs, case):
    """The gathered cache, in the JAX package's layout, leaf for leaf:
    the rings' slots and positions (the hybrid's wrapped), the recurrent
    states."""
    _, d, _ = runs
    got, want = _saved(d / f"{_tag(case)}_port.npz"), \
        _saved(d / f"{_tag(case)}_jax.npz")
    keys = sorted(k for k in want if k.startswith("cache/"))
    assert keys == sorted(k for k in got if k.startswith("cache/"))
    for k in keys:
        assert got[k].shape == want[k].shape, k
        if k.endswith("['pos']"):
            np.testing.assert_array_equal(got[k], want[k], k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL,
                                       err_msg=k)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.startswith("moe")))
def test_logits_equal_one_process(runs, case):
    _, d, one = runs
    got = _saved(d / f"{_tag(case)}_port.npz")
    for i in range(STEPS + 1):
        np.testing.assert_allclose(got[f"logits{i}"], one[case][f"logits{i}"],
                                   rtol=0, atol=TOL_ONE, err_msg=f"step {i}")


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if not c.startswith("moe")))
def test_greedy_tokens_equal_one_process(runs, case):
    ranks, _, one = runs
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["cases"][case]["greedy"]),
                                      one[case]["greedy"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_cache_bytes_a_rank(runs, case):
    """Each rank's cache leaves have the local shapes ``cache_specs``
    gives; K/V are the whole ring's bytes over ``|pod data| |model|``
    (whole over ``model`` where ``Lc`` does not divide it)."""
    ranks, _, _ = runs
    for r in ranks:
        row = r["cases"][case]
        assert row["local_shapes"] and row["kv_bytes"], r["rank"]
    key, shape, L = CASES[case]
    cfg = _config(key)
    whole = T.cache_shapes(cfg, BATCH, L + _patches(cfg))
    specs = ranks[0]["cases"][case]["specs"]
    kv = [(s["k"], w["k"][0][1]) for s, w in zip(specs, whole) if "k" in s]
    assert len(kv) == sum(k in ("attn", "local") for k in cfg.blocks)
    assert all((len(s) > 1 and s[1] == "model") == (Lc % shape[-1] == 0)
               for s, Lc in kv), kv


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicas_are_bitwise(runs, case):
    """Ranks at the same coordinates on every axis a cache leaf's spec
    shards hold the same bits of it; ``shard_cache`` of the gathered
    cache gives each rank's own back."""
    ranks, d, _ = runs
    local = [_saved(d / f"{_tag(case)}_local{r}.npz") for r in range(4)]
    specs = ranks[0]["cases"][case]["specs"]
    pairs = 0
    for i, spec in enumerate(specs):
        for name, s in spec.items():
            axes = {a for e in s if e for a in ([e] if isinstance(e, str)
                                                else e)}
            key = lambda r: tuple(ranks[r]["cases"][case]["coord"][a]
                                  for a in sorted(axes))
            for a in range(4):
                for b in range(a + 1, 4):
                    if key(a) == key(b):
                        np.testing.assert_array_equal(
                            local[a][f"{i}.{name}"], local[b][f"{i}.{name}"])
                        pairs += 1
    assert pairs > 0
    assert all(r["cases"][case]["shard_cache"] for r in ranks)


@pytest.mark.parametrize("case", sorted(CASES))
def test_collectives_equal_the_serve_schedule(runs, case):
    ranks, _, _ = runs
    for r in ranks:
        assert r["cases"][case]["schedule"] == [""] * (STEPS + 1), (
            r["rank"], r["cases"][case]["schedule"])


def test_cache_converts_to_and_from_the_jax_layout():
    """``to_jax_cache`` stacks the layers as the JAX package's
    ``init_cache`` does, and ``from_jax_cache`` undoes it."""
    from repro.models import transformer as JT
    for key in ("hybrid", "rwkv"):
        cfg = _config(key)
        cache = T.init_cache(cfg, 2, 16, device="cpu")
        for i, c in enumerate(cache):
            for t in c.values():
                t.copy_(torch.arange(t.numel()).view(t.shape) + 1000 * i)
        tree = to_jax_cache(cache, cfg)
        jshape = JT.init_cache(cfg, 2, 16)
        import jax
        assert jax.tree.structure(jshape) == jax.tree.structure(tree)
        assert [x.shape for x in jax.tree.leaves(jshape)] == \
            [tuple(x.shape) for x in jax.tree.leaves(tree)]
        back = from_jax_cache(jax.tree.map(lambda t: t.numpy(), tree), cfg)
        assert all(torch.equal(a[n], b[n]) for a, b in zip(back, cache)
                   for n in a)


def test_launcher_serves_on_a_mesh(runs):
    ranks, _, one = runs
    for r in ranks:
        np.testing.assert_array_equal(np.asarray(r["launch_tokens"]),
                                      one["launch"])
