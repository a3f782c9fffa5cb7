"""The port's training path (``repro_torch.training``) against the JAX
package's, on the CPU.

* The data pipeline: batches bitwise the JAX package's.
* ``models.transformer.loss_fn`` and every gradient, mapped onto the JAX
  package's leaves by ``models.convert.leaf_layout``, against
  ``jax.value_and_grad(repro.models.transformer.loss_fn)`` for each dense
  arch's fp32 smoke config (norm scales moved off zero), with
  ``loss_chunks`` 1 and 4 and with a ``loss_mask``: the loss within 1e-5
  relative, each gradient within 1e-5 of its largest element (fp32 sums
  in other orders).  ``remat_policy`` changes neither: "none", "minimal"
  and "full" give the same bits.  "minimal"'s backward runs as many
  ``aten.mm`` as "none"'s (it saves the weight GEMMs' outputs), "full"'s
  those and the layers' forward ones again, and the bytes a step holds
  for its backward order full < minimal < none.
* Five train steps of the JAX package's ``TINY`` model and of a smoke
  config, with and without compression, at microbatches 1 and 4, against
  its ``make_train_step`` on the same weights (the compression fed the
  JAX package's ``Q0``): every loss within 1e-5 relative, every
  parameter within 1e-4 (AdamW divides by the gradients' scale, and the
  power step's subspace is only as well conditioned as ``M Q``).
* The runner resumed after a planted failure repeats the uninterrupted
  run bitwise; ``python -m repro_torch.launch.train --smoke --device
  cpu`` trains; a mesh gives the sharded step, plain or compressed
  (trained in ``tests/test_torch_sharded_lm.py`` and
  ``tests/test_torch_sharded_compression.py``).
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jax_configs
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.optim import adamw as jopt
from repro.optim import compression as jcomp
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit
from repro.training import make_train_step as jmake
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import from_jax_params, gather, leaf_layout
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.training import (TrainConfig, TrainState, init_train_state,
                                  make_train_step)
from repro_torch.training.runner import RunnerConfig, TrainingRunner

DENSE_ARCHS = ["gemma2-9b", "yi-6b", "qwen3-0.6b", "starcoder2-15b"]
TOL_LOSS = 1e-5
TOL_GRAD = 1e-5
TOL_STEP_PARAMS = 1e-4
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
            dtype="float32")


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        float(np.abs(got - want).max()), scale)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(64, 16, 4, 1234),
                                                  (151936, 33, 3, 7),
                                                  (128, 1, 1, 0)])
def test_data_pipeline_is_bitwise_the_jax_packages(vocab, seq, batch, seed):
    ours = SyntheticLMDataset(DataConfig(vocab, seq, batch, seed=seed))
    theirs = JDataset(JDataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 1, 9):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(ours.batch(3)["labels"][:, :-1],
                                  ours.batch(3)["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def _pair(arch, seed=0, **over):
    jc = dataclasses.replace(
        jax_configs.smoke_config(jax_configs.get_config(arch)), **over)
    pc = dataclasses.replace(configs.smoke_config(configs.get_config(arch)),
                             **over)
    params = JT.init_model(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + jnp.asarray(rng.normal(0, 0.5, x.shape),
                                        x.dtype)
        if getattr(path[-1], "key", None) == "scale" else x, params)
    model = T.Transformer(pc, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                          pc))
    return params, model, jc, pc


def _batch(cfg, B, S, seed, mask):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
         "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


def _port_grads(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, m = T.loss_fn(model, tb)
    names = [n for n, _ in model.named_parameters()]
    gs = torch.autograd.grad(total, [p for _, p in model.named_parameters()])
    return float(total), float(m["loss"]), dict(zip(names, gs))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("loss_chunks", [1, 4])
@pytest.mark.parametrize("mask", [False, True])
def test_loss_and_grads_match_jax(arch, loss_chunks, mask):
    params, model, jc, pc = _pair(arch, loss_chunks=loss_chunks)
    batch = _batch(pc, 2, 16, 1, mask)
    (jtot, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
        has_aux=True)(params)
    tot, loss, grads = _port_grads(model, batch)
    _rel_close(tot, float(jtot), TOL_LOSS)
    _rel_close(loss, float(jm["loss"]), TOL_LOSS)
    for leaf, want in zip(leaf_layout(model), jax.tree.leaves(jg)):
        _rel_close(gather(leaf, grads).numpy(), np.asarray(want), TOL_GRAD)


@pytest.mark.parametrize("policy", ["none", "minimal", "full"])
def test_remat_changes_no_math(policy):
    _, model, _, pc = _pair("gemma2-9b", remat_policy=policy)
    _, base, _, _ = _pair("gemma2-9b", remat_policy="none")
    batch = _batch(pc, 2, 12, 2, False)
    tot, _, g = _port_grads(model, batch)
    tot0, _, g0 = _port_grads(base, batch)
    assert tot == tot0
    assert all(torch.equal(g[n], g0[n]) for n in g)


class _Tally(TorchDispatchMode):
    """Counts the aten ops that run, and keeps a weak reference to every
    storage an op makes: those still alive after the forward are what
    the step holds for its backward."""

    def __init__(self):
        super().__init__()
        self.ops, self.made = {}, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[func] = self.ops.get(func, 0) + 1
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.untyped_storage().nbytes():
                self.made.append((StorageWeakRef(t.untyped_storage()),
                                  t.untyped_storage().nbytes()))
        return out

    def mm(self) -> int:
        return sum(self.ops.get(op, 0) for op in T.SAVED_OPS)

    def alive_bytes(self) -> int:
        gc.collect()
        return sum({w.cdata: n for w, n in self.made
                    if not w.expired()}.values())


REMAT_ARCHS = ["gemma2-9b", "rwkv6-1.6b", "recurrentgemma-9b",
               "grok-1-314b"]


def _remat_step(arch, policy):
    """(forward tally, backward tally, mm of the layers' forward) of one
    loss and gradient of ``arch``'s fp32 smoke config under ``policy``."""
    cfg = dataclasses.replace(configs.smoke_config(configs.get_config(arch)),
                              dtype="float32", remat_policy=policy)
    model = T.init_model(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12)))
    # early stop off: a recompute runs its whole region (the sharded
    # step's setting), so "full" recomputes every GEMM of the forward
    with torch.utils.checkpoint.set_checkpoint_early_stop(False):
        with _Tally() as fwd:
            total, _ = T.loss_fn(model, {"tokens": toks, "labels": toks})
        fwd.alive = fwd.alive_bytes()
        with _Tally() as bwd:
            torch.autograd.grad(total, list(model.parameters()))
    with torch.no_grad(), _Tally() as layers:
        T._hidden(model, toks, None, "none")
    return fwd, bwd, layers.mm()


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_minimal_recomputes_no_weight_gemm(arch):
    """The backward of "minimal" runs as many ``aten.mm`` as that of
    "none" (the weight GEMMs' outputs are saved, not recomputed); that of
    "full" as many plus every one of the layers' forward."""
    runs = {p: _remat_step(arch, p) for p in ("none", "minimal", "full")}
    none, minimal, full = (runs[p][1].mm() for p in ("none", "minimal",
                                                     "full"))
    assert runs["none"][0].mm() == runs["minimal"][0].mm()
    assert minimal == none
    assert full == none + runs["none"][2] and runs["none"][2] > 0


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_minimal_holds_between_none_and_full(arch):
    """The bytes a step holds after its forward for the backward: "full"
    (each layer's input) < "minimal" (those and the GEMMs' outputs) <
    "none" (every activation)."""
    held = {p: _remat_step(arch, p)[0].alive
            for p in ("none", "minimal", "full")}
    assert held["full"] < held["minimal"] < held["none"], held


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _jax_q0_into(state, jstate, layout):
    jq = jax.tree.leaves(jstate.comp["Q"], is_leaf=lambda x: isinstance(
        x, tuple) or hasattr(x, "shape"))
    for leaf, q in zip(layout, jq):
        if leaf.path in state.comp["Q"]:
            state.comp["Q"][leaf.path] = torch.from_numpy(np.array(q))


@pytest.mark.parametrize("which", ["tiny", "qwen3-0.6b-smoke"])
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("micro", [1, 4])
def test_train_steps_match_jax(which, compress, micro):
    if which == "tiny":
        jc, pc = JModelConfig(**TINY), ModelConfig(**TINY)
    else:
        jc = jax_configs.smoke_config(jax_configs.get_config("qwen3-0.6b"))
        pc = configs.smoke_config(configs.get_config("qwen3-0.6b"))
    akw = dict(lr=5e-3, warmup_steps=2, total_steps=20)
    ckw = dict(enabled=compress, rank=8, min_size=512)
    jtc = JTrainConfig(adamw=jopt.AdamWConfig(**akw),
                       compression=jcomp.CompressionConfig(**ckw),
                       microbatches=micro)
    tc = TrainConfig(adamw=opt.AdamWConfig(**akw),
                     compression=comp.CompressionConfig(**ckw),
                     microbatches=micro)
    js = jinit(jax.random.PRNGKey(0), jc, jtc)
    model = T.Transformer(pc, device="cpu")
    model.load_state_dict(from_jax_params(jax.tree.map(np.asarray,
                                                       js.params), pc))
    layout = leaf_layout(model)
    state = TrainState(model=model, opt=opt.init_opt_state(
        dict(model.named_parameters()), tc.adamw), comp=None, step=0)
    if compress:
        state.comp = comp.init_state(layout, tc.compression, "cpu")
        _jax_q0_into(state, js, layout)
    ds = SyntheticLMDataset(DataConfig(vocab_size=pc.vocab_size, seq_len=16,
                                       global_batch=8))
    jstep, step = jax.jit(jmake(jc, jtc, None)), make_train_step(pc, tc)
    for i in range(5):
        js, jm = jstep(js, ds.batch(i))
        state, m = step(state, ds.batch(i))
        _rel_close(float(m["loss"]), float(jm["loss"]), TOL_LOSS)
        if compress:
            assert float(m["compress_ratio"]) == float(jm["compress_ratio"])
    assert state.step == int(js.step) == 5
    named = {n: p.detach() for n, p in model.named_parameters()}
    for leaf, want in zip(layout, jax.tree.leaves(js.params)):
        np.testing.assert_allclose(gather(leaf, named).numpy(),
                                   np.asarray(want), rtol=0,
                                   atol=TOL_STEP_PARAMS)


@pytest.mark.parametrize("compressed", [True, False])
def test_train_step_over_a_mesh_names_its_roadmap_item(compressed):
    """A mesh returns the sharded step, plain or compressed (ROADMAP item
    16, done; trained in ``tests/test_torch_sharded_lm.py`` and
    ``tests/test_torch_sharded_compression.py``)."""
    cfg = ModelConfig(**TINY)
    tc = TrainConfig(compression=comp.CompressionConfig(enabled=compressed))
    assert callable(make_train_step(cfg, tc, mesh=object()))


def _runner(tmp_path, label, hook=None):
    cfg = configs.smoke_config(configs.get_config("gemma2-9b"))
    tc = TrainConfig(adamw=opt.AdamWConfig(lr=5e-3, warmup_steps=2,
                                           total_steps=8),
                     compression=comp.CompressionConfig(rank=4,
                                                        min_size=512))
    rc = RunnerConfig(total_steps=8, ckpt_every=4,
                      ckpt_dir=str(tmp_path / label),
                      max_restarts=1 if hook else 0)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4)
    return TrainingRunner(cfg, tc, rc, dc, failure_hook=hook, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaves(tree[key])]
    return [] if tree is None else [tree]


def test_runner_resumes_bitwise_after_a_failure(tmp_path):
    fired = []

    def plant(step):
        if step == 5 and not fired:
            fired.append(step)
            raise RuntimeError("planted")

    clean = _runner(tmp_path, "a")
    ta = clean.run().tree()
    faulty = _runner(tmp_path, "b", plant)
    tb = faulty.run().tree()
    assert faulty.restarts == 1 and fired == [5]
    la = {h["step"]: h["loss"] for h in clean.history}
    lb = {h["step"]: h["loss"] for h in faulty.history}
    assert la == lb and sorted(la) == list(range(8))
    assert [h["step"] for h in faulty.history] == [0, 1, 2, 3, 4, 4, 5, 6, 7]
    assert all(torch.equal(a.detach(), b.detach())
               for a, b in zip(_leaves(ta), _leaves(tb)))
    # a new runner on the same directory resumes from the last checkpoint
    again = _runner(tmp_path, "b")
    again.run()
    assert again.history == []


def test_runner_raises_on_a_non_finite_loss(tmp_path):
    runner = _runner(tmp_path, "nan")
    runner_state = runner._fresh_state()
    with torch.no_grad():
        runner_state.model.embed.fill_(float("nan"))
    runner._fresh_state = lambda: runner_state
    with pytest.raises(FloatingPointError, match="non-finite"):
        runner.run()


def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    out = launch_train.main(["--arch", "qwen3-0.6b", "--smoke", "--device",
                             "cpu", "--steps", "6", "--batch", "4", "--seq",
                             "16", "--compress", "--loss-chunks", "4",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "3"])
    assert len(out["losses"]) == 6 and all(np.isfinite(out["losses"]))
    assert out["state"].model.cfg.loss_chunks == 4
    assert "loss" in capsys.readouterr().out


def test_init_train_state_is_seeded():
    cfg = ModelConfig(**TINY)
    tc = TrainConfig(compression=comp.CompressionConfig(min_size=512))
    a = init_train_state(cfg, tc, device="cpu")
    b = init_train_state(cfg, tc, device="cpu")
    assert all(torch.equal(x.detach(), y.detach())
               for x, y in zip(_leaves(a.tree()), _leaves(b.tree())))
    assert a.comp["Q"] and all(q.shape[1] == 8 for q in a.comp["Q"].values())
