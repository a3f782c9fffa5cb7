"""The port's optimizer, gradient compression and leaf layout against the
JAX package's.

* ``schedule``, ``global_norm``, ``clip_by_global_norm`` and three
  ``apply_updates`` steps on the same numpy trees: within 1e-6 relative
  (both in fp32, the same formulas; the port's global norm sums per
  tensor).  Weight decay follows the JAX leaf a tensor belongs to
  (``models.convert.decayed``): a stacked norm scale is decayed, the
  final norm's is not, and with ``scan_layers=False`` no 1-D scale is.
* ``compress_grads`` is fed the JAX package's ``Q0`` (the two RNGs
  cannot agree): ``M_hat`` and the error buffers (sign-invariant) within
  1e-5 of the factored matrix ``M`` in Frobenius norm, the next ``Q`` up
  to its columns' signs within 1e-5 of its norm (fp32 products and QR in
  other orders; one power step's subspace is only as well conditioned as
  ``M Q``, so single elements of a small error buffer can differ more),
  and ``compress_ratio`` exactly; on a smoke config's stacked leaves and on
  the JAX package's own four cases (``tests/test_training.py:78-130``).
* ``leaf_layout`` lists the JAX package's leaves, paths and shapes in its
  flattening order, for every dense arch, stacked or not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro.optim import adamw as jopt
from repro.optim import compression as jcomp
from repro_torch import configs
from repro_torch.models import transformer as T
from repro_torch.models.convert import (decayed, from_jax_params, gather,
                                        leaf_layout, scatter)
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp

DENSE_ARCHS = ["gemma2-9b", "yi-6b", "qwen3-0.6b", "starcoder2-15b"]
TOL_ADAM = 1e-6
TOL_COMP = 1e-5


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        float(np.abs(got - want).max()), scale)


def _jax_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _pair(arch, scan_layers=True, seed=0):
    """(JAX params, the port's model on them, jax cfg, port cfg), the
    smoke config in fp32, norm scales moved off zero."""
    jc = dataclasses.replace(jax_configs.smoke_config(
        jax_configs.get_config(arch)), scan_layers=scan_layers)
    pc = dataclasses.replace(configs.smoke_config(configs.get_config(arch)),
                             scan_layers=scan_layers)
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


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("scan_layers", [True, False])
def test_leaf_layout_is_the_jax_flattening(arch, scan_layers):
    params, model, _, _ = _pair(arch, scan_layers)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    layout = leaf_layout(model)
    assert [(leaf.path, leaf.shape) for leaf in layout] == [
        (_jax_path(path), tuple(x.shape)) for path, x in flat]
    named = {n: p.detach() for n, p in model.named_parameters()}
    assert sorted(n for leaf in layout for n in leaf.names) == sorted(named)
    for leaf, (_, x) in zip(layout, flat):
        np.testing.assert_array_equal(gather(leaf, named).numpy(),
                                      np.asarray(x))
        back = scatter(leaf, gather(leaf, named))
        assert all(torch.equal(back[n], named[n]) for n in leaf.names)


def test_decay_follows_the_jax_leaf():
    _, model, _, _ = _pair("qwen3-0.6b")
    d = decayed(leaf_layout(model))
    assert "layers.0.norm1.scale" in d and "layers.1.mix.q_norm" in d
    assert "final_norm.scale" not in d and "embed" in d
    _, flat_model, _, _ = _pair("qwen3-0.6b", scan_layers=False)
    d = decayed(leaf_layout(flat_model))
    assert not any(n.endswith(("scale", "_norm")) for n in d)
    assert "layers.0.mix.wq" in d


@pytest.mark.parametrize("step", [0, 1, 5, 10, 57, 100, 150])
def test_schedule_matches_jax(step):
    c = opt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                        min_lr_ratio=0.1)
    jc = jopt.AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    want = float(jopt.schedule(jc, jnp.int32(step)))
    got = float(opt.schedule(c, step))
    assert abs(got - want) <= TOL_ADAM * max(abs(want), 1e-30)


def test_global_norm_and_clip_match_jax():
    rng = np.random.default_rng(2)
    g = {"a": rng.normal(size=(10, 3)).astype(np.float32) * 4,
         "b": rng.normal(size=(7,)).astype(np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    tg = {k: torch.from_numpy(v) for k, v in g.items()}
    _rel_close(float(opt.global_norm(tg.values())),
               float(jopt.global_norm(jg)), TOL_ADAM)
    jc, jn = jopt.clip_by_global_norm(jg, 1.0)
    tc, tn = opt.clip_by_global_norm(tg, 1.0)
    _rel_close(float(tn), float(jn), TOL_ADAM)
    for k in g:
        _rel_close(tc[k].numpy(), np.asarray(jc[k]), TOL_ADAM)


@pytest.mark.parametrize("arch,scan_layers", [("qwen3-0.6b", True),
                                              ("gemma2-9b", True),
                                              ("qwen3-0.6b", False)])
def test_apply_updates_matches_jax_on_the_model_tree(arch, scan_layers):
    params, model, _, _ = _pair(arch, scan_layers, seed=1)
    layout = leaf_layout(model)
    cfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                          weight_decay=0.1)
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                            weight_decay=0.1)
    tparams = dict(model.named_parameters())
    tstate = opt.init_opt_state(tparams, cfg)
    jstate = jopt.init_opt_state(params, jcfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), params)
        params, jstate, jm = jopt.apply_updates(params, grads, jstate, jcfg)
        tg = from_jax_params(jax.tree.map(np.asarray, grads),
                             model.cfg)
        tm = opt.apply_updates(tparams, tg, tstate, cfg, decayed(layout))
    _rel_close(float(tm["grad_norm"]), float(jm["grad_norm"]), TOL_ADAM)
    _rel_close(float(tm["lr"]), float(jm["lr"]), TOL_ADAM)
    named = {n: p.detach() for n, p in tparams.items()}
    flat = jax.tree.leaves(params)
    for leaf, want in zip(layout, flat):
        _rel_close(gather(leaf, named).numpy(), np.asarray(want), TOL_ADAM)
    for key in ("m", "v"):
        for leaf, want in zip(layout, jax.tree.leaves(jstate[key])):
            _rel_close(gather(leaf, tstate[key]).numpy(), np.asarray(want),
                       TOL_ADAM)
    assert int(tstate["count"]) == int(jstate["count"]) == 3


def test_moment_dtype_is_honoured():
    cfg = opt.AdamWConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((3, 2), dtype=torch.bfloat16)}
    state = opt.init_opt_state(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    opt.apply_updates(params, {"w": torch.ones((3, 2),
                                               dtype=torch.bfloat16)},
                      state, cfg)
    assert params["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

class _Flat:
    """A dict of named arrays as a one-level model for ``leaf_layout``'s
    counterpart: each name is its own unstacked leaf, in sorted order."""


def _flat_layout(tree):
    from repro_torch.models.convert import Leaf
    return [Leaf(k, (k,), False, tuple(np.shape(tree[k])))
            for k in sorted(tree)]


def _jax_q(state):
    return jax.tree.leaves(state["Q"], is_leaf=lambda x: isinstance(
        x, tuple) or hasattr(x, "shape"))


def _port_state(layout, jstate, cc):
    """The port's compression state with the JAX package's Q0."""
    st = comp.init_state(layout, cc, "cpu")
    for leaf, q in zip(layout, _jax_q(jstate)):
        if leaf.path in st["Q"]:
            st["Q"][leaf.path] = torch.from_numpy(np.array(q))
    return st


def _fro_close(got, want, scale, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.linalg.norm(got - want) <= tol * scale, (
        np.linalg.norm(got - want), scale)


def _check_compressed(layout, jout, jstate, jstats, out, st, stats):
    """``M_hat`` and the error buffer within ``TOL_COMP`` of ||M||
    (Frobenius; M = M_hat + err, the leaf the step factored), the next Q
    up to its columns' signs within ``TOL_COMP`` of ||Q||; a leaf not
    compressed passes through exactly; the ratio is exact."""
    named_out = dict(out)
    jq = _jax_q(jstate)
    je = jax.tree.leaves(jstate["err"], is_leaf=lambda x: isinstance(
        x, tuple) or hasattr(x, "shape"))
    for leaf, want, q, e in zip(layout, jax.tree.leaves(jout), jq, je):
        got = gather(leaf, named_out).numpy()
        if leaf.path not in st["Q"]:
            assert isinstance(q, tuple) and isinstance(e, tuple)
            np.testing.assert_array_equal(got, np.asarray(want))
            continue
        scale = np.linalg.norm(np.asarray(want, np.float64)
                               + np.asarray(e, np.float64))
        _fro_close(got, want, scale, TOL_COMP)
        _fro_close(st["err"][leaf.path].numpy(), e, scale, TOL_COMP)
        gq, wq = st["Q"][leaf.path].numpy(), np.asarray(q)
        signs = np.sign(np.sum(gq * wq, axis=0))
        _fro_close(gq * signs, wq, np.linalg.norm(wq), TOL_COMP)
    assert float(stats["compress_ratio"]) == float(jstats["compress_ratio"])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_compress_grads_matches_jax_on_stacked_leaves(arch):
    params, model, _, pc = _pair(arch, seed=2)
    layout = leaf_layout(model)
    cc = comp.CompressionConfig(rank=4, min_size=512)
    jcc = jcomp.CompressionConfig(rank=4, min_size=512)
    jstate = jcomp.init_state(params, jcc)
    st = _port_state(layout, jstate, cc)
    assert sorted(st["Q"]) == sorted(
        leaf.path for leaf, q in zip(layout, _jax_q(jstate))
        if not isinstance(q, tuple))
    rng = np.random.default_rng(4)
    for _ in range(2):          # the second step reads the error buffers
        grads = jax.tree.map(lambda x: jnp.asarray(
            rng.normal(size=x.shape).astype(np.float32)), params)
        jout, jstate, jstats = jcomp.compress_grads(grads, jstate, jcc)
        out, st, stats = comp.compress_grads(
            from_jax_params(jax.tree.map(np.asarray, grads), pc), st, cc,
            layout)
        _check_compressed(layout, jout, jstate, jstats, out, st, stats)


def _jax_case(G, cc_kw, steps):
    jcc = jcomp.CompressionConfig(**cc_kw)
    cc = comp.CompressionConfig(**cc_kw)
    jG = {k: jnp.asarray(v) for k, v in G.items()}
    layout = _flat_layout(G)
    jstate = jcomp.init_state(jG, jcc)
    st = _port_state(layout, jstate, cc)
    for _ in range(steps):
        jout, jstate, jstats = jcomp.compress_grads(jG, jstate, jcc)
        out, st, stats = comp.compress_grads(
            {k: torch.from_numpy(np.array(v)) for k, v in G.items()}, st, cc,
            layout)
        _check_compressed(layout, jout, jstate, jstats, out, st, stats)
    return out, st, stats


def test_compression_rank_r_exact_on_lowrank():
    rng = np.random.default_rng(0)
    P = rng.normal(size=(64, 4)).astype(np.float32)
    Q = rng.normal(size=(32, 4)).astype(np.float32)
    G = {"w": P @ Q.T}
    out, _, _ = _jax_case(G, {"rank": 4, "min_size": 0}, 2)
    np.testing.assert_allclose(out["w"].numpy(), G["w"], rtol=1e-3,
                               atol=1e-3)


def test_compression_error_feedback_accumulates():
    rng = np.random.default_rng(1)
    G = {"w": rng.normal(size=(64, 48)).astype(np.float32)}
    out, st, stats = _jax_case(G, {"rank": 2, "min_size": 0}, 1)
    np.testing.assert_allclose(out["w"].numpy() + st["err"]["w"].numpy(),
                               G["w"], atol=1e-4)
    assert float(stats["compress_ratio"]) > 5


def test_small_leaves_not_compressed():
    G = {"w": np.ones((4, 4), np.float32), "b": np.ones((4,), np.float32)}
    out, st, stats = _jax_case(G, {"rank": 2, "min_size": 1000}, 1)
    np.testing.assert_allclose(out["w"].numpy(), 1.0)
    assert float(stats["compress_ratio"]) == 1.0 and not st["Q"]


def test_compressed_training_still_converges():
    """The JAX package's fourth case, on the port alone: rank-8
    compressed grads with error feedback still learn (TINY, 30 steps)."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models.config import ModelConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    tiny = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=64,
                       num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=64,
                       dtype="float32")
    tc = TrainConfig(adamw=opt.AdamWConfig(lr=5e-3, warmup_steps=5,
                                           total_steps=50),
                     compression=comp.CompressionConfig(rank=8,
                                                        min_size=512))
    ds = SyntheticLMDataset(DataConfig(vocab_size=64, seq_len=32,
                                       global_batch=8))
    state = init_train_state(tiny, tc, device="cpu")
    step = make_train_step(tiny, tc)
    losses = []
    for i in range(30):
        state, m = step(state, ds.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.85
    assert float(m["compress_ratio"]) > 2


def test_qwen3_full_width_compress_ratio_is_the_jax_count():
    """At qwen3-0.6b's full width (shapes only, from ``jax.eval_shape``:
    the model itself is 2.4 GB), rank 8: 8 compressed leaves and 5 plain
    ones (the final norm, the stacked q/k norms and the two stacked
    block norms), the JAX package's 2384199680 / 41213952."""
    jc = jax_configs.get_config("qwen3-0.6b")
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jc))
    from repro_torch.models.convert import Leaf
    layout = [Leaf(_jax_path(p), (), False, tuple(x.shape))
              for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    cc = comp.CompressionConfig(rank=8)
    on = [leaf for leaf in layout if comp.compressed(leaf, cc)]
    assert len(on) == 8 and len(layout) - len(on) == 5
    full = sum(leaf.size for leaf in layout) * 4
    sent = sum((leaf.size if not comp.compressed(leaf, cc) else
                8 * sum(comp._mat_shape(leaf.shape))) for leaf in layout) * 4
    assert (full, sent) == (2384199680, 41213952)


_POD_RANKS = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch import configs
from repro_torch.core import collectives
from repro_torch.models import transformer as T
from repro_torch.models.convert import leaf_layout
from repro_torch.optim import compression as comp
from repro_torch.training import TrainConfig, init_train_state

dist.init_process_group("gloo")
mesh = init_device_mesh("cpu", (2, 1, 1),
                        mesh_dim_names=("pod", "data", "model"))
cfg = configs.smoke_config(configs.get_config("qwen3-0.6b"))
cc = comp.CompressionConfig(rank=4, min_size=512)
st = init_train_state(cfg, TrainConfig(compression=cc), device="cpu",
                      mesh=mesh)
layout = leaf_layout(st.model)
rng = np.random.default_rng(6)
grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
         for n, p in st.model.named_parameters()}
plain = leaf_layout(T.Transformer(cfg, torch.device("meta")))
want, wst, wstats = comp.compress_grads(
    grads, comp.init_state(plain, cc, "cpu"), cc, plain)
collectives.reset_record()
got, gst, stats = comp.compress_grads(grads, st.comp, cc, layout,
                                      plan=st.plan)
same = lambda a, b: sorted(a) == sorted(b) and all(
    torch.equal(a[k], b[k]) for k in a)
expect = []
for leaf in layout:
    if leaf.path in gst["Q"]:
        p, q = comp._mat_shape(leaf.shape)
        expect += [[p, 4], [q, 4]]
    else:
        expect.append(list(leaf.shape))
out = {"grads": same(got, want), "Q": same(gst["Q"], wst["Q"]),
       "err": same(gst["err"], wst["err"]),
       "ratio": [float(stats["compress_ratio"]),
                 float(wstats["compress_ratio"])],
       "shapes": [list(r["shape"]) for r in collectives.record],
       "expect": expect, "ops": sorted({r["op"] for r in collectives.record}),
       "axes": sorted({r["axes"] for r in collectives.record})}
if dist.get_rank() == 0:
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
dist.barrier()
dist.destroy_process_group()
"""


def test_compress_grads_over_a_group_all_reduces_the_factors(tmp_path):
    """Across ranks (``plan=``, two gloo ranks on a ``(2, 1, 1)`` pod x
    data x model mesh, the same gradients on both pods: the pods' mean
    is the value itself) the result is bitwise the one-process one, and
    the collectives are two all-reduces over ``pod`` a compressed leaf,
    of (p, r) and (q, r), and one a whole uncompressed leaf."""
    import json
    import os
    import subprocess
    import sys
    script, result = tmp_path / "ranks.py", tmp_path / "out.json"
    script.write_text(_POD_RANKS)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", str(script), str(result)],
        env=dict(os.environ, PYTHONPATH=os.path.join(repo, "src"),
                 OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-6000:]
    out = json.loads(result.read_text())
    assert out["grads"] and out["Q"] and out["err"]
    assert out["ratio"][0] == out["ratio"][1]
    assert out["shapes"] == out["expect"]
    assert out["ops"] == ["all_reduce"]
    # labelled with the leaf's sharded axes too, each of one rank here
    assert all("pod" in a.split("+") for a in out["axes"]), out["axes"]
