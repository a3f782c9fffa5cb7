"""The port's logical-axis rules (``repro_torch.sharding``) against the
JAX package's (``repro.sharding``).

* The eight cases of ``tests/test_sharding.py``, against the port's
  ``resolve_spec`` (which returns the ``PartitionSpec``'s entries as a
  plain tuple), on the JAX package's ``AbstractMesh`` and on a dict of
  axis sizes.
* For every parameter of the ten archs' published configs, on the
  ``(16, 16)`` and ``(2, 16, 16)`` production meshes: the port's spec
  (``models.transformer.resolved_specs``) equals the JAX package's
  ``resolve_spec(model_specs(cfg), AbstractMesh, shape)`` of the leaf the
  parameter belongs to (``models.convert.leaf_layout``; a stacked leaf's
  leading ``"layers"`` entry, never sharded, dropped).  No ranks: both
  sides resolve names and sizes only.
"""
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jax_configs
from repro import sharding as JSh
from repro.compat import AbstractMesh
from repro.models import transformer as JT
from repro_torch import configs, sharding as Sh
from repro_torch.models import transformer as T
from repro_torch.models.convert import leaf_layout

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _mesh():
    return AbstractMesh((16, 16), ("data", "model"))


def _spec(p: P) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("mesh", [_mesh(), {"data": 16, "model": 16}],
                         ids=["abstract", "dict"])
def test_basic_resolution(mesh):
    assert Sh.resolve_spec(("batch", None, "mlp"), mesh) == ("data", None,
                                                             "model")
    assert Sh.resolve_spec(("vocab", "embed_p"), mesh) == ("model", "data")


def test_divisibility_fallback():
    m = _mesh()
    assert Sh.resolve_spec(("batch", None, "kv_heads", None), m,
                           (256, 4, 8, 16)) == ("data",)
    assert Sh.resolve_spec(("batch", None, "kv_heads", None), m,
                           (256, 4, 32, 16)) == ("data", None, "model")


def test_missing_axis_dropped():
    assert Sh.resolve_spec(("batch",), _mesh(), (256,)) == ("data",)


def test_multipod_batch_axes():
    m = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert Sh.resolve_spec(("batch", None), m, (256, 4096)) == (
        ("pod", "data"),)


def test_no_double_axis_use():
    assert Sh.resolve_spec(("mlp", "heads"), _mesh(), (64, 64)) == (
        "model",)


def test_rules_override_context():
    m = _mesh()
    with Sh.rules({"mlp": "data"}):
        assert Sh.resolve_spec((None, "mlp"), m, (4, 64)) == (None, "data")
    assert Sh.resolve_spec((None, "mlp"), m, (4, 64)) == (None, "model")


def test_trailing_nones_trimmed():
    assert Sh.resolve_spec(("batch", None, None), _mesh(),
                           (256, 2, 2)) == ("data",)


def test_cache_seq_prioritized_over_kv_heads():
    assert Sh.resolve_spec(("batch", "cache_seq", None, None), _mesh(),
                           (128, 32768, 8, 128)) == ("data", "model")


def test_default_rules_are_the_jax_packages():
    assert Sh.DEFAULT_RULES == JSh.DEFAULT_RULES


def test_local_shape_and_placements():
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    sizes = {"pod": 2, "data": 4, "model": 2}
    spec = Sh.resolve_spec(("embed_p", "heads", "qkv"), sizes, (64, 8, 16))
    assert spec == ("data", "model")
    assert Sh.local_shape((64, 8, 16), spec, sizes) == (16, 4, 16)
    assert [type(p).__name__ for p in Sh.placements(spec, mesh)] == [
        "Replicate", "Shard", "Shard"]
    assert [getattr(p, "dim", None) for p in Sh.placements(spec, mesh)] == [
        None, 0, 1]


def _jax_leaf_specs(cfg, mesh) -> dict:
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0),
                                                  cfg))
    specs = JT.model_specs(cfg)
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        shapes, is_leaf=lambda x: hasattr(x, "shape"))[0]
    spec_of = dict(jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, tuple))[0])
    for path, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = _spec(JSh.resolve_spec(tuple(spec_of[path]), mesh,
                                          tuple(leaf.shape)))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", configs.list_archs())
def test_every_parameter_spec_is_the_jax_packages(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, names)
    want = _jax_leaf_specs(jax_configs.get_config(arch), jmesh)
    cfg = configs.get_config(arch)
    got = T.resolved_specs(cfg, dict(zip(names, shape)))
    layout = leaf_layout(T.Transformer(cfg, torch.device("meta")))
    assert {leaf.path for leaf in layout} == set(want)
    sharded = 0
    for leaf in layout:
        w = want[leaf.path]
        if leaf.stacked:
            assert w[:1] in ((), (None,)), (leaf.path, w)
            w = w[1:]
        for name in leaf.names:
            assert got[name] == w, (leaf.path, name, got[name], w)
        sharded += any(e is not None for e in w)
    assert sharded > 0


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "recurrentgemma-9b"])
def test_train_state_specs_are_the_jax_packages(arch):
    """``training.train_state_specs`` against the JAX package's, leaf for
    leaf through ``leaf_layout``: the parameters and both moments, and
    with compression ``Q`` replicated and ``err`` its leaf's spec."""
    from repro.optim.compression import CompressionConfig as JComp
    from repro.training import TrainConfig as JTC
    from repro.training.train import train_state_specs as jspecs
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import TrainConfig
    from repro_torch.training.train import train_state_specs
    cfg = configs.smoke_config(configs.get_config(arch))
    got = train_state_specs(cfg, TrainConfig(
        compression=CompressionConfig(enabled=True, min_size=512)))
    want = jspecs(jax_configs.smoke_config(jax_configs.get_config(arch)),
                  JTC(compression=JComp(enabled=True, min_size=512)))
    flat = lambda tree: {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
        tuple(v) for path, v in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))[0]}
    layout = leaf_layout(T.Transformer(cfg, torch.device("meta")))
    for part in (want.params, want.opt["m"], want.opt["v"]):
        spec = flat(part)
        for leaf in layout:
            w = spec[leaf.path][1:] if leaf.stacked else spec[leaf.path]
            assert all(tuple(got["params"][n]) == w for n in leaf.names)
    assert got["opt"]["count"] == () and got["step"] == ()
    err = flat(want.params)
    assert got["comp"]["err"] and set(got["comp"]["err"]) <= set(err)
    for path, spec in got["comp"]["err"].items():
        assert spec == err[path], path
        assert got["comp"]["Q"][path] == (None, None)
