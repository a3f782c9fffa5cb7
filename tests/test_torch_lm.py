"""The port's LM serving path against the JAX package's model.

Both packages run the same weights: the JAX package's ``init_model``
draws them, every norm scale is moved off its zero init (so a missing
``1 + scale`` shows), and ``repro_torch.models.convert.from_jax_params``
loads the numpy tree into the port's modules.  The port runs on the CPU
(``device="cpu"``), where its prefill attention is the plain version of
the ``local_attention`` kernel.

gemma2-9b's smoke config (2 layers, local + global, window 8, soft-caps,
sandwich norms, GeGLU) is checked in fp32 through ``forward``,
``prefill`` (last logits and every cache tensor) with a prompt of 12 >
8 tokens, eight ``decode_step`` calls (the local ring buffer wraps) and
the greedy tokens of the serve loop, within the JAX package's own
decode-vs-forward limit, 2e-3 (``tests/test_models.py:83-84``).  The
other dense attention archs (qk-norm, SwiGLU, the plain GELU FFN,
untied heads) are checked through ``forward``.

In bf16 the two packages round at different places (the JAX package
rounds the attention probabilities to bf16 before the V product, the
kernel's plain version sums them in fp32; XLA and PyTorch fuse the
elementwise ops differently), so the bf16 smoke model is held to 5e-2,
the JAX package's own bf16 limit for this kernel
(``tests/test_kernels.py:221-222``).

The configs: ``param_count()`` and ``smoke_config`` of all ten archs
equal to the JAX package's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params, jax_layers

TOL = 2e-3
TOL_BF16 = 5e-2
B, P, STEPS = 2, 12, 8
DENSE_ARCHS = ["gemma2-9b", "yi-6b", "qwen3-0.6b", "starcoder2-15b"]


def _configs(arch, dtype="float32"):
    jc = jax_configs.smoke_config(jax_configs.get_config(arch))
    pc = configs.smoke_config(configs.get_config(arch))
    return (dataclasses.replace(jc, dtype=dtype),
            dataclasses.replace(pc, dtype=dtype))


def _models(arch, dtype="float32", seed=0):
    """(JAX params, the port's model on the same weights, JAX cfg, cfg)."""
    jc, pc = _configs(arch, dtype)
    params = JT.init_model(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        if getattr(path[-1], "key", None) == "scale":
            return x + jnp.asarray(rng.normal(0, 0.5, x.shape), x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = T.Transformer(pc, device="cpu")
    model.load_state_dict(
        from_jax_params(jax.tree.map(np.asarray, params), pc), strict=True)
    return params, model, jc, pc


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_forward_matches_jax(arch):
    params, model, jc, pc = _models(arch)
    toks = _tokens(pc, (B, 16), 1)
    want, _ = JT.forward(params, jc, {"tokens": jnp.asarray(toks)})
    got = T.forward(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, 16, pc.vocab_size)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=TOL, atol=TOL)


def _jax_serve(params, jc, prompt, steps_tokens):
    """The JAX package's prefill, then one decode step per given token
    (None: the greedy pick), as ``repro/launch/serve.py`` runs them."""
    cache = JT.init_cache(jc, B, P + STEPS)
    logits, cache = jax.jit(lambda p, b, c: JT.prefill(p, jc, b, c))(
        params, {"tokens": jnp.asarray(prompt)}, cache)
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jc, c, t, pos))
    out = [(logits, cache)]
    for i, tok in enumerate(steps_tokens):
        nxt = jnp.argmax(logits, axis=-1) if tok is None else jnp.asarray(tok)
        logits, cache = decode(params, cache, nxt.reshape(B, 1),
                               jnp.int32(P + i))
        out.append((logits, cache, nxt))
    return out


def _check_cache(jax_cache, cache, pc, tol):
    layers = jax_layers(jax.tree.map(np.asarray, jax_cache), pc)
    assert len(layers) == len(cache) == pc.num_layers
    for want, got in zip(layers, cache):
        np.testing.assert_array_equal(got["pos"].numpy(), want["pos"])
        for key in ("k", "v"):
            assert got[key].dtype == getattr(torch, pc.dtype)
            np.testing.assert_allclose(got[key].float().numpy(),
                                       _np(want[key]), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
def test_prefill_and_decode_match_jax(dtype, tol):
    params, model, jc, pc = _models("gemma2-9b", dtype)
    prompt = _tokens(pc, (B, P), 2)
    feed = _tokens(pc, (STEPS, B), 3)
    ref = _jax_serve(params, jc, prompt, list(feed))

    cache = T.init_cache(pc, B, P + STEPS, device="cpu")
    logits, cache = T.prefill(model, torch.from_numpy(prompt), cache)
    np.testing.assert_allclose(logits.numpy(), _np(ref[0][0]), rtol=tol,
                               atol=tol)
    _check_cache(ref[0][1], cache, pc, tol)
    assert [int(c["pos"].max()) for c in cache] == [P - 1, P - 1]
    assert [c["k"].shape[1] for c in cache] == [pc.window, P + STEPS]

    for i, tok in enumerate(feed):
        logits, cache = T.decode_step(model, cache,
                                      torch.from_numpy(tok)[:, None], P + i)
        np.testing.assert_allclose(logits.numpy(), _np(ref[i + 1][0]),
                                   rtol=tol, atol=tol)
    _check_cache(ref[-1][1], cache, pc, tol)
    # the local ring buffer wrapped: it holds the last `window` positions
    assert sorted(cache[0]["pos"].tolist()) == list(
        range(P + STEPS - pc.window, P + STEPS))


def test_greedy_serve_tokens_match_jax():
    params, model, jc, pc = _models("gemma2-9b", seed=4)
    prompt = _tokens(pc, (B, P), 5)
    ref = _jax_serve(params, jc, prompt, [None] * STEPS)
    want = np.stack([np.asarray(r[2]) for r in ref[1:]], axis=1)

    logits, cache, _ = serve.serve_prefill(model, torch.from_numpy(prompt),
                                           P + STEPS)
    tokens, last, _ = serve.serve_decode(model, cache, logits, P, STEPS)
    np.testing.assert_array_equal(tokens.numpy(), want)
    np.testing.assert_allclose(last.numpy(), _np(ref[-1][0]), rtol=TOL,
                               atol=TOL)


def test_decode_matches_forward():
    """The port against itself: the cached path's last logits equal the
    full forward's (``tests/test_models.py:61``, on the kernel's side)."""
    _, model, _, pc = _models("gemma2-9b", seed=6)
    toks = torch.from_numpy(_tokens(pc, (B, 16), 7))
    full = T.forward(model, toks)
    cache = T.init_cache(pc, B, 32, device="cpu")
    _, cache = T.prefill(model, toks[:, :15], cache)
    got, _ = T.decode_step(model, cache, toks[:, 15:], 15)
    torch.testing.assert_close(got, full[:, -1], rtol=TOL, atol=TOL)
    no_cache, _ = T.prefill(model, toks, None)
    torch.testing.assert_close(no_cache, full[:, -1], rtol=1e-5, atol=1e-5)


def test_serve_main_runs_on_the_cpu(capsys):
    out = serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--tokens", "3"])
    assert out["tokens"].shape == (2, 3)
    assert "prefill(10 tok x2)" in capsys.readouterr().out
    sampled = serve.main(["--arch", "gemma2-9b", "--smoke", "--device",
                          "cpu", "--batch", "2", "--prompt-len", "10",
                          "--tokens", "3", "--temperature", "0.7"])
    assert sampled["tokens"].shape == (2, 3)


def test_init_model_is_seeded():
    _, pc = _configs("gemma2-9b")
    a = T.init_model(pc, seed=3, device="cpu")
    b = T.init_model(pc, seed=3, device="cpu")
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert float(a.layers[0].norm1.scale.abs().max()) == 0.0
    assert abs(float(a.layers[0].mix.wq.std()) - pc.d_model ** -0.5) < 0.02


@pytest.mark.parametrize("arch,build", [
    ("gemma2-9b", lambda cfg, **kw: T.Transformer(cfg, **kw)),
    ("gemma2-9b", lambda cfg, **kw: T.Layer(cfg, "local", **kw)),
    ("gemma2-9b", lambda cfg, **kw: L.Attention(cfg, **kw)),
    ("gemma2-9b", lambda cfg, **kw: M.MLP(cfg, **kw)),
    ("gemma2-9b", lambda cfg, **kw: L.RMSNorm(cfg.d_model, cfg.norm_eps,
                                              **kw)),
    ("recurrentgemma-9b", lambda cfg, **kw: T.Layer(cfg, "rglru", **kw)),
    ("recurrentgemma-9b", lambda cfg, **kw: R.RGLRUBlock(cfg, **kw)),
    ("rwkv6-1.6b", lambda cfg, **kw: T.Layer(cfg, "rwkv", **kw)),
    ("rwkv6-1.6b", lambda cfg, **kw: R.RWKVBlock(cfg, **kw)),
    ("grok-1-314b", lambda cfg, **kw: M.MoE(cfg, **kw)),
    ("musicgen-large", lambda cfg, **kw: T.Transformer(cfg, **kw)),
    ("llava-next-34b", lambda cfg, **kw: T.Transformer(cfg, **kw)),
], ids=["Transformer", "Layer", "Attention", "MLP", "RMSNorm", "Layer-rglru",
        "RGLRUBlock", "Layer-rwkv", "RWKVBlock", "MoE", "Transformer-audio",
        "Transformer-vlm"])
def test_constructors_build_on_the_card_by_default(arch, build):
    """``device=None`` is the card, as for ``init_model``: without one a
    bare constructor raises instead of building on the CPU."""
    cfg = configs.smoke_config(configs.get_config(arch))
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in build(cfg).parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(cfg)
    params = list(build(cfg, device="cpu").parameters())
    assert params and all(p.device.type == "cpu" for p in params)


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_configs_match_jax(arch):
    jc, pc = jax_configs.get_config(arch), configs.get_config(arch)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)
    assert pc.param_count() == jc.param_count()
    assert pc.active_param_count() == jc.active_param_count()
    assert dataclasses.asdict(configs.smoke_config(pc)) == dataclasses.asdict(
        jax_configs.smoke_config(jc))
    for shape in jax_configs.SHAPES:
        assert configs.cell_applicable(pc, shape) == \
            jax_configs.cell_applicable(jc, shape)


def test_registry_matches_jax():
    assert configs.list_archs() == jax_configs.list_archs()
    assert configs.ARCH_MODULES == jax_configs.ARCH_MODULES
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
