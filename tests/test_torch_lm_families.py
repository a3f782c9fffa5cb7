"""The six model families that are not plain attention text models, the
port against the JAX package on the CPU.

recurrentgemma-9b (RG-LRU + local attention), rwkv6-1.6b (RWKV-6),
grok-1-314b and llama4-scout-17b-a16e (the capacity MoE), llava-next-34b
(the VLM front end) and musicgen-large (the audio front end), each at
its ``smoke_config``, on the same weights: the JAX package's
``init_model`` draws them, every norm scale is moved off its zero init,
and ``models.convert.from_jax_params`` loads them into the port
(``strict=True``).  The port runs on the CPU (``device="cpu"``), where
the recurrences and the attention are their kernels' plain versions.

Checked, within the LM tests' limits (``tests/test_torch_lm.py``: 2e-3
in fp32, the JAX package's own decode-vs-forward limit; 5e-2 in bf16,
where the two frameworks round at other places): ``forward``;
``prefill`` (last logits and every cache leaf), each ``decode_step``
and the final cache (the local ring and the conv state wrap: the prompt
is longer than both), in fp32 greedily through ``launch/serve.py`` with
the tokens equal; ``loss_fn`` and its gradients (the MoE's aux, the VLM's dropped
patch positions, audio's (B, K, S) labels); the data pipeline's VLM and
audio batches bitwise; ``serve.main`` for each family.  For every one
of the ten architectures: ``leaf_layout`` lists the JAX package's
flattened tree (paths and shapes), ``from_jax_params`` loads it, and
``init_model`` draws each leaf from the JAX package's distribution
(constants equal; standard deviations within 5 % on leaves of at least
4096 elements, at a widened smoke config so that every such leaf is
large).  The MoE configs serve with ``capacity_factor`` 8 where decode
and prefill are compared, as ``tests/test_models.py:56-57`` does: at
the published factor a prefill can drop a token that a decode step
keeps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMDataset as JDataset
from repro.models import mlp as JM
from repro.models import transformer as JT
from repro_torch import configs
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import serve
from repro_torch.models import mlp as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import (_to_tensor, from_jax_params,
                                        gather, jax_layers, leaf_layout)

TOL = 2e-3
TOL_BF16 = 5e-2
B, P, STEPS = 2, 12, 6
FAMILIES = ["recurrentgemma-9b", "rwkv6-1.6b", "grok-1-314b",
            "llama4-scout-17b-a16e", "llava-next-34b", "musicgen-large"]


def _configs(arch, dtype="float32", **over):
    jc = jax_configs.smoke_config(jax_configs.get_config(arch))
    pc = configs.smoke_config(configs.get_config(arch))
    if pc.is_moe and "capacity_factor" not in over:
        over["capacity_factor"] = 8.0
    return (dataclasses.replace(jc, dtype=dtype, **over),
            dataclasses.replace(pc, dtype=dtype, **over))


def _models(arch, dtype="float32", seed=0, **over):
    """(JAX params, the port's model on the same weights, JAX cfg, cfg)."""
    jc, pc = _configs(arch, dtype, **over)
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


def _tokens(cfg, S, seed, batch=B):
    shape = ((batch, cfg.num_codebooks, S) if cfg.family == "audio"
             else (batch, S))
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _patches(cfg, seed):
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.patch_positions, cfg.d_model)).astype(np.float32)


def _jbatch(toks, patches):
    batch = {"tokens": jnp.asarray(toks)}
    if patches is not None:
        batch["patch_embeds"] = jnp.asarray(patches)
    return batch


def _t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
def test_forward_matches_jax(arch, dtype, tol):
    params, model, jc, pc = _models(arch, dtype)
    toks, pe = _tokens(pc, 16, 1), _patches(pc, 2)
    want, want_aux = JT.forward(params, jc, _jbatch(toks, pe))
    got = T.forward(model, _t(toks), patch_embeds=_t(pe))
    S = 16 + (pc.patch_positions if pc.family == "vlm" else 0)
    shape = ((B, S, pc.num_codebooks, pc.vocab_size)
             if pc.family == "audio" else (B, S, pc.vocab_size))
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=tol, atol=tol)


def _decode_tokens(logits):
    """The next tokens of (B, V) (audio (B, K, V)) logits, as decode
    takes them: (B, 1) (audio (B, K, 1))."""
    return jnp.argmax(logits, axis=-1)[..., None]


def _jax_serve(params, jc, prompt, patches, feed):
    """The JAX package's prefill, then one decode step per entry of
    ``feed`` (None: the greedy pick), as ``repro/launch/serve.py`` runs
    them.  Returns [(logits, cache)] + [(logits, cache, token)]."""
    Pp = jc.patch_positions if jc.family == "vlm" else 0
    cache = JT.init_cache(jc, B, P + STEPS + Pp)
    logits, cache = jax.jit(lambda p, b, c: JT.prefill(p, jc, b, c))(
        params, _jbatch(prompt, patches), cache)
    decode = jax.jit(lambda p, c, t, pos: JT.decode_step(p, jc, c, t, pos))
    out = [(logits, cache)]
    for i, tok in enumerate(feed):
        nxt = _decode_tokens(logits) if tok is None else jnp.asarray(tok)
        logits, cache = decode(params, cache, nxt, jnp.int32(Pp + P + i))
        out.append((logits, cache, nxt))
    return out


def _check_cache(jax_cache, cache, pc, tol, rows):
    """Every leaf of every layer's cache, the batch ``rows`` of those
    with a batch axis (all but the slots' positions)."""
    layers = jax_layers(jax.tree.map(np.asarray, jax_cache), pc)
    assert len(layers) == len(cache) == pc.num_layers
    for want, got in zip(layers, cache):
        assert set(got) == set(want)
        for key, t in got.items():
            assert tuple(t.shape) == want[key].shape, key
            if not t.is_floating_point():
                np.testing.assert_array_equal(t.numpy(), want[key])
                continue
            assert str(t.dtype).split(".")[-1] == str(want[key].dtype), key
            np.testing.assert_allclose(t.float().numpy()[rows],
                                       _np(want[key])[rows], rtol=tol,
                                       atol=tol, err_msg=key)


def _record_routes(monkeypatch):
    """Record every MoE call's expert choices on both sides, in call
    order: (port's, JAX's, JAX's top-k margins), each a list of (B, S, k)
    / (B, S) arrays."""
    port, jax_ids, margins = [], [], []
    route = M.moe_route

    def port_route(p, cfg, x):
        out = route(p, cfg, x)
        port.append(out["experts"].view(*x.shape[:2], -1).numpy())
        return out

    local = JM._moe_local

    def jax_local(x, router, *args, cfg, **kw):
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
        top = jax.lax.top_k(probs, cfg.experts_per_token + 1)
        jax_ids.append(np.asarray(top[1][..., :-1]))
        margins.append(np.asarray(top[0][..., -2] - top[0][..., -1]))
        return local(x, router, *args, cfg=cfg, **kw)

    monkeypatch.setattr(M, "moe_route", port_route)
    monkeypatch.setattr(JM, "_moe_local", jax_local)
    return port, jax_ids, margins


def _unflipped_rows(routes, calls_a_step, steps):
    """The batch rows to compare after each of ``steps`` + 1 serving
    steps (the prefill first): a row whose expert choices ever differed
    between the two sides is dropped from then on.  Holds the drops to
    one row at most, each differing choice a near-tie on the JAX side."""
    port, theirs, margins = routes
    assert len(port) == len(theirs) == calls_a_step * (steps + 1)
    rows, out = set(range(B)), []
    for c, (a, b, m) in enumerate(zip(port, theirs, margins)):
        differ = (np.sort(a, -1) != np.sort(b, -1)).any(-1)     # (B, S)
        assert (m[differ] < 2e-2).all(), m[differ]
        rows -= set(np.nonzero(differ.any(-1))[0].tolist())
        if c % calls_a_step == calls_a_step - 1:
            out.append(sorted(rows))
    assert len(rows) >= B - 1, "routing differs in more than one row"
    return out


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
def test_prefill_and_decode_match_jax(arch, dtype, tol, monkeypatch):
    """fp32: greedy decoding, the tokens equal.  bf16: both fed the same
    tokens, the JAX package's functions run op by op
    (``jax.disable_jit``), each bf16 op rounded as its source writes it,
    as the port rounds (jitted on the CPU, XLA's fusions keep some bf16
    chains in fp32 and use their own exp/log approximations, a
    difference as large as bf16's own from fp32 at these logits; RG-LRU's
    block is bitwise the port's op by op).  A bf16 MoE can pick other
    experts for a token whose router is near a tie: the two sides'
    choices are recorded call by call (``_unflipped_rows``)."""
    params, model, jc, pc = _models(arch, dtype, seed=2)
    prompt, pe = _tokens(pc, P, 3), _patches(pc, 4)
    greedy = dtype == "float32"
    routes = (_record_routes(monkeypatch) if pc.is_moe and not greedy
              else None)
    if greedy:
        feed = [None] * STEPS
        ref = _jax_serve(params, jc, prompt, pe, feed)
    else:
        feed = [t[..., None]
                for t in np.moveaxis(_tokens(pc, STEPS, 5), -1, 0)]
        with jax.disable_jit():
            ref = _jax_serve(params, jc, prompt, pe, feed)

    logits, cache, _ = serve.serve_prefill(model, _t(prompt), P + STEPS,
                                           patch_embeds=_t(pe))
    outs = [logits]
    first = [{k: t.clone() for k, t in c.items()} for c in cache]
    start = serve.decode_start(pc, P)
    for i, tok in enumerate(feed):
        if greedy:
            tok = torch.argmax(logits, dim=-1)[..., None]
            np.testing.assert_array_equal(tok.numpy(),
                                          np.asarray(ref[i + 1][2]))
        else:
            tok = torch.from_numpy(tok)
        logits, cache = T.decode_step(model, cache, tok, start + i)
        outs.append(logits)
    rows = (_unflipped_rows(routes, pc.num_layers, STEPS) if routes
            else [list(range(B))] * (STEPS + 1))
    for i, got in enumerate(outs):
        np.testing.assert_allclose(got.numpy()[rows[i]],
                                   _np(ref[i][0])[rows[i]], rtol=tol,
                                   atol=tol, err_msg=f"step {i}")
    _check_cache(ref[0][1], first, pc, tol, rows[0])
    _check_cache(ref[-1][1], cache, pc, tol, rows[-1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_matches_forward(arch):
    """The port against itself: the cached path's last logits equal the
    full forward's (``tests/test_models.py:52``)."""
    _, model, _, pc = _models(arch, seed=9)
    toks, pe = torch.from_numpy(_tokens(pc, 16, 10)), _t(_patches(pc, 11))
    full = T.forward(model, toks, patch_embeds=pe)
    cache = T.init_cache(pc, B, 32, device="cpu")
    _, cache = T.prefill(model, toks[..., :15], cache, patch_embeds=pe)
    got, _ = T.decode_step(model, cache, toks[..., 15:],
                           serve.decode_start(pc, 15))
    torch.testing.assert_close(got, full[:, -1], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# training: loss and gradients on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_gradients_match_jax(arch):
    over = {"capacity_factor": 0.75} if "grok" in arch or "llama4" in arch \
        else {}
    params, model, jc, pc = _models(arch, seed=12, **over)
    toks = _tokens(pc, 16, 13)
    labels = _tokens(pc, 16, 14)
    batch = {"tokens": toks, "labels": labels}
    pe = _patches(pc, 15)
    if pe is not None:
        batch["patch_embeds"] = pe
    (want, want_m), want_g = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jc, {k: jnp.asarray(v)
                                     for k, v in batch.items()}),
        has_aux=True)(params)
    total, m = T.loss_fn(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    total.backward()
    np.testing.assert_allclose(float(total), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(want_m["aux"]),
                               rtol=1e-5, atol=1e-7)
    if pc.is_moe:
        assert float(m["aux"]) > 0
    grads = from_jax_params(jax.tree.map(np.asarray, want_g), pc)
    for name, p in model.named_parameters():
        scale = float(grads[name].abs().max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy() / scale,
                                   grads[name].numpy() / scale, rtol=0,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("family,extra", [("vlm", {"patch_positions": 5,
                                                   "d_model": 12}),
                                          ("audio", {"num_codebooks": 4})])
@pytest.mark.parametrize("step", [0, 7])
def test_data_pipeline_families_are_bitwise_the_jax_packages(family, extra,
                                                            step):
    kw = dict(vocab_size=50, seq_len=9, global_batch=3, seed=11,
              family=family, **extra)
    a = SyntheticLMDataset(DataConfig(**kw)).batch(step)
    b = JDataset(JDataConfig(**kw)).batch(step)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_main_runs_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "10", "--tokens", "3"])
    cfg = configs.smoke_config(configs.get_config(arch))
    want = (2, cfg.num_codebooks, 3) if cfg.family == "audio" else (2, 3)
    assert tuple(out["tokens"].shape) == want
    assert int(out["tokens"].min()) >= 0
    assert int(out["tokens"].max()) < cfg.vocab_size
    assert "prefill(10 tok x2)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# every architecture: the parameter tree and its distributions
# ---------------------------------------------------------------------------

def _flat_jax(params):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = leaf
    return out


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_leaf_layout_is_the_jax_tree(arch):
    jc = jax_configs.smoke_config(jax_configs.get_config(arch))
    pc = configs.smoke_config(configs.get_config(arch))
    params = JT.init_model(jax.random.PRNGKey(0), jc)
    model = T.init_model(pc, device="cpu")
    flat = _flat_jax(params)
    layout = leaf_layout(model)
    assert [leaf.path for leaf in layout] == list(flat)
    assert [leaf.shape for leaf in layout] == [v.shape for v in flat.values()]
    state = from_jax_params(jax.tree.map(np.asarray, params), pc)
    model.load_state_dict(state, strict=True)
    tensors = dict(model.named_parameters())
    for leaf in layout:                      # carried across bit for bit
        want = _to_tensor(np.asarray(flat[leaf.path]))
        got = gather(leaf, tensors).detach()
        assert got.dtype == want.dtype, leaf.path
        assert torch.equal(got.view(torch.int16) if got.dtype ==
                           torch.bfloat16 else got, want.view(torch.int16)
                           if want.dtype == torch.bfloat16 else want), \
            leaf.path


def _stats(x):
    x = np.asarray(jnp.asarray(x, jnp.float32), np.float64)
    return x.size, float(x.std()), float(x.min()), float(x.max())


@pytest.mark.parametrize("arch", jax_configs.list_archs())
def test_init_distributions_match_jax(arch):
    over = dict(d_model=256, d_ff=384, rnn_width=192, head_dim=32,
                rwkv_head_dim=32, vocab_size=512)
    jc = dataclasses.replace(
        jax_configs.smoke_config(jax_configs.get_config(arch)), **over)
    pc = dataclasses.replace(
        configs.smoke_config(configs.get_config(arch)), **over)
    flat = _flat_jax(JT.init_model(jax.random.PRNGKey(0), jc))
    model = T.init_model(pc, seed=0, device="cpu")
    tensors = dict(model.named_parameters())
    big = 0
    for leaf in leaf_layout(model):
        n, sd_j, lo_j, hi_j = _stats(flat[leaf.path])
        t = gather(leaf, tensors)
        _, sd_p, lo_p, hi_p = _stats(t.detach().float().numpy())
        assert str(t.dtype).split(".")[-1] == str(flat[leaf.path].dtype)
        if sd_j == 0:                        # a constant leaf
            assert sd_p == 0 and lo_p == lo_j and hi_p == hi_j, leaf.path
        elif n >= 4096:
            big += 1
            assert abs(sd_p / sd_j - 1) <= 0.05, (leaf.path, sd_p, sd_j)
        else:
            assert sd_p > 0, leaf.path
    assert big >= 3
