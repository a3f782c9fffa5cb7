"""The recurrences' gradients: the port's plain reverse loops against the
JAX package's autodiff, on the CPU.

``ref.rglru_scan_bwd_ref`` and ``ref.wkv6_bwd_ref`` are what the card's
backward kernels (``csrc/rglru_scan.cu``, ``csrc/wkv6.cu``) are held to
bit for bit (RG-LRU's da, db, dh0; RWKV-6's dS0) or within a limit
(``tests/test_torch_cuda.py``).  Here they are held against ``jax.vjp``
of ``repro.models.recurrent._rglru_scan`` (an associative scan) and
``_wkv_scan`` (a ``lax.scan``) on the same numpy inputs, with cotangents
for the output and the last state (RG-LRU's last state is ``h[:, -1]``:
its cotangent adds to the output's last step), with and without an
initial state (the JAX functions take zeros where the port takes None),
at T = 1 and at ragged T, at hd 8 and 16, and at decays below 1e-30; and
against autograd of the port's plain forward loops.  Each gradient
within 1e-5 of its own largest magnitude, the forwards' limit
(``TOL_SCAN`` in ``tests/test_torch_recurrent.py``): the loops, XLA's
scans and autograd sum in other orders.  On the CPU the ``ops``
wrappers run these loops.

Also: rwkv6-1.6b's ``compress_ratio`` at full width (rank 8), the count
``chip_smoke.py`` holds the card's compressed steps to, computed from
the JAX package's compression state and from the port's rule on the
same leaves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import recurrent as JR
from repro.models import transformer as JT
from repro.optim import compression as jcomp
from repro_torch.kernels import ops, ref
from repro_torch.optim import compression as comp

TOL = 1e-5


def _within(got, want, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= TOL * scale, (
        name, np.abs(got - want).max(), scale)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _rglru_inputs(rng, B, T, R):
    a = rng.uniform(0.5, 0.999, (B, T, R)).astype(np.float32)
    b = rng.standard_normal((B, T, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    g = rng.standard_normal((B, T, R)).astype(np.float32)
    gT = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, h0, g, gT


@pytest.mark.parametrize("B,T,R", [(2, 37, 24), (1, 1, 8), (3, 130, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_ref_matches_jax_vjp(B, T, R, with_h0):
    a, b, h0, g, gT = _rglru_inputs(np.random.default_rng(B * T + R), B, T,
                                    R)
    h0 = h0 if with_h0 else None

    def f(a, b, h0):
        h = JR._rglru_scan(a, b, h0)
        return h, h[:, -1]
    args = (jnp.asarray(a), jnp.asarray(b),
            None if h0 is None else jnp.asarray(h0))
    (h, _), vjp = jax.vjp(f, *args)
    want = vjp((jnp.asarray(g), jnp.asarray(gT)))
    dh = g.copy()
    dh[:, -1] += gT
    got = ref.rglru_scan_bwd_ref(_t(a), _t(np.asarray(h)), _t(h0), _t(dh))
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        if y is None:
            assert x is None
        else:
            _within(x.numpy(), y, name)


@pytest.mark.parametrize("B,T,R", [(2, 37, 24), (1, 1, 8), (3, 130, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_ref_matches_autograd_of_the_loop(B, T, R, with_h0):
    a, b, h0, g, _ = _rglru_inputs(np.random.default_rng(B + T + R), B, T,
                                   R)
    xs = [_t(x).requires_grad_() for x in ((a, b, h0) if with_h0
                                           else (a, b))]
    h = ref.rglru_scan_ref(*xs)
    want = torch.autograd.grad(h, xs, _t(g))
    got = ref.rglru_scan_bwd_ref(xs[0].detach(), h.detach(),
                                 xs[2].detach() if with_h0 else None, _t(g))
    assert (got[2] is None) == (not with_h0)
    for x, y in zip(got, want):
        _within(x.numpy(), y.numpy())


def _wkv_inputs(rng, B, T, H, hd, decay):
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    if decay == "strong":       # all below 1e-30, some subnormal
        w = np.exp(-80.0 - 10.0 * rng.random((B, T, H, hd)))
    else:
        w = np.exp(-np.exp(rng.normal(-2.0, 0.5, (B, T, H, hd))))
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    do = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    dS = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, S0, do, dS


WKV_CASES = [(2, 33, 3, 16), (1, 1, 2, 8), (2, 45, 2, 8)]


@pytest.mark.parametrize("B,T,H,hd", WKV_CASES)
@pytest.mark.parametrize("with_s0,with_ds", [(False, False), (True, True),
                                             (True, False)])
@pytest.mark.parametrize("decay", ["usual", "strong"])
def test_wkv6_bwd_ref_matches_jax_vjp(B, T, H, hd, with_s0, with_ds, decay):
    r, k, v, w, u, S0, do, dS = _wkv_inputs(
        np.random.default_rng(T * hd + B), B, T, H, hd, decay)
    S0 = S0 if with_s0 else np.zeros_like(S0)
    dS = dS if with_ds else np.zeros_like(dS)
    _, vjp = jax.vjp(JR._wkv_scan, *(jnp.asarray(x)
                                     for x in (r, k, v, w, u, S0)))
    want = vjp((jnp.asarray(do), jnp.asarray(dS)))
    got = ref.wkv6_bwd_ref(*(_t(x) for x in (r, k, v, w, u)),
                           _t(S0) if with_s0 else None, _t(do),
                           _t(dS) if with_ds else None)
    for name, x, y in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got, want):
        _within(x.numpy(), y, name)


@pytest.mark.parametrize("B,T,H,hd", WKV_CASES)
@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("decay", ["usual", "strong"])
def test_wkv6_bwd_ref_matches_autograd_of_the_loop(B, T, H, hd, with_s0,
                                                   decay):
    r, k, v, w, u, S0, do, dS = _wkv_inputs(
        np.random.default_rng(T + hd + B), B, T, H, hd, decay)
    xs = [_t(x).requires_grad_() for x in (r, k, v, w, u)]
    s0 = _t(S0).requires_grad_() if with_s0 else None
    out, S_T = ref.wkv6_ref(*xs, s0)
    want = torch.autograd.grad((out, S_T), xs + ([s0] if with_s0 else []),
                               (_t(do), _t(dS)))
    got = ref.wkv6_bwd_ref(*(x.detach() for x in xs),
                           None if s0 is None else s0.detach(), _t(do),
                           _t(dS))
    for x, y in zip(got, want):
        _within(x.numpy(), y.numpy())


def test_the_wrappers_run_the_plain_loops_on_the_cpu():
    """``ops.rglru_scan_bwd`` / ``ops.wkv6_bwd`` on CPU tensors are the
    plain loops, bit for bit, and count no launch."""
    rng = np.random.default_rng(3)
    a, b, h0, g, _ = (_t(x) for x in _rglru_inputs(rng, 2, 9, 6))
    h = ref.rglru_scan_ref(a, b, h0)
    ops.reset_launches()
    for x, y in zip(ops.rglru_scan_bwd(a, h, h0, g),
                    ref.rglru_scan_bwd_ref(a, h, h0, g)):
        assert torch.equal(x, y)
    r, k, v, w, u, S0, do, dS = (_t(x) for x in _wkv_inputs(
        rng, 2, 7, 2, 8, "usual"))
    for x, y in zip(ops.wkv6_bwd(r, k, v, w, u, S0, do, dS, states=None),
                    ref.wkv6_bwd_ref(r, k, v, w, u, S0, do, dS)):
        assert torch.equal(x, y)
    assert not any(ops.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "shape", "dout", "dS_T"])
def test_the_backward_operands_are_checked(bad):
    r, k, v, w, u, S0, do, dS = (_t(x) for x in _wkv_inputs(
        np.random.default_rng(4), 1, 3, 2, 8, "usual"))
    if bad == "dtype":
        r = r.double()
    elif bad == "shape":
        u = u[:, :4]
    elif bad == "dout":
        do = do[:, :2]
    else:
        dS = dS[..., :4]
    with pytest.raises(ValueError):
        ops.wkv6_bwd(r, k, v, w, u, S0, do, dS, states=None)
    a = torch.rand((2, 3, 4))
    with pytest.raises(ValueError):
        ops.rglru_scan_bwd(a, a, None, a[:, :2] if bad == "shape" else
                           a.double())


def _jax_path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def test_rwkv6_full_width_compress_ratio_is_the_jax_count():
    """At rwkv6-1.6b's full width (shapes only, from ``jax.eval_shape``),
    rank 8, min_size 65536: the JAX package's compression state gives 14
    compressed leaves of 19, 6335569920 bytes of gradient sent as
    24149248 (P and Q of each compressed leaf, the rest whole), and the
    port's rule on the same leaves gives the same count."""
    from repro_torch.models.convert import Leaf
    jc = jax_configs.get_config("rwkv6-1.6b")
    shapes = jax.eval_shape(lambda: JT.init_model(jax.random.PRNGKey(0), jc))
    jcc = jcomp.CompressionConfig(rank=8)
    state = jax.eval_shape(lambda p: jcomp.init_state(p, jcc), shapes)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    qs = jax.tree.leaves(state["Q"], is_leaf=lambda x: isinstance(x, tuple)
                         or hasattr(x, "shape"))
    full = sent = n_comp = 0
    for (_, x), q in zip(flat, qs):
        size = int(np.prod(x.shape))
        full += 4 * size
        if isinstance(q, tuple):
            sent += 4 * size
        else:
            n_comp += 1
            p, qd = jcomp._mat_shape(x.shape)
            assert q.shape == (qd, 8)
            sent += 4 * 8 * (p + qd)
    assert (n_comp, len(flat), full, sent) == (14, 19, 6335569920, 24149248)
    cc = comp.CompressionConfig(rank=8)
    layout = [Leaf(_jax_path(p), (), False, tuple(x.shape)) for p, x in flat]
    port_sent = sum(4 * (leaf.size if not comp.compressed(leaf, cc) else
                         8 * sum(comp._mat_shape(leaf.shape)))
                    for leaf in layout)
    assert (sum(4 * leaf.size for leaf in layout), port_sent) == (full, sent)


def _smoke_run(arch, compressed, noise, monkeypatch):
    """Three fp32 smoke steps at lr 5e-3 (``chip_smoke.py``'s card-vs-CPU
    setting) on the CPU, every gradient times ``1 + noise * N(0, 1)``
    (seeded); the parameters after them."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    import repro_torch.training.train as train
    cfg = configs.smoke_config(configs.get_config(arch))
    tc = TrainConfig(adamw=AdamWConfig(lr=5e-3, warmup_steps=1,
                                       total_steps=3),
                     compression=comp.CompressionConfig(
                         enabled=compressed, rank=8, min_size=512))
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, 4))
    g = torch.Generator().manual_seed(1)
    exact = train._grads_and_metrics

    def perturbed(model, batch, n_micro):
        grads, m = exact(model, batch, n_micro)
        return {k: x * (1 + noise * torch.randn(x.shape, generator=g))
                for k, x in grads.items()}, m
    monkeypatch.setattr(train, "_grads_and_metrics", perturbed)
    state = init_train_state(cfg, tc, device="cpu")
    step = make_train_step(cfg, tc)
    for i in range(3):
        state, _ = step(state, ds.batch(i))
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "grok-1-314b"])
def test_compressed_training_amplifies_rounding(arch, monkeypatch):
    """Why ``chip_smoke.py`` (15.3) holds compressed smoke training card
    against CPU step by step and not as a trajectory: on the CPU alone, a
    relative 1e-7 perturbation of every gradient (the size of fp32 sums
    in another order) moves some parameter tensor by more than 1e-3 of
    its norm over three compressed steps, where plain steps move none by
    more than 1e-5.  AdamW's per-entry update turns the rounding of
    near-zero entries of the decompressed gradient into steps of ``lr``."""
    def worst(compressed):
        a = _smoke_run(arch, compressed, 0.0, monkeypatch)
        b = _smoke_run(arch, compressed, 1e-7, monkeypatch)
        return max(float((a[n] - b[n]).norm() / a[n].norm()) for n in a)
    assert worst(False) <= 1e-5
    assert worst(True) > 1e-3
