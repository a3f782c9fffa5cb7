"""The port's recurrent blocks against the JAX package's, on the CPU.

The two recurrences: ``ref.rglru_scan_ref`` / ``ops.rglru_scan`` against
``repro.models.recurrent._rglru_scan`` (an associative scan) and
``ref.wkv6_ref`` / ``ops.wkv6`` against ``_wkv_scan`` (a ``lax.scan``),
with and without an initial state and at T = 1 (a decode step), on the
same numpy inputs.  The plain versions sum in another order than XLA's
scans (the associative scan's tree; the einsum's order over the key
index), so they are held to 1e-5 relative to the output's largest
magnitude (the card's limits for kernel against plain version: 1e-5 for
``rglru_scan``, 1e-4 for ``wkv6``, are stated in
``tests/test_torch_cuda.py``).  On the CPU ``ops`` runs the plain
version: the two are equal bit for bit.

The blocks: ``apply_rglru_block``, ``apply_rwkv_time_mix`` and
``apply_rwkv_channel_mix`` against their JAX functions on the same
weights, from a zero state and from a random one, with the returned
state, within the LM tests' limits (``tests/test_torch_lm.py``: 2e-3 in
fp32, 5e-2 in bf16, where the two frameworks round the model-dtype
products at other places).  The plain recurrences stay differentiable
by autograd on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import recurrent as JR
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import recurrent as R
from repro_torch.models.convert import _to_tensor

TOL_SCAN = 1e-5
TOL = 2e-3
TOL_BF16 = 5e-2


def _rel_max(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _scan_inputs(rng, B, T, R):
    a = rng.uniform(0.5, 0.999, (B, T, R)).astype(np.float32)
    b = rng.standard_normal((B, T, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,T,R", [(2, 37, 24), (1, 1, 8), (3, 130, 5)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_jax(B, T, R, with_h0):
    a, b, h0 = _scan_inputs(np.random.default_rng(B * T + R), B, T, R)
    h0 = h0 if with_h0 else None
    want = JR._rglru_scan(jnp.asarray(a), jnp.asarray(b),
                          None if h0 is None else jnp.asarray(h0))
    args = [torch.from_numpy(x) if x is not None else None
            for x in (a, b, h0)]
    got = ref.rglru_scan_ref(*args)
    assert got.shape == (B, T, R) and got.dtype == torch.float32
    assert _rel_max(got.numpy(), want) <= TOL_SCAN
    assert torch.equal(ops.rglru_scan(*args), got)


def _wkv_inputs(rng, B, T, H, hd):
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.normal(-2.0, 0.5, (B, T, H, hd)))).astype(
        np.float32)
    u = (0.1 * rng.standard_normal((H, hd))).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, w, u, S0


@pytest.mark.parametrize("B,T,H,hd", [(2, 33, 3, 16), (1, 1, 2, 8),
                                      (2, 9, 1, 64)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_matches_jax(B, T, H, hd, with_s0):
    r, k, v, w, u, S0 = _wkv_inputs(np.random.default_rng(T + hd), B, T, H,
                                    hd)
    zeros = np.zeros_like(S0)
    want_o, want_s = JR._wkv_scan(*(jnp.asarray(x) for x in (r, k, v, w, u)),
                                  jnp.asarray(S0 if with_s0 else zeros))
    args = [torch.from_numpy(x) for x in (r, k, v, w, u)]
    s0 = torch.from_numpy(S0) if with_s0 else None
    got_o, got_s = ref.wkv6_ref(*args, s0)
    assert got_o.shape == (B, T, H, hd) and got_s.shape == (B, H, hd, hd)
    assert _rel_max(got_o.numpy(), want_o) <= TOL_SCAN
    assert _rel_max(got_s.numpy(), want_s) <= TOL_SCAN
    o2, s2 = ops.wkv6(*args, s0)
    assert torch.equal(o2, got_o) and torch.equal(s2, got_s)


#: ``csrc/wkv6.cu``'s order of the output's sums: keys a thread (its Tile
#: KI) by head size; lanes of the warp that sums a step's bonus
WKV_KEYS_A_THREAD = {16: 4, 32: 4, 64: 8, 128: 8}
WKV_LANES = 32


def _fma(a, b, c):
    """fp32 ``a * b + c`` rounded once (the product is exact in float64;
    the sum's rounding to float64 first aside)."""
    return (a.double() * b.double() + c.double()).float()


def _wkv6_kernel_order(r, k, v, w, u, S0):
    """``wkv6`` with the card kernel's output order in plain PyTorch: each
    key group's partial an FMA chain over its keys from the state before
    the step, the partials summed in group order, then v_j times the
    factored bonus sum_i (r_i u_i) k_i (lane l's FMA chain over keys l,
    l + 32, ..., the lanes' sums met in a butterfly of xor-shuffles).  The
    state as the kernel rounds it: k v, w S, their sum."""
    B, T, H, hd = r.shape
    KI = WKV_KEYS_A_THREAD[hd]
    G, L = hd // KI, WKV_LANES
    lanes = torch.arange(L)
    S = r.new_zeros((B, H, hd, hd)) if S0 is None else S0.clone()
    out = []
    for t in range(T):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        acc = torch.zeros((B, H, G, hd))
        for a in range(KI):
            acc = _fma(rt.view(B, H, G, KI)[..., a, None],
                       S.view(B, H, G, KI, hd)[:, :, :, a], acc)
        o = acc[:, :, 0]
        for g in range(1, G):
            o = o + acc[:, :, g]
        ru = rt * u
        b = torch.zeros((B, H, L))
        for m in range(0, hd, L):
            keys = lanes + m
            live = keys < hd
            keys = keys.clamp(max=hd - 1)
            b = torch.where(live, _fma(ru[..., keys], kt[..., keys], b), b)
        d = L // 2
        while d:
            b = b + b[..., lanes ^ d]
            d //= 2
        out.append(_fma(vt, b[..., :1], o))
        S = wt[..., None] * S + kt[..., :, None] * vt[..., None, :]
    return torch.stack(out, dim=1), S


@pytest.mark.parametrize("decay", ["strong", "near_one"])
def test_wkv6_kernel_order_fits_the_card_limit(decay):
    """The card kernel sums the output in another order than the plain
    loop's einsum (``tests/test_torch_cuda.py``'s ``TOL_WKV6``, 1e-4 of
    the output's largest magnitude): its order, emulated here over 4097
    steps (128 chunks and one step) at the two edges of the decays (all
    below 1e-30; all 1 - 2^-24), fits that limit, and its state is the
    plain loop's bit for bit."""
    B, T, H, hd = 1, 4097, 2, 64
    r, k, v, _, u, S0 = _wkv_inputs(np.random.default_rng(31), B, T, H, hd)
    rng = np.random.default_rng(32)
    w = (np.exp(-80.0 - 10.0 * rng.random((B, T, H, hd))) if decay == "strong"
         else np.full((B, T, H, hd), 1.0 - 2.0 ** -24)).astype(np.float32)
    args = [torch.from_numpy(x) for x in (r, k, v, w, u, S0)]
    got_o, got_s = _wkv6_kernel_order(*args)
    want_o, want_s = ref.wkv6_ref(*args)
    assert _rel_max(got_o.numpy(), want_o.numpy()) <= 1e-4
    assert torch.equal(got_s, want_s)


def test_recurrences_are_differentiable_on_the_cpu():
    rng = np.random.default_rng(5)
    a, b, h0 = (torch.from_numpy(x).requires_grad_()
                for x in _scan_inputs(rng, 2, 6, 4))
    ops.rglru_scan(a, b, h0).sum().backward()
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all())
               for x in (a, b, h0))
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _wkv_inputs(rng, 1, 5, 2, 8)]
    o, s = ops.wkv6(*xs)
    (o.sum() + s.sum()).backward()
    assert all(x.grad is not None for x in xs)


@pytest.mark.parametrize("bad", ["dtype", "shape", "T0"])
def test_recurrence_operands_are_checked(bad):
    a = torch.rand((2, 3, 4))
    b = torch.rand((2, 3, 4))
    if bad == "dtype":
        a = a.double()
    elif bad == "shape":
        b = b[:, :, :3]
    else:
        a, b = a[:, :0], b[:, :0]
    with pytest.raises(ValueError):
        ops.rglru_scan(a, b)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _cfg(arch, dtype):
    jc = dataclasses.replace(
        jax_configs.smoke_config(jax_configs.get_config(arch)), dtype=dtype)
    pc = dataclasses.replace(configs.smoke_config(configs.get_config(arch)),
                             dtype=dtype)
    return jc, pc


def _load(module, tree):
    module.load_state_dict({k: _to_tensor(np.asarray(v))
                            for k, v in tree.items()}, strict=True)
    return module


def _state(rng, tree, dtype):
    """A random state of a block's state tree, in its leaves' dtypes."""
    return {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
            for k, v in tree.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("T", [1, 11])
@pytest.mark.parametrize("from_state", [False, True])
def test_rglru_block_matches_jax(dtype, tol, T, from_state):
    jc, pc = _cfg("recurrentgemma-9b", dtype)
    p = JR.init_rglru_block(jax.random.PRNGKey(T), jc)
    block = _load(R.RGLRUBlock(pc, device="cpu"), p)
    rng = np.random.default_rng(T)
    x = jnp.asarray(rng.standard_normal((2, T, pc.d_model)), jc.dtype)
    st = _state(rng, JR.init_rglru_state(jc, 2), dtype) if from_state \
        else None
    want, want_st = JR.apply_rglru_block(p, jc, x, st)
    tst = None if st is None else {k: _to_tensor(np.asarray(v))
                                   for k, v in st.items()}
    with torch.no_grad():
        got, got_st = R.apply_rglru_block(block, pc, _to_tensor(
            np.asarray(x)), tst)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, tol)
    assert got_st["h"].dtype == torch.float32
    assert got_st["conv"].dtype == getattr(torch, dtype)
    for key in ("h", "conv"):
        _close(got_st[key], want_st[key], tol)


@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("T", [1, 9])
@pytest.mark.parametrize("from_state", [False, True])
def test_rwkv_mixes_match_jax(dtype, tol, T, from_state):
    jc, pc = _cfg("rwkv6-1.6b", dtype)
    p = JR.init_rwkv_block(jax.random.PRNGKey(T), jc)
    block = _load(R.RWKVBlock(pc, device="cpu"), p)
    rng = np.random.default_rng(T + 1)
    x = jnp.asarray(rng.standard_normal((2, T, pc.d_model)), jc.dtype)
    st = _state(rng, JR.init_rwkv_state(jc, 2), dtype) if from_state \
        else None
    tst = None if st is None else {k: _to_tensor(np.asarray(v))
                                   for k, v in st.items()}
    tx = _to_tensor(np.asarray(x))
    for jfn, fn, keys in ((JR.apply_rwkv_time_mix, R.apply_rwkv_time_mix,
                           ("x_prev_t", "S")),
                          (JR.apply_rwkv_channel_mix,
                           R.apply_rwkv_channel_mix, ("x_prev_c",))):
        want, want_st = jfn(p, jc, x, st)
        with torch.no_grad():
            got, got_st = fn(block, pc, tx, tst)
        assert got.dtype == getattr(torch, dtype)
        _close(got, want, tol)
        assert set(got_st) == set(keys)
        for key in keys:
            _close(got_st[key], want_st[key], tol)
    assert got_st["x_prev_c"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("arch,fn", [("recurrentgemma-9b",
                                      R.init_rglru_state),
                                     ("rwkv6-1.6b", R.init_rwkv_state)])
def test_states_match_jax(arch, fn):
    jc, pc = _cfg(arch, "bfloat16")
    jfn = {"recurrentgemma-9b": JR.init_rglru_state,
           "rwkv6-1.6b": JR.init_rwkv_state}[arch]
    want = jfn(jc, 3)
    got = fn(pc, 3, device="cpu")
    assert set(got) == set(want)
    for key, t in got.items():
        assert tuple(t.shape) == want[key].shape
        assert str(t.dtype).split(".")[-1] == str(want[key].dtype)
        assert not bool(t.any())
