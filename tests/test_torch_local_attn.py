"""The port's ``local_attention`` against the JAX package's kernel.

On the CPU ``repro_torch.kernels.ops.local_attention`` runs the plain
PyTorch version (``repro_torch/kernels/ref.py::local_attention_ref``);
each case feeds the same seeded numpy inputs to it, to
``repro.kernels.ops.local_attention`` (the Pallas kernel, in interpret
mode on the CPU, padded by its wrapper where S is ragged) and to
``repro.kernels.ref.local_attention_ref`` (the jnp oracle).  Limits are
the JAX package's own (``tests/test_kernels.py:208`` and ``:221-222``):
1e-4 in fp32; bf16 inputs within 5e-2 of the fp32 oracle.

The cases are those of ``tests/test_kernels.py:193-198`` plus the head
dims 16 (the smoke config's) and 128, gemma2's soft-cap of 50, a ragged
S = 100 with window 48, and windows at and past S (plain causal
attention, which the port's global layers use).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import local_attn, ops

CASES = [  # B, H, Hkv, S, D, window, softcap
    (1, 4, 4, 128, 64, 64, None),       # MHA
    (2, 4, 2, 128, 64, 32, None),       # GQA
    (1, 8, 1, 256, 32, 256, None),      # MQA, window = S (full causal)
    (2, 2, 2, 192, 64, 48, None),       # non-pow2 seq
    (1, 4, 2, 128, 16, 8, None),        # the smoke config's head dim
    (1, 2, 1, 128, 128, 64, None),      # D = 128
    (1, 4, 2, 128, 64, 48, 50.0),       # gemma2's attention soft-cap
    (2, 4, 2, 100, 32, 48, None),       # ragged S
    (1, 2, 1, 100, 16, 500, 50.0),      # window past S
]


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D))]


@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap", CASES)
def test_local_attention_matches_jax(B, H, Hkv, S, D, window, softcap):
    q, k, v = _inputs(B, H, Hkv, S, D, B * 100 + S + D)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_kernel = np.asarray(jax_ops.local_attention(
        jq, jk, jv, window=window, softcap=softcap, bq=64, bk=64))
    want_ref = np.asarray(jax_ref.local_attention_ref(
        jq, jk, jv, window=window, softcap=softcap))
    before = ops.launches["local_attention"]
    got = ops.local_attention(*map(torch.from_numpy, (q, k, v)),
                              window=window, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, D)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-4, atol=1e-4)
    assert ops.launches["local_attention"] == before   # the CPU never counts


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_bf16_inputs_near_the_fp32_oracle(softcap):
    q, k, v = _inputs(1, 4, 2, 128, 64, 5)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.local_attention(tq, tk, tv, window=64, softcap=softcap)
    assert got.dtype == torch.bfloat16
    want = jax_ref.local_attention_ref(
        *(jnp.asarray(t.float().numpy()) for t in (tq, tk, tv)),
        window=64, softcap=softcap)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=5e-2, atol=5e-2)


def test_window_at_least_s_is_causal_attention():
    q, k, v = map(torch.from_numpy, _inputs(2, 4, 2, 40, 16, 9))
    full = ops.local_attention(q, k, v, window=40)
    assert torch.equal(full, ops.local_attention(q, k, v, window=4000))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, 1))
    causal = torch.ones(40, 40, dtype=torch.bool).tril()
    want = torch.softmax(scores.masked_fill(~causal, float("-inf"))
                         / 4.0, -1) @ v.repeat_interleave(2, 1)
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)


def test_strided_views_read_like_contiguous_tensors():
    """The model passes (B, S, H, D) projections as (B, H, S, D) views."""
    q, k, v = _inputs(2, 4, 2, 24, 16, 3)
    views = [torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
             for x in (q, k, v)]
    assert not views[0].is_contiguous()
    got = ops.local_attention(*views, window=8, softcap=50.0)
    want = ops.local_attention(*map(torch.from_numpy, (q, k, v)), window=8,
                               softcap=50.0)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["dtype", "heads", "window", "softcap",
                                 "rank", "layout"])
def test_bad_operands_are_refused(bad):
    q, k, v = map(torch.from_numpy, _inputs(1, 4, 2, 16, 16, 0))
    kw = {"window": 4, "softcap": None}
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "heads":
        q = q[:, :3]
    elif bad == "window":
        kw["window"] = 0
    elif bad == "softcap":
        kw["softcap"] = -1.0
    elif bad == "layout":                # 4-byte offset: no 16-byte loads
        q = torch.nn.functional.pad(q, (1, 0))[..., 1:]
    else:
        q = q[0]
    with pytest.raises(ValueError):
        ops.local_attention(q, k, v, **kw)


def test_kernel_template_covers_every_configured_head_dim():
    from repro_torch.configs import get_config, list_archs, smoke_config
    dims = {get_config(a).resolved_head_dim for a in list_archs()
            if set(get_config(a).blocks) <= {"attn", "local"}}
    dims |= {smoke_config(get_config(a)).resolved_head_dim
             for a in list_archs()}
    assert dims <= set(local_attn.HEAD_DIMS)


def test_route_puts_bf16_at_configured_head_dims_on_the_tensor_cores():
    """bf16 at every configured head dim >= 64 takes the wgmma kernel;
    fp32 at every head dim, and bf16 at D in {16, 32}, the FFMA one."""
    from repro_torch.configs import get_config, list_archs
    dims = {get_config(a).resolved_head_dim for a in list_archs()
            if set(get_config(a).blocks) <= {"attn", "local"}}
    assert dims and all(d >= 64 for d in dims)
    for D in dims:
        assert local_attn.route(torch.bfloat16, D) == "wgmma"
    for D in local_attn.HEAD_DIMS:
        assert local_attn.route(torch.float32, D) == "ffma"
    for D in (16, 32):
        assert local_attn.route(torch.bfloat16, D) == "ffma"
    assert set(local_attn.WGMMA_HEAD_DIMS) <= set(local_attn.HEAD_DIMS)


def test_tma_describable_refuses_broadcast_views_only():
    k = torch.zeros((2, 1, 40, 64), dtype=torch.bfloat16)
    assert local_attn.tma_describable(k)                  # size-1 head dim
    assert not local_attn.tma_describable(k.expand(2, 4, 40, 64))
    q = torch.zeros((2, 40, 4, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert local_attn.tma_describable(q)                  # the model's view
