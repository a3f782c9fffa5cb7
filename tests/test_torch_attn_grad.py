"""The gradient of the port's ``local_attention`` on the CPU.

``ref.local_attention_bwd_ref`` writes the backward kernel's formulas out
in plain PyTorch (the probabilities from the forward's log-sum-exp,
``Dlt = sum(dO * O)``, the soft-cap's slope, GQA sums); here it is held
to autograd of ``ref.local_attention_ref`` on float64 inputs (the plain
versions compute in fp32: limit 1e-5 relative to the largest gradient
element), and ``ops.local_attention`` under autograd on CPU tensors must
give the same gradient (it runs the plain version's forward and
backward).  One attention layer's vjp (projections, qk-norm, RoPE, the
soft-capped windowed GQA attention, the output projection), in fp32 on
the same numpy weights and cotangent, against ``jax.vjp`` of
``repro.models.layers.apply_attention``: limit 1e-5 relative to the
largest element of each gradient (fp32 sums in other orders).  The
backward's route on the card (``local_attn.bwd_route``) over every head
dim and dtype, and whether it reads ``o``/``do`` in place or copies them
(``local_attn.bwd_reads_in_place``), as functions of dtype, D and strides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

TOL = 1e-5

CASES = [  # B, H, Hkv, S, D, window, softcap
    (2, 4, 2, 33, 16, 8, 50.0),        # GQA, local, soft-cap, ragged S
    (1, 4, 1, 20, 32, 100, None),      # MQA, window past S
    (1, 2, 2, 17, 16, 3, 5.0),         # MHA, a narrow window, a tight cap
    (1, 8, 1, 24, 16, 24, None),       # G = 8, window = S
]


def _inputs(B, H, Hkv, S, D, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(dtype))
            for shape in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                          (B, H, S, D))]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap", CASES)
def test_bwd_ref_matches_autograd_of_the_forward(B, H, Hkv, S, D, window,
                                                 softcap):
    q, k, v, do = _inputs(B, H, Hkv, S, D, S * 10 + D)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o = ref.local_attention_ref(q, k, v, window=window, softcap=softcap)
    want = torch.autograd.grad(o, (q, k, v), do)
    with torch.no_grad():
        o2, lse = ref.local_attention_lse_ref(q, k, v, window=window,
                                              softcap=softcap)
        got = ref.local_attention_bwd_ref(q, k, v, o2, do, lse,
                                          window=window, softcap=softcap)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        _close(a.numpy(), b.numpy())


@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap", CASES)
def test_ops_autograd_on_the_cpu_is_the_plain_backward(B, H, Hkv, S, D,
                                                       window, softcap):
    q, k, v, do = _inputs(B, H, Hkv, S, D, S + D, np.float32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(ops.launches)
    o = ops.local_attention(*leaves, window=window, softcap=softcap)
    got = torch.autograd.grad(o, leaves, do)
    o2, lse = ref.local_attention_lse_ref(q, k, v, window=window,
                                          softcap=softcap)
    want = ref.local_attention_bwd_ref(q, k, v, o2, do, lse, window=window,
                                       softcap=softcap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.launches == before          # the CPU never counts


def test_without_grad_the_forward_alone_runs():
    q, k, v, _ = _inputs(1, 2, 1, 9, 16, 0, np.float32)
    q.requires_grad_()
    with torch.no_grad():
        o = ops.local_attention(q, k, v, window=4)
    assert o.grad_fn is None and not o.requires_grad
    o = ops.local_attention(q, k, v, window=4)
    assert o.grad_fn is not None


def test_bwd_checks_its_operands():
    q, k, v, do = _inputs(1, 2, 1, 9, 16, 1, np.float32)
    o, lse = ref.local_attention_lse_ref(q, k, v, window=4)
    with pytest.raises(ValueError, match="lse"):
        ops.local_attention_bwd(q, k, v, o, do, lse[..., :-1], window=4)
    with pytest.raises(ValueError, match="o and do"):
        ops.local_attention_bwd(q, k, v, o[:, :1], do, lse, window=4)
    with pytest.raises(ValueError, match="window"):
        ops.local_attention_bwd(q, k, v, o, do, lse, window=0)


@pytest.mark.parametrize("D", (16, 32, 64, 128, 256))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_route_over_every_head_dim(dtype, D):
    """The backward's route on the card: bf16 at D >= 64 on the tensor
    cores, the rest by FFMA, as the forward's; every head dim on one."""
    from repro_torch.kernels import local_attn
    dt = getattr(torch, dtype)
    assert D in local_attn.HEAD_DIMS
    want = "wgmma" if dtype == "bfloat16" and D >= 64 else "ffma"
    assert local_attn.bwd_route(dt, D) == want == local_attn.route(dt, D)


def _strided(shape, strides, dtype=torch.bfloat16):
    """A view of the given shape and element strides over fresh memory."""
    need = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    return torch.zeros(need, dtype=dtype).as_strided(shape, strides)


@pytest.mark.parametrize("route", ["wgmma", "ffma"])
@pytest.mark.parametrize("layout,wgmma,ffma", [
    ("bshd", True, True),          # the model's (B, S, H, D) memory, viewed
    ("contiguous", True, True),
    ("broadcast_heads", False, True),   # do expanded over H: a zero stride
    ("broadcast_batch", False, True),   # ... over B
    ("one_head_zero_stride", True, True),   # stride 0 on a dim of size 1
    ("misaligned_rows", False, False),  # rows 8 bytes apart in bf16 x 4
])
def test_bwd_copy_decision(route, layout, wgmma, ffma):
    """Whether ``ops.local_attention_bwd`` reads ``o``/``do`` in place on a
    route (``local_attn.bwd_reads_in_place``), from strides alone: the
    tensor-core route reads dO through a TMA tensor map, which takes no
    zero stride on a dimension longer than 1; both need 16-byte rows."""
    from repro_torch.kernels import local_attn
    B, H, S, D = 2, 4, 40, 64
    t = {"bshd": lambda: _strided((B, H, S, D), (S * H * D, D, H * D, 1)),
         "contiguous": lambda: torch.zeros((B, H, S, D), dtype=torch.bfloat16),
         "broadcast_heads": lambda: _strided((B, H, S, D), (S * D, 0, D, 1)),
         "broadcast_batch": lambda: _strided((B, H, S, D), (0, S * D, D, 1)),
         "one_head_zero_stride": lambda: _strided((B, 1, S, D),
                                                  (S * D, 0, D, 1)),
         "misaligned_rows": lambda: _strided((B, H, S, 4),
                                             (H * S * 4, S * 4, 4, 1)),
         }[layout]()
    assert local_attn.bwd_reads_in_place(route, t) == {
        "wgmma": wgmma, "ffma": ffma}[route]


def _attention_pair(arch, seed):
    """The JAX package's attention parameters of one layer (smoke config,
    fp32, norm scales moved off zero) and the port's ``Attention``
    module on the same numbers."""
    jc = jax_configs.smoke_config(jax_configs.get_config(arch))
    pc = configs.smoke_config(configs.get_config(arch))
    p = JL.init_attention(jax.random.PRNGKey(seed), jc)
    rng = np.random.default_rng(seed)
    p = {key: (val + rng.normal(0, 0.5, val.shape).astype(np.float32)
               if key.endswith("norm") else val) for key, val in p.items()}
    mod = L.Attention(pc, device="cpu")
    with torch.no_grad():
        for key, val in p.items():
            getattr(mod, key).copy_(torch.from_numpy(np.array(val)))
    return jc, pc, p, mod


@pytest.mark.parametrize("arch,local", [("gemma2-9b", True),
                                        ("gemma2-9b", False),
                                        ("qwen3-0.6b", False)])
def test_attention_layer_vjp_matches_jax(arch, local):
    jc, pc, p, mod = _attention_pair(arch, 3)
    B, S = 2, 12
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, pc.d_model)).astype(np.float32)
    ct = rng.normal(size=(B, S, pc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    y, vjp = jax.vjp(lambda p_, x_: JL.apply_attention(
        p_, jc, x_, jnp.asarray(pos), local=local), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))

    xt = torch.from_numpy(x).requires_grad_()
    yt = L.apply_attention(mod, pc, xt, torch.from_numpy(pos.copy()),
                           local=local)
    names = list(p)
    got = torch.autograd.grad(yt, [xt] + [getattr(mod, n) for n in names],
                              torch.from_numpy(ct))
    _close(yt.detach().numpy(), np.asarray(y))
    _close(got[0].numpy(), np.asarray(gx))
    for n, g in zip(names, got[1:]):
        _close(g.numpy(), np.asarray(gp[n]))


def test_attention_vjp_covers_the_window():
    """A window below S changes the gradient (the check above would not
    pass a kernel that ignored it)."""
    jc, pc, p, mod = _attention_pair("gemma2-9b", 4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 12, pc.d_model)).astype(np.float32)).requires_grad_()
    pos = torch.arange(12, dtype=torch.int32)[None]
    g_local = torch.autograd.grad(
        L.apply_attention(mod, pc, x, pos, local=True).sum(), x)[0]
    g_global = torch.autograd.grad(
        L.apply_attention(mod, pc, x, pos, local=False).sum(), x)[0]
    assert pc.window < 12
    assert float((g_local - g_global).abs().max()) > 1e-3
