"""The port's capacity MoE against the JAX package's single-device body.

``repro_torch.models.mlp.apply_moe`` against
``repro.models.mlp._moe_local`` (the branch ``apply_moe`` takes without a
mesh, ``mlp.py:173-178``) on the same weights and inputs, top-1 (llama4
scout's routing) and top-2 (grok-1's), at capacities that drop tokens
and at one that drops none.  The dispatch is compared exactly: the
port's ``moe_route`` gives C, the keep mask and the slots, and the JAX
package's are those of ``_moe_local``'s own lines (router, ``top_k``,
the int32 ``cumsum`` positions, ``mlp.py:113-137``) evaluated here with
jax.numpy on its own router output.  Outputs and the aux loss within the
LM tests' limits (2e-3 in fp32, 5e-2 in bf16).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import mlp as JM
from repro_torch import configs
from repro_torch.models import mlp as M
from repro_torch.models.convert import _to_tensor

TOL = 2e-3
TOL_BF16 = 5e-2


def _jax_dispatch(x, router, cfg):
    """``_moe_local``'s router and capacity dispatch (``mlp.py:113-137``)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    probs = jax.nn.softmax(x.reshape(T, D).astype(jnp.float32) @ router, -1)
    _, expert_ids = jax.lax.top_k(probs, k)
    C = max(8, int(math.ceil(T * k / E * cfg.capacity_factor)))
    flat = expert_ids.reshape(T * k)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=0) - onehot) * onehot, axis=-1)
    return C, np.asarray(pos < C), np.asarray(flat * C + jnp.minimum(pos,
                                                                     C - 1))


def _pair(arch, dtype, capacity_factor, seed):
    over = dict(dtype=dtype, capacity_factor=capacity_factor)
    jc = dataclasses.replace(
        jax_configs.smoke_config(jax_configs.get_config(arch)), **over)
    pc = dataclasses.replace(configs.smoke_config(configs.get_config(arch)),
                             **over)
    p = JM.init_moe(jax.random.PRNGKey(seed), jc)
    moe = M.MoE(pc, device="cpu")
    moe.load_state_dict({k: _to_tensor(np.asarray(v)) for k, v in p.items()},
                        strict=True)
    return p, moe, jc, pc


def _jax_moe(p, jc, x):
    return JM._moe_local(x, p["router"], p["w_gate"], p["w_in"], p["w_out"],
                         cfg=jc, batch_axes=(), data_axes=(), tp_axis=None)


@pytest.mark.parametrize("arch,k", [("llama4-scout-17b-a16e", 1),
                                    ("grok-1-314b", 2)])
@pytest.mark.parametrize("dtype,tol", [("float32", TOL),
                                       ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_apply_moe_matches_jax(arch, k, dtype, tol, capacity_factor):
    p, moe, jc, pc = _pair(arch, dtype, capacity_factor, seed=k)
    assert pc.experts_per_token == k
    rng = np.random.default_rng(k)
    # 2 x 40 tokens: C = max(8, ceil(80 k / 4 cf)); 0.5 drops tokens
    x = jnp.asarray(rng.standard_normal((2, 40, pc.d_model)), jc.dtype)
    tx = _to_tensor(np.asarray(x))

    C, keep, slot = _jax_dispatch(x, p["router"], jc)
    route = M.moe_route(moe, pc, tx)
    assert route["C"] == C == M.capacity(pc, 80)
    np.testing.assert_array_equal(route["keep"].numpy(), keep)
    np.testing.assert_array_equal(route["slot"].numpy(), slot)
    if capacity_factor == 0.5:
        assert not keep.all()            # the case drops tokens
    if capacity_factor == 4.0:
        assert keep.all()                # C = T: nothing can drop

    want, want_aux = _jax_moe(p, jc, x)
    with torch.no_grad():
        got, aux = M.apply_moe(moe, pc, tx)
    assert got.dtype == getattr(torch, dtype) and got.shape == tx.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_a_decode_step_has_its_own_capacity():
    """C comes from the call's own token count: 2 tokens give the floor
    of 8 slots, as in the JAX package."""
    p, moe, jc, pc = _pair("grok-1-314b", "float32", 1.25, seed=3)
    x = jnp.asarray(np.random.default_rng(3).standard_normal(
        (2, 1, pc.d_model)), jnp.float32)
    route = M.moe_route(moe, pc, _to_tensor(np.asarray(x)))
    assert route["C"] == _jax_dispatch(x, p["router"], jc)[0] == 8
    assert bool(route["keep"].all())
    want, _ = _jax_moe(p, jc, x)
    with torch.no_grad():
        got, _ = M.apply_moe(moe, pc, _to_tensor(np.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_moe_gradients_match_jax():
    p, moe, jc, pc = _pair("grok-1-314b", "float32", 0.5, seed=4)
    x = np.random.default_rng(4).standard_normal(
        (2, 40, pc.d_model)).astype(np.float32)

    def jloss(p, x):
        y, aux = _jax_moe(p, jc, x)
        return jnp.sum(y * y) + aux

    want = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = M.apply_moe(moe, pc, tx)
    (torch.sum(y * y) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[1]),
                               rtol=TOL, atol=TOL)
    for name, t in moe.named_parameters():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want[0][name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
