"""API-surface snapshot of the port: ``repro_torch.core.__all__`` against
the JAX package's ``repro.core.__all__``, and the legacy ``tsvd`` shim.

The port has every public name of ``repro.core`` but ``key_to_seed``,
which turns a JAX PRNG key into the integer seed; the port has no JAX
keys (its seeds are integers throughout, ``core/tsvd.py::
seeded_generator``), so there is nothing for it to take.  It adds the
mesh helpers ``make_host_mesh`` and ``make_production_mesh``, which the
JAX package keeps in ``repro.launch.mesh``: a torch mesh is made by
every rank of a process group, and the sharded front door takes one.
"""
import warnings

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from repro_torch.core import SVDConfig, svd
from repro_torch.core.svd import _reset_legacy_warnings

OMITTED = {"key_to_seed"}
ADDED = {"make_host_mesh", "make_production_mesh"}


def test_core_all_snapshot_against_the_jax_package():
    assert len(ref_core.__all__) == 63
    assert set(core.__all__) == (set(ref_core.__all__) - OMITTED) | ADDED
    assert len(core.__all__) == len(set(core.__all__)), "duplicate names"


def test_core_all_names_resolve():
    for name in core.__all__:
        assert getattr(core, name, None) is not None, name
    assert core.TSVDResult is core.SVDResult


def _matrix(m=120, n=40, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))


@pytest.mark.parametrize("kw,cfg", [
    ({}, SVDConfig(method="gram")),
    ({"method": "gramfree", "eps": 1e-5, "max_iters": 50},
     SVDConfig(method="gramfree", eps=1e-5, max_iters=50)),
    ({"method": "block", "warmup_q": 1, "oversample": 4,
      "sweep_dtype": "bfloat16", "force_iters": True, "max_iters": 7},
     SVDConfig(method="block", warmup_q=1, oversample=4,
               sweep_dtype="bfloat16", force_iters=True, max_iters=7)),
])
def test_tsvd_is_bitwise_svd_under_the_translated_config(kw, cfg):
    A = _matrix()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        got = core.tsvd(A, 4, 3, device="cpu", **kw)
    want = svd(A, 4, device="cpu", config=cfg.replace(seed=3))
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert got.passes_over_A == want.passes_over_A
    assert got.backend == want.backend
    assert np.array_equal(got.iters, want.iters)


def test_tsvd_warns_once_and_keeps_the_gram_default():
    A = _matrix()
    _reset_legacy_warnings()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        first = core.tsvd(A, 3, device="cpu")
        core.tsvd(A, 3, device="cpu")
    dep = [w for w in seen if issubclass(w.category, DeprecationWarning)
           and "tsvd" in str(w.message)]
    assert len(dep) == 1
    # the legacy default is the deflation engine (3 passes a rank)
    assert first.passes_over_A == 3 * 3
    gram = svd(A, 3, device="cpu", method="gram")
    assert torch.equal(first.S, gram.S)
