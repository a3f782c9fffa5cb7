"""The port's sweep wrappers against the JAX package's block kernels.

On the CPU ``repro_torch.kernels.ops`` runs the plain PyTorch versions
(``repro_torch/kernels/ref.py``); each case feeds the same seeded numpy
inputs to them, to ``repro.kernels.ops`` (the Pallas kernels, in
interpret mode on the CPU) and to ``repro.kernels.ref`` (the jnp
oracles), with the JAX package's own tolerances from
``tests/test_kernels.py``: rtol 1e-3 / atol 1e-2 for the fp32 sweeps,
atol 5e-2 for the fp32 chain, rtol 1e-4 / atol 1e-2 under bf16.

The bf16 chain rounds its fp32 intermediate ``Y = A Q`` to bf16.  Two
implementations that sum ``Y`` in different orders may round an entry
to neighbouring bf16 values, which moves the chain by a whole bf16 step
there; so its inputs are multiples of 1/16 in [-8, 8], for which every
sum is exact in fp32 and both packages round the same ``Y``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.operator import DenseOperator as JaxDense
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.operator import DenseOperator
from repro_torch.kernels import build, ops

# the package re-exports the wrapper function under the module's name
cuda_kernels = importlib.import_module("repro_torch.kernels.block_matvec")

SHAPES = [(256, 128, 4), (300, 200, 130), (37, 17, 5)]
OPS = ("block_matvec", "block_rmatvec", "block_gram_chain")
TOLS = {("float32", "block_matvec"): (1e-3, 1e-2),
        ("float32", "block_rmatvec"): (1e-3, 1e-2),
        ("float32", "block_gram_chain"): (1e-3, 5e-2),
        ("bfloat16", "block_matvec"): (1e-4, 1e-2),
        ("bfloat16", "block_rmatvec"): (1e-4, 1e-2),
        ("bfloat16", "block_gram_chain"): (1e-4, 1e-2)}


def _inputs(m, n, k, exact=False):
    rng = np.random.default_rng(31 * m + 7 * n + k)
    arrs = [rng.normal(size=s) for s in ((m, n), (n, k), (m, k))]
    if exact:
        arrs = [np.clip(np.round(a * 16) / 16, -8, 8) for a in arrs]
    return [a.astype(np.float32) for a in arrs]


@pytest.fixture(autouse=True)
def _zero_launches():
    ops.reset_launches()
    yield


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", OPS)
def test_plain_versions_match_jax_kernels(name, dtype, m, n, k):
    exact = dtype == "bfloat16" and name == "block_gram_chain"
    A, Q, Y = _inputs(m, n, k, exact)
    rhs = Y if name == "block_rmatvec" else Q
    jd = None if dtype == "float32" else dtype
    kernel = np.asarray(getattr(jax_ops, name)(
        jnp.asarray(A), jnp.asarray(rhs), bm=128, bn=128, dtype=jd))
    oracle = np.asarray(getattr(jax_ref, f"{name}_ref")(
        jnp.asarray(A), jnp.asarray(rhs), jd))
    got = getattr(ops, name)(torch.from_numpy(A), torch.from_numpy(rhs),
                             dtype=dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == kernel.shape
    rtol, atol = TOLS[(dtype, name)]
    for want in (kernel, oracle):
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert set(ops.launches) >= {"block_matvec", "block_rmatvec",
                                 "block_gram_chain"}
    assert not any(ops.launches.values())
    assert not any(ops.route_launches.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_transposed_chain_is_chain_of_transpose(dtype):
    """``trans=True`` (the wide-input path) is the JAX chain of ``A^T``."""
    A, _, Y = _inputs(40, 90, 6, exact=dtype == "bfloat16")
    jd = None if dtype == "float32" else dtype
    want = np.asarray(jax_ref.block_gram_chain_ref(
        jnp.asarray(A.T), jnp.asarray(Y), jd))
    got = ops.block_gram_chain(torch.from_numpy(A), torch.from_numpy(Y),
                               dtype=dtype, trans=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)


def test_plain_bf16_accumulates_in_fp32():
    """torch.matmul of bf16 tensors returns bf16; the plain version must
    multiply the rounded operands in fp32 (preferred_element_type)."""
    A, Q, _ = _inputs(64, 300, 3)
    got = ops.block_matvec(torch.from_numpy(A), torch.from_numpy(Q),
                           dtype="bfloat16")
    A16 = torch.from_numpy(A).bfloat16().double()
    Q16 = torch.from_numpy(Q).bfloat16().double()
    exact = (A16 @ Q16).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("call,exc", [
    (lambda: ops.block_matvec(torch.ones(4, 3), torch.ones(4, 2)),
     ValueError),
    (lambda: ops.block_rmatvec(torch.ones(4, 3), torch.ones(3, 2)),
     ValueError),
    (lambda: ops.block_matvec(np.ones((4, 3)), torch.ones(3, 2)), TypeError),
    (lambda: ops.block_matvec(torch.ones(4, 3, 1), torch.ones(3, 2)),
     ValueError),
    (lambda: ops.block_matvec(torch.ones(4, 3), torch.ones(3, 2),
                              dtype="float16"), ValueError),
    (lambda: ops.block_matvec(torch.ones(4, 3, dtype=torch.float64),
                              torch.ones(3, 2)), ValueError),
    (lambda: ops.block_matvec(torch.ones(4, 3, device="meta"),
                              torch.ones(3, 2, device="meta")), ValueError),
])
def test_wrappers_check_operands(call, exc):
    with pytest.raises(exc):
        call()
    assert sum(ops.launches.values()) == 0


def _slab_case(m, n, k, slabs, which="wgmma_ld"):
    """A case of ``test_rmatvec_slab_split`` on route ``which``: the
    ``wgmma_ld`` cases keep the ids the retired FFMA route's had; the
    other routes' say which."""
    step = cuda_kernels.STEP[which]
    label = "" if which == "wgmma_ld" else f"{which}-"
    return pytest.param(m, n, k, slabs, step, id=f"{label}{m}-{n}-{k}-{slabs}")


@pytest.mark.parametrize("m,n,k,slabs,step", [
    # bf16 no tensor map describes (wgmma_ld): slabs of whole 64-row stages
    _slab_case(262144, 32768, 32, 16),   # the main path: 16384-row slabs
    _slab_case(262144, 32768, 130, 16),
    _slab_case(1000, 300, 7, 1),         # one slab: the kernel writes Z
    _slab_case(4097, 515, 40, 5),        # few column strips: fill the card
    _slab_case(16384, 4096, 40, 16),
    _slab_case(37, 17, 5, 1),
    # bf16 a tensor map describes (wgmma): the same 64-row stages
    _slab_case(262144, 32768, 32, 16, "wgmma"),
    _slab_case(8192, 131072, 32, 1, "wgmma"),   # the wide input
    _slab_case(5000, 1000, 7, 5, "wgmma"),
    _slab_case(4097, 200, 40, 5, "wgmma"),
    _slab_case(16384, 4096, 32, 16, "wgmma"),
    _slab_case(37, 16, 5, 1, "wgmma"),
    # the fp32 tensor-core route (3xTF32): slabs of whole 32-row stages
    _slab_case(262144, 32768, 32, 16, "tf32x3"),
    _slab_case(8192, 131072, 32, 1, "tf32x3"),
    _slab_case(5000, 1000, 7, 5, "tf32x3"),
    _slab_case(4097, 200, 40, 5, "tf32x3"),
    _slab_case(3001, 2052, 45, 3, "tf32x3"),
    _slab_case(40000, 96, 33, 40, "tf32x3"),
    _slab_case(37, 16, 5, 1, "tf32x3"),
    # the fp32 cp.async route: the same 32-row stages, any width
    _slab_case(262144, 32767, 32, 16, "tf32x3_cpasync"),  # odd-width shard
    _slab_case(65536, 8190, 32, 8, "tf32x3_cpasync"),
    _slab_case(4097, 515, 40, 5, "tf32x3_cpasync"),
    _slab_case(40000, 97, 33, 40, "tf32x3_cpasync"),
    _slab_case(37, 17, 5, 1, "tf32x3_cpasync"),
])
def test_rmatvec_slab_split(m, n, k, slabs, step):
    """The split of block_rmatvec's reduction depends on the shape only:
    slabs of a multiple of the route's stage depth, at most
    SLAB_MAX_ROWS rows."""
    rows = cuda_kernels.rmatvec_slab_rows(m, n, k, step)
    assert rows % step == 0
    assert rows <= max(cuda_kernels.SLAB_MAX_ROWS, step)
    assert -(-m // rows) == slabs


def _meta(m, n, dtype=torch.bfloat16, offset=0, ld=None):
    """An (m, n) operand that only says its dtype, shape, row stride
    (``ld``, default n) and alignment."""
    ld = n if ld is None else ld
    flat = torch.empty(m * ld + offset, dtype=dtype, device="meta")
    return flat[offset:].as_strided((m, n), (ld, 1))


@pytest.mark.parametrize("A,k,want", [
    (_meta(262144, 32768), 32, "wgmma"),          # the main path's A
    (_meta(8192, 131072), 32, "wgmma"),           # the wide input
    (_meta(262144, 32768, torch.float32), 32, "tf32x3"),  # fp32: 3xTF32
    (_meta(4097, 515), 40, "wgmma_ld"),           # n % 8 != 0: no tensor map
    (_meta(1000, 300), 7, "wgmma_ld"),
    (_meta(5000, 1000, offset=1), 7, "wgmma_ld"),  # base 2 bytes off 16
    (_meta(5000, 1000, offset=8), 7, "wgmma"),    # base 16 bytes on
    (_meta(5000, 1000), 7, "wgmma"),              # k % 8 != 0 is read as Y^T
    (_meta(3000, 200), 1, "wgmma"),               # the narrowest k
    (_meta(2048, 1024), 130, "wgmma"),            # k > 64: tiles of 64
    # fp32 rows no tensor map describes: 3xTF32 all the same, by cp.async
    (_meta(4097, 515, torch.float32), 40, "tf32x3_cpasync"),   # n % 4 == 3
    (_meta(5000, 1000, torch.float32, offset=1), 7,
     "tf32x3_cpasync"),                                        # 4 bytes off
    (_meta(8192, 131072, torch.float32), 32, "tf32x3"),   # the wide input
    (_meta(3000, 513, torch.float32), 32, "tf32x3_cpasync"),   # n % 4 == 1
    (_meta(3000, 514, torch.float32), 32, "tf32x3_cpasync"),   # n % 4 == 2
    (_meta(3000, 515, torch.float32), 32, "tf32x3_cpasync"),   # n % 4 == 3
    (_meta(262144, 32767, torch.float32), 32, "tf32x3_cpasync"),
    (_meta(5000, 1000, torch.float32, offset=2), 7,
     "tf32x3_cpasync"),                                        # 8 bytes off
    (_meta(5000, 515, torch.float32, ld=516), 7, "tf32x3"),   # padded rows
    # bf16 rows padded to whole 16 bytes (the solver's copy): wgmma
    (_meta(4097, 515, ld=520), 40, "wgmma"),
    (_meta(4097, 515, ld=520, offset=1), 40, "wgmma_ld"),     # 2 bytes off
    (_meta(4097, 515, ld=517), 40, "wgmma_ld"),   # rows not whole 16 bytes
    # bf16 rows no tensor map describes: the kernels' own copies, by
    # cp.async of 8 bytes (lda % 4 == 0), of 4 (lda even) or in registers
    (_meta(65536, 8188), 32, "wgmma_ld"),         # lda % 8 == 4: 8 bytes
    (_meta(65536, 8190), 32, "wgmma_ld"),         # lda % 4 == 2: 4 bytes
    (_meta(65536, 8191), 32, "wgmma_ld"),         # odd lda
    (_meta(5000, 1000, offset=2), 7, "wgmma_ld"),  # base 4 bytes off 16
    (_meta(5000, 1000, offset=3), 7, "wgmma_ld"),  # base 6 bytes off 16
    (_meta(5000, 1000, offset=4), 7, "wgmma_ld"),  # base 8 bytes off 16
], ids=["main", "wide", "fp32", "n515", "n300", "misaligned", "offset16",
        "k7", "k1", "k130", "fp32-n515", "fp32-misaligned", "fp32-wide",
        "fp32-n513", "fp32-n514", "fp32-n515-ragged", "fp32-odd-shard",
        "fp32-offset8", "fp32-padded", "padded-n515", "padded-misaligned",
        "padded-odd", "lda-8-bytes", "lda-4-bytes", "lda-odd",
        "offset4-bytes", "offset6-bytes", "offset8-bytes"])
def test_route(A, k, want):
    """The sweeps' route depends on dtype, row stride and alignment alone;
    every operand runs on the tensor cores."""
    assert cuda_kernels.route(A, k) == want


@pytest.mark.parametrize("A,want", [
    (_meta(30, 7), 7),                        # contiguous
    (_meta(30, 7, ld=8), 8),                  # a view of wider rows
    (_meta(1, 7, ld=3).as_strided((1, 7), (3, 1)), 7),   # one row
    (_meta(7, 30).mT, None),                  # a transposed view
    (_meta(30, 14)[:, ::2], None),            # a column step
])
def test_row_stride(A, want):
    """The row stride the kernels read A with, or None where they cannot
    read it in place."""
    assert cuda_kernels.row_stride(A) == want


@pytest.mark.parametrize("m,n", [(96, 43), (43, 96), (300, 200), (5, 1)])
def test_bf16_sweep_copy_has_rows_of_whole_16_bytes(m, n):
    """The operator's bf16 copy: A's values, rows padded to whole 16 bytes
    (a tensor map describes it, so the tensor cores read it); the pass
    accounting and the fingerprint stay the JAX package's."""
    A = _inputs(m, n, 1)[0]
    op = DenseOperator(torch.from_numpy(A), device="cpu",
                       sweep_dtype="bfloat16")
    As = op._As
    assert As.shape == (m, n) and As.stride(0) % 8 == 0
    assert cuda_kernels.row_stride(As) == As.stride(0)
    assert torch.equal(As, torch.from_numpy(A).to(torch.bfloat16))
    ref = JaxDense(jnp.asarray(A), sweep_dtype="bfloat16")
    assert op.bytes_per_pass == ref.bytes_per_pass == m * n * 2
    assert op.fingerprint == ref.fingerprint
    fp32 = DenseOperator(torch.from_numpy(A), device="cpu")
    assert fp32._As is fp32._A                # the fp32 A is never copied


def test_build_target_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library is named by its source, every csrc/*.cuh and the flags:
    an edited header gives a new name (a rebuild), an unchanged tree the
    same one (a reuse)."""
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "g.cuh").write_text("// another header\n")
    assert build.library_path("k") not in (first, second)
    (tmp_path / "g.cuh").unlink()
    assert build.library_path("k") == second
