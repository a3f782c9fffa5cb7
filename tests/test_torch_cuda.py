"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is visible.  This file imports torch and ``repro_torch`` only, so it
also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Limits: the same (bf16-rounded) operands summed in fp32 in another
order, 1e-5 relative Frobenius; the bf16 chain, whose fp32 intermediate
is rounded to bf16 where kernel and plain version can land on
neighbouring bf16 values, 1e-3.  The deflation kernels (``matvec``,
``deflate_rmatvec``, ``gram``) at ragged shapes: 1e-5.  ``local_attention``
against its plain version on the same inputs: max |kernel - plain| 1e-4 in
fp32 (the JAX package's limit for its kernel, ``tests/test_kernels.py:208``);
in bf16 each element within the kernel's one rounding of its output to
bf16, 2^-8 |plain| of that element, plus 1e-5 for the fp32 sums' order
(``_attn_within``).  bf16 at D >= 64 runs the tensor-core kernel
(``local_attn.route``), the rest the FFMA one.  Its backward kernel is
held element by element to the same limits against
``ref.local_attention_bwd_ref``, with bitwise reruns, on both of its
routes (``local_attn.bwd_route``: bf16 at D >= 64 on the tensor cores, at
GQA groups 1, 2 and 8, windows cutting key tiles, S no multiple of 64,
the cap on and off; launches counted by route), a broadcast ``do`` copied
first, and the autograd Function's launches are counted.  The block sweeps
(``block_matvec.route``): every fp32 A on the tensor cores as 3xTF32,
staged by TMA where a tensor map describes A and by cp.async elsewhere;
bf16 by wgmma, staged by TMA where a map describes A (the solver's
padded copy included) and by the kernel's own copies elsewhere
(``cp.async``, and registers for rows 2 bytes off a 4-byte boundary);
all four routes are held to the same limits.
``gram`` (``gram.route``): fp32 as 3xTF32 and bf16 by wgmma, each by
TMA where a tensor map describes A and by the producer's own copies
elsewhere, B exactly symmetric, and its off-diagonal entries also read
alone (limit 4e-5, ``chip_smoke.py``'s ``TOL_GRAM_OFFDIAG``).
The out-of-core tiers (``core/staging.py``): every streamed op of a
``HostBlockedMatrix`` against the plain versions on the same staged data
and on the TMA routes at any width (the device rows padded), bitwise
reruns, one registration for an array two matrices share, the disk tier
on the card against the CPU, and the driver's lagged gap read waiting
for its own step only.  The sparse stream (``csr_sweep.cu``): every CSR
sweep bitwise ``np.add.at`` (fp32 and bf16 values, k = 1 to 33, empty
rows and repeated columns), reruns bitwise; the CPU order model's cases
(``tests/csr_cases.py``: an empty block, one column holding every
nonzero, a run longer than a bucket chunk, Z carried across blocks,
n = 2^25 and 2^31 - 1) and a block of the paper's share likewise, with
the launch counts by route; ``csr_rmatmat``'s sort and sum halves
giving the whole call's bits; the pipeline's streamed ops
bitwise the CPU path's, with its launch and PCIe byte counts, through
empty and shrinking blocks too; a block beyond int32 nonzeros refused;
and a sparse solve on the card resumed from a checkpoint bitwise.
The LM's recurrences (``rglru_scan``, ``wkv6``) against their plain loops
at small and ragged shapes (T = 1, T past a stage or chunk and at
``wkv6``'s chunk edges at each head size, R no multiple of 4, decays
below 1e-30 and at 1 - 2^-24, with and without an initial state, reruns
bitwise): RG-LRU's h and RWKV-6's state bitwise (both round each
product, then each sum, as the plain version's elementwise ops), each
output within its stated limit (``rglru_scan`` 1e-5, ``wkv6`` 1e-4 of the
output's largest magnitude: the RWKV-6 output's sum over the key index
runs in another order than the plain version's einsum); their backward
kernels against the plain reverse loops at the same edges (RG-LRU's da,
db, dh0 and RWKV-6's dS0 bitwise, with and without dS_T; RWKV-6's dr,
dk, dv, dw, du within 1e-4 of each one's largest magnitude), the forward
that keeps the chunk starts bitwise the one that does not, the autograd
Functions launching the backward kernels; a training step of the
recurrentgemma and rwkv6 smoke configs with its launches; the attention
backward at recurrentgemma's layout (G = 16, D 256, window 2048); and
the launches of a prefill and a decode step of the two smoke configs.
``repro_torch.analysis.run_all(device="cuda")`` comes out clean with its
A-traffic equal to the accounting and each block step on its dtype's
routes; the SVD service's first solves in a fresh process all finish.
"""
import collections
import importlib

import pytest
import torch

import csr_cases

from repro_torch.kernels import ops, ref

bm = importlib.import_module("repro_torch.kernels.block_matvec")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    # is_pinned() reads False until torch has initialised CUDA
    torch.cuda.init()
    return torch.device("cuda")


def _rel(got, want):
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


@pytest.mark.parametrize("m,n,k", [(1000, 300, 7), (4097, 515, 40),
                                   (2048, 1024, 130), (3000, 200, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_versions(card, m, n, k, dtype):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    A = torch.randn((m, n), generator=g, device=card).to(getattr(torch, dtype))
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    ops.reset_launches()
    chain_tol = 1e-3 if dtype == "bfloat16" else 1e-5
    for got, want, tol in (
            (ops.block_matvec(A, Q), ref.block_matvec_ref(A, Q, dtype), 1e-5),
            (ops.block_rmatvec(A, Y), ref.block_rmatvec_ref(A, Y, dtype),
             1e-5),
            (ops.block_gram_chain(A, Q), ref.block_gram_chain_ref(A, Q, dtype),
             chain_tol),
            (ops.block_gram_chain(A, Y, trans=True),
             ref.block_gram_chain_ref(A, Y, dtype, trans=True), chain_tol)):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= tol
    assert {n: c for n, c in ops.launches.items() if c} == {
        "block_matvec": 3, "block_rmatvec": 3, "block_gram_chain": 2}


def test_kernels_are_deterministic(card):
    g = torch.Generator(device=card).manual_seed(0)
    A = torch.randn((20000, 700), generator=g, device=card)
    Y = torch.randn((20000, 40), generator=g, device=card)
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


def test_non_contiguous_operand_is_refused(card):
    A = torch.randn((64, 32), device=card)
    with pytest.raises(ValueError):
        ops.block_matvec(A.mT, torch.randn((64, 3), device=card))


@pytest.mark.parametrize("m,n,k", [
    (5000, 1000, 7),     # ragged m, n and k (not a multiple of 8)
    (1000, 1024, 1),     # the narrowest k
    (4097, 200, 40),     # one stage, partly past n; k between widths
    (2048, 1024, 130),   # k > 64: three tiles of k
    (257, 4104, 64),     # one row block, partly past m
    (40000, 96, 33),     # several slabs of the reduction
    (33000, 4096, 32),   # the path's k, slabs ragged in m
])
def test_tensor_core_sweeps_match_plain_versions(card, m, n, k):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    A = torch.randn((m, n), generator=g, device=card).to(torch.bfloat16)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == "wgmma"
    ops.reset_launches()
    for got, want, tol in (
            (ops.block_matvec(A, Q), ref.block_matvec_ref(A, Q, "bfloat16"),
             1e-5),
            (ops.block_rmatvec(A, Y), ref.block_rmatvec_ref(A, Y, "bfloat16"),
             1e-5),
            (ops.block_gram_chain(A, Q),
             ref.block_gram_chain_ref(A, Q, "bfloat16"), 1e-3),
            (ops.block_gram_chain(A, Y, trans=True),
             ref.block_gram_chain_ref(A, Y, "bfloat16", trans=True), 1e-3)):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(torch.isfinite(got).all()) and _rel(got, want) <= tol
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_matvec/wgmma": 3, "block_rmatvec/wgmma": 3}


def test_tensor_core_rmatvec_reruns_bitwise(card):
    g = torch.Generator(device=card).manual_seed(3)
    A = torch.randn((40000, 704), generator=g, device=card).to(torch.bfloat16)
    Y = torch.randn((40000, 40), generator=g, device=card)
    assert bm.route(A, 40) == "wgmma"
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


@pytest.mark.parametrize("m,n,k", [
    (5000, 1000, 7),     # ragged m, n (not whole 32-column stages) and k
    (3001, 2052, 45),    # the same, k between widths
    (1000, 300, 1),      # the narrowest k
    (4097, 516, 40),     # n a multiple of 4, not of 8
    (2048, 1024, 130),   # k > 64: three tiles of k
    (257, 4100, 64),     # one row block, partly past m
    (40000, 96, 33),     # several slabs of the reduction
    (33000, 4096, 32),   # the path's k, slabs ragged in m
])
def test_tf32x3_sweeps_match_plain_versions(card, m, n, k):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    A = torch.randn((m, n), generator=g, device=card)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == "tf32x3"
    ops.reset_launches()
    for got, want in (
            (ops.block_matvec(A, Q), ref.block_matvec_ref(A, Q, "float32")),
            (ops.block_rmatvec(A, Y), ref.block_rmatvec_ref(A, Y, "float32")),
            (ops.block_gram_chain(A, Q),
             ref.block_gram_chain_ref(A, Q, "float32")),
            (ops.block_gram_chain(A, Y, trans=True),
             ref.block_gram_chain_ref(A, Y, "float32", trans=True))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(torch.isfinite(got).all()) and _rel(got, want) <= 1e-5
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_matvec/tf32x3": 3, "block_rmatvec/tf32x3": 3}


def test_tf32x3_rmatvec_reruns_bitwise(card):
    g = torch.Generator(device=card).manual_seed(4)
    A = torch.randn((40000, 708), generator=g, device=card)
    Y = torch.randn((40000, 40), generator=g, device=card)
    assert bm.route(A, 40) == "tf32x3"
    assert -(-40000 // bm.rmatvec_slab_rows(40000, 708, 40, bm.TF32_BK)) > 1
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


def test_misaligned_fp32_runs_the_cpasync_route(card):
    """An fp32 A 4 bytes off a 16-byte boundary has no tensor map: 3xTF32
    with A copied by cp.async."""
    m, n, k = 3000, 1024, 9
    g = torch.Generator(device=card).manual_seed(6)
    flat = torch.randn(m * n + 1, generator=g, device=card)
    A = flat[1:].view(m, n)
    Y = torch.randn((m, k), generator=g, device=card)
    assert A.is_contiguous() and bm.route(A, k) == "tf32x3_cpasync"
    ops.reset_launches()
    got = ops.block_rmatvec(A, Y)
    torch.cuda.synchronize()
    assert _rel(got, ref.block_rmatvec_ref(A, Y, "float32")) <= 1e-5
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_rmatvec/tf32x3_cpasync": 1}


def _padded_view(g, card, m, n, ld, offset=0):
    """An fp32 (m, n) view of rows ``ld`` apart starting ``offset``
    elements into an allocation of m + 1 rows, every element outside the
    view NaN: a kernel that reads past a row's n-th element (or past the
    last row) reads NaN and returns it."""
    flat = torch.full((offset + (m + 1) * ld,), float("nan"), device=card)
    view = flat[offset:offset + m * ld].view(m, ld)[:, :n]
    view.copy_(torch.randn((m, n), generator=g, device=card))
    return view


def _sweeps_within(A, Q, Y, sd, route, chain_tol=1e-5):
    """Every block sweep of ``ops`` on A within its limit of the plain
    version, each launch on ``route``."""
    ops.reset_launches()
    for got, want, tol in (
            (ops.block_matvec(A, Q), ref.block_matvec_ref(A, Q, sd), 1e-5),
            (ops.block_rmatvec(A, Y), ref.block_rmatvec_ref(A, Y, sd), 1e-5),
            (ops.block_gram_chain(A, Q), ref.block_gram_chain_ref(A, Q, sd),
             chain_tol),
            (ops.block_gram_chain(A, Y, trans=True),
             ref.block_gram_chain_ref(A, Y, sd, trans=True), chain_tol)):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert bool(torch.isfinite(got).all()) and _rel(got, want) <= tol
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        f"block_matvec/{route}": 3, f"block_rmatvec/{route}": 3}


@pytest.mark.parametrize("m,n,k", [
    (5000, 1001, 7),     # n % 4 == 1, ragged m (not whole 256-row blocks)
    (3001, 2054, 45),    # n % 4 == 2 (8-byte copies), k between widths
    (1000, 515, 1),      # n % 4 == 3, the narrowest k
    (4097, 515, 40),     # k between widths, m not a multiple of 32
    (2049, 1027, 130),   # k > 64: three tiles of k
    (257, 4097, 64),     # one row block, partly past m
    (40001, 97, 33),     # several slabs, the last ragged; one stage deep
    (33000, 4095, 32),   # the path's k, slabs ragged in m
    (1000, 3, 32),       # fewer columns than one copy unit of a warp
])
def test_cpasync_sweeps_match_plain_versions(card, m, n, k):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    A = torch.randn((m, n), generator=g, device=card)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == "tf32x3_cpasync"
    _sweeps_within(A, Q, Y, "float32", "tf32x3_cpasync")


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("ld", [1024, 1026, 1027])
def test_cpasync_reads_only_the_view(card, offset, ld):
    """A base 1-3 floats off 16 bytes and rows of every parity, the
    elements past each row's n-th and past the last row NaN: the cp.async
    route zero-fills the edges and reads nothing outside the view."""
    m, n, k = 3001, 1021, 32
    g = torch.Generator(device=card).manual_seed(offset * ld)
    A = _padded_view(g, card, m, n, ld, offset)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == "tf32x3_cpasync" and bm.row_stride(A) == ld
    _sweeps_within(A, Q, Y, "float32", "tf32x3_cpasync")


@pytest.mark.parametrize("dtype,ld,offset,route", [
    ("float32", 1024, 0, "tf32x3"),      # rows of whole 16 bytes: TMA
    ("bfloat16", 1024, 0, "wgmma"),
    ("bfloat16", 1027, 0, "wgmma_ld"),   # bf16 rows no tensor map takes
    ("bfloat16", 1024, 1, "wgmma_ld"),   # a base 2 bytes off 16
])
def test_views_of_wider_rows_are_read_in_place(card, dtype, ld, offset,
                                               route):
    """The other routes read a view of wider rows in place, never the
    NaN padding past a row."""
    m, n, k = 3001, 1021, 32
    g = torch.Generator(device=card).manual_seed(ld + offset)
    flat = torch.full((offset + (m + 1) * ld,), float("nan"), device=card)
    flat = flat.to(getattr(torch, dtype))
    A = flat[offset:offset + m * ld].view(m, ld)[:, :n]
    A.copy_(torch.randn((m, n), generator=g, device=card))
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == route and bm.row_stride(A) == ld
    _sweeps_within(A, Q, Y, dtype, route,
                   chain_tol=1e-3 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("k", [1, 7, 32, 40, 130])
def test_cpasync_takes_any_k(card, k):
    m, n = 4099, 2047
    g = torch.Generator(device=card).manual_seed(k)
    A = torch.randn((m, n), generator=g, device=card)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    _sweeps_within(A, Q, Y, "float32", "tf32x3_cpasync")


@pytest.mark.parametrize("n", [709, 710])
def test_cpasync_rmatvec_reruns_bitwise(card, n):
    """4- and 8-byte copies; several slabs summed in order."""
    g = torch.Generator(device=card).manual_seed(n)
    A = torch.randn((40000, n), generator=g, device=card)
    Y = torch.randn((40000, 40), generator=g, device=card)
    assert bm.route(A, 40) == "tf32x3_cpasync"
    assert -(-40000 // bm.rmatvec_slab_rows(40000, n, 40, bm.TF32_BK)) > 1
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


@pytest.mark.parametrize("m,n,k", [(5000, 1001, 7), (4097, 515, 40),
                                   (33000, 4095, 32)])
def test_padded_bf16_copy_runs_the_tensor_cores(card, m, n, k):
    """The operator's bf16 copy of an odd-width A (rows padded to whole 16
    bytes, the padding NaN here) on wgmma, within the limits."""
    from repro_torch.core.operator import sweep_copy
    g = torch.Generator(device=card).manual_seed(m + n + k)
    A = torch.randn((m, n), generator=g, device=card)
    As = sweep_copy(A, torch.bfloat16)
    As.as_strided((m, As.stride(0)), (As.stride(0), 1))[:, n:].fill_(
        float("nan"))
    assert As.stride(0) % 8 == 0 and bm.route(As, k) == "wgmma"
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    _sweeps_within(As, Q, Y, "bfloat16", "wgmma", chain_tol=1e-3)


@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_odd_width_svd_runs_no_ffma(card, sweep_dtype):
    """svd(A, 32) at an odd width: the fp32 sweeps on the cp.async route,
    the bf16 chains on wgmma (the padded copy), no FFMA launch, launches
    equal to the pass accounting."""
    import repro_torch
    g = torch.Generator(device=card).manual_seed(8)
    A = torch.randn((4099, 1001), generator=g, device=card)
    ops.reset_launches()
    res = repro_torch.svd(A, 32, sweep_dtype=sweep_dtype, force_iters=True,
                          max_iters=3)
    it = int(res.iters[0])
    assert it == 3 and res.passes_over_A == 2 * it + 1
    assert {n: c for n, c in ops.launches.items() if c} == {
        "block_gram_chain": it, "block_matvec": it + 1, "block_rmatvec": it}
    chains = "wgmma" if sweep_dtype == "bfloat16" else "tf32x3_cpasync"
    want = {f"block_matvec/{chains}": it, f"block_rmatvec/{chains}": it}
    want["block_matvec/tf32x3_cpasync"] = want.get(
        "block_matvec/tf32x3_cpasync", 0) + 1      # the fp32 extraction
    assert {n: c for n, c in ops.route_launches.items() if c} == want
    assert bool(torch.isfinite(res.S).all()) and res.S.shape == (32,)


def test_misaligned_bf16_runs_the_wgmma_ld_route(card):
    """A bf16 A 2 bytes off a 16-byte boundary has no tensor map: the
    tensor cores all the same, A copied by the kernel's producer."""
    m, n, k = 3000, 1024, 9
    g = torch.Generator(device=card).manual_seed(5)
    flat = torch.randn(m * n + 1, generator=g, device=card).to(torch.bfloat16)
    A = flat[1:].view(m, n)
    Q = torch.randn((n, k), generator=g, device=card)
    assert A.is_contiguous() and bm.route(A, k) == "wgmma_ld"
    ops.reset_launches()
    got = ops.block_matvec(A, Q)
    torch.cuda.synchronize()
    assert _rel(got, ref.block_matvec_ref(A, Q, "bfloat16")) <= 1e-5
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_matvec/wgmma_ld": 1}


def _bf16_view(g, card, m, n, ld, offset=0):
    """A bf16 (m, n) view of rows ``ld`` apart starting ``offset``
    elements into an allocation of m + 1 rows, every element outside the
    view NaN."""
    flat = torch.full((offset + (m + 1) * ld,), float("nan"), device=card,
                      dtype=torch.bfloat16)
    view = flat[offset:offset + m * ld].view(m, ld)[:, :n]
    view.copy_(torch.randn((m, n), generator=g, device=card))
    return view


# (n, lda, base offset in elements) of bf16 rows no tensor map describes;
# the comments say how the kernel's producer copies them
@pytest.mark.parametrize("n,ld,offset", [
    pytest.param(1021, 1021, 0, id="lda-n-odd"),     # every other row by
                                                     # registers
    pytest.param(1022, 1022, 0, id="lda-n-even"),    # cp.async of 4 bytes
    pytest.param(1020, 1020, 0, id="lda-n-8bytes"),  # cp.async of 8 bytes
    pytest.param(1021, 1027, 0, id="lda-wider-odd"),
    pytest.param(1021, 1026, 0, id="lda-wider-even"),  # a word half in a row
    pytest.param(1021, 1024, 1, id="base-2-bytes-off"),  # every row by
                                                         # registers
    pytest.param(1021, 1024, 2, id="base-4-bytes-off"),
    pytest.param(1021, 1024, 4, id="base-8-bytes-off"),
])
@pytest.mark.parametrize("k", [1, 7, 32, 40, 130])
def test_wgmma_ld_sweeps_match_plain_versions(card, n, ld, offset, k):
    """Every layout of bf16 rows no tensor map describes, the padding past
    each row and past the last row NaN: the sweeps on wgmma_ld within
    their limits (the padding never read), at every k width."""
    m = 3001
    g = torch.Generator(device=card).manual_seed(n + ld + offset + k)
    A = _bf16_view(g, card, m, n, ld, offset)
    Q = torch.randn((n, k), generator=g, device=card)
    Y = torch.randn((m, k), generator=g, device=card)
    assert bm.route(A, k) == "wgmma_ld" and bm.row_stride(A) == ld
    _sweeps_within(A, Q, Y, "bfloat16", "wgmma_ld", chain_tol=1e-3)


@pytest.mark.parametrize("n", [709, 710, 708])
def test_wgmma_ld_rmatvec_reruns_bitwise(card, n):
    """Odd lda (registers), 4- and 8-byte copies; several slabs summed
    in order."""
    g = torch.Generator(device=card).manual_seed(n)
    A = torch.randn((40000, n), generator=g, device=card).to(torch.bfloat16)
    Y = torch.randn((40000, 40), generator=g, device=card)
    assert bm.route(A, 40) == "wgmma_ld"
    assert -(-40000 // bm.rmatvec_slab_rows(40000, n, 40, bm.TC_BK)) > 1
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


@pytest.mark.parametrize("m,n", [(1000, 300), (4097, 515), (257, 4100),
                                 (40000, 96), (33, 1)])
def test_deflation_kernels_match_plain_versions(card, m, n):
    g = torch.Generator(device=card).manual_seed(m + n)
    A = torch.randn((m, n), generator=g, device=card)
    k = 5
    v, u = torch.randn(n, generator=g, device=card), \
        torch.randn(m, generator=g, device=card)
    U, V = torch.randn((m, k), generator=g, device=card), \
        torch.randn((n, k), generator=g, device=card)
    c = torch.randn(k, generator=g, device=card)
    ops.reset_launches()
    pairs = [(ops.matvec(A, v), ref.matvec_ref(A, v)),
             (ops.matvec(A, u, trans=True), ref.matvec_ref(A, u, True))]
    for got, want in zip(ops.deflate_rmatvec(A, U, u, c),
                         ref.deflate_rmatvec_ref(A, U, u, c)):
        pairs.append((got, want))
    for got, want in zip(ops.deflate_rmatvec(A, V, v, c, trans=True),
                         ref.deflate_rmatvec_ref(A, V, v, c, True)):
        pairs.append((got, want))
    torch.cuda.synchronize()
    for got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert _rel(got, want) <= 1e-5
    assert ops.launches["matvec"] == 2 and ops.launches["deflate_rmatvec"] == 2


@pytest.mark.parametrize("m,n", [(1000, 300), (300, 1000), (4097, 130),
                                 (129, 129), (5, 3)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_kernel_matches_plain_version(card, m, n, dtype):
    g = torch.Generator(device=card).manual_seed(m * n)
    A = torch.randn((m, n), generator=g, device=card).to(getattr(torch, dtype))
    ops.reset_launches()
    for trans in (False, True):
        want = ref.gram_ref(A, trans)
        for symmetric in (True, False):
            got = ops.gram(A, symmetric=symmetric, trans=trans)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert _rel(got, want) <= 1e-5
            assert torch.equal(got, got.mT)        # a tile and its mirror
    assert ops.launches["gram"] == 4


def _offdiag(got, want):
    """chip_smoke.py's second gram reading: the relative Frobenius error
    over the entries off the main diagonal (0 where there are none)."""
    d, w = got - want, want.clone()
    d.diagonal().zero_()
    w.diagonal().zero_()
    den = float(torch.linalg.norm(w))
    return float(torch.linalg.norm(d)) / den if den > 0 else 0.0


@pytest.mark.parametrize("m,n,ld,offset,route", [
    (3000, 2052, 2052, 0, "tf32x3"),            # ragged tiles, A by TMA
    (3000, 2051, 2051, 0, "tf32x3_cpasync"),    # rows of 4 * 2051 bytes
    (3001, 1021, 1026, 2, "tf32x3_cpasync"),    # cp.async of 8 bytes
    (3001, 1021, 1024, 1, "tf32x3_cpasync"),    # a base 4 bytes off 16
    (3001, 1021, 1024, 0, "tf32x3"),            # padded rows, by TMA
    (257, 4100, 4100, 0, "tf32x3"),             # A A^T's reduction long
    (33, 1, 1, 0, "tf32x3_cpasync"),            # one column
])
def test_gram_routes_match_plain_version(card, m, n, ld, offset, route):
    """fp32 gram on each 3xTF32 route, both layouts, symmetric and full,
    on views whose padding is NaN (a read past a row shows): the route
    that ran, B exactly symmetric, the whole product within 1e-5, its
    off-diagonal entries within chip_smoke.py's 4e-5, reruns bitwise."""
    import importlib
    gm = importlib.import_module("repro_torch.kernels.gram")
    g = torch.Generator(device=card).manual_seed(m + n + ld)
    flat = torch.full((offset + (m + 1) * ld,), float("nan"), device=card)
    A = flat[offset:offset + m * ld].view(m, ld)[:, :n]
    A.copy_(torch.randn((m, n), generator=g, device=card))
    assert gm.route(A) == route
    for trans in (False, True):
        want = ref.gram_ref(A, trans)
        for symmetric in (True, False):
            ops.reset_launches()
            got = ops.gram(A, symmetric=symmetric, trans=trans)
            torch.cuda.synchronize()
            assert {n_: c for n_, c in ops.route_launches.items() if c} == {
                f"gram/{route}": 1}
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(got, got.mT)
            assert _rel(got, want) <= 1e-5
            assert _offdiag(got, want) <= 4e-5
            assert torch.equal(got, ops.gram(A, symmetric=symmetric,
                                             trans=trans))


@pytest.mark.parametrize("m,n,ld,offset,route", [
    (3001, 1024, 1024, 0, "wgmma"),             # a tensor map describes A
    (3001, 1024, 1032, 0, "wgmma"),             # padded rows, by TMA
    (3001, 1021, 1021, 0, "wgmma_ld"),          # odd lda: every other row
    (3001, 1021, 1023, 0, "wgmma_ld"),          #   2 bytes off 4
    (3001, 1021, 1022, 0, "wgmma_ld"),          # even lda, not a multiple of 8
    (3001, 1021, 1024, 1, "wgmma_ld"),          # a base 2 bytes off 16
    (257, 4100, 4100, 0, "wgmma_ld"),           # A A^T's reduction long
    (256, 4096, 4096, 0, "wgmma"),
    # the 2 x 2 clusters' edges on wgmma_ld (each tile a cluster's block,
    # boxes pushed to the partners)
    (3001, 1150, 1151, 0, "wgmma_ld"),          # 9 tiles: a group half past
    (3001, 50, 51, 0, "wgmma_ld"),              # n <= 64: one box
    (2049, 2177, 2177, 0, "wgmma_ld"),          # more than one super-block
    (1150, 3001, 3001, 0, "wgmma_ld"),          # A A^T: 9 tiles in m
])
def test_bf16_gram_runs_the_tensor_cores(card, m, n, ld, offset, route):
    """bf16 gram on each tensor-core route, read in place from views whose
    padding is NaN (a read past a row shows), both layouts, symmetric and
    full: the route that ran, B exactly symmetric, the whole product
    within 1e-5, its off-diagonal entries within chip_smoke.py's 4e-5,
    reruns bitwise.  On wgmma_ld also where the 2 x 2 clusters of tiles
    meet B's edge: an odd tile count (a group half past the edge, in
    either layout), a single box, and more groups than one 4 x 4
    super-block."""
    gm = importlib.import_module("repro_torch.kernels.gram")
    g = torch.Generator(device=card).manual_seed(m + n + ld + offset)
    flat = torch.full((offset + (m + 1) * ld,), float("nan"),
                      dtype=torch.bfloat16, device=card)
    A = flat[offset:offset + m * ld].view(m, ld)[:, :n]
    A.copy_(torch.randn((m, n), generator=g, device=card))
    assert gm.route(A) == route
    for trans in (False, True):
        want = ref.gram_ref(A, trans)
        for symmetric in (True, False):
            ops.reset_launches()
            got = ops.gram(A, symmetric=symmetric, trans=trans)
            torch.cuda.synchronize()
            assert {n_: c for n_, c in ops.route_launches.items() if c} == {
                f"gram/{route}": 1}
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert torch.equal(got, got.mT)
            assert _rel(got, want) <= 1e-5
            assert _offdiag(got, want) <= 4e-5
            assert torch.equal(got, ops.gram(A, symmetric=symmetric,
                                             trans=trans))


@pytest.mark.parametrize("n,route", [(300, "tf32x3"),
                                     (301, "tf32x3_cpasync")])
def test_gram_svd_runs_3xtf32(card, n, route):
    """svd(A, k, method="gram") launches gram k times on a 3xTF32 route
    (the residual's rows decide which) and never FFMA."""
    import repro_torch
    g = torch.Generator(device=card).manual_seed(n)
    A = torch.randn((4096, n), generator=g, device=card)
    ops.reset_launches()
    res = repro_torch.svd(A, 4, method="gram")
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        f"gram/{route}": 4}
    assert {n_: c for n_, c in ops.launches.items() if c} == {
        "gram": 4, "matvec": 4}
    assert res.passes_over_A == 12 and bool(torch.isfinite(res.S).all())


@pytest.mark.parametrize("k", [1030, 2100])
@pytest.mark.parametrize("trans", [False, True])
def test_deflate_rmatvec_takes_any_width(card, k, trans):
    """U wider than one 1024-column chunk of U^T Xv sums."""
    m, n = 3000, 2051
    g = torch.Generator(device=card).manual_seed(k + trans)
    A = torch.randn((m, n), generator=g, device=card)
    side = n if trans else m
    U = torch.randn((side, k), generator=g, device=card)
    x = torch.randn(side, generator=g, device=card)
    c = torch.randn(k, generator=g, device=card)
    ops.reset_launches()
    got = ops.deflate_rmatvec(A, U, x, c, trans=trans)
    torch.cuda.synchronize()
    for a, b in zip(got, ref.deflate_rmatvec_ref(A, U, x, c, trans)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert _rel(a, b) <= 1e-5
    assert ops.launches["deflate_rmatvec"] == 1


def test_gramfree_svd_wider_than_1024(card):
    """svd(A, k > 1024, method="gramfree") runs on the card, its launches
    equal to the pass accounting."""
    import repro_torch
    g = torch.Generator(device=card).manual_seed(7)
    A = torch.randn((2048, 1100), generator=g, device=card)
    k = 1030
    ops.reset_launches()
    res = repro_torch.svd(A, k, method="gramfree", force_iters=True,
                          max_iters=1)
    iters = sum(int(i) for i in res.iters)
    assert iters == k
    assert {n: c for n, c in ops.launches.items() if c} == {
        "matvec": iters + k, "deflate_rmatvec": iters}
    assert res.passes_over_A == 3 * iters + k
    assert bool(torch.isfinite(res.S).all()) and res.S.shape == (k,)


def test_deflation_kernels_are_deterministic(card):
    g = torch.Generator(device=card).manual_seed(1)
    A = torch.randn((40000, 700), generator=g, device=card)
    U = torch.randn((40000, 6), generator=g, device=card)
    x = torch.randn(40000, generator=g, device=card)
    c = torch.randn(6, generator=g, device=card)
    for a, b in zip(ops.deflate_rmatvec(A, U, x, c),
                    ops.deflate_rmatvec(A, U, x, c)):
        assert torch.equal(a, b)
    assert torch.equal(ops.matvec(A, x, trans=True),
                       ops.matvec(A, x, trans=True))
    assert torch.equal(ops.gram(A[:3000]), ops.gram(A[:3000]))


def _attn_within(got, want, dtype):
    """Each output element against the plain version: fp32 within 1e-4
    (tests/test_kernels.py:208); bf16 within its own rounding to bf16,
    2^-8 |want|, plus 1e-5 for the fp32 sums' order."""
    err = (got.float() - want).abs()
    if dtype == "float32":
        return bool((err <= 1e-4).all())
    return bool((err <= 2.0 ** -8 * want.abs() + 1e-5).all())


@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap", [
    (1, 4, 4, 128, 64, 64, None), (2, 4, 2, 100, 16, 48, None),
    (1, 8, 1, 257, 32, 300, 50.0), (2, 2, 1, 77, 128, 16, 30.0),
    (1, 4, 2, 200, 256, 64, 50.0), (1, 2, 2, 1, 64, 4, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_attention_kernel_matches_plain_version(
        card, B, H, Hkv, S, D, window, softcap, dtype):
    g = torch.Generator(device=card).manual_seed(B * H * S * D)
    dt = getattr(torch, dtype)
    q = torch.randn((B, H, S, D), generator=g, device=card).to(dt)
    k = torch.randn((B, Hkv, S, D), generator=g, device=card).to(dt)
    v = torch.randn((B, Hkv, S, D), generator=g, device=card).to(dt)
    ops.reset_launches()
    got = ops.local_attention(q, k, v, window=window, softcap=softcap)
    want = ref.local_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (B, H, S, D)
    assert _attn_within(got, want, dtype)
    assert ops.launches["local_attention"] == 1


def test_local_attention_reads_strided_views_and_reruns_bitwise(card):
    g = torch.Generator(device=card).manual_seed(7)
    q, k, v = (torch.randn((2, 300, h, 256), generator=g, device=card)
               .to(torch.bfloat16).transpose(1, 2) for h in (4, 2, 2))
    got = ops.local_attention(q, k, v, window=128, softcap=50.0)
    again = ops.local_attention(q, k, v, window=128, softcap=50.0)
    want = ref.local_attention_ref(q, k, v, window=128, softcap=50.0)
    assert torch.equal(got, again)
    assert got.transpose(1, 2).is_contiguous()      # (B, S, H, D) memory
    assert _attn_within(got, want, "bfloat16")


def test_local_attention_refuses_an_untemplated_head_dim(card):
    q = torch.randn((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError):
        ops.local_attention(q, q, q, window=4)


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,window", [
    (1, 4),          # one row
    (129, 17),       # window below one key tile
    (129, 100),      # window between one and two tiles
    (333, 64),       # window of exactly one tile, ragged S
    (333, 1000),     # window >= S: causal attention
])
@pytest.mark.parametrize("group,softcap", [(1, None), (2, 50.0), (8, 30.0),
                                           (2, None)])
def test_tensor_core_route_matches_plain_version(card, D, S, window, group,
                                                 softcap):
    from repro_torch.kernels import local_attn
    assert local_attn.route(torch.bfloat16, D) == "wgmma"
    Hkv = 2
    g = torch.Generator(device=card).manual_seed(D + S + window + group)
    q, k, v = (torch.randn((2, S, h, D), generator=g, device=card)
               .to(torch.bfloat16).transpose(1, 2)
               for h in (Hkv * group, Hkv, Hkv))
    ops.reset_launches()
    got = ops.local_attention(q, k, v, window=window, softcap=softcap)
    want = ref.local_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert _attn_within(got, want, "bfloat16")
    assert ops.launches["local_attention"] == 1


def test_tensor_core_route_reruns_bitwise_on_strided_views(card):
    """D = 256, GQA group 8, ragged S: two runs on (B, S, H, D) views
    (every stride along B, H and S differs from a contiguous tensor's)
    give the same bits."""
    g = torch.Generator(device=card).manual_seed(11)
    base = [torch.randn((2, 333, h + 1, 256), generator=g, device=card)
            .to(torch.bfloat16) for h in (8, 1, 1)]
    q, k, v = (x[:, :, :-1].transpose(1, 2) for x in base)
    runs = [ops.local_attention(q, k, v, window=200, softcap=50.0)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    want = ref.local_attention_ref(q, k, v, window=200, softcap=50.0)
    assert _attn_within(runs[0], want, "bfloat16")


def test_tensor_core_route_refuses_a_broadcast_view(card):
    q = torch.randn((1, 4, 64, 64), device=card).to(torch.bfloat16)
    k = torch.randn((1, 1, 64, 64), device=card).to(torch.bfloat16)
    with pytest.raises(ValueError):
        ops.local_attention(q, k.expand(1, 2, 64, 64), k.expand(1, 2, 64, 64),
                            window=8)


# ---------------------------------------------------------------------------
# The out-of-core tiers: host blocks over the copy stream (core/staging.py)
# ---------------------------------------------------------------------------

def _host(m, n, seed):
    import numpy as np
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


@pytest.mark.parametrize("n", [300, 515, 1001, 1024])
@pytest.mark.parametrize("stage_dtype", ["float32", "bfloat16"])
def test_streamed_ops_match_the_plain_versions(card, n, stage_dtype):
    """Every streamed op of a HostBlockedMatrix on the card against the
    plain versions of the same kernels on the same (staged) data, summed
    over the same blocks: within the kernels' limits.  The blocks' rows
    are padded to 16 bytes, so every width runs the TMA routes."""
    from repro_torch.core import HostBlockedMatrix
    A = _host(5000, n, n)
    hb = HostBlockedMatrix(A, 3, stage_dtype=stage_dtype)
    sd = getattr(torch, stage_dtype)
    As = torch.from_numpy(A).to(card).to(sd)
    g = torch.Generator(device=card).manual_seed(n)
    Q = torch.randn((n, 7), generator=g, device=card)
    Y = torch.randn((5000, 7), generator=g, device=card)
    v = torch.randn((n,), generator=g, device=card)
    bounds = [hb.plan.bounds(b) for b in range(hb.n_blocks)]
    ops.reset_launches()
    got = {"gram_chain": hb.gram_chain(Q), "matmat": hb.matmat(Q),
           "rmatmat": hb.rmatmat(Y), "gram": hb.gram(), "matvec": hb.matvec(v)}
    torch.cuda.synchronize()
    A32 = As.to(torch.float32)
    want = {"gram_chain": sum(ref.block_gram_chain_ref(As[lo:hi], Q,
                                                       stage_dtype)
                              for lo, hi in bounds),
            "matmat": A32 @ Q, "rmatmat": A32.mT @ Y, "gram": A32.mT @ A32,
            "matvec": A32 @ v}
    for name, tol in (("gram_chain", 1e-3 if stage_dtype == "bfloat16"
                       else 1e-5), ("matmat", 1e-5), ("rmatmat", 1e-5),
                      ("gram", 1e-5), ("matvec", 1e-5)):
        assert got[name].device.type == "cuda", name
        assert _rel(got[name], want[name]) <= tol, name
    # three blocks: the chain's two sweeps and gram on the staged dtype's
    # TMA route, matmat and rmatmat on fp32 rows (tf32x3)
    tma = "tf32x3" if stage_dtype == "float32" else "wgmma"
    want = collections.Counter({f"block_matvec/{tma}": 3,
                                f"block_rmatvec/{tma}": 3, f"gram/{tma}": 3})
    want.update({"block_matvec/tf32x3": 3, "block_rmatvec/tf32x3": 3})
    assert {k: c for k, c in ops.route_launches.items() if c} == dict(want)
    hb.close()


def test_streamed_solves_rerun_bitwise(card):
    import repro_torch
    A = _host(6000, 700, 1)
    runs = [repro_torch.svd(A, 8, n_blocks=3) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert runs[0].backend == "hostblocked"
    runs = [repro_torch.svd(A, 4, n_blocks=3, method="gramfree",
                            max_iters=30) for _ in range(2)]
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)


def test_an_array_shared_by_two_matrices_registers_once(card):
    """Two matrices over one fp32 array page-lock it once; it is unlocked
    when the last closes.  A range the caller locked is used as it is
    and left locked."""
    from repro_torch.core import HostBlockedMatrix, staging
    A = _host(4000, 300, 2)
    t = torch.from_numpy(A)
    key = (t.data_ptr(), t.numel() * 4)
    assert not t.is_pinned() and key not in staging._PINNED
    h1 = HostBlockedMatrix(A, 2)
    h2 = HostBlockedMatrix(A, 4)
    assert t.is_pinned() and staging._PINNED[key] == [2, True]
    h1.close()
    assert t.is_pinned() and staging._PINNED[key] == [1, True]
    Q = torch.randn((300, 3), device=card)
    assert _rel(h2.matmat(Q), torch.from_numpy(A).to(card) @ Q) <= 1e-5
    h2.close()
    assert not t.is_pinned() and key not in staging._PINNED
    lib = staging._lib()
    assert lib.repro_host_register(key[0], key[1]) == 0   # the caller's
    h3 = HostBlockedMatrix(A, 2)
    assert staging._PINNED[key] == [1, False]
    h3.close()
    assert t.is_pinned() and key not in staging._PINNED
    assert lib.repro_host_unregister(key[0]) == 0
    assert not t.is_pinned()


@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_odd_width_host_blocks_run_the_tma_routes(card, sweep_dtype):
    """An odd-width host matrix: each block is copied into rows padded to
    16 bytes, so the chains run tf32x3 (fp32) or wgmma (bf16) and the
    extraction tf32x3, never a cp.async route; launches are n_blocks x
    the pass accounting."""
    import repro_torch
    A = _host(4099, 1001, 3)
    ops.reset_launches()
    res = repro_torch.svd(A, 16, n_blocks=4, sweep_dtype=sweep_dtype,
                          force_iters=True, max_iters=3)
    assert res.backend == "hostblocked" and res.passes_over_A == 3 + 1
    assert {n: c for n, c in ops.launches.items() if c} == {
        "block_gram_chain": 4 * 3, "block_matvec": 4 * 4,
        "block_rmatvec": 4 * 3}
    chains = "wgmma" if sweep_dtype == "bfloat16" else "tf32x3"
    want = {f"block_matvec/{chains}": 12, f"block_rmatvec/{chains}": 12}
    want["block_matvec/tf32x3"] = want.get("block_matvec/tf32x3", 0) + 4
    assert {n: c for n, c in ops.route_launches.items() if c} == want


def test_disk_tier_on_the_card_matches_the_cpu(card, tmp_path):
    """The disk tier on the card (pinned bounce buffers, the ring) and on
    the CPU converge to the same sigma of a matrix with a prescribed
    spectrum; a capped budget reads the file once a pass on both (the
    two devices draw different random starts, so only converged results
    compare)."""
    import numpy as np
    import repro_torch
    from repro_torch.core import stage_to_disk
    rng = np.random.default_rng(4)
    U, _ = np.linalg.qr(rng.standard_normal((3000, 12)))
    V, _ = np.linalg.qr(rng.standard_normal((200, 12)))
    A = ((U * 10.0 * 0.5 ** np.arange(12)) @ V.T).astype(np.float32)
    path = stage_to_disk(A, tmp_path / "A.npy")
    kw = dict(n_blocks=3, host_budget_bytes=A.nbytes // 2)
    gpu = repro_torch.svd(path, 4, **kw)
    cpu = repro_torch.svd(path, 4, device="cpu", **kw)
    assert gpu.backend == cpu.backend == "memmap"
    assert gpu.converged and cpu.converged
    for res in (gpu, cpu):
        assert res.bytes_moved["disk"] == res.passes_over_A * A.nbytes
    assert _rel(gpu.S.cpu(), cpu.S) <= 1e-5
    assert _rel(gpu.S.cpu(), torch.tensor(10.0 * 0.5 ** np.arange(4),
                                          dtype=torch.float32)) <= 1e-5


def test_lagged_gap_read_waits_for_its_step_alone(card):
    """The driver's lagged read of a gap returns once the step that made
    it is done, though work queued after it (the next step, the next
    pass's copies) still runs: ``.item()`` would wait for all of it."""
    import time
    from repro_torch.core.operator import _gap, host_sync_scalar
    Q = torch.linalg.qr(torch.randn((1000, 8), device=card)).Q
    g = _gap(Q, Q)
    torch.cuda._sleep(3_000_000_000)          # ~1.5 s of queued work
    t0 = time.perf_counter()
    v = host_sync_scalar(g)
    waited = time.perf_counter() - t0
    torch.cuda.synchronize()
    assert abs(v) < 1e-4 and waited < 0.5


# ---------------------------------------------------------------------------
# the sparse stream: CSR sweeps and the host -> device pipeline
# ---------------------------------------------------------------------------

def _csr_block(rows, n, per_row, seed, sd):
    """A CSR block of ``rows`` rows (``per_row`` nonzeros each, some
    rows empty, repeated columns), host arrays and card tensors."""
    import numpy as np
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 2 * per_row, rows)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = rng.integers(0, n, int(off[-1])).astype(np.int32)
    val = rng.standard_normal(int(off[-1])).astype(np.float32)
    if sd == torch.bfloat16:
        val = torch.from_numpy(val).to(sd).to(torch.float32).numpy()
    return off, col, val, [torch.from_numpy(x).to("cuda") for x in
                           (off, col, val)]


def _oracle(off, col, val, X, transpose, round_y=False):
    """``np.add.at`` in stream order: the JAX package's host sweep."""
    import numpy as np
    rows = np.repeat(np.arange(len(off) - 1), np.diff(off))
    if transpose:
        out = np.zeros((int(col.max()) + 1 if col.size else 0, X.shape[1]),
                       np.float32)
        np.add.at(out, col, val[:, None] * X[rows])
        return out
    out = np.zeros((len(off) - 1, X.shape[1]), np.float32)
    np.add.at(out, rows, val[:, None] * X[col])
    if round_y:
        out = torch.from_numpy(out).to(torch.bfloat16).to(
            torch.float32).numpy()
    return out


@pytest.mark.parametrize("k", [1, 3, 8, 33])
@pytest.mark.parametrize("sd", [torch.float32, torch.bfloat16])
def test_csr_sweeps_are_bitwise_np_add_at(card, sd, k):
    """Each product rounded before its add, summed in stream order: every
    element is np.add.at's; reruns are bitwise equal (no atomics)."""
    import numpy as np
    n = 5000
    off, col, val, (o, c, v) = _csr_block(3001, n, 5, k, sd)
    v = v.to(sd)
    rng = np.random.default_rng(7)
    Q = rng.standard_normal((n, k)).astype(np.float32)
    Y = rng.standard_normal((3000 + 1, k)).astype(np.float32)
    if sd == torch.bfloat16:
        Q, Y = (torch.from_numpy(x).to(sd).to(torch.float32).numpy()
                for x in (Q, Y))
    Qd, Yd = torch.from_numpy(Q).to(card), torch.from_numpy(Y).to(card)
    ops.reset_launches()
    got = ops.csr_matmat(o, c, v, Qd)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(off, col, val, Q, False))
    Z = torch.zeros((n, k), device=card)
    ops.csr_rmatmat(o, c, v, Yd, Z)
    want = np.zeros((n, k), np.float32)
    np.add.at(want, col, val[:, None] * Y[np.repeat(np.arange(3001),
                                                    np.diff(off))])
    np.testing.assert_array_equal(Z.cpu().numpy(), want)
    Z2 = torch.zeros((n, k), device=card)
    ops.csr_gram_chain(o, c, v, Qd, Z2, round_y=sd == torch.bfloat16)
    y = _oracle(off, col, val, Q, False, round_y=sd == torch.bfloat16)
    want2 = np.zeros((n, k), np.float32)
    np.add.at(want2, col, val[:, None] * y[np.repeat(np.arange(3001),
                                                     np.diff(off))])
    np.testing.assert_array_equal(Z2.cpu().numpy(), want2)
    Z3 = torch.zeros((n, k), device=card)
    ops.csr_gram_chain(o, c, v, Qd, Z3, round_y=sd == torch.bfloat16)
    assert torch.equal(Z2, Z3)
    name = str(sd).rsplit(".", 1)[-1]
    assert ops.launches["csr_matmat"] == 3 and \
        ops.launches["csr_rmatmat"] == 3 and \
        ops.launches["csr_gram_chain"] == 2
    assert ops.route_launches[f"csr_matmat/{name}"] == 3


#: every order case of ``tests/csr_cases.py`` at every k, but n = 2^31 - 1
#: at k = 1 (Q and Z 8.6 GB each, 32-bit index math) and k = 2 (17.2 GB
#: each: n k >= 2^31, the 64-bit index path)
CSR_ORDER = [(name, k) for name in csr_cases.CASES
             for k in (csr_cases.KS if name != "n_2^31-1" else (1, 2))]


def _csr_order_run(case, Q, Z, Zc, Ys, sd, dev):
    """Every block of ``case``: ``A_b Q`` (returned), ``Z += A_b^T Y``
    and the chain into ``Zc``, through ``ops``."""
    ys = []
    for (off, col, val), Y in zip(case["blocks"], Ys):
        o, c = (torch.from_numpy(x).to(dev) for x in (off, col))
        v = torch.from_numpy(val).to(dev).to(sd)
        ys.append(ops.csr_matmat(o, c, v, Q).cpu().numpy())
        ops.csr_rmatmat(o, c, v, torch.from_numpy(Y).to(dev), Z)
        ops.csr_gram_chain(o, c, v, Q, Zc, round_y=sd == torch.bfloat16)
    torch.cuda.synchronize()
    return ys


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name,k", CSR_ORDER)
def test_csr_order_cases_are_bitwise_np_add_at(card, name, k, bf16):
    """The CPU order model's cases on the card: empty rows and an empty
    block, one column holding every nonzero, Z carried across blocks that
    share columns, n = 2^25 and 2^31 - 1; each ``A_b Q``, each
    ``Z += A_b^T Y`` and the chain bitwise ``np.add.at``, the untouched
    rows of Z still zero, a rerun bitwise, and one launch a call counted
    under its route."""
    import numpy as np
    import csr_cases as cc
    case = cc.make_case(name, bf16)
    u = cc.touched(case)
    Qu, Zu, Ys = cc.dense_rows(case, k, bf16)
    sd = torch.bfloat16 if bf16 else torch.float32
    n, nb = case["n"], len(case["blocks"])
    ui = torch.from_numpy(u.astype(np.int64)).to(card)
    Q = torch.zeros((n, k), device=card)
    Q[ui] = torch.from_numpy(Qu).to(card)
    outs = []
    for _ in range(2):                          # the rerun must match
        Z = torch.zeros((n, k), device=card)
        Z[ui] = torch.from_numpy(Zu).to(card)
        Zc = Z.clone()
        ops.reset_launches()
        ys = _csr_order_run(case, Q, Z, Zc, Ys, sd, card)
        name_sd = str(sd).rsplit(".", 1)[-1]
        assert ops.launches["csr_matmat"] == 2 * nb
        assert ops.launches["csr_rmatmat"] == 2 * nb
        assert ops.launches["csr_gram_chain"] == nb
        assert ops.route_launches[f"csr_matmat/{name_sd}"] == 2 * nb
        assert ops.route_launches[f"csr_rmatmat/{name_sd}"] == 2 * nb
        outs.append((ys, Z[ui].cpu().numpy(), Zc[ui].cpu().numpy()))
        Z[ui] = 0
        Zc[ui] = 0
        assert not bool(Z.any()) and not bool(Zc.any())   # untouched rows
        del Z, Zc
    Z_at, C_at = Zu.copy(), Zu.copy()
    for (off, col, val), Y, y in zip(case["blocks"], Ys, outs[0][0]):
        np.testing.assert_array_equal(y, cc.add_at_matmat(off, col, val, u,
                                                          Qu))
        Z_at = cc.add_at_rmatmat(off, col, val, u, Y, Z_at)
        yr = cc.bf16_round(y) if bf16 else y
        C_at = cc.add_at_rmatmat(off, col, val, u, yr, C_at)
    np.testing.assert_array_equal(outs[0][1], Z_at)
    np.testing.assert_array_equal(outs[0][2], C_at)
    for a, b in zip(outs[0][0] + list(outs[0][1:]),
                    outs[1][0] + list(outs[1][1:])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_csr_block_of_the_paper_share_is_bitwise_np_add_at(card, bf16):
    """Rows [2^24, 2^24 + 4096) of ``SyntheticSparseMatrix`` at the
    paper's per-node share (n = 33554432, 33 nonzeros a row), k = 8:
    ``A_b Q`` and ``Z += A_b^T Y`` bitwise ``np.add.at``, a rerun bitwise."""
    import numpy as np
    import csr_cases as cc
    from repro_torch.core import SyntheticSparseMatrix
    sp = SyntheticSparseMatrix(1 << 25, 1 << 25, 33, seed=0)
    lo = 1 << 24
    off, col, val = sp._csr_block(lo, lo + 4096)
    off, col = off.astype(np.int32), col.astype(np.int32)
    val = cc.bf16_round(val) if bf16 else val.astype(np.float32)
    case = {"n": sp.n, "blocks": [(off, col, val)]}
    u = cc.touched(case)
    Qu, Zu, Ys = cc.dense_rows(case, 8, bf16)
    sd = torch.bfloat16 if bf16 else torch.float32
    ui = torch.from_numpy(u.astype(np.int64)).to(card)
    Q = torch.zeros((sp.n, 8), device=card)
    Q[ui] = torch.from_numpy(Qu).to(card)
    got = []
    for _ in range(2):
        Z = torch.zeros((sp.n, 8), device=card)
        Z[ui] = torch.from_numpy(Zu).to(card)
        ys = _csr_order_run(case, Q, Z, Z.clone(), Ys, sd, card)
        got.append((ys[0], Z[ui].cpu().numpy()))
        del Z
    np.testing.assert_array_equal(got[0][0], cc.add_at_matmat(
        off, col, val, u, Qu))
    np.testing.assert_array_equal(got[0][1], cc.add_at_rmatmat(
        off, col, val, u, Ys[0], Zu))
    np.testing.assert_array_equal(got[0][0], got[1][0])
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_csr_halves_and_probe_on_the_card(card):
    """``csr_rmatmat``'s sort half then its sum half on one scratch give
    the whole call's bits (the sort half sums nothing); the library's
    chunk is the binding's ``BUCKET_CAP``; the row gather probe sums
    ``src[idx]`` in column order."""
    import numpy as np
    import csr_cases as cc
    csr = importlib.import_module("repro_torch.kernels.csr_sweep")
    for name in ("ragged", "one_column_long"):
        case = cc.make_case(name, False)
        off, col, val = case["blocks"][0]
        o, c, v = (torch.from_numpy(x).to(card) for x in (off, col, val))
        for k in (1, 8, 33):
            Y = torch.randn((off.size - 1, k), device=card)
            Z0 = torch.randn((case["n"], k), device=card)
            want = csr.csr_rmatmat_cuda(o, c, v, Y, Z0.clone())
            scratch = csr.rmatmat_scratch(col.size, case["n"], card)
            Z = Z0.clone()
            csr.csr_rmatmat_cuda(o, c, v, Y, Z, scratch=scratch,
                                 phases=csr.SORT)
            assert torch.equal(Z, Z0)
            csr.csr_rmatmat_cuda(o, c, v, Y, Z, scratch=scratch,
                                 phases=csr.RUNS)
            assert torch.equal(Z, want), (name, k)
    assert csr.bucket_cap() == csr.BUCKET_CAP
    src = torch.randn((1 << 16, 8), device=card)
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 16, 5000).astype(np.int32)).to(card)
    rows = src[idx.long()]
    want = rows[:, 0].clone()
    for x in range(1, 8):
        want = want + rows[:, x]
    assert torch.equal(csr.row_gather_cuda(src, idx), want)


def test_sparse_stream_on_the_card_matches_the_cpu(card):
    """The pipeline (packing threads, pinned buffers, copy stream) gives
    the CPU path's bits for every streamed op; launches are one a block
    and a kernel; PCIe bytes count the CSR arrays."""
    import numpy as np
    from repro_torch.core import SyntheticSparseMatrix
    sp = SyntheticSparseMatrix(10000, 3000, 7, seed=2, chunk=512)
    Q = np.random.default_rng(1).standard_normal((3000, 8)).astype(
        np.float32)
    Y = np.random.default_rng(2).standard_normal((10000, 8)).astype(
        np.float32)
    for sd in ("float32", "bfloat16"):
        sp.reset_feed_stats()
        ops.reset_launches()
        for name, X in (("matmat", Q), ("rmatmat", Y), ("gram_chain", Q)):
            got = getattr(sp, name)(X, 999, dtype=sd, device=card)
            want = getattr(sp, name)(X, 999, dtype=sd, device="cpu")
            assert torch.equal(got.cpu(), want), (name, sd)
        got = sp.range_sketch(5, seed=3, block_rows=999, dtype=sd,
                              device=card)
        assert torch.equal(got.cpu(), sp.range_sketch(
            5, seed=3, block_rows=999, dtype=sd, device="cpu"))
        blocks = 11
        assert ops.launches["csr_gram_chain"] == blocks
        assert ops.launches["csr_matmat"] == 2 * blocks
        assert ops.launches["csr_rmatmat"] == 3 * blocks
        st = sp.feed_stats()
        assert st["blocks"] == 4 * blocks and st["nnz"] == 4 * sp.nnz
        itemsize = 4 if sd == "float32" else 2
        assert st["pcie_bytes"] == 4 * (sp.nnz * (4 + itemsize) + 4 * (
            10000 + blocks)) + 10000 * 5 * 4
    sp.close()


def test_sparse_solve_on_the_card_resumes_bitwise(card, tmp_path):
    """A capped sparse solve on the card resumes onto the uncapped one's
    bits; launches are blocks x passes by kernel."""
    from repro_torch.core import SyntheticSparseMatrix
    import repro_torch
    sp = SyntheticSparseMatrix(20000, 500, 9, seed=4)
    kw = dict(force_iters=True, max_iters=6, block_rows=4096)
    ops.reset_launches()
    ref = repro_torch.svd(sp, 4, **kw)
    assert ref.passes_over_A == 7 and ref.backend == "sparsestream"
    assert ops.launches["csr_gram_chain"] == 5 * 6
    assert ops.launches["csr_matmat"] == 5 * 7
    ck = str(tmp_path / "ck")
    repro_torch.svd(sp, 4, checkpoint_dir=ck, **{**kw, "max_iters": 3})
    again = repro_torch.svd(sp, 4, checkpoint_dir=ck, **kw)
    for a, b in zip(again[:3], ref[:3]):
        assert torch.equal(a, b)
    assert again.passes_over_A == ref.passes_over_A


def test_sparse_stream_with_empty_blocks_on_the_card(card):
    """A scipy stream whose row blocks hold no nonzeros, or far fewer than
    the block before, goes through the ring's grown and emptied buffers
    with the CPU path's bits."""
    import numpy as np
    import scipy.sparse
    from repro_torch.core import ScipySparseMatrix
    dense = np.zeros((3000, 400), np.float32)
    rng = np.random.default_rng(5)
    dense[:500] = rng.standard_normal((500, 400)) * (rng.random((500, 400))
                                                      < 0.3)
    dense[2200:2210, :7] = 1.5                    # a thin block after
    sp = ScipySparseMatrix(scipy.sparse.csr_matrix(dense))
    Q = rng.standard_normal((400, 3)).astype(np.float32)
    for sd in ("float32", "bfloat16"):
        got = sp.gram_chain(Q, 500, dtype=sd, device=card)
        want = sp.gram_chain(Q, 500, dtype=sd, device="cpu")
        assert torch.equal(got.cpu(), want), sd
        assert torch.equal(sp.matmat(Q, 500, dtype=sd, device=card).cpu(),
                           sp.matmat(Q, 500, dtype=sd, device="cpu"))
    sp.close()


def test_block_beyond_int32_nonzeros_is_refused_on_the_card(card):
    """The packing threads refuse a block of 2^31 nonzeros (the count is
    stubbed) before anything is cast or copied."""
    import numpy as np
    from repro_torch.core import RowBlockStream

    class Huge(RowBlockStream):
        m, n, seed = 2, 8, 0

        def _csr_block(self, lo, hi):
            return (np.array([0, 2**31 - 1, 2**31][:hi - lo + 1], np.int64),
                    np.zeros(0, np.int64), np.zeros(0, np.float32))

    s = Huge()
    with pytest.raises(ValueError, match="int32.*block_rows"):
        s.rmatmat(torch.zeros((2, 1), device=card), block_rows=2)
    s.close()


# ---------------------------------------------------------------------------
# the SVD service on the card (repro_torch.serving)
# ---------------------------------------------------------------------------

def _service_specs(n_jobs, sweep_dtype="float32", nan_lane=None):
    import numpy as np
    from repro_torch.core.config import SVDConfig
    from repro_torch.serving import JobSpec
    rng = np.random.default_rng(0)
    specs = []
    for i in range(n_jobs):
        U, _ = np.linalg.qr(rng.standard_normal((512, 128)))
        V, _ = np.linalg.qr(rng.standard_normal((128, 128)))
        A = ((U * np.geomspace(10.0, 1e-2, 128)) @ V.T).astype(np.float32)
        if i == nan_lane:
            A[1, 2] = np.nan
        specs.append(JobSpec(input=torch.from_numpy(A), k=6, config=SVDConfig(
            eps=1e-6, max_iters=200, warmup_q=1, seed=i,
            sweep_dtype=sweep_dtype)))
    return specs


@pytest.mark.parametrize("sweep_dtype", ["float32", "bfloat16"])
def test_batched_solve_on_the_card_matches_the_cpu(card, sweep_dtype):
    """The same jobs stacked on the card and on the CPU: sigma within
    1e-4, the same subspaces, a NaN lane failing alone on both."""
    import numpy as np
    from repro_torch.serving.batcher import solve_batch
    specs = _service_specs(6, sweep_dtype, nan_lane=3)
    gpu = solve_batch(specs, device="cuda")
    cpu = solve_batch(specs, device="cpu")
    for i, ((g, ge), (c, ce)) in enumerate(zip(gpu, cpu)):
        if i == 3:
            assert g is None and type(ge).__name__ == "NumericalHealthError"
            assert c is None and type(ce).__name__ == "NumericalHealthError"
            continue
        assert ge is None and ce is None
        assert g.S.is_cuda and g.U.is_cuda
        # (no iteration count compared: at eps * l the fp32 gap is near
        # its rounding noise, which differs between the two devices)
        torch.testing.assert_close(g.S.cpu(), c.S, rtol=1e-4, atol=0)
        cos = torch.linalg.svdvals(g.V.cpu().mT @ c.V)
        assert float(cos.min()) > 1 - 1e-3, cos
        for r in (g, c):
            assert r.passes_over_A == 2 * int(r.iters[0]) + 1 + 3
        assert g.bytes_per_pass == c.bytes_per_pass


def test_fp32_lanes_run_no_tf32(card):
    """The port's contract: fp32 operands are never plain TF32.  The
    batcher sets no flag, so a batched fp32 lane's products are full fp32
    sgemm: its chain equals the float64 product to fp32 rounding, where
    TF32 (10-bit mantissas) would be ~1e-3 off."""
    from repro_torch.serving.batcher import _bmm_fp32
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.randn((4, 1024, 256), generator=g, device="cuda")
    Q = torch.randn((4, 256, 8), generator=g, device="cuda")
    got = _bmm_fp32(X, Q)
    want = (X.double() @ Q.double()).float()
    err = float((got - want).norm() / want.norm())
    assert err < 1e-6, err
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_two_workers_on_the_card_give_the_serial_bits(card):
    """Two jobs through a two-worker service on the card, at once on the
    default stream, are bitwise the same solves run one after another,
    and each job's own launch tally is its serial solve's plus one
    ``block_matvec`` a streamed partial."""
    import repro_torch
    from repro_torch.kernels import ops
    from repro_torch.serving import JobStatus, SVDService
    specs = _service_specs(2)
    Xs = [s.input.cuda() for s in specs]
    serial, tallies = [], []
    for X, s in zip(Xs, specs):
        with ops.thread_launches() as tally:
            serial.append(repro_torch.svd(
                X, 6, config=s.config.replace(warmup_q=0)))
        tallies.append(tally)
    with SVDService(max_workers=2, device="cuda") as svc:
        hs = [svc.submit(X, 6, config=s.config.replace(warmup_q=0),
                         stream_every=7) for X, s in zip(Xs, specs)]
        assert all(h.wait(60.0) is JobStatus.DONE for h in hs)
        got = [h.result(1.0) for h in hs]
        jobs = [svc._jobs[h.job_id] for h in hs]
    for s, t in zip(serial, got):
        for a, b in zip(s[:3], t[:3]):
            assert torch.equal(a, b)
        assert s.passes_over_A == t.passes_over_A
    for job, tally in zip(jobs, tallies):
        want = {key: c + job.partial_count * key.startswith("block_matvec")
                for key, c in tally.items()}
        assert job.partial_count > 0 and job.launches == want


@pytest.mark.parametrize("B,H,Hkv,S,D,window,softcap", [
    (2, 4, 2, 133, 128, 64, 50.0), (1, 8, 1, 70, 256, 70, None)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_attention_bwd_matches_plain_version(
        card, B, H, Hkv, S, D, window, softcap, dtype):
    """The backward kernel (``csrc/local_attn_bwd.cu``) at ragged shapes
    against its plain version on the forward kernel's log-sum-exp, each
    gradient element held as the forward's output is (``_attn_within``),
    two runs bitwise equal."""
    from repro_torch.kernels import local_attn
    g = torch.Generator(device=card).manual_seed(B * H * S + D)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=g, device=card).to(dt)
             .transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=card).to(dt)
            .transpose(1, 2) for _ in range(2))
    lse = torch.empty((B, H, S), device=card)
    o = local_attn.local_attention_cuda(q, k, v, window, softcap, lse)
    ops.reset_launches()
    got = ops.local_attention_bwd(q, k, v, o, do, lse, window=window,
                                  softcap=softcap)
    again = ops.local_attention_bwd(q, k, v, o, do, lse, window=window,
                                    softcap=softcap)
    want = ref.local_attention_bwd_ref(q, k, v, o, do, lse, window=window,
                                       softcap=softcap)
    torch.cuda.synchronize()
    assert ops.launches["local_attention_bwd"] == 2 * local_attn.BWD_KERNELS
    for a, b, w in zip(got, again, want):
        assert a.dtype == dt and a.shape == w.shape
        assert torch.equal(a, b)
        assert _attn_within(a, w, dtype)


@pytest.mark.parametrize("B,H,Hkv,S,window,softcap", [
    (1, 4, 4, 97, 40, 50.0),       # G = 1; a window cutting key tiles, cap
    (2, 4, 2, 133, 64, None),      # G = 2, S past two tiles
    (1, 8, 1, 150, 1000, 30.0),    # G = 8, window past S, cap
    (1, 2, 1, 200, 70, None)])     # G = 2, window 70 across three tiles
@pytest.mark.parametrize("D", [64, 128, 256])
def test_local_attention_bwd_tensor_core_route(card, B, H, Hkv, S, D, window,
                                               softcap):
    """bf16 at D >= 64: the backward's tensor-core kernels
    (``local_attn.bwd_route`` says ``"wgmma"``), each gradient element
    held as the forward's output is (``_attn_within``), two runs bitwise
    equal, every launch counted under that route."""
    from repro_torch.kernels import local_attn
    assert local_attn.bwd_route(torch.bfloat16, D) == "wgmma"
    g = torch.Generator(device=card).manual_seed(B * H * S + D + window)
    q, do = (torch.randn((B, S, H, D), generator=g, device=card)
             .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device=card)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    lse = torch.empty((B, H, S), device=card)
    o = local_attn.local_attention_cuda(q, k, v, window, softcap, lse)
    ops.reset_launches()
    got = ops.local_attention_bwd(q, k, v, o, do, lse, window=window,
                                  softcap=softcap)
    again = ops.local_attention_bwd(q, k, v, o, do, lse, window=window,
                                    softcap=softcap)
    want = ref.local_attention_bwd_ref(q, k, v, o, do, lse, window=window,
                                       softcap=softcap)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.route_launches.items() if c} == {
        "local_attention_bwd/wgmma": 2 * local_attn.BWD_KERNELS}
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.equal(a, b)
        assert _attn_within(a, w, "bfloat16")


def test_local_attention_bwd_copies_a_broadcast_gradient(card):
    """A ``do`` broadcast over the heads (a zero stride, which no tensor
    map describes) is copied before the tensor-core route reads it: the
    same gradient as from its contiguous copy."""
    from repro_torch.kernels import local_attn
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((1, 70, h, 128), generator=g, device=card)
               .to(torch.bfloat16).transpose(1, 2) for h in (4, 2, 2))
    do = torch.randn((1, 1, 70, 128), generator=g, device=card).to(
        torch.bfloat16).expand(1, 4, 70, 128)
    assert not local_attn.bwd_reads_in_place("wgmma", do)
    lse = torch.empty((1, 4, 70), device=card)
    o = local_attn.local_attention_cuda(q, k, v, 70, None, lse)
    got = ops.local_attention_bwd(q, k, v, o, do, lse, window=70)
    want = ops.local_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                   window=70)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_local_attention_autograd_launches_forward_and_backward(card):
    """Under autograd ``ops.local_attention`` is the kernel's Function:
    one forward launch (keeping the log-sum-exp), then the backward's
    kernels; no grad, the forward alone."""
    from repro_torch.kernels import local_attn
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((1, 130, h, 128), generator=g, device=card)
               .to(torch.bfloat16).transpose(1, 2).requires_grad_()
               for h in (4, 2, 2))
    ops.reset_launches()
    o = ops.local_attention(q, k, v, window=64, softcap=50.0)
    grads = torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.launches.items() if c} == {
        "local_attention": 1, "local_attention_bwd": local_attn.BWD_KERNELS}
    assert all(gr.shape == x.shape for gr, x in zip(grads, (q, k, v)))
    ops.reset_launches()
    with torch.no_grad():
        ops.local_attention(q, k, v, window=64, softcap=50.0)
    assert {n: c for n, c in ops.launches.items() if c} == {
        "local_attention": 1}


def test_analysis_on_the_card_census_and_a_traffic(card):
    """``chip_smoke.py``'s 13.1 as a test: every analysis target runs on the
    card (the sharded ones in a child process on a world-1 NCCL group) and
    comes out clean; each accounting group's A-traffic, the kernels' own
    tally (``ops.thread_a_bytes``), equals its operator's accounting; the
    block steps launched the routes their sweep dtype names."""
    from repro_torch.analysis import run_all
    rep = run_all(device="cuda")
    assert rep.ok, "\n".join(str(v) for v in rep.failures)
    acct = [c.details for c in rep.checks
            if c.target.startswith("accounting:")]
    assert len(acct) == 12
    for d in acct:
        assert d["measured_bytes"] == d["expected_bytes"], d
    trace = {c.target: c.details for c in rep.checks
             if c.pass_name == "trace"}
    for tag, routes in (("dense/block/float32", ("tf32x3", "tf32x3_cpasync")),
                        ("sharded/block/float32",
                         ("tf32x3", "tf32x3_cpasync")),
                        ("dense/block/bfloat16", ("wgmma", "wgmma_ld")),
                        ("sharded/block/bfloat16", ("wgmma", "wgmma_ld")),
                        ("hostblocked/chain/bfloat16/block0",
                         ("wgmma", "wgmma_ld"))):
        ran = {k.split("/", 1)[1] for k in trace[tag]["launches"]
               if k.startswith(("block_matvec/", "block_rmatvec/"))}
        assert ran and ran <= set(routes), (tag, trace[tag]["launches"])
    assert trace["sparsestream/block/bfloat16"]["launches"].get(
        "csr_gram_chain/bfloat16") == 3


def test_service_first_solves_on_the_card_in_a_fresh_process(card):
    """A fresh process's first ``torch.linalg`` calls on the card load
    torch's CUDA linear-algebra library, a load that is not thread-safe:
    two workers starting their first solves at once failed one job with
    ``lazy wrapper should be called at most once`` until
    ``SVDService.start`` made one call first."""
    import os
    import subprocess
    import sys
    code = (
        "import torch\n"
        "from repro_torch.serving import JobStatus, SVDService\n"
        "g = torch.Generator(device='cuda').manual_seed(0)\n"
        "with SVDService(max_workers=4, device='cuda') as svc:\n"
        "    hs = [svc.submit(torch.randn((64 + 8 * i, 24), generator=g,\n"
        "                                 device='cuda'), 4, stream_every=1)\n"
        "          for i in range(8)]\n"
        "    st = [h.wait(120.0) for h in hs]\n"
        "print([s.value for s in st], [h.error for h in hs])\n"
        "assert all(s is JobStatus.DONE for s in st)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# the LM's recurrences
# ---------------------------------------------------------------------------

TOL_RGLRU = 1e-5
TOL_WKV6 = 1e-4


def _rel_max(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("B,T,R", [(2, 1, 64), (2, 37, 130), (1, 4097, 96),
                                   (3, 16, 4096), (2, 161, 100),
                                   (1, 95, 4099)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_matches_plain_version(card, B, T, R, with_h0):
    g = torch.Generator(device=card).manual_seed(B * T + R)
    a = torch.rand((B, T, R), generator=g, device=card) * 0.5 + 0.499
    b = torch.randn((B, T, R), generator=g, device=card)
    h0 = torch.randn((B, R), generator=g, device=card) if with_h0 else None
    ops.reset_launches()
    got = ops.rglru_scan(a, b, h0)
    want = ref.rglru_scan_ref(a, b, h0)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == 1
    assert got.shape == (B, T, R) and got.dtype == torch.float32
    assert _rel_max(got, want) <= TOL_RGLRU
    assert torch.equal(got, want)


def _wkv_operands(g, card, B, T, H, hd):
    r, k, v = (torch.randn((B, T, H, hd), generator=g, device=card)
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn((B, T, H, hd), generator=g,
                                         device=card) * 0.5 - 2.0))
    u = torch.randn((H, hd), generator=g, device=card) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("B,T,H,hd", [(2, 1, 4, 16), (2, 33, 3, 32),
                                      (1, 4097, 2, 64), (2, 70, 2, 128)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_kernel_matches_plain_version(card, B, T, H, hd, with_s0):
    g = torch.Generator(device=card).manual_seed(B * T + hd)
    r, k, v, w, u = _wkv_operands(g, card, B, T, H, hd)
    S0 = (torch.randn((B, H, hd, hd), generator=g, device=card)
          if with_s0 else None)
    ops.reset_launches()
    out, S_T = ops.wkv6(r, k, v, w, u, S0)
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, S0)
    torch.cuda.synchronize()
    assert ops.launches["wkv6"] == 1
    assert out.shape == (B, T, H, hd) and S_T.shape == (B, H, hd, hd)
    assert _rel_max(out, want_o) <= TOL_WKV6
    assert _rel_max(S_T, want_s) <= TOL_WKV6
    assert torch.equal(S_T, want_s)


#: steps a chunk of ``csrc/wkv6.cu`` by head size (its Tile's C), for the
#: parametrizations; ``test_wkv6_chunk_table_is_the_builds`` holds it to
#: the build's own ``recurrent.wkv_chunk``
WKV_CHUNK = {16: 32, 32: 32, 64: 32, 128: 16}


def _wkv6_case(card, B, T, H, hd, w=None, with_s0=True, seed=0):
    """The kernel against the plain loop on one draw (``w`` replacing the
    decays where given): one launch, the output within ``TOL_WKV6``, the
    state bitwise, and a rerun bitwise."""
    g = torch.Generator(device=card).manual_seed(seed)
    r, k, v, w0, u = _wkv_operands(g, card, B, T, H, hd)
    w = w0 if w is None else w(g)
    S0 = (torch.randn((B, H, hd, hd), generator=g, device=card)
          if with_s0 else None)
    ops.reset_launches()
    out, S_T = ops.wkv6(r, k, v, w, u, S0)
    torch.cuda.synchronize()
    assert ops.launches["wkv6"] == 1
    want_o, want_s = ref.wkv6_ref(r, k, v, w, u, S0)
    assert _rel_max(out, want_o) <= TOL_WKV6
    assert torch.equal(S_T, want_s)
    again = ops.wkv6(r, k, v, w, u, S0)
    assert torch.equal(again[0], out) and torch.equal(again[1], S_T)


@pytest.mark.parametrize("hd,T", [(hd, C + d) for hd, C in WKV_CHUNK.items()
                                  for d in (-1, 0, 1)])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_kernel_at_chunk_edges(card, hd, T, with_s0):
    _wkv6_case(card, 2, T, 3, hd, with_s0=with_s0, seed=T + hd)


#: decays at the edges the plain loop takes: all below 1e-30 (exp(-80)
#: and less), and all 1 - 2^-24, the largest float32 below 1
WKV_DECAYS = {
    "strong": lambda shape: lambda g: torch.exp(
        -80.0 - torch.rand(shape, generator=g, device=g.device) * 10.0),
    "near_one": lambda shape: lambda g: torch.full(
        shape, 1.0 - 2.0 ** -24, device=g.device)}


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("decay", sorted(WKV_DECAYS))
def test_wkv6_kernel_at_extreme_decays(card, hd, decay):
    B, T, H = 2, 2 * WKV_CHUNK[hd] + 5, 2
    _wkv6_case(card, B, T, H, hd, w=WKV_DECAYS[decay]((B, T, H, hd)),
               seed=hd)


def test_wkv6_refuses_an_untemplated_head_size(card):
    g = torch.Generator(device=card).manual_seed(0)
    with pytest.raises(ValueError, match="head size"):
        ops.wkv6(*_wkv_operands(g, card, 1, 4, 2, 24))


#: the RWKV-6 backward's gradients other than dS0 (sums over a key or a
#: value index, in another order than the plain loop's), each against its
#: largest magnitude: the forward output's limit
TOL_WKV6_BWD = 1e-4


def _rglru_bwd_case(card, B, T, R, with_h0, seed):
    """The backward kernel against the plain reverse loop: one launch, da,
    db and dh0 bitwise, a rerun bitwise."""
    g = torch.Generator(device=card).manual_seed(seed)
    a = torch.rand((B, T, R), generator=g, device=card) * 0.5 + 0.499
    b = torch.randn((B, T, R), generator=g, device=card)
    h0 = torch.randn((B, R), generator=g, device=card) if with_h0 else None
    dh = torch.randn((B, T, R), generator=g, device=card)
    h = ops.rglru_scan(a, b, h0)
    ops.reset_launches()
    got = ops.rglru_scan_bwd(a, h, h0, dh)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan_bwd"] == 1
    want = ref.rglru_scan_bwd_ref(a, h, h0, dh)
    again = ops.rglru_scan_bwd(a, h, h0, dh)
    for x, y, z in zip(got, want, again):
        if y is None:
            assert x is None and z is None
        else:
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("B,T,R", [(2, 1, 64), (2, 37, 130), (1, 4097, 96),
                                   (3, 16, 4096), (2, 161, 100),
                                   (1, 95, 4099)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_bwd_kernel_matches_plain_version(card, B, T, R,
                                                     with_h0):
    _rglru_bwd_case(card, B, T, R, with_h0, seed=B * T + R + 1)


def _wkv6_bwd_case(card, B, T, H, hd, w=None, with_s0=True, with_ds=True,
                   seed=0):
    """The backward kernel against the plain reverse loop, from the chunk
    states of the forward kernel: one backward launch, dS0 bitwise, the
    other gradients within ``TOL_WKV6_BWD``, a rerun bitwise."""
    from repro_torch.kernels import recurrent
    g = torch.Generator(device=card).manual_seed(seed)
    r, k, v, w0, u = _wkv_operands(g, card, B, T, H, hd)
    w = w0 if w is None else w(g)
    S0 = (torch.randn((B, H, hd, hd), generator=g, device=card)
          if with_s0 else None)
    do = torch.randn((B, T, H, hd), generator=g, device=card)
    dS = (torch.randn((B, H, hd, hd), generator=g, device=card)
          if with_ds else None)
    Sc = recurrent.wkv6_cuda(r, k, v, w, u, S0, states=True)[2]
    ops.reset_launches()
    got = ops.wkv6_bwd(r, k, v, w, u, S0, do, dS, states=Sc)
    torch.cuda.synchronize()
    assert ops.launches["wkv6_bwd"] == 1 and ops.launches["wkv6"] == 0
    want = ref.wkv6_bwd_ref(r, k, v, w, u, S0, do, dS)
    again = ops.wkv6_bwd(r, k, v, w, u, S0, do, dS, states=Sc)
    for name, x, y, z in zip(("dr", "dk", "dv", "dw", "du", "dS0"), got,
                             want, again):
        assert x.shape == y.shape and torch.equal(x, z), name
        if name == "dS0":
            assert torch.equal(x, y)
        else:           # dw is all zeros at T = 1 without dS_T
            assert float((x - y).abs().max()) <= TOL_WKV6_BWD * float(
                y.abs().max()), name


@pytest.mark.parametrize("B,T,H,hd", [(2, 1, 4, 16), (2, 33, 3, 32),
                                      (1, 4097, 2, 64), (2, 70, 2, 128)])
@pytest.mark.parametrize("with_s0,with_ds", [(False, False), (True, True),
                                             (True, False)])
def test_wkv6_bwd_kernel_matches_plain_version(card, B, T, H, hd, with_s0,
                                               with_ds):
    _wkv6_bwd_case(card, B, T, H, hd, with_s0=with_s0, with_ds=with_ds,
                   seed=B * T + hd + 7)


@pytest.mark.parametrize("hd,T", [(hd, C + d) for hd, C in WKV_CHUNK.items()
                                  for d in (-1, 0, 1)])
def test_wkv6_bwd_kernel_at_chunk_edges(card, hd, T):
    _wkv6_bwd_case(card, 2, T, 3, hd, seed=T + hd + 3)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
@pytest.mark.parametrize("decay", sorted(WKV_DECAYS))
def test_wkv6_bwd_kernel_at_extreme_decays(card, hd, decay):
    B, T, H = 2, 2 * WKV_CHUNK[hd] + 5, 2
    _wkv6_bwd_case(card, B, T, H, hd, w=WKV_DECAYS[decay]((B, T, H, hd)),
                   seed=hd + 1)


#: steps a sub-chunk of the ``csrc/wkv6.cu`` backward by head size (its
#: BPlan's U), for the parametrizations; held to the build's own
#: ``recurrent.wkv_bwd_sub`` by ``test_wkv6_bwd_sub_chunk_table_is_the_builds``
WKV_BWD_SUB = {16: 8, 32: 8, 64: 8, 128: 4}


@pytest.mark.parametrize("hd,T", [(hd, base + U + d)
                                  for hd, U in WKV_BWD_SUB.items()
                                  for base in (0, WKV_CHUNK[hd])
                                  for d in (-1, 0, 1)])
def test_wkv6_bwd_kernel_at_sub_chunk_edges(card, hd, T):
    """T = U - 1, U, U + 1 inside the first chunk and past the first
    chunk: a last sub-chunk one step short, whole, and one step long."""
    _wkv6_bwd_case(card, 2, T, 2, hd, seed=T + hd + 11)


@pytest.mark.parametrize("B,T,H,hd", [(1, 300, 2, 64), (1, 100, 1, 128),
                                      (2, 150, 3, 16), (1, 77, 3, 32)])
def test_wkv6_bwd_kernel_below_the_sm_count(card, B, T, H, hd):
    """Fewer blocks (B H times the partials) than the card has SMs."""
    from repro_torch.kernels import recurrent
    assert B * H * recurrent.wkv_bwd_parts(hd) < torch.cuda.get_device_properties(
        card).multi_processor_count
    _wkv6_bwd_case(card, B, T, H, hd, with_s0=False, with_ds=True,
                   seed=B + T + H + hd)


@pytest.mark.parametrize("with_s0,with_ds", [(False, False), (True, True),
                                             (True, False)])
def test_wkv6_bwd_kernel_at_hd128_two_chunks_and_five(card, with_s0,
                                                      with_ds):
    _wkv6_bwd_case(card, 2, 2 * WKV_CHUNK[128] + 5, 2, 128,
                   with_s0=with_s0, with_ds=with_ds, seed=133)


@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_wkv6_autograd_matches_autograd_of_the_plain_loop(card, hd):
    """``ops.wkv6`` under autograd (r, k, v, w, u and S0 require grad;
    both outputs used): one forward launch (which keeps the chunk starts)
    and one backward launch, every gradient within ``TOL_WKV6_BWD`` of
    its largest magnitude against autograd of the plain loop."""
    g = torch.Generator(device=card).manual_seed(hd + 5)
    B, T, H = 2, 2 * WKV_CHUNK[hd] + 3, 2
    xs = list(_wkv_operands(g, card, B, T, H, hd))
    xs.append(torch.randn((B, H, hd, hd), generator=g, device=card))
    gout = torch.randn((B, T, H, hd), generator=g, device=card)
    gS = torch.randn((B, H, hd, hd), generator=g, device=card)
    xs = [x.requires_grad_() for x in xs]
    ops.reset_launches()
    out, S_T = ops.wkv6(*xs)
    ((out * gout).sum() + (S_T * gS).sum()).backward()
    torch.cuda.synchronize()
    assert ops.launches["wkv6"] == 1 and ops.launches["wkv6_bwd"] == 1
    ys = [x.detach().clone().requires_grad_() for x in xs]
    out2, S_T2 = ref.wkv6_ref(*ys)
    ((out2 * gout).sum() + (S_T2 * gS).sum()).backward()
    for name, x, y in zip(("r", "k", "v", "w", "u", "S0"), xs, ys):
        assert float((x.grad - y.grad).abs().max()) <= TOL_WKV6_BWD * float(
            y.grad.abs().max()), name


def test_wkv6_bwd_sub_chunk_table_is_the_builds(card):
    """The sub-chunk lengths the parametrizations above use are the
    build's, each divides its chunk, and an SM holds at least one block
    of the backward at every head size."""
    from repro_torch.kernels import recurrent
    assert {hd: recurrent.wkv_bwd_sub(hd) for hd in WKV_BWD_SUB} == \
        WKV_BWD_SUB
    for hd, U in WKV_BWD_SUB.items():
        assert WKV_CHUNK[hd] % U == 0
        assert recurrent.wkv_bwd_blocks_per_sm(hd) >= 1, hd
    assert recurrent.wkv_bwd_sub(24) == 0


def test_wkv6_chunk_table_is_the_builds(card):
    """The chunk lengths the parametrizations above use are the build's,
    and the backward's partials divide each head size."""
    from repro_torch.kernels import recurrent
    assert {hd: recurrent.wkv_chunk(hd) for hd in WKV_CHUNK} == WKV_CHUNK
    for hd in recurrent.WKV_HEAD_DIMS:
        parts = recurrent.wkv_bwd_parts(hd)
        assert parts >= 1 and hd % parts == 0, hd
    assert recurrent.wkv_chunk(24) == 0 and recurrent.wkv_bwd_parts(24) == 0


def test_wkv6_bwd_takes_the_forwards_chunk_states(card):
    """On the card the backward runs only from the forward's chunk starts:
    without them, or with another chunk count, it raises and launches
    nothing."""
    g = torch.Generator(device=card).manual_seed(2)
    B, T, H, hd = 1, 40, 2, 16
    r, k, v, w, u = _wkv_operands(g, card, B, T, H, hd)
    do = torch.randn((B, T, H, hd), generator=g, device=card)
    ops.reset_launches()
    for Sc in (None, torch.zeros((B, H, 1, hd, hd), device=card)):
        with pytest.raises(ValueError, match="chunk states"):
            ops.wkv6_bwd(r, k, v, w, u, None, do, None, states=Sc)
    assert not any(ops.launches.values())


@pytest.mark.parametrize("hd", [16, 64, 128])
def test_wkv6_chunk_states_leave_the_forward_unchanged(card, hd):
    """The forward that keeps the chunk starts gives the same bits as the
    one that does not, and each start is the plain loop's state there."""
    from repro_torch.kernels import recurrent
    g = torch.Generator(device=card).manual_seed(hd)
    B, T, H = 2, 3 * WKV_CHUNK[hd] + 2, 2
    r, k, v, w, u = _wkv_operands(g, card, B, T, H, hd)
    S0 = torch.randn((B, H, hd, hd), generator=g, device=card)
    out, S_T = recurrent.wkv6_cuda(r, k, v, w, u, S0)
    out2, S_T2, Sc = recurrent.wkv6_cuda(r, k, v, w, u, S0, states=True)
    assert torch.equal(out, out2) and torch.equal(S_T, S_T2)
    C = WKV_CHUNK[hd]
    assert Sc.shape == (B, H, -(-T // C), hd, hd)
    for c in range(Sc.shape[2]):
        want = S0 if c == 0 else ref.wkv6_ref(r[:, :c * C], k[:, :c * C],
                                              v[:, :c * C], w[:, :c * C], u,
                                              S0)[1]
        assert torch.equal(Sc[:, :, c], want), c


def test_recurrence_autograd_launches_the_backward_kernels(card):
    """Under autograd, ``rglru_scan`` and ``wkv6`` on the card are their
    Functions: a backward launches each one's backward kernel once, and
    the gradients match autograd of the plain loops (RG-LRU bitwise; the
    state output's gradient unused, so dS_T arrives as None)."""
    g = torch.Generator(device=card).manual_seed(1)
    a = (torch.rand((2, 40, 72), generator=g, device=card) * 0.5
         + 0.499).requires_grad_()
    b = torch.randn((2, 40, 72), generator=g, device=card).requires_grad_()
    ops.reset_launches()
    h = ops.rglru_scan(a, b)
    (h * h).sum().backward()
    assert ops.launches["rglru_scan"] == 1
    assert ops.launches["rglru_scan_bwd"] == 1
    a2, b2 = (x.detach().requires_grad_() for x in (a, b))
    (ref.rglru_scan_ref(a2, b2) ** 2).sum().backward()
    assert torch.equal(a.grad, a2.grad) and torch.equal(b.grad, b2.grad)
    xs = [x.requires_grad_() for x in _wkv_operands(g, card, 2, 37, 3, 64)]
    ops.reset_launches()
    out, _ = ops.wkv6(*xs)
    (out * out).sum().backward()
    assert ops.launches["wkv6"] == 1 and ops.launches["wkv6_bwd"] == 1
    ys = [x.detach().requires_grad_() for x in xs]
    (ref.wkv6_ref(*ys)[0] ** 2).sum().backward()
    for x, y in zip(xs, ys):
        assert _rel_max(x.grad, y.grad) <= TOL_WKV6_BWD


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_smoke_training_step_launches(card, arch):
    """A training step of the smoke config on the card: each recurrent
    layer launches its recurrence twice (the forward and the remat
    recompute) and its backward kernel once, each local layer the
    attention twice and its backward's kernels once; the loss is finite
    and the same step on the CPU gives the same loss within 1e-4."""
    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import local_attn
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.compression import CompressionConfig
    from repro_torch.training import (TrainConfig, init_train_state,
                                      make_train_step)
    cfg = configs.smoke_config(configs.get_config(arch))
    tc = TrainConfig(adamw=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=2),
                     compression=CompressionConfig(enabled=False))
    sc = init_train_state(cfg, tc, device="cpu")
    sg = init_train_state(cfg, tc, device=card)
    sg.load_tree(_to_device(sc.tree(), card))
    batch = SyntheticLMDataset(DataConfig(cfg.vocab_size, 24, 2)).batch(0)
    ops.reset_launches()
    sg, mg = make_train_step(cfg, tc)(sg, batch)
    got = {n: c for n, c in ops.launches.items() if c}
    _, mc = make_train_step(cfg, tc)(sc, batch)
    n_rglru, n_rwkv = cfg.blocks.count("rglru"), cfg.blocks.count("rwkv")
    n_local = cfg.blocks.count("local")
    want = {n: c for n, c in (
        ("rglru_scan", 2 * n_rglru), ("rglru_scan_bwd", n_rglru),
        ("wkv6", 2 * n_rwkv), ("wkv6_bwd", n_rwkv),
        ("local_attention", 2 * n_local),
        ("local_attention_bwd", local_attn.BWD_KERNELS * n_local)) if c}
    assert cfg.remat_policy == "minimal" and got == want
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= 1e-4


def _to_device(tree, where):
    if isinstance(tree, dict):
        return {key: _to_device(val, where) for key, val in tree.items()}
    return None if tree is None else tree.detach().to(where).clone()


@pytest.mark.parametrize("S", [2111, 4133])
def test_local_attention_bwd_at_recurrentgemma_layout(card, S):
    """recurrentgemma-9b's local layers: MQA with a group of 16 query
    heads, D 256, window 2048, bf16 on the tensor-core route; each
    gradient element held as the forward's output is, reruns bitwise.
    The plain version's sums run in float64 here: dK and dV sum 16 x
    2048 terms, where the fp32 plain version's own rounding exceeds the
    limit's 1e-5 floor (``chip_smoke.py`` phase 15.1 prints the kernel's
    reading against both)."""
    from repro_torch.kernels import local_attn
    assert local_attn.bwd_route(torch.bfloat16, 256) == "wgmma"
    g = torch.Generator(device=card).manual_seed(S)
    q, do = (torch.randn((1, S, 16, 256), generator=g, device=card)
             .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((1, S, 1, 256), generator=g, device=card)
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    lse = torch.empty((1, 16, S), device=card)
    o = local_attn.local_attention_cuda(q, k, v, 2048, None, lse)
    ops.reset_launches()
    got = ops.local_attention_bwd(q, k, v, o, do, lse, window=2048)
    again = ops.local_attention_bwd(q, k, v, o, do, lse, window=2048)
    want = ref.local_attention_bwd_ref(q, k, v, o, do, lse, window=2048,
                                       sums=torch.float64)
    torch.cuda.synchronize()
    assert {n: c for n, c in ops.route_launches.items() if c} == {
        "local_attention_bwd/wgmma": 2 * local_attn.BWD_KERNELS}
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert torch.equal(a, b)
        assert _attn_within(a, w, "bfloat16")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_recurrent_smoke_serving_launches(card, arch):
    """A prefill launches one recurrence a recurrent layer (and one
    attention a local layer); a decode step one recurrence a recurrent
    layer and no attention."""
    from repro_torch.launch import serve
    model = serve.build(arch, smoke=True, device=card)
    cfg = model.cfg
    prompt = serve.make_prompt(cfg, 2, 12, device=card)
    n_rglru, n_rwkv = cfg.blocks.count("rglru"), cfg.blocks.count("rwkv")
    n_local = cfg.blocks.count("local")
    ops.reset_launches()
    logits, cache, _ = serve.serve_prefill(model, prompt, 16)
    pre = {n: c for n, c in ops.launches.items() if c}
    ops.reset_launches()
    tokens, last, _ = serve.serve_decode(model, cache, logits, 12, 1)
    dec = {n: c for n, c in ops.launches.items() if c}
    want = {n: c for n, c in (("rglru_scan", n_rglru), ("wkv6", n_rwkv),
                              ("local_attention", n_local)) if c}
    assert pre == want
    assert dec == {n: c for n, c in want.items() if n != "local_attention"}
    assert bool(torch.isfinite(last).all())
