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
(``local_attn.route``), the rest the FFMA one.  The block sweeps run on
the tensor cores where a TMA tensor map describes A
(``block_matvec.route``: fp32 as 3xTF32, bf16 by wgmma), the rest by
FFMA; all three routes are held to the same limits.
"""
import importlib

import pytest
import torch

from repro_torch.kernels import ops, ref

bm = importlib.import_module("repro_torch.kernels.block_matvec")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
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


def test_misaligned_fp32_runs_the_ffma_route(card):
    """An fp32 A 4 bytes off a 16-byte boundary has no tensor map: FFMA."""
    m, n, k = 3000, 1024, 9
    g = torch.Generator(device=card).manual_seed(6)
    flat = torch.randn(m * n + 1, generator=g, device=card)
    A = flat[1:].view(m, n)
    Y = torch.randn((m, k), generator=g, device=card)
    assert A.is_contiguous() and bm.route(A, k) == "ffma"
    ops.reset_launches()
    got = ops.block_rmatvec(A, Y)
    torch.cuda.synchronize()
    assert _rel(got, ref.block_rmatvec_ref(A, Y, "float32")) <= 1e-5
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_rmatvec/ffma": 1}


def test_misaligned_bf16_runs_the_ffma_route(card):
    """A bf16 A 2 bytes off a 16-byte boundary has no tensor map: FFMA."""
    m, n, k = 3000, 1024, 9
    g = torch.Generator(device=card).manual_seed(5)
    flat = torch.randn(m * n + 1, generator=g, device=card).to(torch.bfloat16)
    A = flat[1:].view(m, n)
    Q = torch.randn((n, k), generator=g, device=card)
    assert A.is_contiguous() and bm.route(A, k) == "ffma"
    ops.reset_launches()
    got = ops.block_matvec(A, Q)
    torch.cuda.synchronize()
    assert _rel(got, ref.block_matvec_ref(A, Q, "bfloat16")) <= 1e-5
    assert {n_: c for n_, c in ops.route_launches.items() if c} == {
        "block_matvec/ffma": 1}


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
