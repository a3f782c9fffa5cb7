"""The summation order of the sparse stream's CSR kernels, on the CPU.

``csrc/csr_sweep.cu`` cannot run here, so this file holds a numpy model of
its order against the sums it must reproduce bit for bit:

* ``csr_rmatmat``: each nonzero's (row, value) record; a stable radix
  pass on the top ``bucket_bits`` of the ``key_bits(n)`` bits the
  columns need; then each bucket in chunks of ``BUCKET_CAP`` entries, in
  order, each chunk sorted stably on the low bits and each of its runs
  summed into Z's row (a column whose run spans two chunks gets the
  first part, then the next);
* ``csr_matmat``: each row's products formed together (the kernel loads
  eight nonzeros ahead), then added in stream order.

Both are held bitwise against ``np.add.at`` (the JAX package's host sweep,
``repro/core/sparse.py``), against ``kernels/ref.py``'s ``csr_*_ref``
(``index_add_``), and against the JAX package's own
``SyntheticSparseMatrix`` sweeps, on the cases of ``tests/csr_cases.py``:
empty rows and an empty block, one column holding every nonzero, columns
shared by consecutive blocks with Z carried, n = 2^25 and n = 2^31 - 1
(the model keeps only the touched rows of Z), fp32 and bf16 values, k in
(1, 3, 8, 16, 33); and with chunks of a few entries, so that runs span
them.  The binding's host helpers (``key_bits``, ``bucket_bits``,
``scratch_layout``) are tested on their own.
"""
import numpy as np
import pytest
import torch

import csr_cases as cc
from repro.core.sparse import SyntheticSparseMatrix as JaxSynthetic
from repro_torch.kernels import csr_sweep, ref

RADIX = 8                          # bits a pass of the model's sort


def radix_order(col: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """The stable LSD radix sort's permutation of ``col`` on its bits
    [lo, hi), 8 at a pass, each pass a stable counting sort."""
    perm = np.arange(col.size)
    key = col.astype(np.int64)
    for b in range(lo, hi, RADIX):
        digit = (key[perm] >> b) & ((1 << min(RADIX, hi - b)) - 1)
        perm = perm[np.argsort(digit, kind="stable")]
    return perm


def _sum_runs(skey, srow, sval, Y, u, out):
    """Each run of ``skey`` summed into its row of ``out`` (Z's touched
    rows on the columns ``u``), in the given order: Z's row read once a
    run and written once."""
    starts = np.flatnonzero(np.r_[True, skey[1:] != skey[:-1]]) \
        if skey.size else np.zeros(0, np.int64)
    ends = np.r_[starts[1:], skey.size]
    zi = np.searchsorted(u, skey[starts])
    acc = out[zi]
    for t in range(int((ends - starts).max()) if starts.size else 0):
        live = ends - starts > t            # runs with a t-th entry
        j = starts[live] + t
        prod = sval[j, None] * Y[srow[j]]   # rounded, then added
        acc[live] = acc[live] + prod
    out[zi] = acc


def model_rmatmat(off, col, val, Y, u, Zu, n, cap=csr_sweep.BUCKET_CAP):
    """The kernel's ``Z += A_b^T Y`` on the touched rows ``Zu`` of Z
    (columns ``u``), in its order with chunks of ``cap`` entries."""
    rows = cc.rows_of(off)
    bits = csr_sweep.key_bits(n)
    out = Zu.copy()
    low = bits - csr_sweep.bucket_bits(col.size, bits)
    perm = radix_order(col, low, bits)          # the partition
    key, row, v = col[perm], rows[perm], val[perm]
    top = key.astype(np.int64) >> low
    for b in np.unique(top):
        lo_, hi_ = np.searchsorted(top, [b, b + 1])
        for c0 in range(lo_, hi_, cap):         # chunks, in order
            sl = slice(c0, min(c0 + cap, hi_))
            p = radix_order(key[sl], 0, low)
            _sum_runs(key[sl][p], row[sl][p], v[sl][p], Y, u, out)
    return out


def model_matmat(off, col, val, u, Qu):
    """The kernel's ``A_b Q``: a row's products formed ahead, added in
    stream order from 0."""
    rows = len(off) - 1
    prods = val[:, None] * Qu[np.searchsorted(u, col)]
    lens = np.diff(off)
    acc = np.zeros((rows, Qu.shape[1]), np.float32)
    for t in range(int(lens.max()) if rows else 0):
        live = lens > t
        acc[live] = acc[live] + prods[off[:-1][live] + t]
    return acc


def _ref_rmatmat(off, col, val, Y, u, Zu):
    """``ref.csr_rmatmat_ref`` on the touched rows (columns renumbered
    onto ``u``: ``index_add_`` reads only the indices)."""
    Z = torch.from_numpy(Zu.copy())
    ref.csr_rmatmat_ref(torch.from_numpy(off),
                        torch.from_numpy(np.searchsorted(u, col).astype(
                            np.int32)),
                        torch.from_numpy(val), torch.from_numpy(Y), Z)
    return Z.numpy()


def _ref_matmat(off, col, val, u, Qu, round_out=False):
    return ref.csr_matmat_ref(
        torch.from_numpy(off),
        torch.from_numpy(np.searchsorted(u, col).astype(np.int32)),
        torch.from_numpy(val), torch.from_numpy(Qu), round_out).numpy()


@pytest.mark.parametrize("k", cc.KS)
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", cc.CASES)
def test_model_is_bitwise_np_add_at_and_ref(name, bf16, k):
    """Each block's ``A_b Q``, ``Z += A_b^T Y`` (Z carried from block to
    block) and the chain (y rounded to bf16 under bf16): the model is
    bitwise ``np.add.at`` and ``ref.csr_*_ref``."""
    case = cc.make_case(name, bf16)
    u = cc.touched(case)
    Qu, Zu, Ys = cc.dense_rows(case, k, bf16)
    Z_model, Z_at, Z_ref = Zu.copy(), Zu.copy(), Zu.copy()
    C_model, C_at = Zu.copy(), Zu.copy()
    for (off, col, val), Y in zip(case["blocks"], Ys):
        y = model_matmat(off, col, val, u, Qu)
        np.testing.assert_array_equal(y, cc.add_at_matmat(off, col, val, u,
                                                           Qu))
        np.testing.assert_array_equal(y, _ref_matmat(off, col, val, u, Qu))
        Z_model = model_rmatmat(off, col, val, Y, u, Z_model, case["n"])
        Z_at = cc.add_at_rmatmat(off, col, val, u, Y, Z_at)
        Z_ref = _ref_rmatmat(off, col, val, Y, u, Z_ref)
        yr = cc.bf16_round(y) if bf16 else y
        C_model = model_rmatmat(off, col, val, yr, u, C_model, case["n"])
        C_at = cc.add_at_rmatmat(off, col, val, u, yr, C_at)
        if bf16:
            np.testing.assert_array_equal(
                yr, _ref_matmat(off, col, val, u, Qu, round_out=True))
    np.testing.assert_array_equal(Z_model, Z_at)
    np.testing.assert_array_equal(Z_model, Z_ref)
    np.testing.assert_array_equal(C_model, C_at)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_model_is_bitwise_the_jax_package_stream(bf16):
    """Over every row block of the JAX package's ``SyntheticSparseMatrix``
    (rows sharing columns across blocks), the model's ``A Q`` and
    ``A^T Y`` are bitwise its ``matmat`` and ``rmatmat``."""
    sd = "bfloat16" if bf16 else "float32"
    sp = JaxSynthetic(900, 70, 6, seed=4)
    rng = np.random.default_rng(2)
    Q = rng.standard_normal((70, 8)).astype(np.float32)
    Y = rng.standard_normal((900, 8)).astype(np.float32)
    r = cc.bf16_round if bf16 else (lambda x: x)
    u = np.arange(70)
    got_y, got_z = [], np.zeros((70, 8), np.float32)
    for lo in range(0, 900, 256):
        hi = min(lo + 256, 900)
        rows, cols, vals = sp.row_block_coo(lo, hi)
        off = np.r_[0, np.cumsum(np.bincount(rows - lo, minlength=hi - lo))
                    ].astype(np.int32)
        col, val = cols.astype(np.int32), r(vals.astype(np.float32))
        got_y.append(model_matmat(off, col, val, u, r(Q)))
        got_z = model_rmatmat(off, col, val, r(Y)[lo:hi], u, got_z, 70)
    np.testing.assert_array_equal(np.concatenate(got_y),
                                  sp.matmat(Q, 256, dtype=sd))
    np.testing.assert_array_equal(got_z, sp.rmatmat(Y, 256, dtype=sd))


@pytest.mark.parametrize("cap", [1, 7, 64])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", cc.CASES)
def test_chunks_of_a_few_entries_are_bitwise_np_add_at(name, bf16, cap):
    """With chunks of a few entries (runs spanning chunks, Z read again
    by the next) the order still gives ``np.add.at``'s bits, Z carried
    across blocks, k = 3."""
    case = cc.make_case(name, bf16)
    u = cc.touched(case)
    _, Zu, Ys = cc.dense_rows(case, 3, bf16)
    got, want = Zu.copy(), Zu.copy()
    for (off, col, val), Y in zip(case["blocks"], Ys):
        got = model_rmatmat(off, col, val, Y, u, got, case["n"], cap)
        want = cc.add_at_rmatmat(off, col, val, u, Y, want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nnz,bits,want", [
    (0, 25, 0), (5120, 25, 0), (5121, 25, 1), (2_162_688, 25, 8),
    (2_162_688, 22, 8), (10 ** 6, 3, 2), (10 ** 9, 1, 0), (40_000, 31, 3)])
def test_bucket_bits(nnz, bits, want):
    """The partition's top bits: buckets average at most half a chunk
    unless one radix pass (8 bits) or the key (a bit left) stops them."""
    hi = csr_sweep.bucket_bits(nnz, bits)
    assert hi == want
    assert 0 <= hi <= min(csr_sweep.MAX_BUCKET_BITS, bits - 1)
    if hi < min(csr_sweep.MAX_BUCKET_BITS, bits - 1):
        assert nnz >> hi <= csr_sweep.BUCKET_CAP // 2


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1 << 16, 1 << 25,
                               (1 << 25) + 1, 2 ** 31 - 1])
def test_key_bits_covers_every_column_and_no_more(n):
    """``key_bits(n)`` holds column n - 1 and is the least that does; a
    sort on those bits orders every column below n, one bit fewer
    does not."""
    bits = csr_sweep.key_bits(n)
    assert (n - 1) >> bits == 0
    assert bits == 1 or (n - 1) >> (bits - 1) == 1
    col = np.array([n - 1, 0, n // 2, n - 1, 0], np.int64)
    perm = radix_order(col, 0, bits)
    assert np.array_equal(perm, np.argsort(col, kind="stable"))
    if bits > 1 and n - 1 > 0:
        short = radix_order(col, 0, bits - 1)
        assert not np.array_equal(col[short], np.sort(col))


@pytest.mark.parametrize("nnz,sort_bytes", [(0, 0), (1, 1), (2_162_688, 777),
                                            (1000, 256), (7, 4096)])
def test_scratch_layout_regions_are_aligned_and_disjoint(nnz, sort_bytes):
    """Every region starts 256-byte aligned, holds its size and overlaps
    no other; the total covers the last."""
    offsets, total = csr_sweep.scratch_layout(nnz, sort_bytes)
    sizes = {"skey": 4 * nnz, "rec_in": 8 * nnz, "rec_out": 8 * nnz,
             "starts": 4 * nnz, "count": 4,
             "bounds": 4 * (2 ** csr_sweep.MAX_BUCKET_BITS + 1),
             "sort": sort_bytes}
    assert set(offsets) == set(sizes)
    spans = sorted((offsets[name], offsets[name] + sizes[name])
                   for name in sizes)
    for (a0, a1), (b0, _) in zip(spans, spans[1:]):
        assert a1 <= b0
    assert all(at % 256 == 0 for at in offsets.values())
    assert total >= spans[-1][1] and total % 256 == 0
    assert total < sum(sizes.values()) + 256 * len(sizes)


def test_radix_model_is_stable_on_equal_columns():
    """Entries of one column keep their stream order through every pass
    (rows ascending, and a row's repeats in CSR order)."""
    col = np.array([5, 3, 5, 5, 3, 260, 5], np.int64)
    perm = radix_order(col, 0, csr_sweep.key_bits(300))
    assert perm.tolist() == [1, 4, 0, 2, 3, 6, 5]
