"""The port's ``gram`` kernels: their route, and the check that holds them.

``kernels/gram.py::route`` picks the kernel from dtype, row stride and
alignment alone (no card needed): every ``A`` runs on the tensor cores,
fp32 as 3xTF32 and bf16 on their bf16 form, by TMA where a tensor map
describes it (``"tf32x3"``, ``"wgmma"``), else by the producer's own
copies (``"tf32x3_cpasync"``, ``"wgmma_ld"``).

``chip_smoke.py`` holds the card's ``gram`` to two readings: the
relative Frobenius error of the whole product against ``gram_tol`` and
that of its off-diagonal entries against ``TOL_GRAM_OFFDIAG``.  The
second exists because the first cannot see plain TF32: at the gram
path's aspect (m / n = 32) the whole product's error is the diagonal's,
where the rounding of growing positive sums averages out.  The test
below emulates both arithmetics on the CPU (TF32 rounding as
``cvt.rna.tf32.f32`` does it, products and sums in float64) on the
planted-fault check's 65536 x 2048 signed N(0, 1) input, over a slice
of rows of ``A^T A`` (every row of it alike, so the slice's readings are
the product's), against the exact product.
"""
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
gram = importlib.import_module("repro_torch.kernels.gram")
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


def _meta(m, n, dtype=torch.float32, offset=0, ld=None):
    """An (m, n) operand that only says its dtype, shape, row stride
    (``ld``, default n) and alignment."""
    ld = n if ld is None else ld
    flat = torch.empty(m * ld + offset, dtype=dtype, device="meta")
    return flat[offset:].as_strided((m, n), (ld, 1))


@pytest.mark.parametrize("A,want", [
    (_meta(262144, 8192), "tf32x3"),              # the gram path (A^T A)
    (_meta(8192, 131072), "tf32x3"),              # the wide input (A A^T)
    (_meta(4097, 515), "tf32x3_cpasync"),         # n % 4 == 3
    (_meta(3000, 514), "tf32x3_cpasync"),         # n % 4 == 2
    (_meta(3000, 2051), "tf32x3_cpasync"),        # n % 4 == 3, wide rows
    (_meta(33, 1), "tf32x3_cpasync"),             # one column
    (_meta(5000, 1000, offset=1), "tf32x3_cpasync"),   # base 4 bytes off
    (_meta(5000, 1000, offset=2), "tf32x3_cpasync"),   # base 8 bytes off
    (_meta(5000, 1000, offset=4), "tf32x3"),           # base 16 bytes on
    (_meta(5000, 515, ld=516), "tf32x3"),         # rows padded to 16 bytes
    (_meta(5000, 515, ld=517), "tf32x3_cpasync"),  # rows not whole 16 bytes
    (_meta(262144, 8192, torch.bfloat16), "wgmma"),
    (_meta(4097, 515, torch.bfloat16, ld=520), "wgmma"),
    (_meta(262144, 8190, torch.bfloat16), "wgmma_ld"),  # even, not 8k
    (_meta(262144, 8191, torch.bfloat16), "wgmma_ld"),  # odd lda
    (_meta(5000, 1024, torch.bfloat16, offset=1), "wgmma_ld"),  # 2 B off
    (_meta(5000, 1024, torch.bfloat16, offset=8), "wgmma"),  # 16 B on
], ids=["path", "wide", "n515", "n514", "n2051", "n1", "offset4B",
        "offset8B", "offset16B", "padded", "padded-odd", "bf16",
        "bf16-padded", "bf16-ld8190", "bf16-ld-odd", "bf16-offset2B",
        "bf16-offset16B"])
def test_route(A, want):
    """The route depends on dtype, row stride and alignment alone, the
    same for A^T A and A A^T; no operand runs FFMA."""
    assert gram.route(A) == want


def test_every_route_is_counted():
    from repro_torch.kernels import ops
    assert {f"gram/{which}" for which in gram.ROUTES} <= set(
        ops.route_launches)
    assert gram.ROUTES == ("tf32x3", "tf32x3_cpasync", "wgmma", "wgmma_ld")


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as cvt.rna.tf32.f32 does: to nearest on the
    10-bit mantissa, ties away from zero (the low 13 bits zero)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def test_tf32_rounding_is_round_to_nearest_away():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11])
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -9])
    assert torch.equal(_tf32(x), want)


def _gram_rows(m, n, rows, seed, chunk=2048):
    """Rows [0, rows) of B = A^T A for a signed N(0, 1) fp32 A (m, n),
    drawn in row chunks: exact, plain TF32 (the ``hi hi`` term alone) and
    3xTF32 (``hi hi + hi lo + lo hi``), each rounded once to fp32."""
    rng = np.random.default_rng(seed)
    exact, plain, x3 = (torch.zeros((rows, n), dtype=torch.float64)
                        for _ in range(3))
    for _ in range(0, m, chunk):
        A = torch.from_numpy(rng.standard_normal((chunk, n),
                                                 dtype=np.float32))
        hi = _tf32(A)
        lo = _tf32(A - hi)
        A, hi, lo = A.double(), hi.double(), lo.double()
        exact += A[:, :rows].T @ A
        plain += hi[:, :rows].T @ hi
        x3 += hi[:, :rows].T @ hi + hi[:, :rows].T @ lo + lo[:, :rows].T @ hi
    return exact.float(), plain.float(), x3.float()


def test_offdiagonal_reading_rejects_plain_tf32():
    """At the planted-fault check's shape (the gram path's aspect) the
    whole product's reading passes plain TF32 and 3xTF32 alike; the
    off-diagonal reading rejects plain TF32 and passes 3xTF32."""
    m, n = chip_smoke.GRAM_FAULT
    assert m == 32 * n
    exact, plain, x3 = _gram_rows(m, n, rows=32, seed=0)
    whole = {name: chip_smoke.rel_err(torch, got, exact)
             for name, got in (("plain", plain), ("x3", x3))}
    off = {name: chip_smoke.gram_offdiag_err(torch, got, exact)
           for name, got in (("plain", plain), ("x3", x3))}
    assert whole["plain"] <= chip_smoke.gram_tol(m)       # the blind spot
    assert whole["x3"] <= chip_smoke.gram_tol(m)
    assert off["plain"] > 3 * chip_smoke.TOL_GRAM_OFFDIAG
    assert off["x3"] < chip_smoke.TOL_GRAM_OFFDIAG / 100


def test_offdiagonal_reading_ignores_the_diagonal():
    rng = np.random.default_rng(1)
    want = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32))
    got = want.clone()
    got.diagonal().mul_(2.0)
    assert chip_smoke.gram_offdiag_err(torch, got, want) == 0.0
    assert chip_smoke.rel_err(torch, got, want) > 0.1
    got = want.clone()
    got[0, 1] += 1.0
    assert chip_smoke.gram_offdiag_err(torch, got, want) > 0.0
    one = torch.ones((1, 1))                   # no entry off the diagonal
    assert chip_smoke.gram_offdiag_err(torch, 2 * one, one) == 0.0
