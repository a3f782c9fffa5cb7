"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (with its reason) where no CUDA device
is visible.  This file imports torch and ``repro_torch`` only, so it
also runs on a GPU machine without JAX:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Limits: the same (bf16-rounded) operands summed in fp32 in another
order, 1e-5 relative Frobenius; the bf16 chain, whose fp32 intermediate
is rounded to bf16 where kernel and plain version can land on
neighbouring bf16 values, 1e-3.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref

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
    assert ops.launches == {"block_matvec": 3, "block_rmatvec": 3,
                            "block_gram_chain": 2}


def test_kernels_are_deterministic(card):
    g = torch.Generator(device=card).manual_seed(0)
    A = torch.randn((20000, 700), generator=g, device=card)
    Y = torch.randn((20000, 40), generator=g, device=card)
    assert torch.equal(ops.block_rmatvec(A, Y), ops.block_rmatvec(A, Y))


def test_non_contiguous_operand_is_refused(card):
    A = torch.randn((64, 32), device=card)
    with pytest.raises(ValueError):
        ops.block_matvec(A.mT, torch.randn((64, 3), device=card))
