"""Plain PyTorch versions of the port's kernels.

The counterparts of the JAX package's ``repro/kernels/ref.py`` oracles
for the kernels this port has.  They are what ``kernels/ops.py`` runs
for tensors the caller put on the CPU, and what the CUDA kernels are
held against on the card.

``dtype`` is the sweep dtype of the precision policy: operands are
rounded to it and the contraction accumulates in fp32.  ``torch.matmul``
of two bf16 tensors would return bf16, so the bf16-rounded operands are
upcast to fp32 before the product (exact: a product of two bf16 values
fits in fp32), which is the JAX package's
``preferred_element_type=float32``.

``trans=True`` on the deflation kernels' versions applies the same
function to ``A^T`` without forming it (the wide inputs' left-side
power step), as the kernels' ``trans`` forms do.

The CSR sweeps' versions (``csr_matmat_ref``, ``csr_rmatmat_ref``,
``csr_gram_chain_ref``) are ``index_add_`` over the block's nonzeros in
stream order, each product rounded before its add: on CPU tensors that
is bitwise ``np.add.at``, the JAX package's host sweep; on CUDA tensors
``index_add_`` sums with atomics, in no fixed order.

``local_attention_ref`` is the JAX oracle's math for the LM prefill
attention: K/V repeated to every query head, the full (S, S) scores, the
causal window mask, a softmax, all in fp32.  ``local_attention_lse_ref``
also gives each row's log-sum-exp, and ``local_attention_bwd_ref`` is
the gradient written out from the same formulas as the backward kernel
(the probabilities from that log-sum-exp, ``Dlt = sum(dO * O)``, the
soft-cap's slope ``1 - tanh^2``, GQA's dK and dV summed over each K/V
head's query heads), in plain PyTorch, not by autograd.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.precision import resolve_sweep_dtype


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    sd = torch.float32 if dtype is None else resolve_sweep_dtype(dtype)
    return x.to(sd).to(torch.float32)


def block_matvec_ref(A: torch.Tensor, Q: torch.Tensor,
                     dtype=None) -> torch.Tensor:
    """``Y = A @ Q`` (multi-vector forward sweep); fp32 accumulation."""
    return _rounded(A, dtype) @ _rounded(Q, dtype)


def block_rmatvec_ref(A: torch.Tensor, Y: torch.Tensor,
                      dtype=None) -> torch.Tensor:
    """``Z = A^T @ Y`` (multi-vector reverse sweep); fp32 accumulation."""
    return _rounded(A, dtype).mT @ _rounded(Y, dtype)


def block_gram_chain_ref(A: torch.Tensor, Q: torch.Tensor, dtype=None,
                         trans: bool = False) -> torch.Tensor:
    """``Z = A^T (A Q)`` (block power / range-finder sweep), or with
    ``trans=True`` the chain of the transposed operand, ``A (A^T Q)``.

    The fp32-accumulated intermediate is rounded back to the sweep dtype
    for the second sweep, as the JAX package's chain does.
    """
    if trans:
        return block_matvec_ref(A, block_rmatvec_ref(A, Q, dtype), dtype)
    return block_rmatvec_ref(A, block_matvec_ref(A, Q, dtype), dtype)


def matvec_ref(A: torch.Tensor, v: torch.Tensor,
               trans: bool = False) -> torch.Tensor:
    """``y = A @ v`` (``A^T @ v`` with ``trans``) in fp32."""
    A32 = A.to(torch.float32)
    return (A32.mT if trans else A32) @ v.to(torch.float32)


def deflate_rmatvec_ref(A: torch.Tensor, U: torch.Tensor, Xv: torch.Tensor,
                        SVtv: torch.Tensor, trans: bool = False):
    """Fused Alg-4 reverse sweep: ``t13 = A^T (Xv - U @ SVtv)`` and
    ``utxv = U^T Xv``; with ``trans`` the same for ``A^T``, i.e.
    ``A (x - V @ c)`` and ``V^T x`` with ``V (n, k)``, ``x (n,)``."""
    A32 = A.to(torch.float32)
    U32 = U.to(torch.float32)
    Xv32 = Xv.to(torch.float32)
    corr = Xv32 - U32 @ SVtv.to(torch.float32)
    return (A32 if trans else A32.mT) @ corr, U32.mT @ Xv32


def gram_ref(A: torch.Tensor, trans: bool = False) -> torch.Tensor:
    """``B = A^T A`` (``A A^T`` with ``trans``) in fp32."""
    A32 = A.to(torch.float32)
    return A32 @ A32.mT if trans else A32.mT @ A32


def csr_rows(off: torch.Tensor, nnz: int) -> torch.Tensor:
    """The block-local row of each nonzero of a CSR block of ``nnz``
    nonzeros (its columns' length, so nothing is read on the host)."""
    rows = off.numel() - 1
    return torch.repeat_interleave(
        torch.arange(rows, device=off.device), (off[1:] - off[:-1]).long(),
        output_size=nnz)


def csr_matmat_ref(off: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   Q: torch.Tensor, round_out: bool = False) -> torch.Tensor:
    """``A_b Q`` of a CSR block (``off`` rows + 1, ``col``/``val`` nnz);
    ``round_out`` rounds the fp32 sums to bf16."""
    Y = torch.zeros((off.numel() - 1, Q.shape[1]), dtype=torch.float32,
                    device=Q.device)
    Y.index_add_(0, csr_rows(off, col.numel()),
                 val.to(torch.float32)[:, None] * Q[col.long()])
    return _rounded(Y, "bfloat16") if round_out else Y


def csr_rmatmat_ref(off: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                    Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``Z += A_b^T Y`` in place; returns ``Z``."""
    return Z.index_add_(0, col.long(),
                        val.to(torch.float32)[:, None]
                        * Y[csr_rows(off, col.numel())])


def csr_gram_chain_ref(off, col, val, Q, Z, round_y: bool = False):
    """``Z += A_b^T (A_b Q)``, ``y`` rounded to bf16 with ``round_y``."""
    return csr_rmatmat_ref(off, col, val,
                           csr_matmat_ref(off, col, val, Q, round_y), Z)


def _attention_logits(q, k, window, softcap):
    """(capped logits, tanh of the scaled scores or None, live mask) in
    fp32, K already repeated to q's heads."""
    S, D = q.shape[2], q.shape[3]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * (1.0 / math.sqrt(D))
    t = None
    if softcap is not None:
        t = torch.tanh(logits / softcap)
        logits = t * softcap
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                             - window)
    return logits, t, mask


def local_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, window: int,
                            softcap: float | None = None):
    """``local_attention_ref`` and each row's log-sum-exp of its live
    logits: (o fp32 (B, H, S, D), lse fp32 (B, H, S))."""
    rep = q.shape[1] // k.shape[1]
    logits, _, mask = _attention_logits(
        q, k.repeat_interleave(rep, dim=1), window, softcap)
    logits = torch.where(mask, logits, -1e30)
    v = v.to(torch.float32).repeat_interleave(rep, dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, dim=-1), v)
    return o, torch.logsumexp(logits, dim=-1)


def local_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int,
                        softcap: float | None = None) -> torch.Tensor:
    """Causal sliding-window attention, fp32 out: query ``i`` attends to
    keys ``i - window < j <= i``.  q (B, H, S, D), k/v (B, Hkv, S, D);
    GQA by repeating each K/V head ``H // Hkv`` times."""
    return local_attention_lse_ref(q, k, v, window=window,
                                   softcap=softcap)[0]


def local_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            window: int, softcap: float | None = None):
    """The gradient of ``local_attention`` given its output ``o``, the
    output's gradient ``do`` and the rows' log-sum-exp ``lse``: (dq, dk,
    dv) fp32 in the shapes of q, k, v.  P = exp(c - lse) on the live
    pairs, dC = P (dO V^T - sum(dO * O)), dS = dC (1 - tanh^2) with a
    soft-cap, dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO,
    dK and dV summed over the query heads of each K/V head."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    k32 = k.to(torch.float32).repeat_interleave(rep, dim=1)
    v32 = v.to(torch.float32).repeat_interleave(rep, dim=1)
    q32, do32 = q.to(torch.float32), do.to(torch.float32)
    logits, t, mask = _attention_logits(q32, k32, window, softcap)
    p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    delta = (do32 * o.to(torch.float32)).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    return (dq, dk.view(B, Hkv, rep, S, D).sum(dim=2),
            dv.view(B, Hkv, rep, S, D).sum(dim=2))
