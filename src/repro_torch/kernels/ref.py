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

``rglru_scan_ref`` and ``wkv6_ref`` are the two recurrences of the LM's
recurrent blocks (RG-LRU and RWKV-6) as loops over time, one step a
time: the JAX package's ``_rglru_scan`` (an associative scan) and
``_wkv_scan`` (a ``lax.scan``).  Each elementwise step rounds as the
kernels do (a product rounded, then a sum), so the RG-LRU kernel and
the RWKV-6 kernel's state equal them bit for bit; only the RWKV-6
output's sum over the key index runs in another order.  Both stay
differentiable by autograd on the CPU.  ``rglru_scan_bwd_ref`` and
``wkv6_bwd_ref`` are their gradients written out as reverse loops over
time, in the rounding order of the backward kernels (a product rounded,
then a sum): RG-LRU's ``d_t = g_t + a_{t+1} d_{t+1}`` and RWKV-6's
``D <- w_t * D + r_t do_t^T``, so the kernels' ``da``, ``db``, ``dh0``
and ``dS0`` equal them bit for bit; RWKV-6's other gradients are sums
over a key or a value index, in another order on the card.
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


def _attention_logits(q, k, window, softcap, sums=torch.float32):
    """(capped logits, tanh of the scaled scores or None, live mask) in
    fp32 (or ``sums``), K already repeated to q's heads."""
    S, D = q.shape[2], q.shape[3]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.to(sums),
                          k.to(sums)) * (1.0 / math.sqrt(D))
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
                            window: int, softcap: float | None = None,
                            sums: torch.dtype = torch.float32):
    """The gradient of ``local_attention`` given its output ``o``, the
    output's gradient ``do`` and the rows' log-sum-exp ``lse``: (dq, dk,
    dv) fp32 in the shapes of q, k, v.  P = exp(c - lse) on the live
    pairs, dC = P (dO V^T - sum(dO * O)), dS = dC (1 - tanh^2) with a
    soft-cap, dQ = dS K / sqrt(D), dK = dS^T Q / sqrt(D), dV = P^T dO,
    dK and dV summed over the query heads of each K/V head.
    ``sums=torch.float64`` evaluates the same formulas in float64 (and
    returns float64): the reading where this version's own fp32
    rounding nears a limit, as in dK and dV summed over G x window
    terms."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    k32 = k.to(sums).repeat_interleave(rep, dim=1)
    v32 = v.to(sums).repeat_interleave(rep, dim=1)
    q32, do32 = q.to(sums), do.to(sums)
    logits, t, mask = _attention_logits(q32, k32, window, softcap, sums)
    p = torch.where(mask, torch.exp(logits - lse.to(sums)[..., None]), 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    delta = (do32 * o.to(sums)).sum(dim=-1)
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do32)
    return (dq, dk.view(B, Hkv, rep, S, D).sum(dim=2),
            dv.view(B, Hkv, rep, S, D).sum(dim=2))


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor | None = None) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` along axis 1: a, b (B, T, R), h0 (B, R)
    or None (zeros) -> h (B, T, R) fp32.  The last state is ``h[:, -1]``."""
    a32, b32 = a.to(torch.float32), b.to(torch.float32)
    h = (torch.zeros_like(b32[:, 0]) if h0 is None
         else h0.to(torch.float32))
    out = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor,
             S0: torch.Tensor | None = None):
    """RWKV-6's recurrence: r, k, v, w (B, T, H, hd), u (H, hd), S0
    (B, H, hd, hd) or None (zeros) -> (out (B, T, H, hd), S_T) fp32.
    Each step ``o_t = r_t^T (S + (u * k_t) v_t^T)`` (``u * (k_t v_t^T)``
    as the JAX package rounds it), then ``S <- w_t * S + k_t v_t^T``."""
    r, k, v, w = (x.to(torch.float32) for x in (r, k, v, w))
    B, T, H, hd = r.shape
    S = (r.new_zeros((B, H, hd, hd)) if S0 is None
         else S0.to(torch.float32))
    ub = u.to(torch.float32)[None, :, :, None]
    out = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + ub * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(out, dim=1), S


def rglru_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor,
                       h0: torch.Tensor | None,
                       g: torch.Tensor) -> tuple:
    """The gradient of ``rglru_scan``: a, h (B, T, R) (h the forward's
    output), h0 (B, R) or None, g = dL/dh (B, T, R) -> (da, db, dh0 or
    None), fp32.  From t = T - 1 down: ``d_t = g_t + a_{t+1} d_{t+1}``
    (``d_{T-1} = g_{T-1}``), ``db_t = d_t``, ``da_t = d_t h_{t-1}`` (h0,
    or zeros, before step 0), ``dh0 = a_0 d_0``."""
    a32, h32, g32 = (x.to(torch.float32) for x in (a, h, g))
    da, db = torch.empty_like(g32), torch.empty_like(g32)
    first = (torch.zeros_like(g32[:, 0]) if h0 is None
             else h0.to(torch.float32))
    d = None
    for t in reversed(range(a.shape[1])):
        d = g32[:, t] if d is None else g32[:, t] + a32[:, t + 1] * d
        db[:, t] = d
        da[:, t] = d * (h32[:, t - 1] if t > 0 else first)
    return da, db, (None if h0 is None else a32[:, 0] * d)


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, S0: torch.Tensor | None,
                 dout: torch.Tensor, dS_T: torch.Tensor | None = None):
    """The gradient of ``wkv6``: its operands, dout = dL/dout (B, T, H,
    hd) and dS_T = dL/dS_T (B, H, hd, hd) or None (zeros) -> (dr, dk,
    dv, dw (B, T, H, hd), du (H, hd), dS0 (B, H, hd, hd)), fp32.  The
    states S_{t-1} are recomputed as ``wkv6_ref`` makes them; then from
    t = T - 1 down, with D = dL/dS_t (``b`` = v_t . do_t):

    * ``dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u_i k_t[i] b``
    * ``dk_t[i] = sum_j D[i][j] v_t[j] + u_i r_t[i] b``
    * ``dv_t[j] = sum_i D[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) do_t[j]``
    * ``dw_t[i] = sum_j D[i][j] S_{t-1}[i][j]``
    * ``du_i += r_t[i] k_t[i] b``
    * ``D <- w_t[i] D[i][j] + r_t[i] do_t[j]``, and ``dS0`` is the last D.
    """
    r, k, v, w, do = (x.to(torch.float32) for x in (r, k, v, w, dout))
    u = u.to(torch.float32)
    B, T, H, hd = r.shape
    S = r.new_zeros((B, H, hd, hd)) if S0 is None else S0.to(torch.float32)
    states = []
    for t in range(T):
        states.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
    D = (r.new_zeros((B, H, hd, hd)) if dS_T is None
         else dS_T.to(torch.float32))
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dot = (x[:, t] for x in (r, k, v, w, do))
        Sp = states[t]
        b = (vt * dot).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", Sp, dot) + u * kt * b
        dk[:, t] = torch.einsum("bhij,bhj->bhi", D, vt) + u * rt * b
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", D, kt)
                    + (rt * u * kt).sum(-1, keepdim=True) * dot)
        dw[:, t] = (D * Sp).sum(-1)
        du = du + (rt * kt * b).sum(0)
        D = wt[..., None] * D + rt[..., None] * dot[..., None, :]
    return dr, dk, dv, dw, du, D
