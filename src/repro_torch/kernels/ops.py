"""Public wrappers of the port's kernels.

The block sweeps ``block_matvec`` (``A @ Q``), ``block_rmatvec``
(``A^T @ Y``) and their composition ``block_gram_chain``
(``A^T (A Q)``); the deflation engines' ``matvec`` (``A @ v``),
``deflate_rmatvec`` (the fused Alg-4 reverse sweep) and ``gram``
(``A^T A``), each with ``trans=True`` for the same function of ``A^T``;
and the LM prefill's ``local_attention`` (causal sliding-window
attention with GQA and soft-capping).  Each checks its operands, then:

* for tensors on the CPU, run the plain PyTorch version
  (``kernels/ref.py``) — the caller asked for the CPU;
* for CUDA tensors, launch the Hopper kernel (``kernels/block_matvec.py``,
  ``deflate_matvec.py``, ``gram.py``, ``local_attn.py``) or raise.
  There is no fallback from the card to anything else.

``dtype`` is the sweep dtype of the precision policy (``None`` = A's own
dtype): both operands are cast to it and the sums are fp32, so the
output is always fp32.  A caller that sweeps many times casts ``A``
once itself (``DenseOperator`` does), which makes the cast here a no-op.

``matvec`` and ``deflate_rmatvec`` read fp32 (the deflation engines are
the fp32 oracle); an operand of another dtype is cast first.  ``gram``
reads fp32 or bf16, like ``block_matvec``.  ``local_attention`` reads
fp32 or bf16 and returns q's dtype, as the JAX kernel does.

``launches`` counts, per kernel, the launches these wrappers made on the
card; the CPU path never touches it.  A wrapper counts one per call,
whatever the layout (``trans``), although a split reduction adds a
second (summing) launch on the card, and a 3xTF32 sweep a first one
that splits its skinny operand.  ``route_launches`` splits the block
sweeps' counts by the route that ran (``block_matvec.route``: fp32 on
the tensor cores as 3xTF32, ``"tf32x3"``; bf16 on them, ``"wgmma"``;
or ``"ffma"``).

The JAX package's TPU-only wrapper logic has no counterpart here: the
kernels mask ragged edges themselves, so there is no lane padding of k,
no tile padding of ``A`` (a padded copy of a 32 GiB ``A`` would not fit
beside it) and no interpret mode.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.kernels import block_matvec as _bm
from repro_torch.kernels import deflate_matvec as _dm
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import local_attn as _la
from repro_torch.kernels import ref as _ref

#: launches made on the card since the last ``reset_launches()``
launches = {"block_matvec": 0, "block_rmatvec": 0, "block_gram_chain": 0,
            "matvec": 0, "deflate_rmatvec": 0, "gram": 0,
            "local_attention": 0}


#: the block sweeps' launches by route, since the last ``reset_launches()``
route_launches = {f"{name}/{which}": 0
                  for name in ("block_matvec", "block_rmatvec")
                  for which in ("tf32x3", "wgmma", "ffma")}


def reset_launches() -> None:
    for counts in (launches, route_launches):
        for name in counts:
            counts[name] = 0


def _sweep_dtype(A, X, dtype, what: str) -> torch.dtype:
    """Check the operands; the dtype both are read in."""
    if not isinstance(A, torch.Tensor) or not isinstance(X, torch.Tensor):
        raise TypeError(f"{what} takes torch tensors, got "
                        f"{type(A).__name__} and {type(X).__name__}")
    if A.ndim != 2 or X.ndim != 2:
        raise ValueError(f"{what} takes 2-D operands, got shapes "
                         f"{tuple(A.shape)} and {tuple(X.shape)}")
    if A.device != X.device:
        raise ValueError(f"{what}: operands on different devices "
                         f"({A.device} and {X.device})")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cpu' (plain PyTorch) or 'cuda' "
                         f"(the Hopper kernel), got {A.device}")
    sd = A.dtype if dtype is None else resolve_sweep_dtype(dtype)
    if sd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what} reads float32 or bfloat16 operands, "
                         f"got {sd}")
    return sd


def _on_card(A: torch.Tensor, X: torch.Tensor, sd: torch.dtype):
    """Operands as the kernel reads them: contiguous, in ``sd``.  A
    non-contiguous ``A`` is refused rather than copied."""
    if not A.is_contiguous():
        raise ValueError("the CUDA sweep kernels read A row-major: pass a "
                         "contiguous A (for A^T use the other sweep)")
    return A.to(sd), X.to(sd).contiguous()


def block_matvec(A: torch.Tensor, Q: torch.Tensor, *,
                 dtype=None) -> torch.Tensor:
    """``A @ Q``; A (m, n), Q (n, k) -> (m, k) fp32."""
    sd = _sweep_dtype(A, Q, dtype, "block_matvec")
    if Q.shape[0] != A.shape[1]:
        raise ValueError(f"block_matvec: A {tuple(A.shape)} @ Q "
                         f"{tuple(Q.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.block_matvec_ref(A, Q, sd)
    if A.numel() == 0 or Q.shape[1] == 0:
        return torch.zeros((A.shape[0], Q.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Q = _on_card(A, Q, sd)
    which = _bm.route(A, Q.shape[1])
    Y = _bm.block_matvec_cuda(A, Q, which)
    launches["block_matvec"] += 1
    route_launches[f"block_matvec/{which}"] += 1
    return Y


def block_rmatvec(A: torch.Tensor, Y: torch.Tensor, *,
                  dtype=None) -> torch.Tensor:
    """``A^T @ Y``; A (m, n), Y (m, k) -> (n, k) fp32."""
    sd = _sweep_dtype(A, Y, dtype, "block_rmatvec")
    if Y.shape[0] != A.shape[0]:
        raise ValueError(f"block_rmatvec: A^T {tuple(A.shape)} @ Y "
                         f"{tuple(Y.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.block_rmatvec_ref(A, Y, sd)
    if A.numel() == 0 or Y.shape[1] == 0:
        return torch.zeros((A.shape[1], Y.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Y = _on_card(A, Y, sd)
    which = _bm.route(A, Y.shape[1])
    Z = _bm.block_rmatvec_cuda(A, Y, which)
    launches["block_rmatvec"] += 1
    route_launches[f"block_rmatvec/{which}"] += 1
    return Z


def block_gram_chain(A: torch.Tensor, X: torch.Tensor, *, dtype=None,
                     trans: bool = False) -> torch.Tensor:
    """``A^T (A X)`` — one block power sweep — or, with ``trans=True``,
    the chain of the transposed operand ``A (A^T X)`` without ever
    forming ``A^T``.  ``A`` is cast once; the fp32 intermediate is
    rounded to the sweep dtype by the second sweep's operand cast, as in
    the JAX package's ``block_gram_chain``."""
    sd = _sweep_dtype(A, X, dtype, "block_gram_chain")
    A = A.to(sd)                          # cast once, both sweeps reuse
    if trans:
        Z = block_matvec(A, block_rmatvec(A, X, dtype=sd), dtype=sd)
    else:
        Z = block_rmatvec(A, block_matvec(A, X, dtype=sd), dtype=sd)
    if A.device.type == "cuda":
        launches["block_gram_chain"] += 1
    return Z


def _vector_operands(what: str, A, *vecs) -> None:
    """Check the deflation sweeps' operands: tensors, 2-D ``A``, one
    device, 'cpu' or 'cuda'."""
    for x in (A, *vecs):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what} takes torch tensors, got "
                            f"{type(x).__name__}")
        if x.device != A.device:
            raise ValueError(f"{what}: operands on different devices "
                             f"({A.device} and {x.device})")
    if A.ndim != 2:
        raise ValueError(f"{what} takes a 2-D A, got shape "
                         f"{tuple(A.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cpu' (plain PyTorch) or 'cuda' "
                         f"(the Hopper kernel), got {A.device}")


def _fp32_on_card(A: torch.Tensor, *vecs):
    """Operands as the fp32 kernels read them; a non-contiguous ``A`` is
    refused rather than copied."""
    if not A.is_contiguous():
        raise ValueError("the CUDA kernels read A row-major: pass a "
                         "contiguous A (for A^T use trans=True)")
    return (A.to(torch.float32),
            *(x.to(torch.float32).contiguous() for x in vecs))


def matvec(A: torch.Tensor, v: torch.Tensor, *,
           trans: bool = False) -> torch.Tensor:
    """``A @ v``; A (m, n), v (n,) -> (m,) fp32.  ``trans=True``:
    ``A^T @ v``, v (m,) -> (n,)."""
    _vector_operands("matvec", A, v)
    m, n = A.shape
    if v.ndim != 1 or v.shape[0] != (m if trans else n):
        raise ValueError(f"matvec: A {tuple(A.shape)} (trans={trans}) and "
                         f"v {tuple(v.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.matvec_ref(A, v, trans)
    if A.numel() == 0:
        return torch.zeros((n if trans else m,), dtype=torch.float32,
                           device=A.device)
    A, v = _fp32_on_card(A, v)
    y = _dm.matvec_cuda(A, v, trans)
    launches["matvec"] += 1
    return y


def deflate_rmatvec(A: torch.Tensor, U: torch.Tensor, Xv: torch.Tensor,
                    SVtv: torch.Tensor, *, trans: bool = False):
    """The fused Alg-4 reverse sweep, one read of ``A``:
    ``(A^T (Xv - U @ SVtv), U^T Xv)`` for A (m, n), U (m, k), Xv (m,),
    SVtv (k,) -> ((n,), (k,)) fp32.  ``trans=True`` is the same function
    of ``A^T``: U (n, k), Xv (n,) -> ``(A (Xv - U @ SVtv), U^T Xv)``,
    ((m,), (k,))."""
    _vector_operands("deflate_rmatvec", A, U, Xv, SVtv)
    m, n = A.shape
    side = n if trans else m
    if (U.ndim != 2 or U.shape[0] != side or Xv.shape != (side,)
            or SVtv.shape != (U.shape[1],)):
        raise ValueError(
            f"deflate_rmatvec: A {tuple(A.shape)} (trans={trans}), U "
            f"{tuple(U.shape)}, Xv {tuple(Xv.shape)}, SVtv "
            f"{tuple(SVtv.shape)} do not conform")
    if A.device.type == "cpu":
        return _ref.deflate_rmatvec_ref(A, U, Xv, SVtv, trans)
    if A.numel() == 0:
        return (torch.zeros((m if trans else n,), dtype=torch.float32,
                            device=A.device),
                _ref.deflate_rmatvec_ref(A, U, Xv, SVtv, trans)[1])
    A, U, Xv, SVtv = _fp32_on_card(A, U, Xv, SVtv)
    out = _dm.deflate_rmatvec_cuda(A, U, Xv, SVtv, trans)
    launches["deflate_rmatvec"] += 1
    return out


def gram(A: torch.Tensor, *, symmetric: bool = True,
         trans: bool = False) -> torch.Tensor:
    """``A^T A`` (``A A^T`` with ``trans``), fp32 out, from fp32 or bf16
    ``A``.  ``symmetric=True`` is the reduced-task schedule (upper-
    triangle tiles, mirrored); ``False`` computes every tile.  Both give
    the full product; the plain version has no tiles and ignores it."""
    _vector_operands("gram", A)
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram reads float32 or bfloat16, got {A.dtype}")
    if A.device.type == "cpu":
        return _ref.gram_ref(A, trans)
    m, n = A.shape
    N = m if trans else n
    if A.numel() == 0:
        return torch.zeros((N, N), dtype=torch.float32, device=A.device)
    if not A.is_contiguous():
        raise ValueError("the CUDA gram kernel reads A row-major: pass a "
                         "contiguous A (for A A^T use trans=True)")
    B = _gram.gram_cuda(A, symmetric=symmetric, trans=trans)
    launches["gram"] += 1
    return B


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, softcap: float | None = None
                    ) -> torch.Tensor:
    """Causal sliding-window attention: query ``i`` attends to keys
    ``i - window < j <= i`` (``window >= S`` is plain causal attention),
    logits ``tanh(s / softcap) * softcap`` when ``softcap`` is given.
    q (B, H, S, D), k/v (B, Hkv, S, D) with ``Hkv`` dividing ``H`` (head
    ``h`` reads K/V head ``h // (H // Hkv)``) -> (B, H, S, D) in q's
    dtype.  On the card D is one of ``local_attn.HEAD_DIMS`` and
    ``local_attn.route`` picks the kernel (bf16 at D >= 64 on the tensor
    cores, the rest by FFMA); any strides along B, H and S are read in
    place, and an operand whose base or strides are not 16-byte aligned
    is refused, on both devices (on the tensor-core route, also a zero
    stride: a broadcast view)."""
    for x in (q, k, v):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"local_attention takes torch tensors, got "
                            f"{type(x).__name__}")
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"local_attention: q, k and v must share one "
                             f"device and dtype, got {q.device}/{q.dtype} "
                             f"and {x.device}/{x.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"local_attention reads float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"local_attention takes q (B, H, S, D) and k, v "
                         f"(B, Hkv, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"local_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} do not conform")
    if window < 1 or (softcap is not None and not softcap > 0):
        raise ValueError(f"local_attention needs window >= 1 and softcap > 0 "
                         f"or None, got {window}, {softcap}")
    if q.numel() and not all(_la.readable(x) for x in (q, k, v)):
        raise ValueError("local_attention reads q, k and v in place: unit "
                         "stride along D, base and other strides 16-byte "
                         "aligned (pass a contiguous copy)")
    if q.device.type == "cpu":
        return _ref.local_attention_ref(q, k, v, window=window,
                                        softcap=softcap).to(q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"local_attention runs on 'cpu' (plain PyTorch) or "
                         f"'cuda' (the Hopper kernel), got {q.device}")
    if D not in _la.HEAD_DIMS:
        raise ValueError(f"local_attention on the card takes a head dim in "
                         f"{_la.HEAD_DIMS}, got {D}")
    if q.numel() == 0:
        return torch.empty_like(q)
    if _la.route(q.dtype, D) == "wgmma" and not all(
            _la.tma_describable(x) for x in (q, k, v)):
        raise ValueError("local_attention on the tensor cores reads q, k "
                         "and v through TMA tensor maps, which take no zero "
                         "stride (pass a contiguous copy)")
    out = _la.local_attention_cuda(q, k, v, window, softcap)
    launches["local_attention"] += 1
    return out


block_matvec_ref = _ref.block_matvec_ref
block_rmatvec_ref = _ref.block_rmatvec_ref
block_gram_chain_ref = _ref.block_gram_chain_ref
matvec_ref = _ref.matvec_ref
deflate_rmatvec_ref = _ref.deflate_rmatvec_ref
gram_ref = _ref.gram_ref
local_attention_ref = _ref.local_attention_ref
