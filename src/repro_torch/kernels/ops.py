"""Public wrappers of the port's kernels.

The block sweeps ``block_matvec`` (``A @ Q``), ``block_rmatvec``
(``A^T @ Y``) and their composition ``block_gram_chain``
(``A^T (A Q)``); the deflation engines' ``matvec`` (``A @ v``),
``deflate_rmatvec`` (the fused Alg-4 reverse sweep) and ``gram``
(``A^T A``), each with ``trans=True`` for the same function of ``A^T``;
the LM's ``local_attention`` (causal sliding-window attention with GQA
and soft-capping; differentiable where autograd records, its gradient
being ``local_attention_bwd``); and the sparse stream's CSR
sweeps of one row block, ``csr_matmat`` (``A_b Q``), ``csr_rmatmat``
(``Z += A_b^T Y``, in place) and ``csr_gram_chain`` (both halves on one
copy of the block).  Each checks its operands, then:

* for tensors on the CPU, run the plain PyTorch version
  (``kernels/ref.py``) — the caller asked for the CPU;
* for CUDA tensors, launch the Hopper kernel (``kernels/block_matvec.py``,
  ``deflate_matvec.py``, ``gram.py``, ``local_attn.py``) or raise.
  There is no fallback from the card to anything else.  The CSR sweeps'
  kernels are ``kernels/csr_sweep.py``'s.

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
the tensor cores as 3xTF32, ``"tf32x3"`` where a TMA tensor map
describes ``A``, else ``"tf32x3_cpasync"``; bf16 on them, ``"wgmma"``
by the same rule, else ``"wgmma_ld"``, ``A`` copied by the kernel's own
producer), and ``gram``'s (``gram.route``: fp32 on ``"tf32x3"`` or
``"tf32x3_cpasync"`` by the same rule, bf16 on ``"wgmma"`` or
``"wgmma_ld"`` by it), and the CSR sweeps' counts by the values'
dtype (``"csr_matmat/float32"``, ``"csr_matmat/bfloat16"``, ...), and
the attention backward's by ``local_attn.bwd_route`` (``"wgmma"`` or
``"ffma"``, ``local_attn.BWD_KERNELS`` launches a call).  The
CSR chain counts itself and its two halves, as ``block_gram_chain``
does.  ``thread_launches`` also tallies, by kernel and by route, the
launches one thread makes while it is open (the SVD service's workers
each run one job at a time, so a job's own launches).  ``thread_a_bytes``
tallies, by kernel and in all (``"a_bytes"``), the bytes of ``A`` the
sweeps one thread calls read while it is open, on the CPU path as on the
card: ``A.numel()`` times the sweep dtype's itemsize for the dense
sweeps (``block_gram_chain`` is its two sweeps), the values' bytes for
the CSR sweeps (a chain reads its block once), the unit the operators'
``bytes_per_pass`` counts in; the static analysis
(``repro_torch.analysis``) holds it against that accounting.

The block sweeps and ``gram`` read ``A`` in place where it is row-major
with unit column stride (``block_matvec.row_stride``): contiguous, or a
view of wider rows such as ``DenseOperator``'s bf16 copy, whose rows are
padded to whole 16 bytes.

The JAX package's TPU-only wrapper logic has no counterpart here: the
kernels mask ragged edges themselves, so there is no lane padding of k,
no tile padding of ``A`` (a padded copy of a 32 GiB ``A`` would not fit
beside it) and no interpret mode.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.core.precision import resolve_sweep_dtype
from repro_torch.kernels import block_matvec as _bm
from repro_torch.kernels import csr_sweep as _csr
from repro_torch.kernels import deflate_matvec as _dm
from repro_torch.kernels import gram as _gram
from repro_torch.kernels import local_attn as _la
from repro_torch.kernels import ref as _ref

#: launches made on the card since the last ``reset_launches()``
launches = {"block_matvec": 0, "block_rmatvec": 0, "block_gram_chain": 0,
            "matvec": 0, "deflate_rmatvec": 0, "gram": 0,
            "local_attention": 0, "local_attention_bwd": 0,
            "csr_matmat": 0, "csr_rmatmat": 0, "csr_gram_chain": 0}

#: the CSR sweeps, by the dtype of the values they read
CSR_KERNELS = ("csr_matmat", "csr_rmatmat", "csr_gram_chain")


#: the block sweeps' and ``gram``'s launches by route, since the last
#: ``reset_launches()``
route_launches = {**{f"{name}/{which}": 0
                     for name in ("block_matvec", "block_rmatvec")
                     for which in _bm.ROUTES},
                  **{f"gram/{which}": 0 for which in _gram.ROUTES},
                  **{f"{name}/{dt}": 0 for name in CSR_KERNELS
                     for dt in ("float32", "bfloat16")},
                  **{f"local_attention_bwd/{which}": 0
                     for which in ("wgmma", "ffma")}}


#: the counts are written from every thread that launches (the SVD
#: service's workers run solves at once): an increment holds this lock
_COUNT_LOCK = threading.Lock()

#: this thread's open ``thread_launches`` tally, if any
_TALLY = threading.local()


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (launches, route_launches):
            for name in counts:
                counts[name] = 0


@contextlib.contextmanager
def _thread_tally(attr: str):
    """Open a fresh dict as this thread's ``attr`` tally for the block,
    then restore the one it replaced."""
    outer = getattr(_TALLY, attr, None)
    tally = {}
    setattr(_TALLY, attr, tally)
    try:
        yield tally
    finally:
        setattr(_TALLY, attr, outer)


def thread_launches():
    """Yields a dict that counts, by kernel name and by route (the keys
    of ``launches`` and ``route_launches``), the launches this thread
    makes until the block ends."""
    return _thread_tally("counts")


def thread_a_bytes():
    """Yields a dict that sums, by kernel name and in all (``"a_bytes"``),
    the bytes of ``A`` the sweeps this thread calls read until the block
    ends, on either device."""
    return _thread_tally("a_bytes")


def _read_a(name: str, nbytes: int) -> None:
    """``nbytes`` of ``A`` read by one call of the sweep ``name``."""
    tally = getattr(_TALLY, "a_bytes", None)
    if tally is not None:
        for key in ("a_bytes", name):
            tally[key] = tally.get(key, 0) + int(nbytes)


def _count(name: str, route: str | None = None) -> None:
    """One launch of ``name`` (and of its ``route``) on the card."""
    with _COUNT_LOCK:
        launches[name] += 1
        if route is not None:
            route_launches[route] += 1
    tally = getattr(_TALLY, "counts", None)
    if tally is not None:
        for key in (name, route) if route is not None else (name,):
            tally[key] = tally.get(key, 0) + 1


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
    """Operands as the kernel reads them, in ``sd``: ``A`` row-major with
    unit column stride and rows at least n apart (contiguous, or a view
    of wider rows), ``X`` contiguous.  Any other ``A`` is refused rather
    than copied."""
    if _bm.row_stride(A) is None:
        raise ValueError("the CUDA sweep kernels read A row-major with unit "
                         "column stride: pass a contiguous A or a view of "
                         "wider rows (for A^T use the other sweep)")
    return A.to(sd), X.to(sd).contiguous()


def block_matvec(A: torch.Tensor, Q: torch.Tensor, *,
                 dtype=None) -> torch.Tensor:
    """``A @ Q``; A (m, n), Q (n, k) -> (m, k) fp32."""
    sd = _sweep_dtype(A, Q, dtype, "block_matvec")
    if Q.shape[0] != A.shape[1]:
        raise ValueError(f"block_matvec: A {tuple(A.shape)} @ Q "
                         f"{tuple(Q.shape)} do not conform")
    _read_a("block_matvec", A.numel() * sd.itemsize)
    if A.device.type == "cpu":
        return _ref.block_matvec_ref(A, Q, sd)
    if A.numel() == 0 or Q.shape[1] == 0:
        return torch.zeros((A.shape[0], Q.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Q = _on_card(A, Q, sd)
    which = _bm.route(A, Q.shape[1])
    Y = _bm.block_matvec_cuda(A, Q, which)
    _count("block_matvec", f"block_matvec/{which}")
    return Y


def block_rmatvec(A: torch.Tensor, Y: torch.Tensor, *,
                  dtype=None) -> torch.Tensor:
    """``A^T @ Y``; A (m, n), Y (m, k) -> (n, k) fp32."""
    sd = _sweep_dtype(A, Y, dtype, "block_rmatvec")
    if Y.shape[0] != A.shape[0]:
        raise ValueError(f"block_rmatvec: A^T {tuple(A.shape)} @ Y "
                         f"{tuple(Y.shape)} do not conform")
    _read_a("block_rmatvec", A.numel() * sd.itemsize)
    if A.device.type == "cpu":
        return _ref.block_rmatvec_ref(A, Y, sd)
    if A.numel() == 0 or Y.shape[1] == 0:
        return torch.zeros((A.shape[1], Y.shape[1]), dtype=torch.float32,
                           device=A.device)
    A, Y = _on_card(A, Y, sd)
    which = _bm.route(A, Y.shape[1])
    Z = _bm.block_rmatvec_cuda(A, Y, which)
    _count("block_rmatvec", f"block_rmatvec/{which}")
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
        _count("block_gram_chain")
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
    _read_a("matvec", A.numel() * 4)
    if A.device.type == "cpu":
        return _ref.matvec_ref(A, v, trans)
    if A.numel() == 0:
        return torch.zeros((n if trans else m,), dtype=torch.float32,
                           device=A.device)
    A, v = _fp32_on_card(A, v)
    y = _dm.matvec_cuda(A, v, trans)
    _count("matvec")
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
    _read_a("deflate_rmatvec", A.numel() * 4)
    if A.device.type == "cpu":
        return _ref.deflate_rmatvec_ref(A, U, Xv, SVtv, trans)
    if A.numel() == 0:
        return (torch.zeros((m if trans else n,), dtype=torch.float32,
                            device=A.device),
                _ref.deflate_rmatvec_ref(A, U, Xv, SVtv, trans)[1])
    A, U, Xv, SVtv = _fp32_on_card(A, U, Xv, SVtv)
    out = _dm.deflate_rmatvec_cuda(A, U, Xv, SVtv, trans)
    _count("deflate_rmatvec")
    return out


def gram(A: torch.Tensor, *, symmetric: bool = True,
         trans: bool = False) -> torch.Tensor:
    """``A^T A`` (``A A^T`` with ``trans``), fp32 out, from fp32 or bf16
    ``A``.  ``symmetric=True`` is the reduced-task schedule (upper-
    triangle tiles, mirrored); ``False`` computes every tile.  Both give
    the full product, exactly symmetric; the plain version has no tiles
    and ignores it.  On the card ``gram.route`` picks the kernel (fp32 as
    3xTF32 on the tensor cores, bf16 on their bf16 form), which reads
    ``A`` in place where it is row-major with unit column stride
    (``row_stride``)."""
    _vector_operands("gram", A)
    if A.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram reads float32 or bfloat16, got {A.dtype}")
    _read_a("gram", A.numel() * A.element_size())
    if A.device.type == "cpu":
        return _ref.gram_ref(A, trans)
    m, n = A.shape
    N = m if trans else n
    if A.numel() == 0:
        return torch.zeros((N, N), dtype=torch.float32, device=A.device)
    if _bm.row_stride(A) is None:
        raise ValueError("the CUDA gram kernels read A row-major with unit "
                         "column stride: pass a contiguous A or a view of "
                         "wider rows (for A A^T use trans=True)")
    which = _gram.route(A)
    B = _gram.gram_cuda(A, which, symmetric=symmetric, trans=trans)
    _count("gram", f"gram/{which}")
    return B


def _attention_operands(q, k, v, window, softcap) -> None:
    """Check ``local_attention``'s operands, on both devices."""
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"local_attention runs on 'cpu' (plain PyTorch) or "
                         f"'cuda' (the Hopper kernel), got {q.device}")
    if q.device.type == "cuda":
        if D not in _la.HEAD_DIMS:
            raise ValueError(f"local_attention on the card takes a head dim "
                             f"in {_la.HEAD_DIMS}, got {D}")
        if q.numel() and _la.route(q.dtype, D) == "wgmma" and not all(
                _la.tma_describable(x) for x in (q, k, v)):
            raise ValueError("local_attention on the tensor cores reads q, k "
                             "and v through TMA tensor maps, which take no "
                             "zero stride (pass a contiguous copy)")


def _attention_forward(q, k, v, window, softcap, with_lse: bool):
    """(o, lse or None) of checked operands: the plain version on the
    CPU, the kernel (one counted launch) on the card."""
    if q.device.type == "cpu":
        o, lse = _ref.local_attention_lse_ref(q, k, v, window=window,
                                              softcap=softcap)
        return o.to(q.dtype), lse if with_lse else None
    if q.numel() == 0:
        return torch.empty_like(q), q.new_empty(q.shape[:3],
                                                dtype=torch.float32)
    lse = (torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
           if with_lse else None)
    out = _la.local_attention_cuda(q, k, v, window, softcap, lse)
    _count("local_attention")
    return out, lse


class _LocalAttention(torch.autograd.Function):
    """``local_attention`` with its gradient: the forward kernel keeping
    each row's log-sum-exp, the backward ``local_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, window, softcap):
        o, lse = _attention_forward(q, k, v, window, softcap, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.softcap = window, softcap
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = local_attention_bwd(q, k, v, o, do, lse,
                                         window=ctx.window,
                                         softcap=ctx.softcap)
        return dq, dk, dv, None, None


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
    stride: a broadcast view).

    Where autograd records (grad mode on and q, k or v requiring grad),
    the call is differentiable: the forward also keeps each row's
    log-sum-exp and the backward is ``local_attention_bwd`` (on the card
    the hand-written backward kernel).  Without grad it is the forward
    alone, as prefill runs it."""
    _attention_operands(q, k, v, window, softcap)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _LocalAttention.apply(q, k, v, window, softcap)
    return _attention_forward(q, k, v, window, softcap, False)[0]


def local_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, window: int, softcap: float | None = None):
    """The gradient of ``local_attention``: given its operands, its output
    ``o``, the output's gradient ``do`` and the forward's row log-sum-exp
    ``lse`` (B, H, S) fp32, (dq, dk, dv) in q's dtype and the shapes of
    q, k and v.  On the CPU the plain version
    (``ref.local_attention_bwd_ref``); on the card the backward kernel
    (``csrc/local_attn_bwd.cu``: ``local_attn.BWD_KERNELS`` launches, all
    counted under ``local_attention_bwd`` and under its route,
    ``local_attention_bwd/<local_attn.bwd_route>``).  ``do`` and ``o``
    are read in place where ``local_attn.bwd_reads_in_place`` takes them
    on that route, else copied contiguous first; ``lse`` likewise."""
    _attention_operands(q, k, v, window, softcap)
    for x in (o, do):
        if x.shape != q.shape or x.device != q.device:
            raise ValueError(f"local_attention_bwd: o and do must be "
                             f"{tuple(q.shape)} on {q.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"local_attention_bwd: lse must be "
                         f"{tuple(q.shape[:3])} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if q.device.type == "cpu":
        return tuple(g.to(q.dtype) for g in _ref.local_attention_bwd_ref(
            q, k, v, o, do, lse, window=window, softcap=softcap))
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    which = _la.bwd_route(q.dtype, q.shape[3])
    o, do = (x if x.dtype == q.dtype and _la.bwd_reads_in_place(which, x)
             else x.to(q.dtype).contiguous() for x in (o, do))
    grads = _la.local_attention_bwd_cuda(q, k, v, o, do, lse.contiguous(),
                                         window, softcap)
    for _ in range(_la.BWD_KERNELS):
        _count("local_attention_bwd", f"local_attention_bwd/{which}")
    return grads


def _csr_operands(what: str, off, col, val, X, *, rows_of_X: bool,
                  out=None) -> None:
    """Check one CSR block and its dense operand ``X`` (``Q`` (n, k) or
    ``Y`` (rows, k)): tensors on one device, int32 ``off`` (rows + 1) and
    ``col`` (nnz), fp32 or bf16 ``val`` (nnz), contiguous fp32 ``X``."""
    for x in (off, col, val, X, *(() if out is None else (out,))):
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{what} takes torch tensors, got "
                            f"{type(x).__name__}")
        if x.device != X.device:
            raise ValueError(f"{what}: operands on different devices "
                             f"({x.device} and {X.device})")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cpu' (plain PyTorch) or 'cuda' "
                         f"(the Hopper kernel), got {X.device}")
    if off.dtype != torch.int32 or col.dtype != torch.int32 or \
            off.ndim != 1 or col.ndim != 1 or off.numel() < 1:
        raise ValueError(f"{what} takes int32 row offsets (rows + 1) and "
                         f"int32 columns, got {off.dtype} {tuple(off.shape)} "
                         f"and {col.dtype} {tuple(col.shape)}")
    if val.dtype not in (torch.float32, torch.bfloat16) or \
            val.shape != col.shape:
        raise ValueError(f"{what} reads float32 or bfloat16 values, one a "
                         f"column, got {val.dtype} {tuple(val.shape)}")
    if X.dtype != torch.float32 or X.ndim != 2 or not X.is_contiguous():
        raise ValueError(f"{what} takes a contiguous 2-D float32 dense "
                         f"operand, got {X.dtype} {tuple(X.shape)}")
    if rows_of_X and X.shape[0] != off.numel() - 1:
        raise ValueError(f"{what}: Y has {X.shape[0]} rows, the block "
                         f"{off.numel() - 1}")
    for x in (off, col, val):
        if not x.is_contiguous():
            raise ValueError(f"{what} reads the CSR arrays contiguous")


def _count_csr(name: str, val: torch.Tensor) -> None:
    _count(name, f"{name}/{str(val.dtype).rsplit('.', 1)[-1]}")


def csr_matmat(off: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
               Q: torch.Tensor, *, out: torch.Tensor | None = None
               ) -> torch.Tensor:
    """``A_b Q`` of one CSR row block; Q (n, k) -> (rows, k) fp32, into
    ``out`` (contiguous, (rows, k) fp32) when given.  Each row's
    nonzeros are summed in stream order."""
    _csr_operands("csr_matmat", off, col, val, Q, rows_of_X=False, out=out)
    rows, k = off.numel() - 1, Q.shape[1]
    if out is not None and (out.shape != (rows, k) or out.dtype !=
                            torch.float32 or not out.is_contiguous()):
        raise ValueError(f"csr_matmat: out must be contiguous ({rows}, {k}) "
                         f"float32, got {out.dtype} {tuple(out.shape)}")
    _read_a("csr_matmat", val.numel() * val.element_size())
    if Q.device.type == "cpu":
        Y = _ref.csr_matmat_ref(off, col, val, Q)
        return Y if out is None else out.copy_(Y)
    Y = _csr.csr_matmat_cuda(off, col, val, Q, out)
    _count_csr("csr_matmat", val)
    return Y


def csr_rmatmat(off: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                Y: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """``Z += A_b^T Y`` for one CSR row block, in place (Y (rows, k), Z
    (n, k) fp32); returns ``Z``.  Each column's nonzeros are added in
    stream order, straight into ``Z``: no atomics."""
    _csr_operands("csr_rmatmat", off, col, val, Y, rows_of_X=True, out=Z)
    if Z.dtype != torch.float32 or Z.ndim != 2 or not Z.is_contiguous() \
            or Z.shape[1] != Y.shape[1]:
        raise ValueError(f"csr_rmatmat: Z must be contiguous (n, "
                         f"{Y.shape[1]}) float32, got {Z.dtype} "
                         f"{tuple(Z.shape)}")
    _read_a("csr_rmatmat", val.numel() * val.element_size())
    if Y.device.type == "cpu":
        return _ref.csr_rmatmat_ref(off, col, val, Y, Z)
    _csr.csr_rmatmat_cuda(off, col, val, Y, Z)
    _count_csr("csr_rmatmat", val)
    return Z


def csr_gram_chain(off: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   Q: torch.Tensor, Z: torch.Tensor, *,
                   round_y: bool = False) -> torch.Tensor:
    """``Z += A_b^T (A_b Q)`` for one CSR row block, both halves on the
    same copy of the block; ``round_y`` rounds the intermediate to bf16
    (the JAX package's bf16 chain).  Returns ``Z``."""
    _csr_operands("csr_gram_chain", off, col, val, Q, rows_of_X=False,
                  out=Z)
    if Z.dtype != torch.float32 or Z.ndim != 2 or not Z.is_contiguous() \
            or Z.shape[1] != Q.shape[1]:
        raise ValueError(f"csr_gram_chain: Z must be contiguous (n, "
                         f"{Q.shape[1]}) float32, got {Z.dtype} "
                         f"{tuple(Z.shape)}")
    _read_a("csr_gram_chain", val.numel() * val.element_size())
    if Q.device.type == "cpu":
        return _ref.csr_gram_chain_ref(off, col, val, Q, Z, round_y)
    _csr.csr_gram_chain_cuda(off, col, val, Q, Z, round_y)
    for name in CSR_KERNELS:
        _count_csr(name, val)
    return Z


block_matvec_ref = _ref.block_matvec_ref
block_rmatvec_ref = _ref.block_rmatvec_ref
block_gram_chain_ref = _ref.block_gram_chain_ref
matvec_ref = _ref.matvec_ref
deflate_rmatvec_ref = _ref.deflate_rmatvec_ref
gram_ref = _ref.gram_ref
local_attention_ref = _ref.local_attention_ref
local_attention_bwd_ref = _ref.local_attention_bwd_ref
csr_matmat_ref = _ref.csr_matmat_ref
csr_rmatmat_ref = _ref.csr_rmatmat_ref
csr_gram_chain_ref = _ref.csr_gram_chain_ref
