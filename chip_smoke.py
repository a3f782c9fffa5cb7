#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build the CUDA kernels of ``src/repro_torch/csrc`` and
   print the build time and each kernel's registers/spills; for every
   ``local_attention`` instance and every tensor-core instance of the
   block sweeps (``block_matvec_tc``: bf16; ``block_matvec_tf32``: fp32
   as 3xTF32) its registers, spills (and for attention its dynamic
   shared memory) and tensor-core instructions (``HGMMA``/``HMMA`` in
   the library's SASS, ``cuobjdump -sass``).  Fails unless the path's
   instances (attention bf16 D = 256; the sweeps' ``matvec_tc<32>``,
   ``rmatvec_tc``, ``matvec_tf32<32>`` and ``rmatvec_tf32<32>``, k = 32)
   have tensor-core instructions and spill nothing.  Beside the real
   build, three planted faults for phase 2b: ``block_matvec_tc.cu`` with
   ``-DREPRO_TC_SUMS_ONLY``, ``block_matvec_tf32.cu`` with
   ``-DREPRO_TF32_ONLY`` and with ``-DREPRO_TC_SUMS_ONLY``.
2. every kernel on the card against its plain PyTorch version
   (``repro_torch/kernels/ref.py``): ``block_matvec``, ``block_rmatvec``
   and ``block_gram_chain`` (both orientations), fp32 and bf16, at
   ragged shapes, each with the route that ran it (``tf32x3``: fp32 on
   the tensor cores; ``wgmma``: bf16 on them; ``ffma``; read from the
   route launch counts), and at the main path's 262144 x 32768, k = 32,
   with the relative Frobenius error and its limit; kernel, plain,
   library (``torch.matmul``, a yardstick only) and bound (by route)
   times at that shape (the FFMA kernels' on the odd-width input of phase
   3, the shape of their path, after its solve).  Then
   the planted faults the limit must reject, against the real sweeps, on
   a 65536 x 32768 |N(0, 1)| ``A`` (bf16 for ``block_matvec_tc``, fp32
   for ``block_matvec_tf32``) with skinny operands uniform in [0, 1)
   (every partial sum grows, as a truncating accumulator likes least)
   and, in fp32, on a signed N(0, 1) input (the sums cancel, so the
   products' rounding is not averaged away): the sums left in the tensor
   cores' accumulators for the whole reduction, not promoted to rounded
   adds every stage; and plain TF32, the ``hi hi`` term of 3xTF32 alone.
   Each must read above the limit on at least one input.
3. the main path: ``repro_torch.svd(A, 32)`` with the default config on
   a 262144 x 32768 fp32 ``A`` (32 GiB, the paper's per-node shard)
   built on the card with singular values ``100 * 0.9**i`` (i < 64) plus
   noise far below them; sigma checked to rtol 1e-4, launch counts
   (by route: ``tf32x3``, chains and extraction) checked against the
   pass accounting, and a profile of it (device busy share, time by
   kernel).  Then ``sweep_dtype="bfloat16"`` (eps 1e-4, rtol 1e-2) on the
   same ``A``, its chains on the ``wgmma`` route (the extraction reads
   ``A`` in fp32: ``tf32x3``), and its profile; an fp32 input of odd
   width (65536 x 8190, rows no tensor map describes: ``ffma`` end to
   end); and a contiguous wide input (the operator's transposed path).
4. the deflation kernels (``matvec``, ``deflate_rmatvec``, ``gram``,
   both layouts; ``gram`` symmetric and full, fp32 and bf16) against
   their plain versions at ragged shapes (relative Frobenius error, limit
   1e-5; ``gram`` 4 sqrt(r) 2^-24 for a reduction of length r, at least
   1e-5, see ``gram_tol``), and at the deflation paths' shapes with
   kernel, plain, bound and library (a yardstick only) times.
5. the gram-free path: ``repro_torch.svd(A, 16, method="gramfree")`` on
   the same 262144 x 32768 ``A``; sigma within rtol 2e-3 of the
   prescribed spectrum (the JAX package's deflation tolerance), launches
   ``matvec`` sum(iters) + k and ``deflate_rmatvec`` sum(iters), passes
   3 sum(iters) + k.  Then the gram path: ``svd(A, 8, method="gram")`` on
   a 262144 x 8192 ``A`` (launches ``gram`` k, ``matvec`` k; passes 3k),
   and both methods at k = 4 on the contiguous wide input (the ``trans``
   kernels).
6. determinism: two block solves (fp32 on ``tf32x3``, and bf16 on
   ``wgmma``) and two gram-free solves of a 16384 x 4096 matrix, each
   pair bitwise equal.
7. the LM serving path: the ``local_attention`` kernels (causal
   sliding-window attention, GQA, soft-cap; bf16 at D >= 64 on the
   tensor cores, the rest by FFMA) against their plain version at
   ragged shapes (fp32 and bf16, every head dim of its template) and at
   the path's shapes (gemma2-9b prefill: B = 2, H = 16, Hkv = 8,
   S = 8192, D = 256, bf16, soft-cap 50, window 4096 and window S; the
   plain version two heads at a time).  Each output element is held to
   its own limit (``attn_share``): fp32 within 1e-4, the JAX package's
   limit for its kernel; bf16 within the kernel's one rounding of its
   fp32 output to bf16, 2^-8 |o| of that element, plus 1e-5 for the
   fp32 sums' order.  At the path's shapes the same check must reject
   the kernel run with its window one key tile (64) short.  Then
   gemma2-9b at full width (42 layers, bf16, weights from seed 0)
   through ``repro_torch.launch.serve``'s functions: a prefill of 2
   prompts of 8192 tokens (twice the window, so the local mask and the
   local ring buffer both bite) with 42 kernel launches, checked, and
   32 greedy decode steps with none; prefill seconds, decode tokens/s,
   peak memory.  Consistency: the decode step's logits at position 8192
   against the last logits of a prefill over the 8193 tokens, relative
   Frobenius error at most ``TOL_CONSISTENCY``.  The two paths cannot
   agree bit for bit: the prefill runs the kernel on a ragged S with
   fp32 probabilities, the decode the plain cache path with bf16
   probabilities, and cuBLAS rounds the bf16 products of 8193 rows and
   of one row in other orders, compounded over 42 layers.  The limit,
   5e-2, is set from readings of this script, between the sound
   decode's (2.07e-2) and decodes with a fault planted in a copy of
   the cache (``planted_decode_faults``): the position off by one reads
   1.67e-1 and an empty cache 1.41, and these (``FAULTS_SEEN``) must
   read above the limit or the run fails.  One skipped cache slot reads
   2.34e-2, inside the bf16 noise at random weights: this check cannot
   see it.  A second check can (``smoke_cache_check``): the fp32 smoke
   config of gemma2-9b (2 layers, window 8) served on the card and on
   the CPU from the same seed-0 weights, a prefill of 12 tokens and 12
   decode steps (the local ring buffer wraps), every step's logits and
   every cache tensor within ``TOL_CACHE`` relative and the slots'
   positions equal; the same serve on the card with the last prompt
   position's slot skipped must read above ``TOL_CACHE``.
   Determinism: two prefills give bitwise-equal logits.  Times of the
   kernel per layer kind beside its bound, its plain version and
   ``scaled_dot_product_attention`` with a band mask (a yardstick only,
   timed without the soft-cap on both sides: no single PyTorch call
   soft-caps), and on the global layer also with ``is_causal=True`` and
   no mask tensor (the flash backend, the fastest single call for causal
   attention; ``library_causal_ms``).

Prints a ``{"kernels": [...]}`` line (each kernel's launches in the
solve of its path, and its times; the block sweeps once for the FFMA
kernels, launches and times from the odd-width input, as ``<name>/tf32x3`` for
the main path's fp32 solve and as ``<name>/wgmma`` for the bf16 solve's
chains), the ``nvidia-smi`` name and power limit line again, and last
``{"ok": true, "device": {...}}``.  Exits 2
without a CUDA device or without ``src/repro_torch`` beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SEED = 0
M, N, K = 262144, 32768, 32            # the main path's shape and rank
N_SPECTRUM = 64                        # s_i = 100 * 0.9**i, i < 64
NOISE = 1e-6                           # entry std; ||noise||_2 ~ 7e-4 << s_31
WIDE = (8192, 131072)                  # contiguous wide input
RERUN = (16384, 4096)
K_GRAMFREE, K_GRAM, K_WIDE = 16, 8, 4  # ranks of the deflation solves
N_GRAM = 8192                          # columns of the gram path's A
TOL_DEFLATION = 2e-3                   # sigma rtol, tests/test_tsvd.py:20
LM_ARCH, LM_SEED = "gemma2-9b", 0
LM_BATCH, LM_PROMPT, LM_TOKENS = 2, 8192, 32   # prompts, tokens, decode steps
TOL_ATTN_FP32 = 1e-4                   # tests/test_kernels.py:208
ATOL_ATTN_BF16 = 1e-5                  # 10x the fp32 kernel-vs-plain errors
# decode vs prefill, from readings on an H100: sound 2.07e-2; planted
# faults: position off by one 1.67e-1, cache empty 1.41, one skipped slot
# 2.34e-2 (within noise at random weights, so not claimed)
TOL_CONSISTENCY = 5e-2
FAULTS_SEEN = ("position off by one", "cache empty")
# the fp32 smoke config of gemma2-9b served on the card and on the CPU from
# the same seed-0 weights: a prefill of CACHE_PROMPT tokens and CACHE_STEPS
# decode steps, which wrap the local layers' ring of `window` (8) slots
# one and a half times; every step's logits and every cache tensor
# compared.  Readings on an H100: sound 5.24e-7 (fp32 sums in other
# orders), the last prompt position's slot skipped 2.33e-1
CACHE_PROMPT, CACHE_STEPS = 12, 12
TOL_CACHE = 1e-4
SLAB = 16384                           # rows per chunk of the plain versions
# Limits of kernel vs plain: the same (bf16-rounded) operands summed in
# fp32 in another order.  The bf16 chain rounds its fp32 intermediate to
# bf16; where kernel and plain land on either side of a rounding
# boundary that entry moves by a whole bf16 step (2^-8 relative).
TOL = {"float32": 1e-5, "bfloat16": 1e-5}
TOL_CHAIN_BF16 = 1e-3


def gram_tol(r: int) -> float:
    """Limit of the gram kernel against its plain version for a reduction
    of length ``r``: the kernel sums each entry in one fixed sequence (no
    split of the reduction, so no atomics), which rounds to about
    sqrt(r) * 2^-24 relative, where the plain version (cuBLAS) sums in
    blocks and rounds less; 4 sqrt(r) 2^-24, and at least the 1e-5 of
    the other kernels (1.2e-4 at r = 262144)."""
    return max(1e-5, 4 * r ** 0.5 * 2.0 ** -24)
# H100 SXM data sheet: HBM3 rate, fp32 (non-tensor), tf32 and bf16 dense
# peaks
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "tfloat32": 495e12, "bfloat16": 989e12}
TPU_KERNEL = "src/repro/kernels/block_matvec.py"
REPLACES = {"block_matvec": f"{TPU_KERNEL}:81",
            "block_rmatvec": f"{TPU_KERNEL}:127",
            "block_gram_chain": f"{TPU_KERNEL}:146",
            "matvec": "src/repro/kernels/deflate_matvec.py:55",
            "deflate_rmatvec": "src/repro/kernels/deflate_matvec.py:127",
            "gram": "src/repro/kernels/gram.py:84",
            "local_attention": "src/repro/kernels/local_attn.py:104"}
TC_SOURCE = "src/repro_torch/csrc/block_matvec_tc.cu"
TF32_SOURCE = "src/repro_torch/csrc/block_matvec_tf32.cu"
ODD = (65536, 8190)                    # fp32 rows no tensor map describes
SOURCES = {"block_matvec": "src/repro_torch/csrc/block_matvec.cu",
           "block_rmatvec": "src/repro_torch/csrc/block_matvec.cu",
           "block_gram_chain": "src/repro_torch/csrc/block_matvec.cu",
           "matvec": "src/repro_torch/csrc/deflate_matvec.cu",
           "deflate_rmatvec": "src/repro_torch/csrc/deflate_matvec.cu",
           "gram": "src/repro_torch/csrc/gram.cu",
           "local_attention": "src/repro_torch/csrc/local_attn.cu"}
LIBRARY = {"matvec": "torch.mv(A, v)",
           "deflate_rmatvec": "torch.mv(A.mT, Xv - U @ SVtv) + U.mT @ Xv "
                              "(two calls)",
           "gram": "torch.mm(A.mT, A) (TF32 off)"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def pick(t_bytes: float, t_ops: float) -> tuple:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def deflation_bound(name: str, m: int, n: int, k: int = 0) -> tuple:
    """Least time on an H100 SXM for the fp32 deflation kernels: each
    input read once and each output written once over the memory rate,
    the flop over the fp32 (non-tensor) peak.  ``gram`` counts the
    symmetric schedule's m*n*(n+1) flop (each of the n(n+1)/2 distinct
    entries is a length-m dot product)."""
    if name == "matvec":
        nbytes, flop = 4 * (m * n + n + m), 2 * m * n
    elif name == "deflate_rmatvec":
        nbytes = 4 * (m * n + m * k + m + k + n + k)
        flop = 2 * m * n + 4 * m * k
    else:
        nbytes, flop = 4 * (m * n + n * n), m * n * (n + 1)
    return pick(nbytes / PEAK_BYTES * 1e3, flop / PEAK_OPS["float32"] * 1e3)


def bound(name: str, m: int, n: int, k: int, dtype: str,
          route: str = "ffma") -> tuple:
    """Least time for the function on an H100 SXM by ``route``: A and the
    skinny input read once in ``dtype``, the fp32 output written once,
    over the memory rate; 2*m*n*k flop per product over the peak for
    ``dtype`` (fp32 by FFMA; on the ``tf32x3`` route three TF32 products
    at the TF32 peak).  The chain's bound counts A once: a one-read fusion
    is possible."""
    isz = 2 if dtype == "bfloat16" else 4
    skinny_in, out, products = {"block_matvec": (n, m, 1),
                                "block_rmatvec": (m, n, 1),
                                "block_gram_chain": (n, n, 2)}[name]
    nbytes = m * n * isz + skinny_in * k * isz + out * k * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if route == "tf32x3":
        products, dtype = 3 * products, "tfloat32"
    t_ops = products * 2 * m * n * k / PEAK_OPS[dtype] * 1e3
    return pick(t_bytes, t_ops)


# ---------------------------------------------------------------------------
# plain versions in row slabs (the bf16 upcast of a whole A would need
# another 34 GB); each slab is the plain version of ref.py
# ---------------------------------------------------------------------------

def plain_matvec(torch, ref, A, Q, sd):
    return torch.cat([ref.block_matvec_ref(A[r:r + SLAB], Q, sd)
                      for r in range(0, A.shape[0], SLAB)])


def plain_rmatvec(torch, ref, A, Y, sd):
    Z = torch.zeros((A.shape[1], Y.shape[1]), dtype=torch.float32,
                    device=A.device)
    for r in range(0, A.shape[0], SLAB):
        Z += ref.block_rmatvec_ref(A[r:r + SLAB], Y[r:r + SLAB], sd)
    return Z


def plain_chain(torch, ref, A, X, sd, trans=False):
    if trans:
        return plain_matvec(torch, ref, A, plain_rmatvec(torch, ref, A, X,
                                                         sd), sd)
    return plain_rmatvec(torch, ref, A, plain_matvec(torch, ref, A, X, sd),
                         sd)


def sweep_rows(torch, ops, ref, bm, A, Q, Ym, sd) -> dict:
    """The block sweeps of ``ops`` on ``A`` (fp32, taken in ``sd``) with
    k = Q.shape[1], each against its plain version (fail beyond its
    limit), with kernel, plain, ``torch.matmul`` (a yardstick only) and
    bound times and the route that ran it; one row a sweep.  Launches
    here are comparisons: the caller reads the path's counts before."""
    m, n = A.shape
    k = Q.shape[1]
    As = A if sd == "float32" else A.to(torch.bfloat16)
    Qs, Ys = Q.to(As.dtype), Ym.to(As.dtype)
    fns = {
        "block_matvec": (
            lambda: ops.block_matvec(As, Q),
            lambda: plain_matvec(torch, ref, As, Q, sd),
            lambda: torch.matmul(As, Qs)),
        "block_rmatvec": (
            lambda: ops.block_rmatvec(As, Ym),
            lambda: plain_rmatvec(torch, ref, As, Ym, sd),
            lambda: torch.matmul(As.mT, Ys)),
        "block_gram_chain": (
            lambda: ops.block_gram_chain(As, Q),
            lambda: plain_chain(torch, ref, As, Q, sd),
            lambda: torch.linalg.multi_dot([As.mT, As, Qs])),
    }
    rows = {}
    for name, (kern, plain, lib) in fns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        e = rel_err(torch, got, want)
        tol = TOL_CHAIN_BF16 if (sd == "bfloat16" and
                                 name == "block_gram_chain") else TOL[sd]
        if not (bool(torch.isfinite(got).all()) and e <= tol):
            fail(f"{name} {sd} at {(m, n, k)}: rel err {e} > {tol}")
        row = {
            "shape": [m, n, k],
            "max_abs_err": float((got - want).abs().max()),
            "rel_err": e, "limit": tol,
            "ms": time_ms(torch, kern, 5),
            "plain_ms": time_ms(torch, plain, 2),
            "library_ms": time_ms(torch, lib, 3),
        }
        row["route"] = bm.route(As, k)
        row["bound_ms"], row["bound_by"] = bound(name, m, n, k, sd,
                                                 row["route"])
        rows[name] = row
        print(f"  {name:16s} {sd:8s} ({row['route']}) {m}x{n} k={k}: "
              f"rel err {e:.2e} "
              f"(limit {tol:.0e}), kernel {row['ms']:.2f} ms, plain "
              f"{row['plain_ms']:.2f} ms, torch.matmul "
              f"{row['library_ms']:.2f} ms, bound "
              f"{row['bound_ms']:.2f} ms ({row['bound_by']})")
        del got, want
    return rows


def rel_err(torch, got, want) -> float:
    return float(torch.linalg.norm(got - want) /
                 (torch.linalg.norm(want) + 1e-30))


def spectral_matrix(torch, m, n, seed, dev):
    """``U diag(s) V^T + NOISE * G`` on the card, built in row chunks
    from a seeded generator; returns (A, s)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    s = (100.0 * 0.9 ** torch.arange(N_SPECTRUM, dtype=torch.float64)
         ).to(torch.float32).to(dev)
    U = torch.linalg.qr(torch.randn(m, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    V = torch.linalg.qr(torch.randn(n, N_SPECTRUM, generator=g,
                                    device=dev)).Q
    A = torch.empty((m, n), dtype=torch.float32, device=dev)
    step = max(1, (1 << 28) // n)                 # 1 GiB of fp32 per chunk
    for r in range(0, m, step):
        A[r:r + step] = (U[r:r + step] * s) @ V.mT
        A[r:r + step].add_(torch.randn((min(step, m - r), n), generator=g,
                                       device=dev), alpha=NOISE)
    return A, s


def check(torch, label: str, got, want, tol: float) -> float:
    """Fail unless ``got`` is a finite fp32 tensor of ``want``'s shape
    within ``tol`` relative Frobenius error of it; return the error."""
    if got.dtype != torch.float32 or got.shape != want.shape:
        fail(f"{label}: got {got.dtype} {tuple(got.shape)}, want "
             f"{tuple(want.shape)}")
    e = rel_err(torch, got, want)
    if not (bool(torch.isfinite(got).all()) and e <= tol):
        fail(f"{label}: rel err {e} > {tol}")
    return e


def deflation_ragged(torch, ops, ref, g, dev) -> float:
    """The deflation kernels against their plain versions at ragged
    shapes, both layouts; returns the worst error as a share of its
    limit."""
    worst = 0.0
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    # k = 1030: U^T Xv summed in two column chunks of U
    for (m, n, k) in [(1000, 300, 7), (4097, 515, 1), (257, 4100, 16),
                      (40000, 96, 3), (33, 1, 2), (3000, 2051, 5),
                      (3000, 2051, 1030)]:
        A = rnd(m, n)
        v, u, c = rnd(n), rnd(m), rnd(k)
        U, V = rnd(m, k), rnd(n, k)
        cases = [("matvec", ops.matvec(A, v), ref.matvec_ref(A, v), 1e-5),
                 ("matvec[trans]", ops.matvec(A, u, trans=True),
                  ref.matvec_ref(A, u, True), 1e-5)]
        for lab, got, want in (
                ("deflate_rmatvec", ops.deflate_rmatvec(A, U, u, c),
                 ref.deflate_rmatvec_ref(A, U, u, c)),
                ("deflate_rmatvec[trans]",
                 ops.deflate_rmatvec(A, V, v, c, trans=True),
                 ref.deflate_rmatvec_ref(A, V, v, c, True))):
            cases += [(lab + ".t13", got[0], want[0], 1e-5),
                      (lab + ".utx", got[1], want[1], 1e-5)]
        for sd in ("float32", "bfloat16"):
            As = A.to(getattr(torch, sd))
            for trans in (False, True):
                want = ref.gram_ref(As, trans)
                for sym in (True, False):
                    got = ops.gram(As, symmetric=sym, trans=trans)
                    cases.append((f"gram[{sd},{'sym' if sym else 'full'}"
                                  f"{',trans' if trans else ''}]", got, want,
                                  gram_tol(n if trans else m)))
                    if not torch.equal(got, got.mT):
                        fail(f"gram {sd} {(m, n)}: B is not symmetric")
        torch.cuda.synchronize()
        for lab, got, want, tol in cases:
            e = check(torch, f"{lab} m={m} n={n} k={k}", got, want, tol)
            worst = max(worst, e / tol)
            print(f"  {lab:30s} m={m} n={n} k={k}: rel err {e:.2e} "
                  f"(limit {tol:.1e})")
    return worst


def time_kernel(torch, name, kern, plain, lib, reps, tol, bnd) -> dict:
    """Check the kernel at a path shape and time it, its plain version
    and its library yardstick (``reps`` runs each, CUDA events)."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        errs = [check(torch, name, a, b, tol) for a, b in zip(got, want)]
        e = max(errs)
        mae = max(float((a - b).abs().max()) for a, b in zip(got, want))
    else:
        e = check(torch, name, got, want, tol)
        mae = float((got - want).abs().max())
    del got, want
    row = {"max_abs_err": mae, "rel_err": e, "limit": tol,
           "ms": time_ms(torch, kern, reps),
           "plain_ms": time_ms(torch, plain, reps),
           "library_ms": time_ms(torch, lib, reps)}
    row["bound_ms"], row["bound_by"] = bnd
    print(f"  {name:16s} fp32: rel err {e:.2e} (limit {tol:.0e}), kernel "
          f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, library "
          f"{row['library_ms']:.3f} ms ({LIBRARY[name]}), bound "
          f"{row['bound_ms']:.3f} ms ({row['bound_by']})")
    return row


def deflation_solve(torch, repro_torch, ops, X, k, method, label, s,
                    table=None):
    """One deflation solve through ``repro_torch.svd``, held to the
    prescribed spectrum and to the pass accounting; returns the launch
    counts of its run."""
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = repro_torch.svd(X, k, method=method)
    counts = {n: c for n, c in ops.launches.items() if c}
    it = [int(i) for i in res.iters]
    err = float((res.S.double().cpu() / s[:k].double().cpu() - 1)
                .abs().max())
    print(f"{label}: iters per rank {it} (sum {sum(it)}), passes_over_A "
          f"{res.passes_over_A}, bytes_per_pass {res.bytes_per_pass}, "
          f"converged {res.converged}, wall_time_s {res.wall_time_s:.3f}, "
          f"launches {counts}, max sigma rel err {err:.2e} (limit "
          f"{TOL_DEFLATION:.0e}), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    if method == "gramfree":
        want = {"matvec": sum(it) + k, "deflate_rmatvec": sum(it)}
        passes = 3 * sum(it) + k
    else:
        want, passes = {"gram": k, "matvec": k}, 3 * k
    if counts != want:
        fail(f"{label}: launches {counts}, pass accounting implies {want}")
    if res.passes_over_A != passes or res.backend != "dense" \
            or res.bytes_moved is not None:
        fail(f"{label}: passes {res.passes_over_A} (want {passes}), "
             f"backend {res.backend}")
    if not (res.converged and err <= TOL_DEFLATION
            and bool(torch.isfinite(res.U).all())
            and bool(torch.isfinite(res.V).all())):
        fail(f"{label}: not converged to the prescribed sigma")
    if table is not None:           # kernel time x launches vs wall time
        kern_s = sum(table[n]["ms"] * c for n, c in counts.items()) / 1e3
        print(f"  {label}: kernels {kern_s:.3f} s of {res.wall_time_s:.3f} "
              f"s ({100 * kern_s / res.wall_time_s:.1f} %, kernel ms x "
              f"launches); the rest, {res.wall_time_s - kern_s:.3f} s, is "
              f"the per-step sync, the small products and host work")
    return counts

# ---------------------------------------------------------------------------
# phase 7: the LM serving path (gemma2-9b) and its local_attention kernel
# ---------------------------------------------------------------------------

def instances(build, name: str, log: str) -> tuple:
    """Each kernel of library ``name``: registers and spills from its
    ``nvcc -Xptxas=-v`` log, and tensor-core instructions (``HGMMA`` or
    ``HMMA``) from the SASS of the built library; (info by mangled name,
    count by mangled name).  Prints ptxas's "wgmma serialized" notes."""
    insts, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and "spill stores" in line:
            insts[fn] = {"spill": int(line.split()[4])}
        elif fn in insts and "Used" in line and "registers" in line:
            insts[fn]["regs"] = int(line.split("Used ")[1].split()[0])
        if "C7512" in line:              # wgmma serialized by ptxas
            print(f"  {line.strip()}")
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass",
         str(build.library_path(name))], capture_output=True,
        text=True, check=True).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            mma[fn] = 0
        elif fn is not None and ("HGMMA" in line or "HMMA" in line):
            mma[fn] += 1
    return insts, mma


def sweep_instances(build, name: str, log: str, tag: str, dtype: str,
                    want: tuple) -> None:
    """Each tensor-core instance of the block sweeps of library ``name``
    (``block_matvec_tc``: kernels ``matvec_tc<N>``, ``rmatvec_tc``;
    ``block_matvec_tf32``: ``matvec_tf32<N>``, ``rmatvec_tf32<N>``, ``tag``
    the suffix): registers, spills, HGMMA count; fail unless the path's
    (``want``, k = 32) have HGMMA and spill nothing."""
    import re
    insts, mma = instances(build, name, log)
    path = {}
    for mangled, info in insts.items():
        m = re.search(rf"\d(r?matvec)_{tag}(?:ILi(\d+)E)?", mangled)
        if m is None:
            continue
        label = m.group(1) + f"_{tag}" + (f"<{m.group(2)}>" if m.group(2)
                                          else "")
        n_mma = mma.get(mangled, 0)
        print(f"  {name} {label:16s} {dtype}: {info['regs']} registers, "
              f"{info['spill']} bytes spilled, {n_mma} tensor-core "
              f"instructions (HGMMA)")
        if label in want:
            path[label] = (n_mma, info["spill"])
    if sorted(path) != sorted(want) or any(
            n == 0 or sp != 0 for n, sp in path.values()):
        fail(f"{name} path instances (HGMMA, bytes spilled): {path}; want "
             f"tensor-core instructions and no spills")


def attention_instances(build, la, log: str) -> None:
    """Each ``local_attn`` instance's registers, spills and dynamic shared
    memory (``nvcc -Xptxas=-v``) and its tensor-core instructions (SASS of
    the built library); fail unless the bf16 D = 256 instance, the LM
    path's, has tensor-core instructions and spills nothing."""
    import re
    insts, mma = instances(build, "local_attn", log)
    path = None
    for mangled, info in insts.items():
        m = re.search(r"local_attn_(wgmma|ffma)I(f|13__nv_bfloat16)?Li(\d+)E",
                      mangled)
        if m is None:
            continue
        route, D = m.group(1), int(m.group(3))
        dtype = "fp32" if m.group(2) == "f" else "bf16"
        n_mma = mma.get(mangled, 0)
        print(f"  local_attn {route:5s} {dtype} D={D:3d}: {info['regs']} "
              f"registers, {info['spill']} bytes spilled, "
              f"{la.smem_bytes(route, D)} bytes of dynamic shared memory, "
              f"{n_mma} tensor-core instructions (HGMMA/HMMA)")
        if route == "wgmma" and D == 256:
            path = (n_mma, info["spill"])
    if path is None or path[0] == 0 or path[1] != 0:
        fail(f"local_attn bf16 D=256 instance (tensor-core instructions, "
             f"bytes spilled): {path}; want tensor-core instructions and no "
             f"spills")


# the planted faults of phase 2b: (library, its -D flag)
PLANTED = (("block_matvec_tc", "REPRO_TC_SUMS_ONLY"),
           ("block_matvec_tf32", "REPRO_TF32_ONLY"),
           ("block_matvec_tf32", "REPRO_TC_SUMS_ONLY"))


def build_planted(build, name: str, flag: str) -> tuple:
    """Start ``nvcc`` on ``csrc/<name>.cu`` with ``-D<flag>`` (a planted
    fault of phase 2b) beside the real build; returns (the process, the
    library it writes)."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / f"{name}-{flag.lower()}.so"
    proc = subprocess.Popen(
        [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, f"-D{flag}",
         "-o", str(out), str(build.CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


FAULT_LABELS = {"REPRO_TC_SUMS_ONLY": "the sums left in the tensor cores",
                "REPRO_TF32_ONLY": "plain TF32 (the hi hi term alone)"}


def planted_faults(torch, bm, ref, planted, sd, g, dev, inputs) -> dict:
    """The tensor-core sweeps of dtype ``sd`` (bf16: ``wgmma``; fp32:
    ``tf32x3``) and the same sweeps from each planted-fault library of
    ``planted`` ({(library, flag): path}), against the plain version on
    65536 x 32768 inputs: ``"abs"``, an |N(0, 1)| ``A`` with skinny
    operands uniform in [0, 1) (every partial sum grows, as a truncating
    accumulator likes least), and ``"signed"``, N(0, 1) ``A`` and skinny
    operands (the sums cancel, so a rounding error of each product is
    not averaged away against a growing sum).  Fail unless the real
    sweeps are within the limit on every input and every planted fault
    reads outside it on at least one.  Returns the errors by input."""
    import ctypes
    m = 65536
    dt = getattr(torch, sd)
    tol = TOL[sd]
    errs = {}
    for kind in inputs:
        A = torch.empty((m, N), dtype=dt, device=dev)
        for r in range(0, m, SLAB):
            x = torch.randn((SLAB, N), generator=g, device=dev)
            A[r:r + SLAB] = x.abs_() if kind == "abs" else x
            del x
        draw = torch.rand if kind == "abs" else torch.randn
        Q = draw((N, K), generator=g, device=dev).to(dt)
        Y = draw((m, K), generator=g, device=dev).to(dt)
        which = bm.route(A, K)
        want = {"block_matvec": plain_matvec(torch, ref, A, Q, sd),
                "block_rmatvec": plain_rmatvec(torch, ref, A, Y, sd)}

        def run():
            return {"block_matvec": bm.block_matvec_cuda(A, Q, which),
                    "block_rmatvec": bm.block_rmatvec_cuda(A, Y, which)}
        runs = {"real": run()}
        library = bm.build.library
        for (lib, flag), path in planted.items():
            fault = ctypes.CDLL(str(path))
            bm.build.library = lambda name: (fault if name == lib
                                             else library(name))
            try:
                runs[flag] = run()
            finally:
                bm.build.library = library
        torch.cuda.synchronize()
        for name in want:
            e = errs[(kind, name)] = {
                key: rel_err(torch, out[name], want[name])
                for key, out in runs.items()}
            print(f"  {name:16s} {sd} ({which}) {m}x{N} k={K}, {kind} "
                  f"input: rel err {e['real']:.2e}" + "".join(
                      f"; with {FAULT_LABELS[flag]} {e[flag]:.2e}"
                      for flag in runs if flag != "real")
                  + f" (limit {tol:.0e})")
            if not e["real"] <= tol:
                fail(f"{name} {sd} on the {kind} input: rel err "
                     f"{e['real']} > {tol}")
        del A, Q, Y, want, runs
        torch.cuda.empty_cache()
    for _, flag in planted:
        for name in ("block_matvec", "block_rmatvec"):
            if not any(errs[(kind, name)][flag] > tol for kind in inputs):
                fail(f"{name} {sd} with {FAULT_LABELS[flag]} reads within "
                     f"the limit {tol} on every input: the check cannot "
                     f"see it")
    return errs


def attn_share(got, want, dtype: str) -> float:
    """The worst |kernel - plain| of ``local_attention`` as a share of its
    limit, element by element: fp32 1e-4 (the JAX package's,
    ``tests/test_kernels.py:208``); bf16 the kernel's one rounding of
    its fp32 output to bf16, at most half a bf16 step, 2^-8 |o|, of
    that element, plus ``ATOL_ATTN_BF16`` for fp32 sums in another
    order.  Each element is held to its own size: most rows average
    thousands of keys and are small, so a limit from the largest output
    would pass a wrong key tile there."""
    err = (got.float() - want).abs()
    if dtype == "float32":
        return float(err.max()) / TOL_ATTN_FP32
    return float((err / (2.0 ** -8 * want.abs() + ATOL_ATTN_BF16)).max())


def attn_inputs(torch, g, dev, B, H, Hkv, S, D, dtype):
    """q (B, H, S, D), k, v (B, Hkv, S, D): views of (B, S, H, D) memory,
    as the model passes its projections."""
    return [torch.randn((B, S, h, D), generator=g, device=dev)
            .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv)]


def plain_attention(ref, q, k, v, window, softcap, each=None):
    """The plain version two query heads (one K/V head group slice) at a
    time, so its (S, S) scores stay a few GB; ``each(h0, out)`` sees every
    chunk."""
    H, Hkv = q.shape[1], k.shape[1]
    group = H // Hkv
    step = max(2, group)
    for h0 in range(0, H, step):
        out = ref.local_attention_ref(
            q[:, h0:h0 + step], k[:, h0 // group:(h0 + step - 1) // group + 1],
            v[:, h0 // group:(h0 + step - 1) // group + 1], window=window,
            softcap=softcap)
        if each is not None:
            each(h0, out)
        del out


def attn_readings(torch, ref, outs, q, k, v, window, softcap) -> tuple:
    """Each output of ``outs`` against the plain version, chunked: (max
    |out - plain| of the first, and each one's worst share of the
    bf16 per-element limit)."""
    mae, shares = 0.0, [0.0] * len(outs)

    def each(h0, want):
        nonlocal mae
        for i, out in enumerate(outs):
            got = out[:, h0:h0 + want.shape[1]]
            if i == 0:
                mae = max(mae, float((got.float() - want).abs().max()))
            shares[i] = max(shares[i], attn_share(got, want, "bfloat16"))
    plain_attention(ref, q, k, v, window, softcap, each)
    return mae, shares


def attn_bound(B, H, Hkv, S, D, window) -> tuple:
    """Least time on an H100 SXM: 4 D flop per live (query, key) pair over
    the bf16 tensor-core peak, against q, k, v read once and o written
    once (bf16) over the memory rate."""
    w = min(window, S)
    pairs = B * H * (w * (w + 1) // 2 + (S - w) * w)
    nbytes = 2 * B * S * D * (2 * H + 2 * Hkv)
    return pick(nbytes / PEAK_BYTES * 1e3,
                pairs * 4 * D / PEAK_OPS["bfloat16"] * 1e3)


def attention_ragged(torch, ops, ref, la, g, dev) -> float:
    """``local_attention`` against its plain version at ragged shapes,
    fp32 and bf16, every head dim of the template; the worst error as a
    share of its limit."""
    worst = 0.0
    for D in la.HEAD_DIMS:
        for (B, H, Hkv, S, window, softcap) in [(2, 4, 2, 333, 64, 50.0),
                                                (1, 6, 3, 130, 200, None),
                                                (3, 2, 1, 65, 1, 30.0),
                                                (1, 8, 1, 129, 1000, 50.0)]:
            for sd in ("float32", "bfloat16"):
                q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D,
                                      getattr(torch, sd))
                got = ops.local_attention(q, k, v, window=window,
                                          softcap=softcap)
                want = ref.local_attention_ref(q, k, v, window=window,
                                               softcap=softcap)
                torch.cuda.synchronize()
                e = float((got.float() - want).abs().max())
                share = attn_share(got, want, sd)
                label = (f"local_attention {sd} ({la.route(q.dtype, D)}) B={B} "
                         f"H={H} Hkv={Hkv} S={S} D={D} window={window} "
                         f"softcap={softcap}")
                print(f"  {label}: max abs err {e:.2e}, {share:.2f} of the "
                      f"per-element limit")
                if not (got.dtype == q.dtype and got.shape == q.shape
                        and bool(torch.isfinite(got).all()) and share <= 1):
                    fail(f"{label}: {share} of the per-element limit")
                worst = max(worst, share)
    return worst


def attention_path_table(torch, ops, ref, la, g, dev, cfg, S) -> dict:
    """The kernel at the path's shapes, one row per layer kind: checked
    against the plain version, then timed beside its bound, the plain
    version and ``scaled_dot_product_attention`` (band mask; both
    without the soft-cap, since no single PyTorch call soft-caps), and on
    the global layer also ``is_causal=True`` with no mask tensor
    (``library_causal_ms``: the flash backend; no call takes a window)."""
    import torch.nn.functional as F
    B, H, Hkv, D = LM_BATCH, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    q, k, v = attn_inputs(torch, g, dev, B, H, Hkv, S, D, torch.bfloat16)
    rows = {}
    for kind, window in (("local", cfg.window), ("attn", S)):
        cap = cfg.attn_softcap
        got = ops.local_attention(q, k, v, window=window, softcap=cap)
        # a planted fault the limit must reject: one key tile short
        short_w = max(1, window - la.BK)
        short = ops.local_attention(q, k, v, window=short_w, softcap=cap)
        torch.cuda.synchronize()
        mae, (share, fault) = attn_readings(torch, ref, [got, short], q, k, v,
                                            window, cap)
        label = (f"local_attention bf16 {kind} B={B} H={H} Hkv={Hkv} S={S} "
                 f"D={D} window={window} softcap={cap}")
        if not (bool(torch.isfinite(got).all()) and share <= 1):
            fail(f"{label}: {share} of the per-element limit")
        if fault <= 1:
            fail(f"{label}: window {short_w} reads {fault} of the per-element "
                 f"limit; the check cannot see a missing key tile")
        del got, short
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                                 > pos[:, None] - window)
        kr = k.repeat_interleave(H // Hkv, dim=1).contiguous()
        vr = v.repeat_interleave(H // Hkv, dim=1).contiguous()
        qc = q.contiguous()
        row = {"max_abs_err": mae, "share_of_limit": share,
               "tile_short_share": fault,
               "ms": time_ms(torch, lambda: ops.local_attention(
                   q, k, v, window=window, softcap=cap), 10),
               "plain_ms": time_ms(torch, lambda: plain_attention(
                   ref, q, k, v, window, cap), 1),
               "nocap_ms": time_ms(torch, lambda: ops.local_attention(
                   q, k, v, window=window, softcap=None), 10),
               "library_ms": time_ms(
                   torch, lambda: F.scaled_dot_product_attention(
                       qc, kr, vr, attn_mask=band), 3)}
        if kind == "attn":
            row["library_causal_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qc, kr, vr, is_causal=True), 10)
        row["bound_ms"], row["bound_by"] = attn_bound(B, H, Hkv, S, D, window)
        rows[kind] = row
        del kr, vr, qc, band
        print(f"  {label}: max abs err {mae:.2e}, {share:.2f} of the "
              f"per-element limit (window {short_w}, a key tile short: "
              f"{fault:.1f} of it), kernel "
              f"{row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, bound "
              f"{row['bound_ms']:.3f} ms ({row['bound_by']}); without the "
              f"soft-cap: kernel {row['nocap_ms']:.3f} ms, "
              f"scaled_dot_product_attention {row['library_ms']:.3f} ms "
              f"(band mask)" + (
                  f", {row['library_causal_ms']:.3f} ms (is_causal=True)"
                  if "library_causal_ms" in row else ""))
    torch.cuda.empty_cache()
    return rows


def profile_window(torch, fn) -> tuple:
    """``fn()`` under ``torch.profiler``: (its result, wall seconds under
    the profiler, device-busy seconds, device activities, busy seconds
    by activity name).  Busy time is the sum of the device activities'
    spans (one stream, so they do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    n = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us() / 1e6
    return out, wall, sum(by_name.values()), n, by_name


def planted_decode_faults(torch, T, model, cache, nxt, S) -> dict:
    """The logits of the decode at position ``S`` with a fault planted in
    a copy of ``cache``: the readings that set ``TOL_CONSISTENCY``."""
    out = {}
    for name in ("position off by one", "the last prompt position's slot "
                 "skipped", "local window one key short", "cache empty"):
        bad = [{n: t.clone() for n, t in c.items()} for c in cache]
        pos = S
        for c, kind in zip(bad, model.cfg.blocks):
            Lc = c["pos"].shape[0]
            if name == "position off by one":
                pos = S + 1
            elif name.startswith("the last"):
                c["pos"][(S - 1) % Lc] = -1
            elif name.startswith("local") and kind == "local":
                c["pos"][(S - model.cfg.window + 1) % Lc] = -1
            elif name == "cache empty":
                c["pos"].fill_(-1)
        out[name] = T.decode_step(model, bad, nxt, pos)[0]
        del bad
    return out


def smoke_serve(torch, T, serve, model, dev, tokens, plant=False) -> tuple:
    """The fp32 smoke model on ``dev``: a prefill of the prompt
    ``tokens[:, :CACHE_PROMPT]``, then ``CACHE_STEPS`` decode steps fed
    the next columns of ``tokens``; with ``plant``, the slot of the last
    prompt position is marked empty in every layer's cache after the
    prefill (a skipped cache slot).  Returns (each step's logits on the
    CPU, the final cache on the CPU)."""
    logits, cache, _ = serve.serve_prefill(
        model, tokens[:, :CACHE_PROMPT].to(dev), CACHE_PROMPT + CACHE_STEPS)
    if plant:
        for c in cache:
            c["pos"][(CACHE_PROMPT - 1) % c["pos"].shape[0]] = -1
    out = [logits.cpu()]
    for i in range(CACHE_STEPS):
        pos = CACHE_PROMPT + i
        logits, cache = T.decode_step(model, cache,
                                      tokens[:, pos:pos + 1].to(dev), pos)
        out.append(logits.cpu())
    return out, [{n: t.cpu() for n, t in c.items()} for c in cache]


def cache_reading(torch, got, want) -> tuple:
    """The worst relative Frobenius error over every step's logits and
    every float cache tensor of ``got`` against ``want``, and whether
    their integer cache tensors (the slots' positions) are equal."""
    (lg, cg), (lw, cw) = got, want
    errs = [rel_err(torch, a, b) for a, b in zip(lg, lw)]
    same = True
    for a, b in zip(cg, cw):
        for name in b:
            if b[name].is_floating_point():
                errs.append(rel_err(torch, a[name], b[name]))
            else:
                same = same and torch.equal(a[name], b[name])
    return max(errs), same


def smoke_cache_check(torch, T, serve, dev) -> dict:
    """The fp32 smoke config of gemma2-9b served on the card and on the
    CPU with the same seed-0 weights (drawn on the CPU, copied to the
    card); fail unless every step's logits and every cache tensor agree
    within ``TOL_CACHE`` and the slots hold the same positions, and
    unless the card's serve with a skipped cache slot reads above
    ``TOL_CACHE``.  Returns the readings."""
    import copy
    cpu = torch.device("cpu")
    model = serve.build(LM_ARCH, smoke=True, device=cpu, seed=LM_SEED)
    cfg = model.cfg
    prompt = serve.make_prompt(cfg, LM_BATCH, CACHE_PROMPT, seed=LM_SEED,
                               device=cpu)
    # the decode feeds the CPU's greedy tokens on both devices
    logits, cache, _ = serve.serve_prefill(model, prompt,
                                           CACHE_PROMPT + CACHE_STEPS)
    fed, _, _ = serve.serve_decode(model, cache, logits, CACHE_PROMPT,
                                   CACHE_STEPS)
    tokens = torch.cat([prompt, fed], dim=1)
    want = smoke_serve(torch, T, serve, model, cpu, tokens)
    card = copy.deepcopy(model).to(dev)
    sound, same = cache_reading(
        torch, smoke_serve(torch, T, serve, card, dev, tokens), want)
    fault, _ = cache_reading(
        torch, smoke_serve(torch, T, serve, card, dev, tokens, plant=True),
        want)
    print(f"{cfg.name} fp32 (window {cfg.window}), card vs CPU, prefill "
          f"{CACHE_PROMPT} tokens + {CACHE_STEPS} decode steps: worst rel "
          f"err over the logits and cache tensors {sound:.2e} (limit "
          f"{TOL_CACHE:.0e}), slot positions equal: {same}; with the last "
          f"prompt position's slot skipped {fault:.2e}")
    if not (same and sound <= TOL_CACHE):
        fail(f"smoke serve card vs CPU: rel err {sound} (limit {TOL_CACHE}), "
             f"positions equal {same}")
    if not fault > TOL_CACHE:
        fail(f"a skipped cache slot reads {fault}, within the limit "
             f"{TOL_CACHE}: the check cannot see it")
    return {"sound": sound, "skipped_slot": fault}


def lm_serving(torch, ops, ref, la, g, dev) -> tuple:
    """Phase 7; returns (the kernel's JSON row, its launches per prefill)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    smoke_cache_check(torch, T, serve, dev)
    worst = attention_ragged(torch, ops, ref, la, g, dev)
    print(f"local_attention at ragged shapes: all within limits (worst "
          f"{worst:.2f} of limit)")
    cfg = get_config(LM_ARCH)
    S, steps = LM_PROMPT, LM_TOKENS
    rows = attention_path_table(torch, ops, ref, la, g, dev, cfg, S)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = serve.build(LM_ARCH, device=dev, seed=LM_SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {cfg.num_layers} layers ({cfg.blocks.count('local')} "
          f"local, window {cfg.window}), {n_params / 1e9:.3f} B parameters "
          f"({w_bytes / 1e9:.2f} GB {cfg.dtype}) drawn on the card from seed "
          f"{LM_SEED} in {time.perf_counter() - t0:.1f} s")
    prompt = serve.make_prompt(cfg, LM_BATCH, S, seed=LM_SEED, device=dev)

    ops.reset_launches()
    logits, cache, t_pre = serve.serve_prefill(model, prompt, S + steps)
    pre_counts = {n: c for n, c in ops.launches.items() if c}
    ops.reset_launches()
    tokens, last, t_dec = serve.serve_decode(model, cache, logits, S, steps)
    dec_counts = {n: c for n, c in ops.launches.items() if c}
    peak = torch.cuda.max_memory_allocated()
    cache_bytes = sum(c[n].numel() * c[n].element_size() for c in cache
                      for n in ("k", "v"))
    print(f"serve {cfg.name} batch {LM_BATCH}: prefill {S} tokens "
          f"{t_pre:.3f} s ({LM_BATCH * S / t_pre:.0f} tokens/s), "
          f"local_attention launches {pre_counts}; {steps} greedy decode "
          f"steps {t_dec:.3f} s ({steps * LM_BATCH / t_dec:.1f} tokens/s, "
          f"{1e3 * t_dec / steps:.2f} ms a step; weight-read bound "
          f"{w_bytes / PEAK_BYTES * 1e3:.2f} ms), launches {dec_counts}; KV "
          f"caches {cache_bytes / 1e9:.2f} GB; peak device memory "
          f"{peak / 2**30:.1f} GiB")
    print(f"  seq0: {tokens[0, :16].tolist()}")
    if pre_counts != {"local_attention": cfg.num_layers}:
        fail(f"prefill launches {pre_counts}, want one local_attention a "
             f"layer ({cfg.num_layers})")
    if dec_counts:
        fail(f"decode launched kernels {dec_counts}; it runs the plain "
             f"cache path")
    if not (tokens.shape == (LM_BATCH, steps)
            and int(tokens.min()) >= 0 and int(tokens.max()) < cfg.vocab_size
            and bool(torch.isfinite(logits).all())
            and bool(torch.isfinite(last).all())
            and logits.shape == (LM_BATCH, cfg.vocab_size)):
        fail("serve: non-finite logits or tokens out of range")
    del cache, last

    # determinism, then decode at position S against a prefill over S + 1
    again, cache, t_again = serve.serve_prefill(model, prompt, S + 3)
    same = torch.equal(again, logits)
    print(f"rerun prefill: {t_again:.3f} s, logits bitwise equal: {same}")
    if not same:
        fail("two prefills of the same prompt differ")
    nxt = torch.argmax(again, dim=-1)[:, None]
    faulty = planted_decode_faults(torch, T, model, cache, nxt, S)
    dec, _ = T.decode_step(model, cache, nxt, S)
    # where the device time goes: two more decode steps, then the prefill
    # over S + 1 tokens that the decode is checked against
    _, w2, busy2, n2, _ = profile_window(torch, lambda: [
        T.decode_step(model, cache, nxt, S + i) for i in (1, 2)])
    del cache
    full, w1, busy1, n1, names = profile_window(
        torch, lambda: T.prefill(model, torch.cat([prompt, nxt], dim=1),
                                 None)[0])
    if n1 and n2:
        attn = sum(t for name, t in names.items() if "local_attn" in name)
        step = t_dec / steps
        print(f"profile of the prefill over {S + 1} tokens: {w1:.3f} s under "
              f"the profiler, device busy {busy1:.3f} s ({100 * busy1 / w1:.1f}"
              f" %), {n1} device activities; local_attention kernels "
              f"{attn:.3f} s ({100 * attn / busy1:.1f} % of busy); the rest "
              f"by time: " + ", ".join(
                  f"{name[:40]} {t:.3f} s" for name, t in sorted(
                      ((n, t) for n, t in names.items()
                       if "local_attn" not in n), key=lambda x: -x[1])[:4]))
        print(f"profile of two decode steps: device busy {1e3 * busy2 / 2:.2f}"
              f" ms a step against {1e3 * step:.2f} ms a step unprofiled "
              f"(device idle share {100 * (1 - busy2 / 2 / step):.1f} %), "
              f"{n2 / 2:.0f} device activities a step")
    else:
        print("profiles: not measured (the profiler saw no device activity)")
    e = rel_err(torch, dec, full)
    print(f"decode at position {S} vs prefill over {S + 1} tokens: rel err "
          f"{e:.2e} (limit {TOL_CONSISTENCY:.0e}), max abs "
          f"{float((dec - full).abs().max()):.3e} of max |logit| "
          f"{float(full.abs().max()):.2f}")
    readings = {name: rel_err(torch, f, full) for name, f in faulty.items()}
    for name, r in readings.items():
        print(f"  planted decode fault, {name}: rel err {r:.2e}")
    if not (bool(torch.isfinite(dec).all()) and e <= TOL_CONSISTENCY):
        fail(f"decode vs prefill logits: rel err {e} > {TOL_CONSISTENCY}")
    unseen = [n for n in FAULTS_SEEN if readings[n] <= TOL_CONSISTENCY]
    if unseen:
        fail(f"planted decode faults {unseen} read within the limit "
             f"{TOL_CONSISTENCY}: the check cannot see them")
    del model, full, dec, faulty
    torch.cuda.empty_cache()

    n_local = cfg.blocks.count("local")
    n_global = cfg.num_layers - n_local
    mean = lambda key: (n_local * rows["local"][key]
                        + n_global * rows["attn"][key]) / cfg.num_layers
    row = {key: mean(key) for key in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "nocap_ms")}
    row["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    row["bound_by"] = rows["local"]["bound_by"]
    row["library_causal_ms"] = rows["attn"]["library_causal_ms"]
    print(json.dumps({"local_attention_by_layer_kind": rows}))
    return row, pre_counts["local_attention"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    import importlib

    import repro_torch
    from repro_torch.kernels import build, local_attn, ops, ref
    bm = importlib.import_module("repro_torch.kernels.block_matvec")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)                           # nvidia-smi name, power.limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print("TF32 is off for matmul and cuDNN: the plain fp32 versions and "
          "the library yardsticks are full fp32 (the kernels' fp32 is FFMA or "
          "3xTF32, never plain TF32)")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    planted_builds = {key: build_planted(build, *key) for key in PLANTED}
    logs = build.build_all()
    planted = {}
    for (name, flag), (proc, path) in planted_builds.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            fail(f"nvcc {name}.cu -D{flag} failed:\n{out}")
        planted[(name, flag)] = path
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'up to date'}; and the planted faults of "
          f"phase 2b: " + ", ".join(f"{name} -D{flag}"
                                    for name, flag in PLANTED) + ")")
    for name, log in logs.items():       # nvcc -Xptxas=-v, per kernel
        regs = [int(l.split("Used ")[1].split()[0])
                for l in log.splitlines() if "registers" in l]
        spills = [int(l.split()[4]) for l in log.splitlines()
                  if "spill stores" in l]
        print(f"  {name}: {len(regs)} kernels, registers <= {max(regs)}, "
              f"{sum(b > 0 for b in spills)} with spills (<= "
              f"{max(spills)} bytes stored)")
    attention_instances(build, local_attn, logs.get("local_attn") or (
        build.BUILD_DIR / "local_attn.log").read_text())
    for name, tag, sd, want in (
            ("block_matvec_tc", "tc", "bf16", ("matvec_tc<32>", "rmatvec_tc")),
            ("block_matvec_tf32", "tf32", "fp32",
             ("matvec_tf32<32>", "rmatvec_tf32<32>"))):
        sweep_instances(build, name, logs.get(name) or (
            build.BUILD_DIR / f"{name}.log").read_text(), tag, sd, want)

    # -- 2a. kernels vs plain at ragged shapes -----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    # n in {300, 515, 4100, 2052} has bf16 rows a tensor map cannot
    # describe (n % 8 != 0): bf16 there stays FFMA; fp32 rows only where
    # n % 4 != 0 (515).  (5000, 1000, 7) and (3001, 2052, 45) are ragged in
    # m (not whole 256-row blocks), n (not whole stages: 64 bf16, 32 fp32)
    # and k (not a multiple of 8) on the tensor-core routes
    shapes = [(1000, 300, 7), (4097, 515, 40), (2048, 1024, 130),
              (3000, 200, 1), (257, 4100, 32), (40000, 96, 33),
              (5000, 1000, 7), (3001, 2052, 45)]
    worst = 0.0
    for (m, n, k) in shapes:
        A = torch.randn((m, n), generator=g, device=dev)
        Qn = torch.randn((n, k), generator=g, device=dev)
        Ym = torch.randn((m, k), generator=g, device=dev)
        for sd in ("float32", "bfloat16"):
            As = A.to(getattr(torch, sd))
            route = bm.route(As, k)
            ops.reset_launches()
            cases = [
                ("block_matvec", ops.block_matvec(As, Qn),
                 ref.block_matvec_ref(As, Qn, sd), TOL[sd]),
                ("block_rmatvec", ops.block_rmatvec(As, Ym),
                 ref.block_rmatvec_ref(As, Ym, sd), TOL[sd]),
                ("block_gram_chain", ops.block_gram_chain(As, Qn),
                 ref.block_gram_chain_ref(As, Qn, sd),
                 TOL_CHAIN_BF16 if sd == "bfloat16" else TOL[sd]),
                ("block_gram_chain[trans]",
                 ops.block_gram_chain(As, Ym, trans=True),
                 ref.block_gram_chain_ref(As, Ym, sd, trans=True),
                 TOL_CHAIN_BF16 if sd == "bfloat16" else TOL[sd]),
            ]
            torch.cuda.synchronize()
            ran = {n_: c for n_, c in ops.route_launches.items() if c}
            if ran != {f"block_matvec/{route}": 3,
                       f"block_rmatvec/{route}": 3}:
                fail(f"{sd} {(m, n, k)}: route {route}, launches {ran}")
            for name, got, want, tol in cases:
                if got.dtype != torch.float32 or got.shape != want.shape:
                    fail(f"{name} {sd} {(m, n, k)}: got {got.dtype} "
                         f"{tuple(got.shape)}")
                e = rel_err(torch, got, want)
                worst = max(worst, e / tol)
                print(f"  {name:24s} {sd:8s} ({route}) m={m} n={n} k={k}: "
                      f"rel err {e:.2e} (limit {tol:.0e})")
                if not e <= tol:
                    fail(f"{name} {sd} {(m, n, k)}: rel err {e} > {tol}")
    print(f"ragged shapes: all within limits (worst {worst:.2f} of limit)")
    worst = deflation_ragged(torch, ops, ref, g, dev)
    print(f"deflation kernels at ragged shapes: all within limits (worst "
          f"{worst:.2f} of limit)")

    # -- 2b/3. the main path's A ----------------------------------------
    t0 = time.perf_counter()
    A, s = spectral_matrix(torch, M, N, SEED, dev)
    torch.cuda.synchronize()
    print(f"A {M}x{N} fp32 ({A.numel() * 4 / 2**30:.0f} GiB) built on the "
          f"card in {time.perf_counter() - t0:.1f} s")

    # -- 2b. kernels at the main path's shape --------------------------------
    Q = torch.linalg.qr(torch.randn((N, K), generator=g, device=dev)).Q
    Ym = torch.randn((M, K), generator=g, device=dev)
    table = {(name, sd): row for sd in ("float32", "bfloat16")
             for name, row in sweep_rows(torch, ops, ref, bm, A, Q, Ym,
                                         sd).items()}
    del Q, Ym
    torch.cuda.empty_cache()
    for sd, lib, inputs in (("bfloat16", "block_matvec_tc", ("abs",)),
                            ("float32", "block_matvec_tf32",
                             ("abs", "signed"))):
        planted_faults(torch, bm, ref, {
            key: path for key, path in planted.items() if key[0] == lib},
            sd, g, dev, inputs)

    # -- 4. the gram-free kernels at the gram-free path's shape -------------
    v = torch.randn(N, generator=g, device=dev)
    Xv = torch.randn(M, generator=g, device=dev)
    Ud = torch.randn((M, K_GRAMFREE), generator=g, device=dev)
    c = torch.randn(K_GRAMFREE, generator=g, device=dev)
    dtable = {
        "matvec": time_kernel(
            torch, "matvec", lambda: ops.matvec(A, v),
            lambda: ref.matvec_ref(A, v), lambda: torch.mv(A, v), 5,
            TOL["float32"], deflation_bound("matvec", M, N)),
        "deflate_rmatvec": time_kernel(
            torch, "deflate_rmatvec",
            lambda: ops.deflate_rmatvec(A, Ud, Xv, c),
            lambda: ref.deflate_rmatvec_ref(A, Ud, Xv, c),
            lambda: (torch.mv(A.mT, Xv - Ud @ c), Ud.mT @ Xv), 5,
            TOL["float32"],
            deflation_bound("deflate_rmatvec", M, N, K_GRAMFREE)),
    }
    del v, Xv, Ud, c

    # -- 3. the main path (block) -----------------------------------------
    def solve(X, label, expect_trans=False, rtol=1e-4, route="tf32x3",
              **kw):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = repro_torch.svd(X, K, **kw)
        counts = {n: c for n, c in ops.launches.items() if c}
        routes = {n: c for n, c in ops.route_launches.items() if c}
        it = int(res.iters[0])
        err = float((res.S.double().cpu() / s[:K].double().cpu() - 1)
                    .abs().max())
        print(f"{label}: iters {it}, passes_over_A {res.passes_over_A}, "
              f"bytes_per_pass {res.bytes_per_pass}, bytes_moved "
              f"{res.bytes_moved}, converged {res.converged}, wall_time_s "
              f"{res.wall_time_s:.3f}, launches {counts} (by route "
              f"{routes}), max sigma rel "
              f"err {err:.2e} (limit {rtol:.0e}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        want = {"block_gram_chain": it,
                "block_matvec": it + (0 if expect_trans else 1),
                "block_rmatvec": it + (1 if expect_trans else 0)}
        if counts != want:
            fail(f"{label}: launches {counts}, pass accounting implies "
                 f"{want}")
        # the chains run on `route`; the extraction reads the fp32 A
        want_routes = {f"{n}/{route}": it
                       for n in ("block_matvec", "block_rmatvec")}
        last = (f"{'block_rmatvec' if expect_trans else 'block_matvec'}/"
                f"{bm.route(X, K)}")
        want_routes[last] = want_routes.get(last, 0) + 1
        if routes != want_routes:
            fail(f"{label}: launches by route {routes}, want {want_routes}")
        if res.passes_over_A != 2 * it + 1 or res.backend != "dense":
            fail(f"{label}: passes {res.passes_over_A} for {it} iters")
        if not (res.converged and err <= rtol
                and bool(torch.isfinite(res.U).all())
                and bool(torch.isfinite(res.V).all())):
            fail(f"{label}: not converged to the prescribed sigma")
        return res, counts, routes

    def profile_solve(label, **kw):
        """Where a solve's device time goes (another solve, profiled)."""
        res, wall, busy, n_act, names = profile_window(
            torch, lambda: repro_torch.svd(A, K, **kw))
        if not n_act:
            print(f"profile of the {label} solve: not measured (the profiler "
                  f"saw no device activity)")
            return
        keys = (("matvec_tf32", "::matvec_tf32"),
                ("rmatvec_tf32", "::rmatvec_tf32"),
                ("matvec_tc", "::matvec_tc"), ("rmatvec_tc", "::rmatvec_tc"),
                ("split_transpose", "split_transpose"),
                ("slab sum", "sum_slabs"))
        sweeps = {lab: sum(t for n_, t in names.items() if key in n_)
                  for lab, key in keys}
        rest = sorted(((n_, t) for n_, t in names.items() if not any(
            key in n_ for _, key in keys)), key=lambda x: -x[1])
        print(f"profile of the {label} solve ({int(res.iters[0])} iters): "
              f"{wall:.3f} s under the profiler, device busy {busy:.3f} s "
              f"({100 * busy / wall:.1f} %, idle {100 * (1 - busy / wall):.1f}"
              f" %), {n_act} device activities; " + ", ".join(
                  f"{lab} {t:.4f} s" for lab, t in sweeps.items() if t)
              + "; the rest by time: " + ", ".join(
                  f"{n_[:48]} {t:.4f} s" for n_, t in rest[:6]))

    _, main_counts, main_routes = solve(A, f"main path svd(A, {K}) fp32")
    profile_solve("fp32")
    bf16_kw = {"sweep_dtype": "bfloat16", "eps": 1e-4}
    _, bf16_counts, bf16_routes = solve(A, f"svd(A, {K}) bf16 sweeps",
                                        rtol=1e-2, route="wgmma", **bf16_kw)
    profile_solve("bf16", **bf16_kw)

    # -- 5. the deflation paths ------------------------------------------
    counts = deflation_solve(
        torch, repro_torch, ops, A, K_GRAMFREE, "gramfree",
        f"gram-free path svd(A, {K_GRAMFREE}, method='gramfree') "
        f"{M}x{N}", s, table=dtable)
    path_counts = dict(counts)
    del A
    torch.cuda.empty_cache()

    Ag, _ = spectral_matrix(torch, M, N_GRAM, SEED + 4, dev)
    torch.cuda.synchronize()
    dtable["gram"] = time_kernel(
        torch, "gram", lambda: ops.gram(Ag), lambda: ref.gram_ref(Ag),
        lambda: torch.mm(Ag.mT, Ag), 2, gram_tol(M),
        deflation_bound("gram", M, N_GRAM))
    counts = deflation_solve(
        torch, repro_torch, ops, Ag, K_GRAM, "gram",
        f"gram path svd(A, {K_GRAM}, method='gram') {M}x{N_GRAM}", s,
        table=dtable)
    path_counts["gram"] = counts["gram"]
    del Ag
    torch.cuda.empty_cache()

    # rows of 4 * 8190 bytes: no tensor map, the FFMA route end to end
    Ao, _ = spectral_matrix(torch, *ODD, SEED + 5, dev)
    _, odd_counts, _ = solve(Ao, f"odd width {ODD[0]}x{ODD[1]} svd(A, {K}) "
                             f"fp32", route="ffma")
    # the FFMA sweeps on the operands of their path, after its counts
    go = torch.Generator(device=dev).manual_seed(SEED + 6)
    Qo = torch.linalg.qr(torch.randn((ODD[1], K), generator=go,
                                     device=dev)).Q
    Yo = torch.randn((ODD[0], K), generator=go, device=dev)
    for name, row in sweep_rows(torch, ops, ref, bm, Ao, Qo, Yo,
                                "float32").items():
        if row["route"] != "ffma":
            fail(f"{name} at {ODD}: route {row['route']}, not ffma")
        table[(name, "ffma")] = row
    del Ao, Qo, Yo
    Aw, _ = spectral_matrix(torch, *WIDE, SEED + 2, dev)
    solve(Aw, f"wide {WIDE[0]}x{WIDE[1]} svd(A, {K}) fp32",
          expect_trans=True)
    for method in ("gramfree", "gram"):
        deflation_solve(torch, repro_torch, ops, Aw, K_WIDE, method,
                        f"wide {WIDE[0]}x{WIDE[1]} svd(A, {K_WIDE}, "
                        f"method={method!r})", s)
    del Aw

    # -- 6. determinism --------------------------------------------------
    Ar, _ = spectral_matrix(torch, *RERUN, SEED + 3, dev)
    for kw in ({}, {"method": "gramfree"}, bf16_kw):
        k = K_GRAMFREE if "method" in kw else K
        ops.reset_launches()
        r1, r2 = repro_torch.svd(Ar, k, **kw), repro_torch.svd(Ar, k, **kw)
        routes = sorted({n_.split("/")[1]
                         for n_, c in ops.route_launches.items() if c})
        same = all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
        print(f"rerun {RERUN[0]}x{RERUN[1]} svd(A, {k}"
              + "".join(f", {key}={val!r}" for key, val in kw.items())
              + f"): routes {routes}, U, S, V bitwise equal: {same}")
        if "method" not in kw and "tf32x3" not in routes:
            fail(f"the block rerun pair ({kw}) ran routes {routes}, not the "
                 f"fp32 operand's tf32x3")
        if not same:
            fail(f"two solves with the same seed differ ({kw})")

    del Ar
    torch.cuda.empty_cache()

    # -- 7. the LM serving path ------------------------------------------
    dtable["local_attention"], path_counts["local_attention"] = lm_serving(
        torch, ops, ref, local_attn, g, dev)

    sweeps = ("block_matvec", "block_rmatvec", "block_gram_chain")
    # the FFMA sweeps (launches: the odd-width solve, their path)
    rows = {name: table[(name, "ffma")] for name in sweeps}
    for name in sweeps:
        path_counts[name] = odd_counts[name]
    rows.update(dtable)
    # the fp32 solve's sweeps (3xTF32) and the bf16 solve's chains (wgmma)
    for name in sweeps:
        for which, sd, counts, routes, source in (
                ("tf32x3", "float32", main_counts, main_routes, TF32_SOURCE),
                ("wgmma", "bfloat16", bf16_counts, bf16_routes, TC_SOURCE)):
            rows[f"{name}/{which}"] = table[(name, sd)]
            path_counts[f"{name}/{which}"] = routes.get(f"{name}/{which}",
                                                        counts[name])
            SOURCES[f"{name}/{which}"] = source
            REPLACES[f"{name}/{which}"] = REPLACES[name]
    kernels = [{
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": path_counts[name],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        **({"library_causal_ms": row["library_causal_ms"]}
           if "library_causal_ms" in row else {})}
        for name, row in rows.items()]
    print(json.dumps({"block_sweeps_by_route": [
        {"name": name, "dtype": "bfloat16" if key == "bfloat16" else
         "float32", **table[(name, key)]}
        for key in ("float32", "bfloat16", "ffma") for name in sweeps]}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
