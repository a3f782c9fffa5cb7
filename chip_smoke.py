#!/usr/bin/env python3
"""Drive the PyTorch port (``repro_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; one card

Phases (any failure exits non-zero; nothing is caught and passed over):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build the CUDA kernels of ``src/repro_torch/csrc`` and
   print the build time and each kernel's registers/spills.
2. every kernel on the card against its plain PyTorch version
   (``repro_torch/kernels/ref.py``): ``block_matvec``, ``block_rmatvec``
   and ``block_gram_chain`` (both orientations), fp32 and bf16, at
   ragged shapes and at the main path's 262144 x 32768, k = 32, with the
   relative Frobenius error and its limit; kernel, plain, library
   (``torch.matmul``, a yardstick only) and bound times at that shape.
3. the main path: ``repro_torch.svd(A, 32)`` with the default config on
   a 262144 x 32768 fp32 ``A`` (32 GiB, the paper's per-node shard)
   built on the card with singular values ``100 * 0.9**i`` (i < 64) plus
   noise far below them; sigma checked to rtol 1e-4, launch counts
   checked against the pass accounting.  Then ``sweep_dtype="bfloat16"``
   (eps 1e-4, rtol 1e-2) on the same ``A``, and a contiguous wide input
   (the operator's transposed path).
4. determinism: two solves of a 16384 x 4096 matrix, bitwise equal.

Prints a ``{"kernels": [...]}`` line (the fp32 main path's launch counts
and times), the ``nvidia-smi`` name and power limit line again, and last
``{"ok": true, "device": {...}}``.  Exits 2 without a CUDA device or
without ``src/repro_torch`` beside this script.
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
SLAB = 16384                           # rows per chunk of the plain versions
# Limits of kernel vs plain: the same (bf16-rounded) operands summed in
# fp32 in another order.  The bf16 chain rounds its fp32 intermediate to
# bf16; where kernel and plain land on either side of a rounding
# boundary that entry moves by a whole bf16 step (2^-8 relative).
TOL = {"float32": 1e-5, "bfloat16": 1e-5}
TOL_CHAIN_BF16 = 1e-3
# H100 SXM data sheet: HBM3 rate, fp32 (non-tensor) and bf16 dense peaks
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
TPU_KERNEL = "src/repro/kernels/block_matvec.py"
REPLACES = {"block_matvec": f"{TPU_KERNEL}:81",
            "block_rmatvec": f"{TPU_KERNEL}:127",
            "block_gram_chain": f"{TPU_KERNEL}:146"}
SOURCE = "src/repro_torch/csrc/block_matvec.cu"


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


def bound(name: str, m: int, n: int, k: int, dtype: str) -> tuple:
    """Least time for the function on an H100 SXM: A and the skinny
    input read once in ``dtype``, the fp32 output written once, over the
    memory rate; 2*m*n*k flop per product over the peak for ``dtype``.
    The chain's bound counts A once: a one-read fusion is possible."""
    isz = 2 if dtype == "bfloat16" else 4
    skinny_in, out, products = {"block_matvec": (n, m, 1),
                                "block_rmatvec": (m, n, 1),
                                "block_gram_chain": (n, n, 2)}[name]
    nbytes = m * n * isz + skinny_in * k * isz + out * k * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = products * 2 * m * n * k / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    import repro_torch
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)                           # nvidia-smi name, power.limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    print("TF32 is off for matmul and cuDNN: the plain fp32 versions are "
          "full fp32, like the kernels' FFMA")

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(logs) or 'up to date'})")
    for name, log in logs.items():       # nvcc -Xptxas=-v, per kernel
        regs = [int(l.split("Used ")[1].split()[0])
                for l in log.splitlines() if "registers" in l]
        spills = [int(l.split()[4]) for l in log.splitlines()
                  if "spill stores" in l]
        print(f"  {name}: {len(regs)} kernels, registers <= {max(regs)}, "
              f"{sum(b > 0 for b in spills)} with spills (<= "
              f"{max(spills)} bytes stored)")

    # -- 2a. kernels vs plain at ragged shapes -----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    shapes = [(1000, 300, 7), (4097, 515, 40), (2048, 1024, 130),
              (3000, 200, 1), (257, 4100, 32), (40000, 96, 33)]
    worst = 0.0
    for (m, n, k) in shapes:
        A = torch.randn((m, n), generator=g, device=dev)
        Qn = torch.randn((n, k), generator=g, device=dev)
        Ym = torch.randn((m, k), generator=g, device=dev)
        for sd in ("float32", "bfloat16"):
            As = A.to(getattr(torch, sd))
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
            for name, got, want, tol in cases:
                if got.dtype != torch.float32 or got.shape != want.shape:
                    fail(f"{name} {sd} {(m, n, k)}: got {got.dtype} "
                         f"{tuple(got.shape)}")
                e = rel_err(torch, got, want)
                worst = max(worst, e / tol)
                print(f"  {name:24s} {sd:8s} m={m} n={n} k={k}: rel err "
                      f"{e:.2e} (limit {tol:.0e})")
                if not e <= tol:
                    fail(f"{name} {sd} {(m, n, k)}: rel err {e} > {tol}")
    print(f"ragged shapes: all within limits (worst {worst:.2f} of limit)")

    # -- 2b/3. the main path's A ----------------------------------------
    t0 = time.perf_counter()
    A, s = spectral_matrix(torch, M, N, SEED, dev)
    torch.cuda.synchronize()
    print(f"A {M}x{N} fp32 ({A.numel() * 4 / 2**30:.0f} GiB) built on the "
          f"card in {time.perf_counter() - t0:.1f} s")

    # -- 2b. kernels at the main path's shape --------------------------------
    Q = torch.linalg.qr(torch.randn((N, K), generator=g, device=dev)).Q
    Ym = torch.randn((M, K), generator=g, device=dev)
    table = {}
    for sd in ("float32", "bfloat16"):
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
        for name, (kern, plain, lib) in fns.items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            e = rel_err(torch, got, want)
            tol = TOL_CHAIN_BF16 if (sd == "bfloat16" and
                                     name == "block_gram_chain") else TOL[sd]
            if not (bool(torch.isfinite(got).all()) and e <= tol):
                fail(f"{name} {sd} at {(M, N, K)}: rel err {e} > {tol}")
            row = {
                "max_abs_err": float((got - want).abs().max()),
                "rel_err": e, "limit": tol,
                "ms": time_ms(torch, kern, 5),
                "plain_ms": time_ms(torch, plain, 2),
                "library_ms": time_ms(torch, lib, 3),
            }
            row["bound_ms"], row["bound_by"] = bound(name, M, N, K, sd)
            table[(name, sd)] = row
            print(f"  {name:16s} {sd:8s} {M}x{N} k={K}: rel err {e:.2e} "
                  f"(limit {tol:.0e}), kernel {row['ms']:.2f} ms, plain "
                  f"{row['plain_ms']:.2f} ms, torch.matmul "
                  f"{row['library_ms']:.2f} ms, bound "
                  f"{row['bound_ms']:.2f} ms ({row['bound_by']})")
            del got, want
        del As, Qs, Ys
    torch.cuda.empty_cache()

    # -- 3. the main path ------------------------------------------------
    def solve(X, label, expect_trans=False, rtol=1e-4, **kw):
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        res = repro_torch.svd(X, K, **kw)
        counts = dict(ops.launches)
        it = int(res.iters[0])
        err = float((res.S.double().cpu() / s[:K].double().cpu() - 1)
                    .abs().max())
        print(f"{label}: iters {it}, passes_over_A {res.passes_over_A}, "
              f"bytes_per_pass {res.bytes_per_pass}, bytes_moved "
              f"{res.bytes_moved}, converged {res.converged}, wall_time_s "
              f"{res.wall_time_s:.3f}, launches {counts}, max sigma rel "
              f"err {err:.2e} (limit {rtol:.0e}), peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        want = {"block_gram_chain": it,
                "block_matvec": it + (0 if expect_trans else 1),
                "block_rmatvec": it + (1 if expect_trans else 0)}
        if counts != want:
            fail(f"{label}: launches {counts}, pass accounting implies "
                 f"{want}")
        if res.passes_over_A != 2 * it + 1 or res.backend != "dense":
            fail(f"{label}: passes {res.passes_over_A} for {it} iters")
        if not (res.converged and err <= rtol
                and bool(torch.isfinite(res.U).all())
                and bool(torch.isfinite(res.V).all())):
            fail(f"{label}: not converged to the prescribed sigma")
        return res, counts

    _, main_counts = solve(A, f"main path svd(A, {K}) fp32")
    solve(A, f"svd(A, {K}) bf16 sweeps", rtol=1e-2,
          sweep_dtype="bfloat16", eps=1e-4)
    del A
    torch.cuda.empty_cache()
    Aw, _ = spectral_matrix(torch, *WIDE, SEED + 2, dev)
    solve(Aw, f"wide {WIDE[0]}x{WIDE[1]} svd(A, {K}) fp32",
          expect_trans=True)
    del Aw

    # -- 4. determinism --------------------------------------------------
    Ar, _ = spectral_matrix(torch, *RERUN, SEED + 3, dev)
    r1, r2 = repro_torch.svd(Ar, K), repro_torch.svd(Ar, K)
    same = all(torch.equal(a, b) for a, b in zip(r1[:3], r2[:3]))
    print(f"rerun {RERUN[0]}x{RERUN[1]}: U, S, V bitwise equal: {same}")
    if not same:
        fail("two solves with the same seed differ")

    kernels = []
    for name in ("block_matvec", "block_rmatvec", "block_gram_chain"):
        row = table[(name, "float32")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": main_counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    print(json.dumps({"kernels_bfloat16": [
        {"name": name, **table[(name, "bfloat16")]}
        for name in ("block_matvec", "block_rmatvec", "block_gram_chain")]}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
