"""Time the sparse stream's CSR kernels on the card, this checkout's
``csrc/csr_sweep.cu`` against another's.

    python3 -m repro_torch.launch.time_csr                 # this build
    python3 -m repro_torch.launch.time_csr --against OTHER/src

Three blocks of 65536 rows, k = 8: rows [0, 65536) of
``SyntheticSparseMatrix(2^25, 2^25, 33, seed=0)`` (``chip_smoke.py``
phase 9.1's first block: the paper's per-node share), of the
``2^22``-column matrix behind phase 9.3's known spectrum (seed 1: runs
of two or more columns eight times as common), and the first block
with every nonzero moved to one column (one run as long as the block).
On each, fp32 and bf16 values: ``csr_matmat``, ``csr_rmatmat`` and its
two halves alone (the records, the partition, the bucket sorts and the
run list; the sums), ``torch.sort(col, stable=True)`` for comparison,
and with ``--against``
the other checkout's kernels (a parent unpacked by ``git archive``,
say; the interface of ``csr_sweep.cu`` before the sort moved into the
kernel, ``torch.sort`` and all, is recognised).  The other build's
outputs are held bitwise to this one's (each claims ``np.add.at``'s
bits; ``chip_smoke.py`` and the card tests hold this one to
``np.add.at`` itself).  Kernels are timed in turns (other, this, this,
other; CUDA events, ``REPS`` launches a turn, caches warm), beside the
byte bound (``chip_smoke.py``'s count at 3.35 TB/s) and the random-row
ceiling: the rate at which ``row_gather`` reads uniformly random 32-byte
rows of a 1 GiB fp32 array, read once at the block's nonzero count and
once at 2^24 rows.  Prints the card's ``nvidia-smi`` name and power
limit first and last, and one JSON line of every reading before the
last.  Needs one card: exits 2 without one, 1 where a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES = 3.35e12                       # H100 SXM data sheet
ROWS, K, REPS = 1 << 16, 8, 20
GATHER_ROWS = 1 << 24                      # the ceiling's second reading
GATHER_BYTES = 1 << 30                     # the array it reads


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = REPS) -> float:
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


def gather_rate(csr, count: int) -> dict:
    """``row_gather`` of ``count`` uniformly random 32-byte rows of a
    1 GiB fp32 array: ms and bytes a second."""
    src = torch.empty((GATHER_BYTES // 32, 8), dtype=torch.float32,
                      device="cuda").normal_()
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, src.shape[0], (count,), generator=g,
                        device="cuda", dtype=torch.int32)
    ms = time_ms(lambda: csr.row_gather_cuda(src, idx))
    del src, idx
    return {"rows": count, "ms": ms, "bytes_per_s": count * 32 / ms * 1e3}


def build_other(build, src: Path) -> tuple:
    """The other checkout's ``csr_sweep.cu`` built with this package's
    flags: (library, log)."""
    out = build.BUILD_DIR / "time_csr-other.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.cuda_tool("nvcc"), *build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


def other_kernels(lib, csr):
    """(matmat, rmatmat) calls of another build: this interface, or the
    one whose caller sorted with ``torch.sort`` and passed an int64
    permutation and a row scratch."""
    P, I64, INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    if hasattr(lib, "repro_csr_sort_bytes"):
        real = csr.build.library

        def with_lib(fn):
            def call(*a, **kw):
                csr.build.library = lambda name: lib
                try:
                    return fn(*a, **kw)
                finally:
                    csr.build.library = real
            return call
        return with_lib(csr.csr_matmat_cuda), with_lib(csr.csr_rmatmat_cuda)
    lib.repro_csr_matmat.argtypes = [P, P, P, INT, P, P, I64, I64, INT, P]
    lib.repro_csr_rmatmat.argtypes = [P, P, P, P, P, INT, P, P, I64, I64,
                                      I64, P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def matmat(off, col, val, Q, out=None):
        Y = torch.empty((off.numel() - 1, Q.shape[1]), device=Q.device)
        csr._check(lib.repro_csr_matmat(
            off.data_ptr(), col.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Q.data_ptr(), Y.data_ptr(),
            off.numel() - 1, Q.shape[1], 0, stream()), "other csr_matmat")
        return Y

    def rmatmat(off, col, val, Y, Z):
        skey, perm = torch.sort(col, stable=True)
        row_of = torch.empty_like(col)
        csr._check(lib.repro_csr_rmatmat(
            off.data_ptr(), skey.data_ptr(), perm.data_ptr(),
            row_of.data_ptr(), val.data_ptr(),
            int(val.dtype == torch.bfloat16), Y.data_ptr(), Z.data_ptr(),
            off.numel() - 1, col.numel(), Y.shape[1], stream()),
            "other csr_rmatmat")
        return Z
    return matmat, rmatmat


def blocks():
    """(label, off, col, val fp32, n) of the three timed blocks."""
    from repro_torch.core import SyntheticSparseMatrix
    share = SyntheticSparseMatrix(1 << 25, 1 << 25, 33, seed=0)
    off, col, val = share._csr_block(0, ROWS)
    yield "share", off, col, val, share.n
    yield "long_run", off, np.full_like(col, share.n // 3), val, share.n
    spec = SyntheticSparseMatrix(1 << 22, 1 << 22, 33, seed=1)
    off, col, val = spec._csr_block(0, ROWS)
    yield "spectrum", off, col, val, spec.n


def byte_bound_ms(nnz: int, rows: int, touched: int, isz: int) -> dict:
    """``chip_smoke.py``'s byte counts (CSR arrays, each touched row of
    Q or Z once a way, Y) at 3.35 TB/s."""
    csr_bytes = 4 * (rows + 1 + nnz) + isz * nnz
    t = touched * K * 4
    return {"csr_matmat": (csr_bytes + t + rows * K * 4) / PEAK_BYTES * 1e3,
            "csr_rmatmat": (csr_bytes + rows * K * 4 + 2 * t) / PEAK_BYTES
            * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's src directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_csr: no CUDA device is visible", file=sys.stderr)
        return 2
    import importlib
    from repro_torch.kernels import build
    csr = importlib.import_module("repro_torch.kernels.csr_sweep")
    card = card_line()
    print(card)
    logs = build.build_all(["csr_sweep"])
    log = logs.get("csr_sweep") or (build.BUILD_DIR /
                                    "csr_sweep.log").read_text()
    print("build this: " + "; ".join(
        l.strip() for l in log.splitlines() if "registers" in l
        or "spill" in l)[:4000])
    other = None
    if args.against:
        lib, _ = build_other(build, Path(args.against) / "repro_torch" /
                                "csrc" / "csr_sweep.cu")
        other = other_kernels(lib, csr)
    ceiling = {"nnz": None, "large": gather_rate(csr, GATHER_ROWS)}
    failed, out = [], {"card": card, "blocks": {}}
    dev = torch.device("cuda")
    for label, off, col, val, n in blocks():
        g = torch.Generator(device=dev).manual_seed(1)
        Q = torch.randn((n, K), generator=g, device=dev)
        Y = torch.randn((ROWS, K), generator=g, device=dev)
        o, c = (torch.from_numpy(x.astype(np.int32)).to(dev)
                for x in (off, col))
        touched = int(torch.unique(c).numel())
        if ceiling["nnz"] is None:
            ceiling["nnz"] = gather_rate(csr, col.size)
        for sd in (torch.float32, torch.bfloat16):
            name = f"{label}/{str(sd).rsplit('.', 1)[-1]}"
            v = torch.from_numpy(val.astype(np.float32)).to(dev).to(sd)
            Z0 = torch.zeros((n, K), device=dev)
            want_y = csr.csr_matmat_cuda(o, c, v, Q)
            want_z = csr.csr_rmatmat_cuda(o, c, v, Y, Z0.clone())
            scratch = csr.rmatmat_scratch(col.size, n, dev)
            Zt = Z0.clone()
            fns = {
                "matmat": lambda: csr.csr_matmat_cuda(o, c, v, Q),
                "rmatmat": lambda: csr.csr_rmatmat_cuda(
                    o, c, v, Y, Zt, scratch=scratch),
                "rmatmat/sort_half": lambda: csr.csr_rmatmat_cuda(
                    o, c, v, Y, Zt, scratch=scratch, phases=csr.SORT),
                "rmatmat/sum_half": lambda: csr.csr_rmatmat_cuda(
                    o, c, v, Y, Zt, scratch=scratch, phases=csr.RUNS),
                "torch.sort": lambda: torch.sort(c, stable=True)}
            checks = {}
            if other is not None:
                checks["other_matmat"] = torch.equal(other[0](o, c, v, Q),
                                                     want_y)
                checks["other_rmatmat"] = torch.equal(other[1](
                    o, c, v, Y, Z0.clone()), want_z)
                fns["other_matmat"] = lambda: other[0](o, c, v, Q)
                fns["other_rmatmat"] = lambda: other[1](o, c, v, Y, Zt)
            reps = 3 if label == "long_run" else REPS
            ms = {key: [] for key in fns}
            keys = list(fns)
            for key in keys + keys[::-1]:          # in turns
                ms[key].append(time_ms(fns[key], reps))
            isz = 4 if sd == torch.float32 else 2
            bound = byte_bound_ms(col.size, ROWS, touched, isz)
            row = {"nnz": int(col.size), "touched": touched,
                   "checks": checks, "ms": ms, "bound_ms": bound}
            out["blocks"][name] = row
            if not all(checks.values()):
                failed.append(name)
            best = {key: min(v_) for key, v_ in ms.items()}
            print(f"{name}: {col.size} nonzeros, {touched} columns; "
                  f"the other build bitwise {checks}; ms (best of the "
                  f"turns) " + ", ".join(
                      f"{key} {t:.4f}" for key, t in best.items())
                  + f"; byte bound matmat {bound['csr_matmat']:.4f}, "
                  f"rmatmat {bound['csr_rmatmat']:.4f}", flush=True)
            del Z0, Zt, scratch, want_z
        del Q, Y
        torch.cuda.empty_cache()
    out["ceiling"] = ceiling
    print(f"random 32-byte rows of a 1 GiB fp32 array (row_gather): "
          + "; ".join(f"{r['rows']} rows {r['ms']:.4f} ms, "
                      f"{r['bytes_per_s'] / 1e12:.3f} TB/s"
                      for r in ceiling.values()))
    out["failed"] = failed
    print(json.dumps({"time_csr": out}))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
