"""Time bf16 ``gram`` on the card, one build of ``csrc/gram_bf16.cu``
against another.

    python3 -m repro_torch.launch.time_gram            # this checkout's build
    python3 -m repro_torch.launch.time_gram --flag REPRO_STAGING_ONLY \\
        --against OTHER/src --shape 262144x8191 --shape 8192x131071t

Builds this checkout's ``gram_bf16.cu`` with the package's ``nvcc``
flags and, beside it (one ``nvcc`` each, all at once), the same source
with ``-D<flag>`` for every ``--flag`` and, with ``--against``, the
``gram_bf16.cu`` of each other checkout's ``src`` directory (a parent
commit unpacked by ``git archive``, say; labelled by the checkout's
directory name), and prints each build's registers and spills per
instance.  On each ``--shape`` (``MxN``: ``A^T A`` of an M x N bf16
``A``; ``MxNt``: ``A A^T``; contiguous, random N(0, 1) from seed 0;
default the two ``chip_smoke.py`` times on ``wgmma_ld``) it holds every
build without a flag to the plain version, as ``chip_smoke.py`` does
(relative Frobenius error within ``gram_tol`` and off the diagonal
within 4e-5, B exactly symmetric, a rerun bitwise equal), then times all
builds in turns (A B B A; CUDA events, ``REPS`` launches a turn) beside
``torch.mm(..., out_dtype=torch.float32)`` and the least time on an H100
SXM (the flop at the bf16 peak against the bytes at 3.35 TB/s).  Prints
the card's ``nvidia-smi`` name and power limit first and last, and one
JSON line of every reading before the last.  Needs one card: exits 2
without one, 1 where a reading fails.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BF16, PEAK_BYTES = 989e12, 3.35e12     # H100 SXM data sheet
TOL_OFFDIAG = 4e-5                          # chip_smoke.py's second reading
DEFAULT_SHAPES = ("262144x8191", "8192x131071t")
REPS = 2                                    # launches a timed turn


def gram_tol(r: int) -> float:
    """``chip_smoke.py``'s limit for a reduction of length ``r``."""
    return max(1e-5, 4 * r ** 0.5 * 2.0 ** -24)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def instances(log: str) -> dict:
    """``gram_bf16<TRANS,LD>``: (registers, bytes spilled) from an ``nvcc
    -Xptxas=-v`` log."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*gram_bf16ILb(\d)ELb(\d)E",
                      line)
        if m:
            fn = f"gram_bf16<{m.group(1)},{m.group(2)}>"
        elif fn and "spill stores" in line:
            out[fn] = [None, int(line.split()[4])]
        elif fn in out and "Used" in line and "registers" in line:
            out[fn][0] = int(line.split("Used ")[1].split()[0])
    return out


def build_libraries(build, flags, against) -> dict:
    """{label: (library path, log)}: this checkout's build, one with each
    flag, and the other checkouts' ({label: source})."""
    jobs = {}
    for label, src, extra in ([(f.lower(), build.CSRC / "gram_bf16.cu",
                                [f"-D{f}"]) for f in flags]
                              + [(lab, path, []) for lab, path in
                                 against.items()]):
        out = build.BUILD_DIR / f"time_gram-{label}.so"
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs[label] = (subprocess.Popen(
            [build.cuda_tool("nvcc"), *build.NVCC_FLAGS, *extra, "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    logs = build.build_all(["gram_bf16"])
    libs = {"this": (build.library_path("gram_bf16"), logs.get("gram_bf16")
                     or (build.BUILD_DIR / "gram_bf16.log").read_text())}
    for label, (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {label} build:\n{log}")
        libs[label] = (out, log)
    return libs


def parse_shape(s: str) -> tuple:
    trans = s.endswith("t")
    m, n = (int(v) for v in s.rstrip("t").split("x"))
    return m, n, trans


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another checkout's src directory, labelled by "
                         "the checkout's directory name; repeatable")
    ap.add_argument("--flag", action="append", default=[],
                    help="also time this checkout built with -D<flag>")
    ap.add_argument("--shape", action="append",
                    help="MxN (A^T A) or MxNt (A A^T); repeatable")
    ap.add_argument("--route", choices=("wgmma", "wgmma_ld"),
                    help="the route of every shape (default gram.route's: "
                         "wgmma_ld reads any A, so it can be timed where a "
                         "tensor map describes A too)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_gram: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ref
    # the module (the package's own ``gram`` is the ops function)
    gm = importlib.import_module("repro_torch.kernels.gram")

    card = card_line()
    print(card)
    against = {Path(d).resolve().parent.name: Path(d) / "repro_torch" /
               "csrc" / "gram_bf16.cu" for d in args.against}
    libs = build_libraries(build, args.flag, against)
    for label, (path, log) in libs.items():
        print(f"build {label} ({path.name}): " + ", ".join(
            f"{k} {r} registers, {s} bytes spilled"
            for k, (r, s) in sorted(instances(log).items())))
    loaded = {label: ctypes.CDLL(str(path)) for label, (path, _) in
              libs.items()}
    real = build.library

    def run(label, A, trans):
        build.library = lambda name: (loaded[label] if name == "gram_bf16"
                                      else real(name))
        try:
            return gm.gram_cuda(A, args.route or gm.route(A), trans=trans)
        finally:
            build.library = real

    def time_ms(fn, reps):
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

    def offdiag(got, want):
        d, w = got - want, want.clone()
        d.diagonal().zero_()
        w.diagonal().zero_()
        return float(torch.linalg.norm(d) / torch.linalg.norm(w))

    g = torch.Generator(device="cuda").manual_seed(0)
    failed, rows = [], []
    for shape in args.shape or DEFAULT_SHAPES:
        m, n, trans = parse_shape(shape)
        A = torch.randn((m, n), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        r, N = (n, m) if trans else (m, n)
        t_ops = r * N * (N + 1) / PEAK_BF16 * 1e3
        t_bytes = (2 * m * n + 4 * N * N) / PEAK_BYTES * 1e3
        row = {"m": m, "n": n, "trans": trans,
               "route": args.route or gm.route(A),
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "builds": {}}
        want = ref.gram_ref(A, trans)
        tol = gram_tol(r)
        for label in libs:
            if label.startswith("repro_"):     # a flag: B not computed
                row["builds"][label] = {"ms": []}
                continue
            print(f"  checking {label} at {shape}", file=sys.stderr,
                  flush=True)
            got = run(label, A, trans)
            again = run(label, A, trans)
            torch.cuda.synchronize()
            e = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
            rd = {"rel_err": e, "limit": tol,
                  "offdiag_err": offdiag(got, want),
                  "symmetric": bool(torch.equal(got, got.mT)),
                  "rerun_equal": bool(torch.equal(got, again)), "ms": []}
            row["builds"][label] = rd
            if not (e <= tol and rd["offdiag_err"] <= TOL_OFFDIAG
                    and rd["symmetric"] and rd["rerun_equal"]):
                failed.append(f"{label} {shape}")
            del got, again
        del want
        order = list(libs) + list(reversed(libs))
        for label in order:
            row["builds"][label]["ms"].append(time_ms(
                lambda: run(label, A, trans), REPS))
        row["library_ms"] = time_ms(
            (lambda: torch.mm(A, A.mT, out_dtype=torch.float32)) if trans
            else (lambda: torch.mm(A.mT, A, out_dtype=torch.float32)),
            REPS)
        print(f"{m}x{n}{' (A A^T)' if trans else ''} on {row['route']}: "
              + "; ".join(
                  f"{label} " + " / ".join(f"{t:.3f}" for t in b["ms"])
                  + " ms" + (f" (rel err {b['rel_err']:.2e} of "
                             f"{b['limit']:.1e}, off the diagonal "
                             f"{b['offdiag_err']:.2e} of {TOL_OFFDIAG:.0e}, "
                             f"symmetric {b['symmetric']}, rerun equal "
                             f"{b['rerun_equal']})" if "rel_err" in b
                             else "")
                  for label, b in row["builds"].items())
              + f"; torch.mm(..., out_dtype=torch.float32) "
              f"{row['library_ms']:.3f} ms; bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']})")
        rows.append(row)
        del A
        torch.cuda.empty_cache()
    print(json.dumps({"time_gram": rows, "failed": failed}))
    print(card)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
