"""Time the LM's two recurrence kernels on the card, this checkout's
``csrc/rglru_scan.cu`` and ``csrc/wkv6.cu`` against another's.

    python3 -m repro_torch.launch.time_recurrent                 # this build
    python3 -m repro_torch.launch.time_recurrent --against OTHER/src

Shapes, fp32, with an initial state: ``rglru_scan`` at recurrentgemma-9b's
prefill (2, 4096, 4096) and at (1, 4097, 4099) (rows no multiple of 4
floats); ``wkv6`` at rwkv6-1.6b's prefill (2, 4096, 32, 64), at the other
head sizes with as many state elements a step ((2, 4096, 128, 16),
(2, 4096, 64, 32)) and twice as many ((2, 4096, 16, 128)), and at a
decode step (2, 1, 32, 64).  Each build's result is held to the plain
loop (``kernels/ref.py``): RG-LRU's h and RWKV-6's state bitwise, the
RWKV-6 output within 1e-4 of its largest magnitude.  With ``--against``
the other checkout's sources (a parent unpacked by ``git archive``, say;
the C interfaces are the same) are built with this package's flags and
timed in turns with this build (other, this, this, other; CUDA events,
``REPS`` launches a turn, caches warm), beside the byte bound
(``chip_smoke.py``'s count at 3.35 TB/s).  Prints the card's
``nvidia-smi`` name and power limit first and last, and one JSON line of
every reading before the last.  Needs one card: exits 2 without one, 1
where a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

PEAK_BYTES = 3.35e12                       # H100 SXM data sheet
REPS = 20
TOL_WKV6 = 1e-4
RGLRU_SHAPES = ((2, 4096, 4096), (1, 4097, 4099))
WKV6_SHAPES = ((2, 4096, 32, 64), (2, 4096, 128, 16), (2, 4096, 64, 32),
               (2, 4096, 16, 128), (2, 1, 32, 64))


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


def bound_ms(name: str, shape) -> float:
    """Each input read once, each output written once (fp32)."""
    if name == "rglru_scan":
        B, T, R = shape
        return 4 * (3 * B * T * R + 2 * B * R) / PEAK_BYTES * 1e3
    B, T, H, hd = shape
    return (4 * (5 * B * T * H * hd + 2 * B * H * hd * hd + H * hd)
            / PEAK_BYTES * 1e3)


def build_other(build, src: Path, name: str) -> ctypes.CDLL:
    """The other checkout's ``csrc/<name>.cu`` built with this package's
    flags (its own ``csrc`` on the include path)."""
    out = build.BUILD_DIR / f"time_recurrent-other-{name}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = src / "repro_torch" / "csrc" / f"{name}.cu"
    proc = subprocess.run([build.cuda_tool("nvcc"), *build.NVCC_FLAGS,
                           "-I", str(cu.parent), "-o", str(out), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def with_library(rec, lib):
    """``rec``'s wrappers, calling ``lib`` in place of this build's."""
    def wrap(fn):
        def call(*a):
            real = rec.build.library
            rec.build.library = lambda name: lib[name]
            try:
                return fn(*a)
            finally:
                rec.build.library = real
        return call
    return {"rglru_scan": wrap(rec.rglru_scan_cuda),
            "wkv6": wrap(rec.wkv6_cuda)}


def inputs(name: str, shape, g, dev):
    if name == "rglru_scan":
        B, T, R = shape
        a = torch.rand(shape, generator=g, device=dev) * 0.5 + 0.499
        b = torch.randn(shape, generator=g, device=dev)
        return a, b, torch.randn((B, R), generator=g, device=dev)
    B, T, H, hd = shape
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=g, device=dev)
                             * 0.5 - 2.0))
    u = torch.randn((H, hd), generator=g, device=dev) * 0.1
    S0 = torch.randn((B, H, hd, hd), generator=g, device=dev)
    return r, k, v, w, u, S0


def holds(name: str, got, want) -> bool:
    if name == "rglru_scan":
        return torch.equal(got, want)
    (o, s), (wo, ws) = got, want
    err = float((o - wo).abs().max() / wo.abs().max())
    return torch.equal(s, ws) and err <= TOL_WKV6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's src directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_recurrent: no CUDA device is visible", file=sys.stderr)
        return 2
    import importlib
    from repro_torch.kernels import build, ref
    rec = importlib.import_module("repro_torch.kernels.recurrent")
    card = card_line()
    print(card)
    names = ("rglru_scan", "wkv6")
    build.build_all(list(names))
    this = {"rglru_scan": rec.rglru_scan_cuda, "wkv6": rec.wkv6_cuda}
    other = None
    if args.against:
        libs = {n: build_other(build, Path(args.against), n) for n in names}
        other = with_library(rec, libs)
    plain = {"rglru_scan": ref.rglru_scan_ref, "wkv6": ref.wkv6_ref}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out, failed = {"card": card, "kernels": []}, []
    for name, shapes in (("rglru_scan", RGLRU_SHAPES),
                         ("wkv6", WKV6_SHAPES)):
        for shape in shapes:
            x = inputs(name, shape, g, dev)
            want = plain[name](*x)
            row = {"name": name, "shape": list(shape),
                   "bound_ms": bound_ms(name, shape),
                   "holds": holds(name, this[name](*x), want)}
            if other is not None:
                row["other_holds"] = holds(name, other[name](*x), want)
                turns = [time_ms(lambda: other[name](*x)),
                         time_ms(lambda: this[name](*x)),
                         time_ms(lambda: this[name](*x)),
                         time_ms(lambda: other[name](*x))]
                row["other_ms"] = [turns[0], turns[3]]
                row["ms"] = [turns[1], turns[2]]
            else:
                row["ms"] = [time_ms(lambda: this[name](*x))]
            ms = min(row["ms"])
            print(f"{name} {shape}: {ms:.4f} ms (turns {row['ms']}), bound "
                  f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / ms:.1f}"
                  f" %)" + (f", other {row['other_ms']}" if other else "")
                  + f"; holds to the plain loop: {row['holds']}"
                  + (f", other {row['other_holds']}" if other else ""))
            if not (row["holds"] and row.get("other_holds", True)):
                failed.append(f"{name} {shape}")
            out["kernels"].append(row)
            del x, want
    print(json.dumps(out))
    print(card_line())
    if failed:
        print("time_recurrent: FAILED " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
