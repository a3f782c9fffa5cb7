"""Time the LM's two recurrence kernels and their backward kernels on the
card, this checkout's ``csrc/rglru_scan.cu`` and ``csrc/wkv6.cu`` against
another's.

    python3 -m repro_torch.launch.time_recurrent                 # this build
    python3 -m repro_torch.launch.time_recurrent --against OTHER/src
    python3 -m repro_torch.launch.time_recurrent --phases

Forwards, fp32, with an initial state: ``rglru_scan`` at
recurrentgemma-9b's prefill (2, 4096, 4096) and at (1, 4097, 4099) (rows
no multiple of 4 floats); ``wkv6`` at rwkv6-1.6b's prefill (2, 4096, 32,
64), at the other head sizes with as many state elements a step ((2,
4096, 128, 16), (2, 4096, 64, 32)) and twice as many ((2, 4096, 16,
128)), and at a decode step (2, 1, 32, 64); ``wkv6`` also with the state
kept at each chunk's start (what training runs), beside the same call
without.  Backwards, fp32, as a training step has them (no initial
state, the last state unused): ``rglru_scan_bwd`` at (8, 2048, 4096) and
(1, 4097, 4099); ``wkv6_bwd`` at (8, 2048, 32, 64) and the other head
sizes' (8, 2048, 128, 16), (8, 2048, 64, 32), (8, 2048, 16, 128), from
chunk starts written once, each beside its plain reverse loop (timed
once).  Each build's result is held to the plain loops
(``kernels/ref.py``): RG-LRU's h, da, db and RWKV-6's state and dS0
bitwise, RWKV-6's output and other gradients within 1e-4 of each one's
largest magnitude.  With ``--against`` the other checkout's sources (a
parent unpacked by ``git archive``, say) are built with this package's
flags and timed in turns with this build (other, this, this, other; CUDA
events, ``REPS`` launches a turn, caches warm), both through this
package's wrappers: the forwards always (their C interface is the same
in both), the backwards where the other build has them (a build from
before the backward kernels has the forwards only).  Each row has the
bound (``chip_smoke.py``'s counts: bytes at 3.35 TB/s, fp32 flop at 67
TFLOP/s).  Prints the card's ``nvidia-smi`` name and power
limit first and last, and one JSON line of every reading before the
last.  With ``--phases``, also ``wkv6_bwd``'s cycles by phase at its four
training shapes, from a build of this checkout's ``wkv6.cu`` with
``-DREPRO_WKV6_BWD_PHASES`` (lane 0 of each warp of the first 64 blocks
sums ``clock64()`` between marks: the barriers, the staging and b_t, q_t,
the first pass over a chunk, a sub-chunk's states, the wait for the dv
sums, those sums, its steps), as shares of the warps' cycles.  Needs one
card: exits 2 without one, 1 where a check fails.
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
PEAK_FP32 = 67e12
REPS = 20
TOL_WKV6 = 1e-4
RGLRU_SHAPES = ((2, 4096, 4096), (1, 4097, 4099))
WKV6_SHAPES = ((2, 4096, 32, 64), (2, 4096, 128, 16), (2, 4096, 64, 32),
               (2, 4096, 16, 128), (2, 1, 32, 64))
RGLRU_BWD_SHAPES = ((8, 2048, 4096), (1, 4097, 4099))
WKV6_BWD_SHAPES = ((8, 2048, 32, 64), (8, 2048, 128, 16), (8, 2048, 64, 32),
                   (8, 2048, 16, 128))

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
    """Each input read once, each output written once (fp32), over the
    memory rate, against the fp32 flop over the fp32 peak (the larger)."""
    if name == "rglru_scan":
        B, T, R = shape
        return 4 * (3 * B * T * R + 2 * B * R) / PEAK_BYTES * 1e3
    if name == "rglru_scan_bwd":
        B, T, R = shape
        return max(4 * 5 * B * T * R / PEAK_BYTES,
                   3 * B * T * R / PEAK_FP32) * 1e3
    B, T, H, hd = shape
    if name == "wkv6":
        return (4 * (5 * B * T * H * hd + 2 * B * H * hd * hd + H * hd)
                / PEAK_BYTES * 1e3)
    from repro_torch.kernels.recurrent import wkv_chunk
    chunks = -(-T // wkv_chunk(hd))
    nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                  + B * H * hd * hd * (1 + chunks))
    flop = 14 * B * T * H * hd * hd + 5 * B * T * H * hd
    return max(nbytes / PEAK_BYTES, flop / PEAK_FP32) * 1e3


def build_other(build, src: Path, name: str, flags=(),
                tag: str = "other") -> ctypes.CDLL:
    """The other checkout's ``csrc/<name>.cu`` built with this package's
    flags and ``flags`` (its own ``csrc`` on the include path)."""
    out = build.BUILD_DIR / f"time_recurrent-{tag}-{name}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = src / "repro_torch" / "csrc" / f"{name}.cu"
    proc = subprocess.run([build.cuda_tool("nvcc"), *build.NVCC_FLAGS,
                           *flags, "-I", str(cu.parent), "-o", str(out),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {cu}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(out))


def with_library(rec, lib):
    """``rec``'s wrappers of the kernels ``lib`` (a build by source name)
    has, calling ``lib`` in place of this build's: the forwards, and the
    backwards where ``lib`` has them."""
    def wrap(fn):
        def call(*a, **kw):
            real = rec.build.library
            rec.build.library = lambda name: lib[name]
            try:
                return fn(*a, **kw)
            finally:
                rec.build.library = real
        return call
    fns = {"rglru_scan": rec.rglru_scan_cuda, "wkv6": rec.wkv6_cuda}
    if hasattr(lib["wkv6"], "repro_wkv6_bwd"):
        fns.update(rglru_scan_bwd=rec.rglru_scan_bwd_cuda,
                   wkv6_bwd=rec.wkv6_bwd_cuda)
    return {name: wrap(fn) for name, fn in fns.items()}


def inputs(name: str, shape, g, dev):
    """A forward's operands (with an initial state), or a backward's (no
    initial state; the output's gradient; RWKV-6's dS_T absent)."""
    if name.startswith("rglru_scan"):
        B, T, R = shape
        a = torch.rand(shape, generator=g, device=dev) * 0.5 + 0.499
        b = torch.randn(shape, generator=g, device=dev)
        if name == "rglru_scan":
            return a, b, torch.randn((B, R), generator=g, device=dev)
        from repro_torch.kernels import recurrent as rec
        return (a, rec.rglru_scan_cuda(a, b, None), None,
                torch.randn(shape, generator=g, device=dev))
    B, T, H, hd = shape
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(shape, generator=g, device=dev)
                             * 0.5 - 2.0))
    u = torch.randn((H, hd), generator=g, device=dev) * 0.1
    if name == "wkv6":
        return r, k, v, w, u, torch.randn((B, H, hd, hd), generator=g,
                                          device=dev)
    return r, k, v, w, u, None, torch.randn(shape, generator=g, device=dev)


def holds(name: str, got, want) -> bool:
    exact = {"rglru_scan": (0,), "wkv6": (1,), "rglru_scan_bwd": (0, 1),
             "wkv6_bwd": (5,)}[name]
    got = (got,) if name == "rglru_scan" else got
    want = (want,) if name == "rglru_scan" else want
    for i, (x, y) in enumerate(zip(got, want)):
        if y is None:
            continue
        if i in exact:
            if not torch.equal(x, y):
                return False
        elif float((x - y).abs().max()) > TOL_WKV6 * float(y.abs().max()):
            return False
    return True


#: the phases of a wkv6_bwd_kernel warp's cycles (csrc/wkv6.cu, PHASE)
PHASES = ("barrier A", "staging, b_t, q_t", "first pass", "barrier B",
          "before a sub-chunk", "sub-chunk states", "dv wait", "dv sums",
          "steps", "end")


def phases(rec, build, dev) -> dict:
    """``wkv6_bwd``'s cycles by phase (a ``-DREPRO_WKV6_BWD_PHASES`` build
    of this checkout's ``wkv6.cu``) at ``WKV6_BWD_SHAPES``: the mean over
    the warps of the first 64 blocks, as shares."""
    import numpy as np
    lib = build_other(build, Path(rec.__file__).resolve().parents[2],
                      "wkv6", ("-DREPRO_WKV6_BWD_PHASES",), "phases")
    call = with_library(rec, {"rglru_scan": lib, "wkv6": lib})
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for shape in WKV6_BWD_SHAPES:
        r, k, v, w, u, _, do = inputs("wkv6_bwd", shape, g, dev)
        Sc = call["wkv6"](r, k, v, w, u, None, states=True)[2]
        call["wkv6_bwd"](r, k, v, w, u, Sc, do, None)
        torch.cuda.synchronize()
        buf = np.zeros((64, 16, len(PHASES)), np.uint64)
        err = lib.repro_wkv6_bwd_phases(ctypes.c_void_p(buf.ctypes.data))
        if err:
            raise RuntimeError(f"wkv6 phases: CUDA error {err}")
        used = buf.sum(axis=2) > 0
        mean = buf[used].astype(np.float64).mean(axis=0)
        row = {"cycles": float(mean.sum()),
               **{name: float(x / mean.sum()) for name, x in
                  zip(PHASES, mean)}}
        print(f"wkv6_bwd {shape} phases ({row['cycles']:.0f} cycles a "
              f"warp): " + ", ".join(f"{n} {100 * row[n]:.1f} %"
                                     for n in PHASES))
        out[str(shape)] = row
        del r, k, v, w, u, do, Sc
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's src directory")
    ap.add_argument("--phases", action="store_true",
                    help="also wkv6_bwd's cycles by phase")
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
    builds = {"this": with_library(rec, {n: build.library(n) for n in names})}
    if args.against:
        builds["other"] = with_library(rec, {
            n: build_other(build, Path(args.against), n) for n in names})
    Sc = {}

    def timed(key, name):
        """Build ``key``'s ``name`` on a row's operands (a backward from
        its own build's chunk starts), or None where it has none."""
        fns = builds.get(key, {})
        if name not in fns:
            return None
        if name != "wkv6_bwd":
            return fns[name]
        return lambda r, k, v, w, u, S0, do: fns[name](
            r, k, v, w, u, Sc[key], do, None)
    plain = {"rglru_scan": ref.rglru_scan_ref, "wkv6": ref.wkv6_ref,
             "rglru_scan_bwd": ref.rglru_scan_bwd_ref,
             "wkv6_bwd": lambda r, k, v, w, u, S0, do: ref.wkv6_bwd_ref(
                 r, k, v, w, u, S0, do, None)}
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out, failed = {"card": card, "kernels": []}, []
    for name, shapes in (("rglru_scan", RGLRU_SHAPES),
                         ("wkv6", WKV6_SHAPES),
                         ("rglru_scan_bwd", RGLRU_BWD_SHAPES),
                         ("wkv6_bwd", WKV6_BWD_SHAPES)):
        for shape in shapes:
            x = inputs(name, shape, g, dev)
            if name == "wkv6_bwd":
                for key, fns in builds.items():
                    if name in fns:
                        Sc[key] = fns["wkv6"](*x[:6], states=True)[2]
            want = plain[name](*x)
            mine, theirs = timed("this", name), timed("other", name)
            row = {"name": name, "shape": list(shape),
                   "bound_ms": bound_ms(name, shape),
                   "holds": holds(name, mine(*x), want)}
            if theirs is not None:
                row["other_holds"] = holds(name, theirs(*x), want)
                turns = [time_ms(lambda: theirs(*x)),
                         time_ms(lambda: mine(*x)),
                         time_ms(lambda: mine(*x)),
                         time_ms(lambda: theirs(*x))]
                row["other_ms"] = [turns[0], turns[3]]
                row["ms"] = [turns[1], turns[2]]
            else:
                row["ms"] = [time_ms(lambda: mine(*x))]
            if name == "wkv6":
                states = lambda: builds["this"]["wkv6"](*x, states=True)
                row["states_holds"] = holds(name, states()[:2], want)
                row["states_ms"] = [time_ms(states), time_ms(states)]
            if name.endswith("_bwd"):
                row["plain_ms"] = time_ms(lambda: plain[name](*x), 1)
            ms = min(row["ms"])
            print(f"{name} {shape}: {ms:.4f} ms (turns {row['ms']}), bound "
                  f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / ms:.1f}"
                  f" %)" + (f", other {row['other_ms']}" if theirs else "")
                  + (f", with the chunk starts {row['states_ms']}"
                     if name == "wkv6" else "")
                  + (f", plain {row['plain_ms']:.1f} ms"
                     if "plain_ms" in row else "")
                  + f"; holds to the plain loop: {row['holds']}"
                  + (f", other {row['other_holds']}" if theirs else "")
                  + (f", with the chunk starts {row['states_holds']}"
                     if name == "wkv6" else ""))
            if not (row["holds"] and row.get("other_holds", True)
                    and row.get("states_holds", True)):
                failed.append(f"{name} {shape}")
            out["kernels"].append(row)
            del x, want
            Sc.clear()
            torch.cuda.empty_cache()
    if args.phases:
        out["wkv6_bwd_phases"] = phases(rec, build, dev)
    print(json.dumps(out))
    print(card_line())
    if failed:
        print("time_recurrent: FAILED " + ", ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
