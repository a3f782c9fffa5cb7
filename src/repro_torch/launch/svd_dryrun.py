"""Dry run of the distributed SVD's step on the paper's layout, on fake
tensors and a fake process group (the port of the JAX package's
``repro/launch/svd_dryrun.py``).

One power step of the paper's 1 TB dense problem — the global A is
8,388,608 x 32768 fp32, row-sharded over the 16 x 16 = 256 ranks of
``make_production_mesh()`` (a 32768 x 32768 shard, 4.3 GB, a rank) —
in seven variants:

  chain/faithful   Alg 4: three all-reduces a step (paper lines 6/8/16)
  chain/opt        the fused step: one (n + k,) all-reduce
  gram/faithful    Alg 3: B = all-reduce(X^T X), replicated on every rank
  gram/opt         B row-sharded: a reduce-scatter over "data", the
                   all-reduce of the (n / 16, n) rows over "model", an
                   all-gather of B_loc v
  block/opt        the driver's own ``core/svd.py::step`` on a
                   ``ShardedOperator``: one (n, k) all-reduce advances all
                   k ranks
  block/bf16       the same step under sweep_dtype="bfloat16": A read at
                   2 bytes, the (n, k) payload and the QR stay fp32
  block/warm       the driver's range-finder start (``init_state`` with
                   warmup_q=1): the sketch all-reduce of A^T Omega, one
                   fused refinement

Each rank's step runs under ``FakeTensorMode`` (no memory, no compute)
on the CPU path of ``kernels/ops.py`` (the plain versions), over a
``fake`` process group of world 256 (``torch.testing._internal.
distributed.fake_pg``), so the figures are the work, not a device's
time: FLOPs by ``torch.utils.flop_counter.FlopCounterMode`` (the
products that read an A-sized operand held to their closed form; QR,
which it does not count, reported apart by its Householder closed
form), the bytes of A by ``ops.thread_a_bytes()`` and the collective
bytes by op from ``core/collectives.py``'s record.  Every variant
carries its collective contract (``variant_contract``, the JAX
package's table); a variant whose traced schedule drifts from it makes
the run exit 1 with an expected-against-traced diff.

    python -m repro_torch.launch.svd_dryrun [--out results/svd_dryrun_torch.json]

It makes the process's default process group, so it runs in a process
of its own.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

# Paper's 1 TB dense benchmark: 32 nodes x (262144 x 32768) fp32.
M_GLOBAL = 262_144 * 32
N = 32_768
K = 32
MESH = (16, 16)
AXES = ("data", "model")
L = K + 8                        # the warm start's oversampled width

TAGS = ("chain/faithful", "chain/opt", "gram/faithful", "gram/opt",
        "block/opt", "block/bf16", "block/warm")


def variant_contract(tag: str):
    """The exact collective schedule each variant may have: the shapes
    its all-reduces carry, one rank's, and the other collectives it may
    issue.  The JAX package's table (``repro/launch/svd_dryrun.py``),
    psums written as all-reduces."""
    from repro_torch.analysis.trace_check import StepContract
    nd = MESH[0]
    return {
        "chain/faithful": StepContract(all_reduce_payloads=((N,), (K,), (N,))),
        "chain/opt": StepContract(all_reduce_payloads=((N + K,),)),
        "gram/faithful": StepContract(all_reduce_payloads=((N, N),)),
        "gram/opt": StepContract(
            all_reduce_payloads=((N // nd, N),),
            allowed_collectives=frozenset({"reduce_scatter", "all_gather"})),
        "block/opt": StepContract(all_reduce_payloads=((N, K),)),
        "block/bf16": StepContract(all_reduce_payloads=((N, K),),
                                   requires_bf16=True),
        "block/warm": StepContract(all_reduce_payloads=((N, L), (N, L))),
    }[tag]


def sweep_flops_closed_form(tag: str, m: int) -> int:
    """FLOPs of the products that read an operand of the shard's size
    (m x n elements) in one step of ``tag``, for a shard of ``m`` rows:
    2 a multiply-add.  The paper's shard is square (m = n), so the
    replicated (n, n) Gram that ``gram/faithful``'s B v reads is one."""
    n, k = N, K
    return {
        "chain/faithful": 3 * 2 * m * n,       # A v, A^T Xv, A^T U S V^T v
        "chain/opt": 2 * 2 * m * n,            # A v, A^T (Xv - U SVtv)
        # residual + Gram, and B v where B holds m * n elements
        "gram/faithful": 2 * m * n * k + 2 * m * n * n
        + (2 * n * n if n * n == m * n else 0),
        "gram/opt": 2 * m * n * k + 2 * m * n * n,
        "block/opt": 2 * 2 * m * n * k,        # A Q, A^T Y
        "block/bf16": 2 * 2 * m * n * k,
        "block/warm": 3 * 2 * m * n * L,       # A^T Omega, A Q, A^T Y
    }[tag]


def qr_flops(tag: str) -> int:
    """Householder QR of the step's (n, width) iterates, 2 n w^2 - 2 w^3 / 3
    each, which ``FlopCounterMode`` does not count."""
    def one(w):
        return 2 * N * w * w - (2 * w ** 3) // 3
    return {"block/opt": one(K), "block/bf16": one(K),
            "block/warm": 2 * one(L)}.get(tag, 0)


class _Flops:
    """``FlopCounterMode``'s formulas for the products the plain path
    runs (mm, addmm, and mv, which it lacks), each also summed apart when
    an operand holds ``a_numel`` elements."""

    def __init__(self, a_numel: int):
        self.a_numel, self.sweeps = a_numel, 0

    def _add(self, shapes, flops):
        import math
        if any(math.prod(s) == self.a_numel for s in shapes):
            self.sweeps += flops
        return flops

    def mapping(self) -> dict:
        import torch
        aten = torch.ops.aten

        def mm(a, b, *_, out_shape=None, **__):
            return self._add((a, b), 2 * a[0] * a[1] * b[1])

        def addmm(c, a, b, *_, out_shape=None, **__):
            return self._add((c, a, b), 2 * a[0] * a[1] * b[1])

        def mv(a, v, *_, out_shape=None, **__):
            return self._add((a, v), 2 * a[0] * a[1])

        return {aten.mm: mm, aten.addmm: addmm, aten.mv: mv}


def _variant(tag: str, mesh, layout, groups):
    """``(fn, args)`` of one rank's step of ``tag``; call it under
    ``FakeTensorMode``.  The mesh's own tensors stay real: ``layout``
    (the ``ShardLayout`` of the rows) and ``groups`` (by axes) are made
    before the fake tensors."""
    import torch

    from repro_torch.core.collectives import (all_gather, all_reduce,
                                              reduce_scatter)
    from repro_torch.core.config import SVDConfig
    from repro_torch.core.dist_svd import _deflated_chain_step
    from repro_torch.core.operator import ShardedOperator
    from repro_torch.core.svd import init_state, step
    from repro_torch.kernels import ops

    kind = tag.split("/")[0]
    if kind == "block":
        sd = "bfloat16" if tag == "block/bf16" else "float32"
        op = ShardedOperator.on_layout(torch.empty((M_GLOBAL, N)), layout,
                                       sweep_dtype=sd)
        if tag == "block/warm":
            cfg = SVDConfig(force_iters=True, warmup_q=1, oversample=L - K)
            return init_state, (op, K, cfg)
        cfg = SVDConfig(force_iters=True, sweep_dtype=sd)
        return step, (op, init_state(op, K, cfg), cfg)

    group = groups[AXES]
    m_loc = M_GLOBAL // (MESH[0] * MESH[1])
    args = (torch.empty((m_loc, N)), torch.empty((m_loc, K)),
            torch.empty((K,)), torch.empty((N, K)), torch.empty((N,)))
    faithful = tag.endswith("faithful")

    def power_step(A_loc, U_loc, S, V, v):
        if kind == "chain":
            v1 = _deflated_chain_step(A_loc, U_loc, S, V, v, group,
                                      faithful=faithful)
        else:
            X_loc = torch.addmm(A_loc, U_loc * S, V.mT, alpha=-1.0)
            B = ops.gram(X_loc)
            if faithful:
                v1 = torch.mv(all_reduce(B, group), v)
            else:
                B_loc = all_reduce(reduce_scatter(B, groups[("data",)]),
                                   groups[("model",)])
                v1 = all_gather(torch.mv(B_loc, v), groups[("data",)])
        return v1 / torch.sqrt(torch.sum(v1 * v1))

    return power_step, args


def run_variant(tag: str, mesh) -> tuple:
    """Run one rank's step of ``tag`` on fake tensors; returns
    ``(violations, record)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.trace_check import check_step, trace_step
    from repro_torch.core.operator import ShardLayout
    from repro_torch.launch.mesh import axes_group

    layout = ShardLayout(mesh, AXES, "cpu")
    groups = {axes: axes_group(mesh, axes)
              for axes in (AXES, ("data",), ("model",))}

    contract = variant_contract(tag)
    m_loc = M_GLOBAL // (MESH[0] * MESH[1])
    flops = _Flops(m_loc * N)
    with FakeTensorMode():
        fn, args = _variant(tag, mesh, layout, groups)
        with FlopCounterMode(display=False,
                             custom_mapping=flops.mapping()) as fc:
            trace = trace_step(fn, *args)
    violations, d = check_step(trace, contract, tag, pass_name="dryrun")
    by_op: dict = {}
    for c in d["collectives"]:
        by_op[c["op"]] = by_op.get(c["op"], 0) + c["bytes"]
    closed = sweep_flops_closed_form(tag, m_loc)
    rec = {
        "per_rank_shape": [m_loc, N], "k": K,
        "flops": int(fc.get_total_flops()),
        "sweep_flops": int(flops.sweeps),
        "sweep_flops_closed_form": closed,
        "qr_flops_closed_form": qr_flops(tag),
        "a_bytes": int(trace.a_bytes.get("a_bytes", 0)),
        "collective_bytes_by_op": by_op,
        "collective_bytes_total": sum(by_op.values()),
        "all_reduce_payloads": d["all_reduce_payloads"],
        "contract": [list(s) for s in contract.all_reduce_payloads],
        "collectives": d["collectives"],
        "n_bf16_widened": d["n_bf16_widened"],
    }
    if rec["sweep_flops"] != closed:
        from repro_torch.analysis.report import Violation
        violations.append(Violation(
            "dryrun", "sweep-flops", tag,
            f"the A-sized products count {rec['sweep_flops']:,} FLOPs, the "
            f"closed form {closed:,}"))
    rec["ok"] = not violations
    return violations, rec


def main(argv=None) -> int:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.svd_dryrun")
    ap.add_argument("--out", default=os.path.join("results",
                                                  "svd_dryrun_torch.json"))
    args = ap.parse_args(argv)
    if dist.is_initialized():
        raise RuntimeError("svd_dryrun makes its own (fake) default process "
                           "group: run it in a process of its own")
    world = MESH[0] * MESH[1]
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    print(f"svd_dryrun: fake tensors (FakeTensorMode) and a fake process "
          f"group of world {world}: the work of one rank's step, no device "
          f"time", flush=True)
    try:
        mesh = make_production_mesh(device="cpu")
        out = {"global_shape": [M_GLOBAL, N], "mesh": list(MESH),
               "axes": list(AXES), "k": K, "fake": True, "variants": {}}
        bad = []
        for tag in TAGS:
            violations, rec = run_variant(tag, mesh)
            out["variants"][tag] = rec
            if violations:
                print(f"[FAIL] {tag}: contract violated", flush=True)
                print(f"       expected all-reduces: {rec['contract']}")
                print(f"       traced   all-reduces: "
                      f"{rec['all_reduce_payloads']}")
                for v in violations:
                    print(f"       - {v.rule}: {v.message}")
                bad += violations
            else:
                print(f"[ ok ] {tag}: flops={rec['flops']:.4e} (A-sized "
                      f"{rec['sweep_flops']:.4e} = closed form; QR "
                      f"{rec['qr_flops_closed_form']:.4e} apart) "
                      f"A bytes={rec['a_bytes']:,} collective bytes="
                      f"{rec['collective_bytes_by_op']}", flush=True)
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print("written", args.out)
    if bad:
        print(f"svd_dryrun: {len(bad)} contract violation(s): the traced "
              f"schedule drifted from the documented one", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
