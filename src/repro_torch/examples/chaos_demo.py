"""Chaos drill: a solve survives injected faults AND a real process kill.

    PYTHONPATH=src python -m repro_torch.examples.chaos_demo [--device cpu]

Three legs, each held to an uninterrupted fault-free solve:

1. **transient I/O** — a disk-tier solve with injected read failures
   retries under bounded backoff and finishes bitwise-identical, the
   injected faults and retries reported in ``SVDResult.faults``;
2. **numeric corruption + tier demotion** — a NaN planted in a sweep is
   caught by the health guard and rolled back; an injected device OOM
   demotes a dense solve to the host-blocked tier mid-run, carrying the
   warm iterate;
3. **kill -9 under fault injection** — a CHILD PROCESS runs a
   checkpointed solve with a fault plan that both flakes a disk read and
   calls ``os._exit`` after iteration 2; the parent observes the real
   death, then resumes from the checkpoint directory (with ANOTHER
   transient fault) to bitwise-identical sigmas and conserved passes.

The child is this module run with ``REPRO_TORCH_CHAOS_ROLE=child``.
"""
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.core import (FaultPlan, FaultSpec, inject_faults,
                              stage_to_disk, svd)

M, N, K = 384, 128, 8
SEED = 7
EXIT_CODE = 42
ROLE = "REPRO_TORCH_CHAOS_ROLE"


def make_matrix():
    rng = np.random.default_rng(0)
    U, _, Vt = np.linalg.svd(rng.normal(size=(M, N)).astype(np.float32),
                             full_matrices=False)
    S = np.concatenate([np.linspace(25, 4, K),
                        2 * 0.8 ** np.arange(1, N - K + 1)])
    return ((U * S) @ Vt).astype(np.float32)


def solve(path, dev, ckpt=None):
    return svd(path, K, device=dev, method="block", seed=SEED, n_blocks=4,
               io_retry_backoff=0.0, checkpoint_dir=ckpt,
               checkpoint_every=1)


def child(path, ckpt, dev):
    """A checkpointed solve that flakes a disk read AND dies for real
    after iteration 2; the parent checks the exit code."""
    plan = FaultPlan(FaultSpec(site="disk_read", at=2, count=1),
                     FaultSpec(site="kill", at=2, mode="exit",
                               exit_code=EXIT_CODE))
    with inject_faults(plan):
        solve(path, dev, ckpt=ckpt)
    print("child: survived the kill?!", file=sys.stderr)
    return 1


def main(dev) -> int:
    A = make_matrix()
    workdir = tempfile.mkdtemp(prefix="chaos_demo_")
    try:
        path = stage_to_disk(A, os.path.join(workdir, "a.npy"))
        ref = solve(path, dev)
        print(f"reference: converged={ref.converged} "
              f"passes={ref.passes_over_A} backend={ref.backend}")

        # -- leg 1: transient disk faults, retried to a bitwise result --
        with inject_faults(FaultPlan(FaultSpec(site="disk_read", at=3,
                                               count=2))):
            res = solve(path, dev)
        assert torch.equal(ref.S, res.S)
        print(f"transient-I/O: bitwise OK, faults={res.faults['counters']}")

        # -- leg 2a: NaN sweep -> health-guard rollback -----------------
        with inject_faults(FaultPlan(FaultSpec(site="sweep", at=2))):
            res = solve(path, dev)
        assert torch.equal(ref.S, res.S)
        assert res.passes_over_A == ref.passes_over_A
        print(f"NaN-sweep: rolled back bitwise, "
              f"faults={res.faults['counters']}")

        # -- leg 2b: device OOM -> tier demotion dense -> hostblocked ---
        At = torch.from_numpy(A).to(dev)
        dref = svd(At, K, device=dev, method="block", seed=SEED)
        with inject_faults(FaultPlan(FaultSpec(site="device_oom", at=2))):
            res = svd(At, K, device=dev, method="block", seed=SEED)
        assert res.backend == "hostblocked", res.backend
        np.testing.assert_allclose(res.S.cpu().numpy(), dref.S.cpu().numpy(),
                                   rtol=1e-4)
        print(f"device-OOM: demoted dense->{res.backend}, sigmas agree, "
              f"faults={res.faults['counters']}")

        # -- leg 3: a real kill under an injected fault, then resume ----
        ckpt = os.path.join(workdir, "ckpt")
        env = dict(os.environ, **{ROLE: "child"})
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.chaos_demo",
             "--device", dev.type, path, ckpt], env=env, timeout=300)
        assert proc.returncode == EXIT_CODE, \
            f"child exited {proc.returncode}, wanted {EXIT_CODE}"
        steps = [n for n in os.listdir(ckpt) if n.startswith("step_")]
        print(f"kill: child died with os._exit({EXIT_CODE}), "
              f"checkpoints survived: {sorted(steps)}")
        with inject_faults(FaultPlan(FaultSpec(site="disk_read", at=1))):
            res = solve(path, dev, ckpt=ckpt)
        assert torch.equal(ref.S, res.S)
        assert res.passes_over_A == ref.passes_over_A
        print(f"resume: bitwise OK across the kill, passes conserved "
              f"({res.passes_over_A}), faults={res.faults['counters']}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print("chaos demo: all legs OK")
    return 0


if __name__ == "__main__":
    from repro_torch.core.operator import resolve_device
    from repro_torch.examples import device_arg

    ap = device_arg(__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="(the child's) the .npy and the checkpoint directory")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if os.environ.get(ROLE) == "child":
        sys.exit(child(*args.paths, dev))
    sys.exit(main(dev))
