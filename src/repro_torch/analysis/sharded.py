"""The sharded backend's analysis targets, in a process of their own.

``python -m repro_torch.analysis.sharded --device cpu|cuda`` makes a
world-1 process group (gloo on the CPU, NCCL on the card, as
``chip_smoke.py``'s phase 10.1 does), runs
``analysis/targets.py::sharded_targets`` through
``analysis.run_targets``, destroys the group and prints the plain-data
result as one JSON line.  ``run_all`` starts it, so the caller's own
process group (a process has one default group) is never touched.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    import torch.distributed as dist

    from repro_torch.analysis import run_targets
    from repro_torch.analysis.targets import sharded_targets
    from repro_torch.launch.mesh import axes_group, make_host_mesh

    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.sharded")
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--passes", default="trace,memory")
    ap.add_argument("--budget-bytes", type=int, default=None)
    args = ap.parse_args(argv)
    dist.init_process_group("nccl" if args.device == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(device=args.device)
        targets, groups, twins, _ = sharded_targets(
            args.device, axes_group(mesh, ("data",)), mesh)
        out = run_targets(targets, args.passes.split(","), args.budget_bytes,
                          args.device)
    finally:
        dist.destroy_process_group()
    out["groups"] = [dataclasses.asdict(g) for g in groups]
    out["twins"] = twins
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
