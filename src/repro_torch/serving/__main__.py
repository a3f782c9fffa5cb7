"""Demo/smoke CLI for the SVD serving subsystem (PyTorch port).

::

    python -m repro_torch.serving --smoke               # tiny, on the card
    python -m repro_torch.serving --smoke --device cpu  # plain PyTorch
    python -m repro_torch.serving --small 32 --large 2

Starts an ``SVDService`` in-process, submits a burst of small
same-shape jobs (micro-batched into stacked dispatches) alongside a
couple of large streamed jobs, prints each streamed partial as it
lands, and ends with the queue-level metrics rollup.  Exit code 0 iff
every job reached DONE.

(For LM decode serving see ``python -m repro_torch.launch.serve``.)
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.core.config import SVDConfig
from repro_torch.serving import JobStatus, SVDService


def _lowrank(rng, m: int, n: int) -> np.ndarray:
    r = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, r)))
    V, _ = np.linalg.qr(rng.standard_normal((n, r)))
    s = np.geomspace(10.0, 1e-2, r)
    return (U * s) @ V.T


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes, CI-sized run")
    ap.add_argument("--small", type=int, default=24,
                    help="number of small batchable jobs")
    ap.add_argument("--large", type=int, default=1,
                    help="number of large streamed jobs")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions (default: "
                         "the card, which must be visible)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    sm, sn, sk = (48, 24, 4) if args.smoke else (128, 64, 8)
    lm, ln, lk = (256, 96, 8) if args.smoke else (2048, 512, 16)
    small_cfg = SVDConfig(eps=1e-8, max_iters=300, warmup_q=1)
    large_cfg = SVDConfig(eps=1e-10, max_iters=500)

    ok = True
    with SVDService(max_workers=args.workers, max_batch=16,
                    device=args.device) as svc:
        small = [svc.submit(torch.from_numpy(
                     _lowrank(rng, sm, sn).astype(np.float32)), sk,
                     config=small_cfg.replace(seed=i), tag=f"small-{i}")
                 for i in range(args.small)]
        large = [svc.submit(_lowrank(rng, lm, ln).astype(np.float32), lk,
                            config=large_cfg, stream_every=1,
                            tag=f"large-{i}")
                 for i in range(args.large)]
        for h in large:
            for p in h.stream(timeout=120.0):
                print(f"  {p.job_id} it={p.it:3d} gap={p.gap} "
                      f"S[:3]={np.round(p.S[:3], 4)}")
        for h in small + large:
            status = h.wait(120.0)
            if status is not JobStatus.DONE:
                print(f"{h.job_id}: {status.value} "
                      f"({h.error_kind}: {h.error})", file=sys.stderr)
                ok = False
        metrics = svc.metrics()
    print(json.dumps(metrics, indent=2, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
