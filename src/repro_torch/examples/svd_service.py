"""SVD-as-a-service walkthrough: one warm process, many svd() jobs.

    PYTHONPATH=src python -m repro_torch.examples.svd_service [--device cpu]

``repro_torch.SVDService`` turns the one-call front door into a
persistent serving process: submit jobs from any thread, get handles
back at once, and let the scheduler handle priority, admission,
micro-batching and metering.  This demo walks the client surface:

  1. a burst of small same-shape jobs, stacked by the micro-batcher into
     batched dispatches (``batched_jobs`` in the metrics);
  2. a large job with ``stream_every=2``: leading singular triplets and
     the subspace gap arrive while it runs, long before DONE;
  3. a bad request (k larger than the matrix): FAILED with the typed
     ``InputError``, the "4xx" class; the queue keeps serving;
  4. cancellation of a job that would not end on its own;
  5. the per-job cost records and the queue-level metrics.
"""
import json
import sys

import numpy as np
import torch

from repro_torch.core import InputError, SVDConfig
from repro_torch.serving import JobStatus, SVDService


def lowrank(rng, m, n):
    r = min(m, n)
    U, _ = np.linalg.qr(rng.standard_normal((m, r)))
    V, _ = np.linalg.qr(rng.standard_normal((n, r)))
    return ((U * np.geomspace(10.0, 1e-2, r)) @ V.T).astype(np.float32)


def main(argv=None) -> int:
    from repro_torch.core.operator import resolve_device
    from repro_torch.examples import device_arg

    dev = resolve_device(device_arg(__doc__.splitlines()[0])
                         .parse_args(argv).device)
    rng = np.random.default_rng(0)
    cfg = SVDConfig(eps=1e-8, max_iters=300)

    with SVDService(max_workers=2, max_batch=16, device=dev) as svc:
        # 1) a burst of small same-shape jobs: the batcher stacks these
        burst = [svc.submit(torch.from_numpy(lowrank(rng, 48, 24)).to(dev),
                            4, config=cfg.replace(seed=i), tag="burst")
                 for i in range(12)]

        # 2) a large streamed job (host array: the out-of-core tier)
        big = svc.submit(lowrank(rng, 512, 128), 8, config=cfg,
                         stream_every=2, priority=5, tag="big")
        print("streaming the large job:")
        partials = 0
        for p in big.stream():
            partials += 1
            print(f"  it={p.it:3d} gap={p.gap:.3e} "
                  f"S[:4]={np.round(np.asarray(p.S[:4]), 3)}")
        assert big.wait(60.0) is JobStatus.DONE and partials > 0
        res = big.result()
        want = np.geomspace(10.0, 1e-2, 128)[:8]
        err = float(np.max(np.abs(res.S.cpu().numpy() / want - 1)))
        print(f"  -> {big.wait().value}, {res.passes_over_A} passes over A, "
              f"max sigma rel err {err:.1e}")
        assert err <= 1e-4

        # 3) a bad request fails typed, without hurting the queue
        bad = svc.submit(torch.from_numpy(lowrank(rng, 16, 8)).to(dev), 999)
        assert bad.wait(30.0) is JobStatus.FAILED
        assert isinstance(bad.error, InputError)
        print(f"bad request: {bad.error_kind} error ({bad.error})")

        # 4) cancel a job that would not end on its own (forced
        #    iterations): dropped if still queued, else aborted at its
        #    next iteration hook, whichever the scheduler reached first
        victim = svc.submit(torch.from_numpy(lowrank(rng, 48, 24)).to(dev),
                            4, config=cfg.replace(seed=99, force_iters=True,
                                                  max_iters=10**6),
                            priority=-10, stream_every=1)
        assert victim.cancel()
        assert victim.wait(60.0) is JobStatus.CANCELLED
        print(f"cancelled job: {victim.wait().value} after "
              f"{victim.partial_count} partials")

        for h in burst:
            status = h.wait(60.0)
            assert status is JobStatus.DONE, (status, h.error)
            S = h.result().S.cpu().numpy()
            assert np.allclose(S, np.geomspace(10.0, 1e-2, 24)[:4],
                               rtol=1e-4), S
        print(f"burst of {len(burst)} small jobs: all "
              f"{burst[0].wait().value}, sigmas as prescribed")

        # 5) the bill: per-job cost records + the queue rollup
        rec = next(r for r in svc.meter.records
                   if r.job_id == burst[0].job_id)
        print("\none burst job's cost record:")
        print(json.dumps(rec.to_dict(), indent=2, default=str))
        metrics = svc.metrics()
        print("\nqueue metrics:")
        print(json.dumps(metrics, indent=2, default=str))
    print("svd_service: all legs OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
