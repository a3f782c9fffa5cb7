"""Quickstart: truncated SVD seven ways through the ONE front door.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``repro_torch.svd(A, k, ...)`` dispatches on the input type: a tensor
runs in memory on ``device``, a numpy array stays on the host and is
streamed out-of-core, a matrix plus a mesh is row-sharded over the
ranks (here a world of one).  Every leg is held to the known spectrum;
the last line is the sigmas as JSON.
"""
import json
import socket
import sys

import numpy as np
import torch

from repro_torch.core import SVDConfig, relative_error, svd

M, N, K = 1024, 256, 8
TOL = 1e-3                   # relative error of each sigma


def matrix():
    """A (1024, 256) fp32 matrix with the spectrum linspace(50, 1)."""
    rng = np.random.default_rng(0)
    U, _, Vt = np.linalg.svd(rng.normal(size=(M, N)).astype(np.float32),
                             full_matrices=False)
    spectrum = np.linspace(50, 1, N).astype(np.float32)
    return (U * spectrum) @ Vt, spectrum


def _mesh(device):
    """A world-1 process group and its (1, 1) mesh on ``device``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    return make_host_mesh(device=device.type)


def main(argv=None) -> int:
    from repro_torch.core.operator import resolve_device
    from repro_torch.examples import device_arg

    args = device_arg(__doc__.splitlines()[0]).parse_args(argv)
    dev = resolve_device(args.device)
    A, spectrum = matrix()
    At = torch.from_numpy(A).to(dev)
    print(f"A: {M}x{N} on {dev}, want top-{K} of spectrum {spectrum[:K]}")
    sig, bad = {}, []

    def report(label, res, note=""):
        S = res.S.detach().cpu().numpy()
        sig[label] = [float(s) for s in S]
        err = float(np.max(np.abs(S / spectrum[:K] - 1)))
        print(f"[{label:<14}] sigma: {np.round(S, 3)} (max rel err "
              f"{err:.1e}){note}")
        if not err <= TOL:
            bad.append(label)

    # 1) serial power method (paper Algs 1 + 2): the deflation oracle
    res = svd(At, K, device=dev, method="gram", eps=1e-9, max_iters=500)
    report("serial/gram", res, f", rel reconstruction err "
           f"{float(relative_error(At, res)):.3f}")
    # 2) the gram-free chain (paper Alg 4, the sparse-safe path)
    report("serial/chain", svd(At, K, device=dev, method="gramfree",
                               eps=1e-9, max_iters=500))
    # 3) block subspace iteration, the default: all k ranks a pass over A
    res = svd(At, K, device=dev, eps=1e-8, max_iters=300)
    report("serial/block", res, f" ({int(res.iters[0])} block iterations, "
           f"{int(res.passes_over_A)} passes over A)")
    # 3b) ... from the randomized range-finder start
    cfg = SVDConfig(method="block", eps=1e-8, max_iters=300, warmup_q=1)
    res = svd(At, K, device=dev, config=cfg)
    report("block+warm", res, f" ({int(res.iters[0])} block iterations, "
           f"{int(res.passes_over_A)} passes over A)")
    # 4) out-of-core: a NUMPY array stays on the host, 8 blocks streamed
    report("out-of-core", svd(A, K, device=dev, method="gramfree",
                              n_blocks=8, eps=1e-9, max_iters=500))
    # 4b) out-of-core block: each host block copied ONCE an iteration
    res = svd(A, K, device=dev, method="block", n_blocks=8, eps=1e-8,
              max_iters=300)
    report("oom/block", res, f" (backend={res.backend}, "
           f"{res.bytes_per_pass / 1e6:.1f} MB H2D a pass)")
    # 5) row-sharded over a mesh: every rank makes the same call
    import torch.distributed as dist
    mesh = _mesh(dev)
    try:
        res = svd(At, K, mesh=mesh, eps=1e-8, max_iters=300)
        report(f"distributed x{dist.get_world_size()}", res)
    finally:
        dist.destroy_process_group()

    print(f"\nexpected        : {np.round(spectrum[:K], 3)}")
    if bad:
        print(f"quickstart: sigma off by more than {TOL:.0e} in {bad}",
              file=sys.stderr)
        return 1
    print(json.dumps({"quickstart": sig}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
