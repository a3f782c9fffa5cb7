"""Low-rank model compression with the out-of-core t-SVD.

Factors every large 2-D weight of a model to rank r with the paper's
power method (the block method; the largest weights go in as host numpy
arrays and stream through in blocks, so a matrix larger than the
device's memory works the same way), then reports the size/quality
trade-off and runs the compressed model.  The weights are drawn from a
seed (``models/transformer.py::init_model``); no checkpoint is loaded.

    PYTHONPATH=src python -m repro_torch.examples.compress_model [--rank 16] [--device cpu]

Each factorization is held to the best rank-r error of its weight
(Eckart-Young: the tail of its singular values, from a full SVD on the
host), and the compressed model's logits must be finite.
"""
import sys

import numpy as np
import torch

from repro_torch.core import svd
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def main(argv=None) -> int:
    from repro_torch.core.operator import resolve_device
    from repro_torch.examples import device_arg

    ap = device_arg(__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--min-dim", type=int, default=128)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = ModelConfig(name="demo", family="dense", num_layers=4,
                      d_model=256, num_heads=8, num_kv_heads=4, d_ff=1024,
                      vocab_size=4096, dtype="float32", scan_layers=False)
    model = T.init_model(cfg, seed=0, device=dev)

    total_before = total_after = 0
    print(f"{'weight':<36} {'shape':>14} {'rank':>5} {'rel err':>9} "
          f"{'best':>7} {'ratio':>7}")
    for name, w in model.named_parameters():
        mat = w.detach().to(torch.float32)
        total_before += w.numel()
        if (w.ndim != 2 or min(mat.shape) < args.min_dim
                or args.rank >= min(mat.shape) // 2):
            total_after += w.numel()
            continue
        host = mat.cpu().numpy()
        # the largest weights go in as host arrays (out-of-core streaming),
        # the rest as tensors on the device (block iteration in memory)
        target = host if mat.shape[0] >= 4096 else mat
        res = svd(target, args.rank, device=dev, method="block", n_blocks=4,
                  eps=1e-6, max_iters=50)
        rec = (res.U * res.S) @ res.V.mT
        err = float(torch.linalg.norm(mat - rec) / torch.linalg.norm(mat))
        s = np.linalg.svd(host.astype(np.float64), compute_uv=False)
        best = float(np.sqrt(np.sum(s[args.rank:] ** 2) / np.sum(s ** 2)))
        if not err <= best * (1 + 1e-2) + 1e-6:
            print(f"{name}: rank-{args.rank} error {err:.4f} above the best "
                  f"{best:.4f}", file=sys.stderr)
            return 1
        lr_size = args.rank * (mat.shape[0] + mat.shape[1] + 1)
        total_after += lr_size
        print(f"{name:<36} {str(tuple(mat.shape)):>14} {args.rank:>5} "
              f"{err:>9.3f} {best:>7.3f} {w.numel() / lr_size:>6.1f}x")
        with torch.no_grad():
            w.copy_(rec.to(w.dtype))

    print(f"\nmodel params: {total_before / 1e6:.2f}M -> "
          f"{total_after / 1e6:.2f}M ({total_before / total_after:.2f}x "
          f"smaller)")
    # the compressed model still runs
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g).to(dev)
    logits = T.forward(model, toks)
    if not bool(torch.isfinite(logits).all()):
        print("compressed model: non-finite logits", file=sys.stderr)
        return 1
    print("compressed model forward pass: OK (finite logits)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
