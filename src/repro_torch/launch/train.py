"""Training launcher (the port of the JAX package's
``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch qwen3-0.6b --steps 20 \\
        --batch 8 --seq 2048 --compress --loss-chunks 8      # one card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --device cpu --steps 5 --batch 4 --seq 32
    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        -m repro_torch.launch.train --mesh 2,2 --arch qwen3-0.6b --smoke \\
        --device cpu --steps 5 --batch 4 --seq 32         # sharded

``--arch`` is qwen3-0.6b unless given; ``--smoke`` trains the reduced
same-family config.  The run is on the
card unless ``--device cpu`` is given (and raises where no card is
visible and none was asked for).  ``--compress`` turns on the paper's
power-method gradient compression (rank 8, ``optim/compression.py``;
it factors leaves of 65536 elements or more, which no leaf of a
``--smoke`` config reaches, so there every leaf passes whole);
``--loss-chunks`` sets the config's ``loss_chunks`` (the LM head and
cross entropy in that many sequence chunks).  The runner checkpoints
atomically into ``--ckpt-dir`` and resumes from its latest step, and the
data are ``(seed, step)``-pure, so re-launching the command continues
the run.

``--mesh DATA,MODEL`` (or ``POD,DATA,MODEL``) trains the sharded LM
(``make_train_step(cfg, tc, mesh)``, FSDP over ``data``, tensor
parallel over ``model``, the batch over ``pod`` and ``data``) on the
ranks ``torchrun`` starts; ``--mesh production`` takes the paper's
``(16, 16)`` or ``(2, 16, 16)`` layout at 256 or 512 ranks.  The process
group is gloo on the CPU, and on the card NCCL where each rank has a
card of its own, else gloo (NCCL refuses two ranks on one card).  Each
rank takes its rows of the global batch, the first rank logs and writes
the checkpoints, and a relaunch resumes on any mesh (with ``--compress``,
on any mesh of the same pod count: each pod keeps its own error
buffers).  ``--compress`` with ``--mesh`` compresses across ranks: on
``POD,DATA,MODEL`` each pod takes its own rows' gradient and only the
rank-r factors and the uncompressed leaves cross pods; on
``DATA,MODEL`` the synced gradients' leaves are factored from their
shards::

    PYTHONPATH=src torchrun --standalone --nproc_per_node 4 \\
        -m repro_torch.launch.train --mesh 2,1,2 --compress --smoke \\
        --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.core.operator import resolve_device
from repro_torch.launch.mesh import mesh_from_arg
from repro_torch.data import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compression import CompressionConfig
from repro_torch.training import TrainConfig
from repro_torch.training.runner import RunnerConfig, TrainingRunner


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress", action="store_true",
                    help="power-method (rank-8) gradient compression")
    ap.add_argument("--loss-chunks", type=int, default=None,
                    help="the config's loss_chunks (default: the config's)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default; needs a card) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="DATA,MODEL or POD,DATA,MODEL (under torchrun), "
                         "or 'production'")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None if args.mesh is None else mesh_from_arg(args.mesh, dev)
    first = mesh is None or dist.get_rank() == 0
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.loss_chunks is not None:
        cfg = dataclasses.replace(cfg, loss_chunks=args.loss_chunks)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if first:
        on = "" if mesh is None else " mesh=" + "x".join(
            f"{n}{k}" for n, k in zip(mesh.mesh_dim_names, mesh.mesh.shape))
        print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
              f"device={where}{on}")

    tc = TrainConfig(
        adamw=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                          total_steps=args.steps),
        compression=CompressionConfig(enabled=args.compress),
        microbatches=args.microbatches)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, family=cfg.family,
                    num_codebooks=cfg.num_codebooks,
                    patch_positions=cfg.patch_positions,
                    d_model=cfg.d_model)
    rc = RunnerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=10)
    runner = TrainingRunner(cfg, tc, rc, dc, mesh=mesh,
                            device=dev if mesh is None else None)
    state = runner.run()
    losses = [h["loss"] for h in runner.history]
    if losses and first:
        print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return {"losses": losses, "state": state}


if __name__ == "__main__":
    main()
