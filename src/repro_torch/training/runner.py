"""Fault-tolerant training runner: checkpoint-restart (the port of the
JAX package's ``repro/training/runner.py``).

* checkpoints every ``ckpt_every`` steps and at the end, atomically, in
  the port's ``CheckpointManager`` (``arrays.npz`` + ``meta.json``; the
  train state as a tree of tensors, ``TrainState.tree``);
* ``failure_hook(step)`` is called before each step, so a test can plant
  a fault at any step;
* a step that raises (a planted fault, or a non-finite loss) restores the
  latest checkpoint (or a fresh state when there is none) and replays
  from there, at most ``max_restarts`` times.

The data pipeline is ``(seed, step)``-pure and every kernel of the step
sums in a fixed order, so a resumed run repeats the uninterrupted one
bit for bit.

With a ``mesh`` (every rank runs the runner): the state is the rank's
shards on the mesh's device, each step takes the rank's rows of the
global batch, a checkpoint is the whole state gathered through
``core/collectives.py`` and written by the first rank (the others wait
for it), a restore cuts each rank's shards from it (onto a mesh of any
shape), and only the first rank logs.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
from typing import Callable

import numpy as np
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.operator import resolve_device
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.models.config import ModelConfig
from repro_torch.training.train import (TrainConfig, TrainState,
                                        init_train_state, make_train_step)

log = logging.getLogger("repro_torch.runner")


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    max_restarts: int = 3
    log_every: int = 10


class TrainingRunner:
    def __init__(self, cfg: ModelConfig, tc: TrainConfig, rc: RunnerConfig,
                 data_cfg: DataConfig, mesh=None,
                 failure_hook: Callable[[int], None] | None = None, *,
                 device=None, seed: int = 0):
        self.cfg, self.tc, self.rc = cfg, tc, rc
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else None
        self.first = mesh is None or dist.get_rank() == 0
        self.seed = seed
        self.data = SyntheticLMDataset(data_cfg)
        self.ckpt = CheckpointManager(rc.ckpt_dir, keep=3)
        self.failure_hook = failure_hook or (lambda step: None)
        self.step_fn = make_train_step(cfg, tc, mesh)
        self.history: list[dict] = []
        self.restarts = 0

    def _fresh_state(self) -> TrainState:
        return init_train_state(self.cfg, self.tc, seed=self.seed,
                                device=self.device, mesh=self.mesh)

    def _restore(self, state: TrainState, step: int) -> TrainState:
        state.load_tree(self.ckpt.restore(step, state.like()))
        return state

    def _save(self, step: int, state: TrainState) -> None:
        tree = state.tree()              # gathered on every rank
        if self.first:
            self.ckpt.save(step, tree)
        if self.mesh is not None:
            dist.barrier()

    def run(self) -> TrainState:
        state = self._fresh_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self._restore(state, latest)
            start = latest
            log.info("resumed from checkpoint step %d", start)

        step = start
        while step < self.rc.total_steps:
            try:
                self.failure_hook(step)
                state, metrics = self.step_fn(state, self.data.batch(step))
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
                self.history.append({"step": step, "loss": loss})
                if step % self.rc.log_every == 0 and self.first:
                    log.info("step %d loss %.4f", step, loss)
                step += 1
                if step % self.rc.ckpt_every == 0 or \
                        step == self.rc.total_steps:
                    self._save(step, state)
            except Exception as e:  # noqa: BLE001 — the watchdog boundary
                self.restarts += 1
                log.warning("step %d failed (%s); restart %d/%d",
                            step, e, self.restarts, self.rc.max_restarts)
                if self.restarts > self.rc.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    state = self._fresh_state()
                    step = 0
                else:
                    state = self._restore(state, latest)
                    step = latest
        return state
