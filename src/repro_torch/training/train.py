"""Train step assembly: microbatching, the optimizer and the power-method
gradient compression (the port of the JAX package's
``repro/training/train.py``).

The single-program mode (``train.py:150-180`` there): one process
computes the gradients of the whole batch (microbatches summed in fp32,
then divided by their count), compresses them when
``TrainConfig.compression`` is enabled (``optim/compression.py``: two
block sweeps a compressed leaf, on the card the hand-written 3xTF32
kernels), and applies AdamW.  Parameters, moments and compression state
are updated in place; ``step`` returns the same ``TrainState``.

Not ported: the cross-pod compressed mode (``train.py:181-229``), in
which each pod keeps its own error buffers and only the compressed
factors cross pods, and any sharded single-program run; ``make_train_step``
raises for a mesh, naming the ``ROADMAP.md`` item.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.operator import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw as opt
from repro_torch.optim import compression as comp
from repro_torch.models import convert as LV


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adamw: opt.AdamWConfig = opt.AdamWConfig()
    compression: comp.CompressionConfig = comp.CompressionConfig(
        enabled=False)
    microbatches: int = 1


@dataclasses.dataclass
class TrainState:
    model: T.Transformer
    opt: dict                   # adamw.init_opt_state over the parameters
    comp: dict | None           # compression.init_state, when enabled
    step: int

    def tree(self) -> dict:
        """The state as a tree of tensors (what a checkpoint holds)."""
        return {"params": dict(self.model.named_parameters()),
                "opt": self.opt, "comp": self.comp,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Take ``tree`` (``tree()``'s structure) as the state, in place."""
        params = dict(self.model.named_parameters())
        for name, value in tree["params"].items():
            params[name].copy_(value)
        self.opt, self.comp = tree["opt"], tree["comp"]
        self.step = int(tree["step"])


def init_train_state(cfg: ModelConfig, tc: TrainConfig, *, seed: int = 0,
                     device=None) -> TrainState:
    """The model from ``seed`` (``models.transformer.init_model``), zero
    moments, and the compression's warm-start subspaces and zero error
    buffers when enabled; on ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    model = T.init_model(cfg, seed=seed, device=dev)
    params = dict(model.named_parameters())
    c = None
    if tc.compression.enabled:
        c = comp.init_state(LV.leaf_layout(model), tc.compression, dev)
    return TrainState(model=model, opt=opt.init_opt_state(params, tc.adamw),
                      comp=c, step=0)


def to_device(batch: dict, device) -> dict:
    """A numpy batch (``data.SyntheticLMDataset.batch``) as int64 or
    float32 tensors on ``device``."""
    out = {}
    for key, x in batch.items():
        x = torch.as_tensor(np.asarray(x))
        out[key] = x.to(device=device, dtype=torch.int64 if key in (
            "tokens", "labels") else torch.float32)
    return out


def _grads_and_metrics(model: T.Transformer, batch: dict, n_micro: int):
    """(gradients ``{name: tensor}``, ``{"loss", "aux"}``); over
    ``n_micro`` microbatches the gradients are summed in fp32 and divided
    by ``n_micro``."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]

    def grads_of(mb):
        total, m = T.loss_fn(model, mb)
        gs = torch.autograd.grad(total, params, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for p, g in zip(params, gs)]
        return dict(zip(names, gs)), m

    if n_micro == 1:
        grads, m = grads_of(batch)
        return grads, {"loss": m["loss"].detach(), "aux": m["aux"].detach()}
    B = next(iter(batch.values())).shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} "
                         f"microbatches")
    acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for n, p in zip(names, params)}
    loss_sum = torch.zeros((), dtype=torch.float32, device=params[0].device)
    for i in range(n_micro):
        sl = slice(i * (B // n_micro), (i + 1) * (B // n_micro))
        g, m = grads_of({k: v[sl] for k, v in batch.items()})
        for n in names:
            acc[n] += g[n].to(torch.float32)
        loss_sum = loss_sum + m["loss"].detach()
        del g
    grads = {n: a / n_micro for n, a in acc.items()}
    return grads, {"loss": loss_sum / n_micro,
                   "aux": torch.zeros((), dtype=torch.float32,
                                      device=loss_sum.device)}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds numpy
    arrays or tensors.  Metrics: ``loss``, ``aux``, ``grad_norm``, ``lr``
    and, with compression, ``compress_ratio`` (0-dim tensors)."""
    if mesh is not None:
        raise NotImplementedError(
            "training over a mesh is not ported yet (ROADMAP.md, queue 1, "
            + ("item 16: cross-rank compressed training, only the factors "
               "crossing ranks, per-rank error buffers)"
               if tc.compression.enabled else
               "item 13: LM side, the sharded LM)"))
    def step(state: TrainState, batch: dict):
        model = state.model
        layout = LV.leaf_layout(model)
        dev = next(model.parameters()).device
        grads, metrics = _grads_and_metrics(model, to_device(batch, dev),
                                            tc.microbatches)
        if tc.compression.enabled:
            grads, state.comp, cs = comp.compress_grads(
                grads, state.comp, tc.compression, layout)
            metrics.update(cs)
        om = opt.apply_updates(dict(model.named_parameters()), grads,
                               state.opt, tc.adamw, LV.decayed(layout))
        metrics.update(om)
        state.step += 1
        return state, metrics

    return step
