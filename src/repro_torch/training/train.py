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

The sharded mode, plain (``make_train_step(cfg, tc, mesh)`` on a
``("data", "model")`` or ``("pod", "data", "model")`` ``DeviceMesh``;
the JAX package's GSPMD step, as explicit SPMD): every rank runs the
step on its shards (``init_train_state(..., mesh=)``) and its rows of the
global batch, which split over ``("pod", "data")`` in the JAX rule's
order (rank ``(p, d)`` takes row block ``p * |data| + d``; with
microbatches, of each microbatch of the global batch, as the JAX
package's ``_microbatch`` splits before GSPMD shards).  The layers issue
their collectives (``core/parallel.py``); the loss and the metrics are
the global batch's.  Gradients: an FSDP leaf's come reduce-scattered
over ``data`` by the backward of its gather; every leaf is then
all-reduced over the batch axes its spec does not shard (``pod``, and
``data`` where it is replicated there).  ``grad_norm`` counts each
element of the model once (a shard on the ranks at coordinate 0 of every
axis it is replicated over), AdamW runs on the local shards, and
``TrainState.tree`` gathers the whole state through
``core/collectives.py`` for a checkpoint (``load_tree`` cuts it again,
onto a mesh of any shape).

The sharded mode, compressed (``TrainConfig.compression`` on a mesh;
``optim/compression.py``'s power step on the ranks' shards):

* on a mesh without ``pod`` (the JAX package's ``train.py:150-178``):
  the gradients sync as in the plain step, then each compressed leaf is
  factored whole from its shards;
* on a ``("pod", "data", "model")`` mesh (its cross-pod mode,
  ``:180-229``): each pod takes the gradient of its own rows (pod block
  first, then microbatch, then data block, as the JAX package's
  ``P("pod")`` batch and ``_microbatch``), synced over ``data`` only and
  scaled by the pod count (the objective divides by the global batch,
  ``per_pod`` by the pod's); each pod keeps its own error buffers, and
  only the rank-r factors and the uncompressed leaves cross ``pod``.

AdamW then runs on the decompressed shards, the same bits on every pod.
``TrainState.tree`` holds ``Q`` replicated and ``err`` whole in the JAX
package's layout (stacked ``(npods, ...)`` over ``pod`` in the cross-pod
mode), and ``load_tree`` cuts it onto a mesh with the same pod count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import collectives as coll
from repro_torch.core import parallel
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
    plan: parallel.Plan | None = None   # the rank's plan when sharded

    def tree(self) -> dict:
        """The state as a tree of tensors (what a checkpoint holds); when
        sharded, the whole state, gathered on every rank (a collective)."""
        params = dict(self.model.named_parameters())
        o, c = self.opt, self.comp
        if self.plan is not None:
            un = self.plan.unshard
            o = {"m": {n: un(t, params[n].spec) for n, t in o["m"].items()},
                 "v": {n: un(t, params[n].spec) for n, t in o["v"].items()},
                 "count": o["count"]}
            if c is not None:
                c = {"Q": c["Q"], "err": {path: self._whole_err(leaf, e)
                                          for (path, e), leaf in zip(
                                              c["err"].items(),
                                              self._leaves(c["err"]))}}
            params = {n: un(p, p.spec) for n, p in params.items()}
        return {"params": params, "opt": o, "comp": c,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def _leaves(self, paths) -> list:
        """The layout's leaves of ``paths``, in their order."""
        by_path = {leaf.path: leaf for leaf in LV.leaf_layout(self.model)}
        return [by_path[p] for p in paths]

    def _pods(self) -> int | None:
        """The pod count the error buffers are stacked over (``None``:
        not stacked)."""
        if self.plan is None or "pod" not in self.plan.names:
            return None
        return self.plan.sizes["pod"]

    def _whole_err(self, leaf, e):
        """A rank's error buffer as the JAX package holds it: the whole
        leaf, stacked over the pods in the cross-pod mode."""
        whole = self.plan.unshard(e, leaf.spec)
        if self._pods() is None:
            return whole
        group = self.plan.group(("pod",))
        if group is None:
            return whole[None]
        return coll.all_gather(whole[None], group, axes="pod")

    def like(self) -> dict:
        """A tree of ``tree()``'s structure and dtypes for a checkpoint's
        restore: ``tree()`` itself in one process; when sharded, 0-dim
        host stand-ins (a restore keeps the saved shapes), so nothing is
        gathered."""
        if self.plan is None:
            return self.tree()
        stand = lambda t: torch.zeros((), dtype=t.dtype)
        params = dict(self.model.named_parameters())
        c = self.comp
        if c is not None:
            c = {key: {p: stand(t) for p, t in c[key].items()}
                 for key in ("Q", "err")}
        return {"params": {n: stand(p) for n, p in params.items()},
                "opt": {"m": {n: stand(t) for n, t in self.opt["m"].items()},
                        "v": {n: stand(t) for n, t in self.opt["v"].items()},
                        "count": stand(self.opt["count"])},
                "comp": c,
                "step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def load_tree(self, tree: dict) -> None:
        """Take ``tree`` (``tree()``'s structure: the whole state) as the
        state, in place; when sharded, each rank keeps its shards.  Error
        buffers stacked over another pod count than this state's (or
        stacked where it keeps none, or the other way) raise
        ``ValueError``: each pod's buffer is its own."""
        comp_tree = tree.get("comp")
        if self.plan is not None and self.comp is None:
            comp_tree = None                # a plain sharded run
        if comp_tree is not None:
            self._check_pods(comp_tree["err"])
        params = dict(self.model.named_parameters())
        cut = ((lambda t, n: t) if self.plan is None else
               (lambda t, n: self.plan.shard(t, params[n].spec)))
        for name, value in tree["params"].items():
            params[name].copy_(cut(value, name))
        if self.plan is None:
            self.opt = tree["opt"]
        else:
            for key in ("m", "v"):
                for n, t in self.opt[key].items():
                    t.copy_(cut(tree["opt"][key][n], n))
            self.opt["count"] = tree["opt"]["count"].to(
                self.opt["count"].device)
        if self.plan is None:
            self.comp = comp_tree
        elif comp_tree is not None:
            pods = self._pods()
            for path, q in comp_tree["Q"].items():
                self.comp["Q"][path].copy_(q)
            for leaf in self._leaves(comp_tree["err"]):
                e = comp_tree["err"][leaf.path]
                if pods is not None:
                    e = e[self.plan.coord["pod"]]
                self.comp["err"][leaf.path].copy_(
                    self.plan.shard(e, leaf.spec))
        self.step = int(tree["step"])

    def _check_pods(self, errs: dict) -> None:
        want = self._pods()
        for leaf in self._leaves(errs):
            shape = tuple(errs[leaf.path].shape)
            saved = (shape[0] if len(shape) == leaf.ndim + 1
                     and shape[1:] == leaf.shape else None)
            if saved is None and shape != leaf.shape:
                raise ValueError(f"{leaf.path}: an error buffer of shape "
                                 f"{shape} for a leaf of {leaf.shape}")
            if saved != want:
                name = lambda n: ("no pod axis" if n is None else
                                  f"{n} pod" + "s" * (n != 1))
                raise ValueError(
                    f"the checkpoint's error buffers are of {name(saved)}, "
                    f"this state's of {name(want)}: each pod keeps its own, "
                    f"so they restore only onto the same pod count")


def train_state_specs(cfg: ModelConfig, tc: TrainConfig) -> dict:
    """Logical axes of ``TrainState.tree()`` (the JAX package's
    ``train_state_specs``, ``train.py:73-86``): the parameters' and the
    moments' by the port's names (``models.transformer.model_specs``),
    ``count`` and ``step`` scalars, and with compression ``Q`` replicated
    and ``err`` as its JAX leaf (a stacked leaf with ``"layers"`` first),
    by leaf path."""
    pspecs = T.model_specs(cfg)
    cspecs = None
    if tc.compression.enabled:
        leaves = [leaf for leaf in LV.leaf_layout(T.Transformer(
            cfg, torch.device("meta"))) if comp.compressed(leaf,
                                                          tc.compression)]
        cspecs = {"Q": {leaf.path: (None, None) for leaf in leaves},
                  "err": {leaf.path: (("layers",) if leaf.stacked else ())
                          + tuple(pspecs[leaf.names[0]]) for leaf in leaves}}
    return {"params": pspecs,
            "opt": {"m": pspecs, "v": pspecs, "count": ()},
            "comp": cspecs, "step": ()}


def init_train_state(cfg: ModelConfig, tc: TrainConfig, *, seed: int = 0,
                     device=None, mesh=None) -> TrainState:
    """The model from ``seed`` (``models.transformer.init_model``), zero
    moments, and the compression's warm-start subspaces and zero error
    buffers when enabled; on ``device`` (``None``: the card).  With a
    ``mesh`` (every rank calls it), the rank's shards of that same model
    on the mesh's device, bitwise the one-process model's slices."""
    if mesh is not None:
        plan = parallel.Plan(mesh)
        model = T.init_model(cfg, seed=seed, plan=plan)
        c = None
        if tc.compression.enabled:
            c = comp.init_state(LV.leaf_layout(model), tc.compression,
                                plan.device)
        return TrainState(model=model, opt=opt.init_opt_state(
            dict(model.named_parameters()), tc.adamw), comp=c, step=0,
            plan=plan)
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


def local_rows(batch: dict, plan: parallel.Plan, n_micro: int = 1,
               pod_first: bool = False) -> dict:
    """The rank's rows of a global batch: of each of the ``n_micro``
    microbatches (row blocks of the global batch), block
    ``plan.batch_index`` of ``plan.n_batch``, in microbatch order.
    ``pod_first`` (the cross-pod compressed mode): the pod's row block
    first, then each of its microbatches' ``data`` block."""
    out = {}
    nb, j = plan.n_batch, plan.batch_index
    pods = plan.count(("pod",)) if "pod" in plan.names else 1
    for key, x in batch.items():
        B = x.shape[0]
        if B % (n_micro * nb):
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches over {nb} batch shards")
        b = B // (n_micro * nb)
        if pod_first and pods > 1:
            x = x.reshape(pods, n_micro, nb // pods, b, *x.shape[1:])[
                plan.coord["pod"], :, plan.coord["data"]]
        else:
            x = x.reshape(n_micro, nb, b, *x.shape[1:])[:, j]
        out[key] = x.reshape(n_micro * b, *x.shape[2:])
    return out


def _sync_grads(grads: dict, params: dict, plan: parallel.Plan,
                batch_axes: tuple) -> None:
    """All-reduce each gradient, in place, over the ``batch_axes`` its
    parameter's spec does not shard (an FSDP shard's gradient is already
    summed over ``data`` by the backward of its gather)."""
    from repro_torch import sharding
    for n, g in grads.items():
        spec = params[n].spec
        held = {a for i in range(len(spec))
                for a in sharding.dim_axes(spec, i)}
        axes = tuple(a for a in batch_axes if a not in held)
        group = plan.group(axes)
        if group is not None:
            coll.all_reduce(g, group, axes=plan.label(axes))


def _sharded_norm(grads: dict, params: dict, plan: parallel.Plan):
    """The global norm of the whole model's gradient: each shard's sum of
    squares counted on the ranks at coordinate 0 of every axis it is
    replicated over, summed over every rank."""
    from repro_torch import sharding
    dev = plan.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for n, g in grads.items():
        spec = params[n].spec
        held = {a for i in range(len(spec))
                for a in sharding.dim_axes(spec, i)}
        if all(plan.coord[a] == 0 for a in plan.names if a not in held):
            total = total + torch.sum(torch.square(g.to(torch.float32)))
    group = plan.group(plan.names)
    if group is not None:
        coll.all_reduce(total, group, axes=plan.label(plan.names))
    return torch.sqrt(total)


def _sharded_step(cfg: ModelConfig, tc: TrainConfig, mesh):
    compress = tc.compression.enabled
    def step(state: TrainState, batch: dict):
        plan = state.plan
        if plan is None or plan.mesh is not mesh:
            raise ValueError("a sharded step takes the state that "
                             "init_train_state(..., mesh=) made on its mesh")
        model = state.model
        n_micro = tc.microbatches
        per_pod = compress and "pod" in plan.names
        local = to_device(local_rows(
            {k: np.asarray(v) if not isinstance(v, torch.Tensor) else v
             for k, v in batch.items()}, plan, n_micro, per_pod),
            plan.device)
        # a checkpointed region's recompute reissues all of its forward
        # collectives (``training/schedule.py``), not a prefix of them
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            grads, metrics = _grads_and_metrics(model, local, n_micro)
        params = dict(model.named_parameters())
        layout = LV.leaf_layout(model)
        if per_pod:
            # each pod's gradient of the mean over its own rows
            _sync_grads(grads, params, plan, ("data",))
            for g in grads.values():
                g.mul_(plan.sizes["pod"])
        else:
            _sync_grads(grads, params, plan, plan.batch_axes)
        if compress:
            grads, state.comp, cs = comp.compress_grads(
                grads, state.comp, tc.compression, layout, plan=plan)
            metrics.update(cs)
        gn = _sharded_norm(grads, params, plan)
        om = opt.apply_updates(params, grads, state.opt, tc.adamw,
                               LV.decayed(layout), norm=gn)
        metrics.update(om)
        state.step += 1
        return state, metrics

    return step


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """``step(state, batch) -> (state, metrics)``; ``batch`` holds numpy
    arrays or tensors (with a mesh, the global batch: each rank takes its
    rows).  Metrics: ``loss``, ``aux``, ``grad_norm``, ``lr`` and, with
    compression, ``compress_ratio`` (0-dim tensors)."""
    if mesh is not None:
        return _sharded_step(cfg, tc, mesh)

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
