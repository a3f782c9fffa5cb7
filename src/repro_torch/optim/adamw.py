"""AdamW + cosine schedule + global-norm clipping (the port of the JAX
package's ``repro/optim/adamw.py``).

Over dicts of tensors keyed by the port's parameter names.  Every update
is in fp32 and cast back to the parameter's dtype; the moments are kept
in ``moment_dtype`` (bf16 halves optimizer memory).  ``apply_updates``
writes the parameters and the moments in place: for qwen3-0.6b the
moments alone are 4.77 GB in fp32, and a second copy of them and of the
parameters would only cost memory.

Weight decay follows the JAX package's rule, ``ndim >= 2`` of the JAX
leaf a parameter belongs to: ``models.convert.decayed`` gives that set
(the port's per-layer norm scales are 1-D but their stacked JAX leaves
are not).  Without it, a parameter's own ``ndim`` decides, which is the
JAX rule for a flat tree.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: str = "float32"   # "bfloat16" halves optimizer memory


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio``, in fp32."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: dict, cfg: AdamWConfig) -> dict:
    """``{"m": {name: zeros}, "v": {name: zeros}, "count": int32 0}``,
    the moments in ``moment_dtype`` on each parameter's device."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = next(iter(params.values())).device if params else None
    return {"m": {n: zeros(p) for n, p in params.items()},
            "v": {n: zeros(p) for n, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in fp32."""
    tensors = list(tensors)
    if not tensors:
        return _f32(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(t.to(torch.float32)))
                          for t in tensors))


def clip_by_global_norm(grads: dict, max_norm: float, norm=None):
    """(grads scaled to a global norm of at most ``max_norm``, the norm
    before); a new dict, the scale cast to each gradient's dtype.
    ``norm``: the global norm where the caller computed it (a sharded
    step: the norm of every rank's shards)."""
    gn = global_norm(grads.values()) if norm is None else norm
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                  decay: set | None = None, norm=None) -> dict:
    """One AdamW step on ``params`` (tensors or ``nn.Parameter``s, written
    in place) with ``grads`` (same keys); ``state`` (``init_opt_state``)
    is updated in place.  ``decay`` names the parameters that take weight
    decay (default: ``ndim >= 2``); ``norm`` is the gradients' global norm
    where the caller computed it (``clip_by_global_norm``).  Returns
    ``{"grad_norm", "lr"}``."""
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, norm)
    state["count"] = state["count"] + 1
    c = state["count"].to(torch.float32)
    lr = schedule(cfg, c).to(c.device)
    bc1 = 1.0 - _f32(cfg.b1, c.device) ** c
    bc2 = 1.0 - _f32(cfg.b2, c.device) ** c
    for name, p in params.items():
        g32 = grads[name].to(torch.float32)
        m, v = state["m"][name], state["v"][name]
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g32
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if (p.ndim >= 2) if decay is None else (name in decay):
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
    return {"grad_norm": gn, "lr": lr}
