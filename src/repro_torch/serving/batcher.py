"""Micro-batcher: a burst of small same-shape solves as ONE dispatch
(PyTorch port of the JAX package's ``repro/serving/batcher.py``).

A serving process sees storms of small decompositions (per-user
embedding blocks, per-layer weight tiles) where the python driver loop
plus per-iteration dispatch costs more than the math.  The batcher
groups queued jobs by ``batch_key`` — identical (m, n, k, solver
knobs) — stacks their inputs into an ``(B, m, n)`` tensor on the
service's device, and runs the SAME block subspace iteration the engine
runs per job (the sweep-dtype policy of ``sweep_ops``, thin-QR
orthonormalization, rotation-invariant subspace gap, Rayleigh–Ritz
extraction through ``core/tsvd.py::rayleigh_ritz_from_W``) on every lane
at once.  The JAX package's ``vmap`` + ``lax.while_loop`` becomes:

* **the sweeps**: two ``torch.bmm`` a step over the stacked lanes.  The
  JAX package computes this product with ``jnp.matmul`` under ``vmap``,
  outside any Pallas kernel, so this is a library product in both.
  fp32 lanes are full fp32 (the batcher sets no TF32 flag).  bf16 lanes
  follow ``sweep_ops``: ``X`` rounded to bf16 once, ``Q`` and ``Y``
  rounded as they enter a product, the sums and ``Z = X^T Y`` fp32
  (``bmm(..., out_dtype=torch.float32)`` on the card, the rounded
  operands upcast on the CPU, whose products are exact in fp32);
  the extraction's ``W = X Q`` reads the fp32 ``X``;
* **the loop**: a Python loop over steps with per-lane ``done`` and
  ``iters`` on the device.  Frozen lanes keep their ``Q`` and gap (a
  non-finite gap freezes a lane too).  The stop test ``all(done)`` is
  the one device read a step, and it is read one step late: its copy
  starts when it is produced and is read after the next step is queued,
  so the host never waits on a step in flight.  A step in which every
  lane is already frozen changes no lane, so that costs one step of
  work and alters no result;
* **the RNG**: each lane draws what the port's ``DenseOperator`` draws
  for its seed — ``random_block`` for a cold start, ``range_sketch``'s
  Omega for the warm start — so a lane and the same job's standalone
  ``repro_torch.svd`` start from the same ``Q0``.

One builder per signature (``batched_block_solve_fn``, behind a lock):
there is nothing to compile, but the cached builder keeps the JAX
package's surface and its race-free contract.

Contracts (``tests/test_torch_serving_batch.py``):

* **differential** — each lane's (S, subspace) agrees with a standalone
  per-job ``svd()`` at the same config, on both the dense and the
  host-blocked per-job baselines, of both packages;
* **isolation** — lanes are numerically independent, so a poisoned
  lane (NaN input) fails ALONE: its gap goes non-finite, the loop stops
  iterating it, its extraction is skipped, and the per-lane health check
  fails just that job with the engine's typed ``NumericalHealthError``
  while its batchmates complete;
* **honest accounting** — per-lane ``passes_over_A``/``bytes_moved``
  follow the engine's counting convention (2 passes per iteration +
  warmup + extraction) against the lane's own iteration count.

Stragglers — a flush with a single job, or any job whose input/config
the batcher cannot stack — fall back to the sequential runner
unchanged.
"""
from __future__ import annotations

import functools
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.config import SVDResult
from repro_torch.core.errors import NumericalHealthError
from repro_torch.core.operator import (host_sync_scalar, resolve_device,
                                       stage_scalar, warm_start_width)
from repro_torch.core.precision import dtype_name, resolve_sweep_dtype
from repro_torch.core.tsvd import rayleigh_ritz_from_W, seeded_generator

__all__ = ["batch_key", "batchable", "solve_batch",
           "batched_block_solve_fn", "MAX_BATCH_ELEMS"]

#: lanes bigger than this are not worth stacking (the solve dominates
#: the dispatch overhead; they also inflate the batch's memory peak)
MAX_BATCH_ELEMS = 1 << 18


def batchable(spec) -> bool:
    """True iff this job can ride a stacked batch: a small in-memory
    dense 2-D array (a torch tensor or a numpy array), block method, no
    per-job plumbing (checkpoints, trace hooks, streaming) that needs the
    scalar driver."""
    cfg = spec.resolved_config()
    if cfg.method != "block" or cfg.on_iteration is not None:
        return False
    if cfg.checkpoint_dir is not None or cfg.force_iters:
        return False
    if getattr(spec, "stream_every", 0):
        return False
    A = spec.input
    if isinstance(A, np.memmap):         # staged tiers: never stack
        return False
    if not isinstance(A, (np.ndarray, torch.Tensor)):
        return False
    if A.ndim != 2 or A.shape[0] * A.shape[1] > MAX_BATCH_ELEMS:
        return False
    return min(A.shape) >= 1 and spec.k <= min(A.shape)


def batch_key(spec) -> tuple:
    """Jobs stack iff this key matches: same shape/rank and the same
    trajectory-defining solver knobs plus the budget knobs the loop
    runs on (the seed is per lane, not a key)."""
    cfg = spec.resolved_config()
    A = spec.input
    return (int(A.shape[0]), int(A.shape[1]), int(spec.k),
            cfg.method, cfg.warmup_q, cfg.oversample, cfg.sweep_dtype,
            float(cfg.eps), int(cfg.max_iters))


#: serializes builder-cache misses: ``lru_cache`` alone does NOT dedupe
#: concurrent first calls — racing worker threads would each build their
#: own copy of the same signature
_BUILDER_LOCK = threading.Lock()


def _bmm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` batched, with fp32 sums and an fp32 result, for operands
    already in the sweep dtype: on the card bf16 operands go to
    ``bmm(..., out_dtype=torch.float32)``; on the CPU they are upcast,
    and their products are exact in fp32."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _orth(X: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(X).Q


@functools.lru_cache(maxsize=None)
def _batched_block_solve_fn(m: int, n: int, k: int, l: int,
                            sweep_dtype: str, eps: float,
                            max_iters: int, warmup_q: int):
    """Build (once per signature) the batched block solve.

    Returns ``solve(X, seeds) -> (U, S, V, iters, gaps, converged)`` with
    ``X: (B, m, n)`` stacked tall fp32 inputs on one device and ``seeds``
    one integer a lane; every output is per-lane, on ``X``'s device.

    The iteration mirrors ``core/svd.py::step`` in its unlagged form:
    ``Q <- orth(A^T A Q)``, gap ``l - ||Q^T Qn||_F^2``, stop per lane at
    ``gap <= eps * l``.  Non-finite gaps also stop the lane (so a NaN
    lane cannot spin its batchmates to max_iters); the caller maps those
    lanes to typed failures.
    """
    tol = float(eps) * l
    sd = resolve_sweep_dtype(sweep_dtype)

    def solve(X: torch.Tensor, seeds):
        dev = X.device
        Xs = X.to(sd)                        # rounded once (no copy: fp32)
        mm = lambda Q: _bmm_fp32(Xs, Q.to(sd))
        rmm = lambda Y: _bmm_fp32(Xs.mT, Y.to(sd))
        gens = [seeded_generator(dev, s) for s in seeds]
        if warmup_q > 0:                     # DenseOperator.range_sketch
            Om = torch.stack([torch.randn((m, l), generator=g, device=dev,
                                          dtype=torch.float32)
                              for g in gens])
            Q = _orth(rmm(Om))
            for _ in range(warmup_q):
                Q = _orth(rmm(mm(Q)))
        else:                                # DenseOperator.random_block
            Q = _orth(torch.stack([torch.randn((n, l), generator=g,
                                               device=dev,
                                               dtype=torch.float32)
                                   for g in gens]))
        B = Q.shape[0]
        it = torch.zeros((B,), dtype=torch.int32, device=dev)
        gap = torch.full((B,), float("inf"), dtype=torch.float32,
                         device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        steps, all_done = 0, None
        while steps < max_iters:             # steps == it.max()
            Qn = _orth(rmm(mm(Q)))
            # per-lane rotation-invariant subspace gap (cf. operator._gap)
            g = l - torch.sum(torch.bmm(Q.mT, Qn) ** 2, dim=(1, 2))
            # frozen lanes keep their converged iterate + final gap
            Q = torch.where(done[:, None, None], Q, Qn)
            g = torch.where(done, gap, g)
            it = torch.where(done, it, it + 1)
            gap = g
            done = done | (g <= tol) | ~torch.isfinite(g)
            steps += 1
            # the previous step's test, read with this step queued
            if all_done is not None and host_sync_scalar(all_done):
                break
            all_done = stage_scalar(done.all())
        # a poisoned lane's iterate is skipped by the extraction (its SVD
        # would fail the whole batch) and reported non-finite instead
        ok = torch.isfinite(Q).flatten(1).all(1)
        W = torch.bmm(X, Q)                  # the fp32 X
        ok = ok & torch.isfinite(W).flatten(1).all(1)
        keep = ok[:, None, None]
        U, S, V = rayleigh_ritz_from_W(torch.where(keep, W, 0.0),
                                       torch.where(keep, Q, 0.0))
        S = torch.where(ok[:, None], S, float("nan"))
        conv = done & (gap <= tol) & torch.isfinite(gap)
        return (U[:, :, :k], S[:, :k], V[:, :, :k], it, gap, conv)

    return solve


def batched_block_solve_fn(m: int, n: int, k: int, l: int,
                           sweep_dtype: str, eps: float,
                           max_iters: int, warmup_q: int):
    """Race-free front of the cached builder: every thread asking for
    one signature gets the SAME callable."""
    with _BUILDER_LOCK:
        return _batched_block_solve_fn(m, n, k, l, sweep_dtype, eps,
                                       max_iters, warmup_q)


batched_block_solve_fn.cache_clear = _batched_block_solve_fn.cache_clear


def _lane(A, tall: bool) -> torch.Tensor:
    """One job's input as an fp32 tensor in the tall orientation (the
    caller moves the stack to the device)."""
    if not isinstance(A, torch.Tensor):
        A = torch.from_numpy(np.asarray(A, np.float32))
    A = A.to(torch.float32)
    return A if tall else A.mT


def solve_batch(specs: list, device=None
                ) -> list[tuple[Any, BaseException | None]]:
    """Run a stackable batch on ``device`` (``None`` = the card); returns
    one ``(SVDResult | None, error | None)`` per spec, positionally.
    Lanes whose extraction came back non-finite get ``(None,
    NumericalHealthError)`` — the batch itself never raises for a
    poisoned lane.  ``U``, ``S`` and ``V`` are tensors on ``device``, as
    a per-job ``svd()`` returns them.
    """
    dev = resolve_device(device)
    cfg0 = specs[0].resolved_config()
    sd = resolve_sweep_dtype(cfg0.sweep_dtype)
    A0 = specs[0].input
    m, n = int(A0.shape[0]), int(A0.shape[1])
    k = int(specs[0].k)
    tall = m >= n
    if not tall:
        m, n = n, m
    l = warm_start_width(k, cfg0.oversample, n) if cfg0.warmup_q > 0 else k

    X = torch.stack([_lane(s.input, tall).to(dev) for s in specs])
    seeds = [s.resolved_config().seed for s in specs]
    fn = batched_block_solve_fn(m, n, k, l, dtype_name(sd), float(cfg0.eps),
                                int(cfg0.max_iters), int(cfg0.warmup_q))
    U, S, V, iters, gap, conv = fn(X, seeds)
    finite = torch.isfinite(S).all(1).tolist()
    iters, gap, conv = iters.tolist(), gap.tolist(), conv.tolist()
    bpp = m * n * sd.itemsize

    out = []
    for i, s in enumerate(specs):
        if not finite[i]:
            err = NumericalHealthError(
                f"batched lane {i} produced non-finite singular values "
                f"(subspace gap {gap[i]}): the input contains "
                f"NaN/Inf or overflowed the {dtype_name(sd)} sweep — the "
                f"job fails alone; its batchmates are unaffected",
                kind="nonfinite")
            out.append((None, err))
            continue
        it = int(iters[i])
        cfg = s.resolved_config()
        # engine accounting convention: sketch pass + 2-pass warmup
        # chains, 2 passes per iteration, 1 extraction pass
        passes = (cfg.warmup_q * 2 + 1 if cfg.warmup_q > 0 else 0) \
            + 2 * it + 1
        Ui, Vi = (U[i], V[i]) if tall else (V[i], U[i])
        res = SVDResult(
            Ui.clone(), S[i].clone(), Vi.clone(),
            np.full((k,), it, np.int32), passes, bpp, bool(conv[i]),
            "dense", bytes_moved={"device": passes * bpp})
        out.append((res, None))
    return out
