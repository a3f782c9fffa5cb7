"""One decomposition, every execution regime, ONE call.

    PYTHONPATH=src python -m repro_torch.examples.unified_api [--device cpu]

Builds a matrix with a prescribed spectrum and factorizes it through
``repro_torch.svd`` with the SAME ``SVDConfig`` on different input
types — a tensor on the device, a host numpy array (streamed
out-of-core in blocks), a ``.npy`` file on DISK (blocks staged disk ->
host -> device under a capped host budget), a scipy CSR matrix (the
sparse stream) and a streamed operator — then prints the per-backend
accounting side by side, including the per-tier ``bytes_moved``.

Two more legs show the resumable solver core:

* **warm updates** — the matrix changes slightly and ``svd_update``
  re-converges in a few block iterations from the previous factors,
  the per-iteration subspace gap printed through ``on_iteration``;
* **kill-and-resume** — a solve is killed mid-run, and a second call
  with the same ``checkpoint_dir`` resumes from the last saved
  ``SolverState`` to bitwise-identical sigmas with the pass accounting
  conserved.

``--resume-demo DIR`` runs the kill-and-resume leg across two real
processes: once with ``--max-iters 3`` (a capped, checkpointed solve),
then again without the cap — the second process resumes from DIR and
verifies against an uninterrupted solve in the same process.
"""
import os
import sys
import tempfile

import numpy as np
import scipy.sparse as sps
import torch

from repro_torch.core import (DenseStreamOperator, SVDConfig,
                              SyntheticSparseMatrix, stage_to_disk, svd,
                              svd_update)


def main(dev) -> int:
    rng = np.random.default_rng(0)
    m, n, k = 512, 192, 8
    U, _, Vt = np.linalg.svd(rng.normal(size=(m, n)).astype(np.float32),
                             full_matrices=False)
    spectrum = np.zeros(n, np.float32)
    spectrum[:2 * k] = np.linspace(20, 2, 2 * k)
    A = (U * spectrum) @ Vt

    # one config for every backend: block subspace iteration with a
    # range-finder start and bounded host blocking
    cfg = SVDConfig(method="block", eps=1e-8, max_iters=300, warmup_q=1,
                    n_blocks=4)
    with tempfile.TemporaryDirectory() as tmp:
        # disk tier: the host cache capped at a quarter of the file
        path = stage_to_disk(A, os.path.join(tmp, "A.npy"))
        inputs = [
            ("dense (tensor)", torch.from_numpy(A).to(dev), cfg),
            ("out-of-core (numpy array)", A, cfg),
            ("disk tier (.npy memmap)", path,
             cfg.replace(host_budget_bytes=A.nbytes // 4)),
            ("scipy CSR (real sparse data)", sps.csr_matrix(A), cfg),
            ("streamed operator", DenseStreamOperator(A), cfg),
        ]
        print(f"A: {m}x{n}, top-{k} of spectrum {spectrum[:k]}")
        print(f"\n{'input':<28} {'backend':<14} {'iters':>5} {'passes':>7} "
              f"{'MB/pass':>8} {'conv':>5} {'max sigma err':>14}")
        tiers = {}
        for name, target, c in inputs:
            res = svd(target, k, device=dev, config=c)
            err = float(np.max(np.abs(res.S.cpu().numpy() - spectrum[:k])
                               / spectrum[:k]))
            tiers[res.backend] = res.bytes_moved
            print(f"{name:<28} {res.backend:<14} {int(res.iters[0]):>5} "
                  f"{int(res.passes_over_A):>7} "
                  f"{res.bytes_per_pass / 1e6:>8.2f} "
                  f"{str(res.converged):>5} {err:>14.2e}")
            assert res.converged and err <= 1e-4, (name, err)

    print("\nper-tier bytes_moved (disk / host / device MB):")
    for backend, moved in tiers.items():
        cells = "  ".join(f"{t}={moved.get(t, 0) / 1e6:.1f}"
                          for t in ("disk", "host", "device"))
        print(f"  {backend:<14} {cells}")
    assert tiers["memmap"]["disk"] > 0 and tiers["dense"]["device"] > 0

    # a sparse input the same way: the procedural matrix is generated a
    # row block at a time and never materialized.  A random sparse
    # spectrum is tightly clustered, so the demo loosens eps and widens
    # the sketch: the rank gap, not the backend, sets the rate.
    sp = SyntheticSparseMatrix(m=4096, n=512, nnz_per_row=8, seed=1)
    res = svd(sp, 4, device=dev, config=cfg.replace(eps=1e-4, oversample=28))
    print(f"\nsparse {sp.m}x{sp.n} (density {sp.density:.1e}, dense-equiv "
          f"{sp.dense_bytes / 1e6:.0f} MB, nnz stream "
          f"{res.bytes_per_pass / 1e6:.1f} MB/pass):")
    print("  sigma:", np.round(res.S.cpu().numpy(), 3),
          f" backend={res.backend}, {int(res.passes_over_A)} passes, "
          f"converged={res.converged}")
    assert res.converged and bool(torch.isfinite(res.S).all())

    warm_update_leg(rng, dev)
    kill_and_resume_leg(rng, dev)
    print("unified_api: all legs OK")
    return 0


def _trajectory_hook(rows):
    """An ``on_iteration`` hook that records (it, gap, passes)."""
    def hook(state):
        rows.append((state.it, float(state.gap), int(state.passes)))
    return hook


def _print_trajectory(rows, label, head=3, tail=2):
    shown = rows if len(rows) <= head + tail else (
        rows[:head] + [None] + rows[-tail:])
    for r in shown:
        if r is None:
            print(f"    {label} ...")
            continue
        it, gap, passes = r
        print(f"    {label} it={it:>3}  gap={gap:>9.2e}  passes={passes}")


def warm_update_leg(rng, dev):
    """svd_update(): the matrix changed a little — reuse the factors."""
    A0 = _spectrum_matrix(rng)
    A1 = A0 + 1e-4 * rng.standard_normal(A0.shape).astype(np.float32)
    kw = dict(device=dev, method="block", warmup_q=1, n_blocks=4)
    prev = svd(A0, 5, **kw)
    cold_rows, warm_rows = [], []
    cold = svd(A1, 5, on_iteration=_trajectory_hook(cold_rows), **kw)
    warm = svd_update(prev, A1, on_iteration=_trajectory_hook(warm_rows),
                      **kw)
    print("\nwarm update after a small change to A (per-iteration "
          "subspace gap via on_iteration):")
    _print_trajectory(cold_rows, "cold")
    _print_trajectory(warm_rows, "warm")
    print(f"  cold restart: {int(cold.iters[0])} iterations; svd_update: "
          f"{int(warm.iters[0])} (seeded from the previous V)")
    assert warm.iters[0] <= 3 < cold.iters[0]
    assert np.allclose(warm.S.cpu().numpy(), cold.S.cpu().numpy(),
                       rtol=1e-4)


def kill_and_resume_leg(rng, dev):
    """Kill a checkpointed solve mid-run, resume it, verify bitwise."""
    A = _spectrum_matrix(rng)
    kw = dict(device=dev, method="block", warmup_q=1, n_blocks=4)
    ref = svd(A, 5, **kw)

    class Killed(RuntimeError):
        pass

    def kill_at_4(state):
        if state.it == 4:
            raise Killed

    with tempfile.TemporaryDirectory() as ck:
        try:
            svd(A, 5, checkpoint_dir=ck, checkpoint_every=1,
                on_iteration=kill_at_4, **kw)
        except Killed:
            print("\nkill-and-resume: solve killed at iteration 4 "
                  "(the checkpoint of it=4 already on disk)")
        rows = []
        res = svd(A, 5, checkpoint_dir=ck, checkpoint_every=25,
                  on_iteration=_trajectory_hook(rows), **kw)
        _print_trajectory(rows, "resumed")
        bitwise = torch.equal(res.S.cpu(), ref.S.cpu())
        print(f"  resumed from it=4 -> converged at it={int(res.iters[0])}; "
              f"sigmas bitwise-identical to uninterrupted: {bitwise}; "
              f"passes conserved: {res.passes_over_A} == "
              f"{ref.passes_over_A}")
        assert bitwise and res.passes_over_A == ref.passes_over_A


def _spectrum_matrix(rng, m=256, n=96):
    """Full-rank, gently decaying spectrum: slow enough cold that the
    resumable-state legs have a trajectory worth printing."""
    L = rng.standard_normal((m, n)).astype(np.float32)
    U, _, Vt = np.linalg.svd(L, full_matrices=False)
    return (U * np.linspace(6, 1, n).astype(np.float32)) @ Vt


def resume_demo(ck_dir, max_iters, dev) -> int:
    """The kill-and-resume leg across two real processes (run twice:
    capped, then uncapped against the same directory)."""
    rng = np.random.default_rng(0)
    A = _spectrum_matrix(rng)
    kw = dict(device=dev, method="block", warmup_q=1, n_blocks=4)
    rows = []
    extra = {"max_iters": max_iters} if max_iters else {}
    res = svd(A, 5, checkpoint_dir=ck_dir,
              checkpoint_every=1 if max_iters else 25,
              on_iteration=_trajectory_hook(rows), **kw, **extra)
    first_it = rows[0][0] if rows else int(res.iters[0])
    print(f"{'resumed' if first_it > 1 else 'cold start'}: iterations "
          f"{first_it}..{int(res.iters[0])}, converged={res.converged}, "
          f"cumulative passes={int(res.passes_over_A)}")
    _print_trajectory(rows, "state")
    if not res.converged:
        print(f"budget-capped; the SolverState of it={int(res.iters[0])} is "
              f"checkpointed in {ck_dir}: rerun without --max-iters to "
              f"resume")
        return 0
    ref = svd(A, 5, **kw)
    assert torch.equal(res.S.cpu(), ref.S.cpu()), \
        "resumed sigmas differ from the uninterrupted run"
    assert res.passes_over_A == ref.passes_over_A, (
        f"pass accounting not conserved: {res.passes_over_A} != "
        f"{ref.passes_over_A}")
    print(f"verified against the uninterrupted run: sigmas bitwise-"
          f"identical, passes conserved ({int(res.passes_over_A)})")
    return 0


if __name__ == "__main__":
    from repro_torch.core.operator import resolve_device
    from repro_torch.examples import device_arg

    ap = device_arg(__doc__.splitlines()[0])
    ap.add_argument("--resume-demo", metavar="DIR", default=None,
                    help="run the two-process kill-and-resume demo "
                         "against this checkpoint directory")
    ap.add_argument("--max-iters", type=int, default=None,
                    help="cap the --resume-demo run's iteration budget")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    if args.resume_demo:
        sys.exit(resume_demo(args.resume_demo, args.max_iters, dev))
    sys.exit(main(dev))
