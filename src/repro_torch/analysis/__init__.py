"""Static contract checks over the solver's own step functions
(the port of the JAX package's ``repro/analysis``).

``run_all()`` (CLI: ``python -m repro_torch.analysis``) runs three
passes and aggregates an ``AnalysisReport``:

* trace pass   — collective/precision/purity contracts on one recorded
  run of each of the driver's step functions at small shapes
  (``analysis/trace_check.py``);
* memory pass  — peak live bytes against the device's memory, and the
  A-traffic the kernels' own tally counts held against the operators'
  ``bytes_per_pass`` accounting (``analysis/memory.py``);
* lint pass    — stdlib-ast conventions over ``src/repro_torch/core``
  (``analysis/lint.py``).

The targets run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card and no ``device`` it raises.  The
sharded backend's targets run in a process of their own on a world-1
group (``analysis/sharded.py``), so the caller's process group state is
left as it was.  Intentional exceptions live in ``analysis/allowlist.py``
with written reasons; everything else fails the run (a nonzero exit of
the CLI).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

from repro_torch.analysis.report import AnalysisReport, CheckRecord, Violation

__all__ = ["run_all", "AnalysisReport", "CheckRecord", "Violation",
           "ALL_PASSES"]

ALL_PASSES = ("trace", "memory", "lint")


def run_targets(targets, passes, budget_bytes, device: str) -> dict:
    """Trace each target once on ``device`` and check it; returns the
    plain-data result (``results``: (pass, tag, violations as dicts,
    details); ``measured``: A bytes by accounting group; ``coll``:
    collective bytes by tag)."""
    from repro_torch.analysis.memory import check_memory
    from repro_torch.analysis.trace_check import check_step, trace_step

    out = {"results": [], "measured": {}, "coll": {}}
    for t in targets:
        tr = trace_step(t.fn, *t.args, device=device)
        if "trace" in passes and t.contract is not None:
            v, d = check_step(tr, t.contract, t.tag)
            if t.note:
                d["note"] = t.note
            out["results"].append(("trace", t.tag, [x.to_dict() for x in v],
                                   d))
            out["coll"][t.tag] = sum(c["bytes"] for c in d["collectives"])
        if "memory" in passes:
            v, d = check_memory(
                tr, t.tag, budget_bytes=budget_bytes,
                staged_bytes=t.staged() if t.staged else None,
                mode="staged" if t.staged else "sweeps")
            if t.group:
                out["measured"][t.group] = \
                    out["measured"].get(t.group, 0) + d["a_read_bytes"]
            out["results"].append(("memory", t.tag, [x.to_dict() for x in v],
                                   d))
    return out


def _sharded_child(device: str, passes, budget_bytes) -> dict:
    """The sharded targets' ``run_targets`` result, from a child process
    (``analysis/sharded.py``) on a world-1 group of its own."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.analysis.sharded",
           "--device", device, "--passes", ",".join(passes)]
    if budget_bytes is not None:
        cmd += ["--budget-bytes", str(budget_bytes)]
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"the sharded targets' process failed "
                           f"({proc.returncode}):\n{proc.stdout[-4000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_trace_passes(report: AnalysisReport, passes, budget_bytes, device):
    import dataclasses

    from repro_torch.analysis.allowlist import apply_allowlist
    from repro_torch.analysis.targets import AccountingGroup, build_targets

    targets, groups, twins, cleanups = build_targets(device)
    try:
        local = run_targets(targets, passes, budget_bytes, device)
    finally:
        for c in cleanups:
            c()
    del targets
    sharded = _sharded_child(device, passes, budget_bytes)
    groups += [AccountingGroup(**g) for g in sharded["groups"]]
    twins += [tuple(t) for t in sharded["twins"]]
    coll_by_tag = {**local["coll"], **sharded["coll"]}
    measured = {g.name: 0 for g in groups}
    for part in (local, sharded):
        for name, b in part["measured"].items():
            measured[name] += b
        for pass_name, tag, vs, d in part["results"]:
            report.add(apply_allowlist([Violation(**x) for x in vs]),
                       CheckRecord(pass_name, tag, "ok", d))

    if "trace" in passes:
        for a, b in twins:
            if a not in coll_by_tag or b not in coll_by_tag:
                continue
            ca, cb = coll_by_tag[a], coll_by_tag[b]
            v = []
            if ca != cb:
                v.append(Violation(
                    "trace", "bf16-collective-drift", f"{a}~{b}",
                    f"collective bytes differ between precision twins: "
                    f"{ca:,} vs {cb:,} — the bf16 sweep must halve the "
                    f"bytes of A, never touch the (fp32 accumulator) "
                    f"all-reduce payload"))
            report.add(apply_allowlist(v), CheckRecord(
                "trace", f"twin:{a}~{b}", "ok",
                {"collective_bytes": [ca, cb]}))

    if "memory" in passes:
        for g in groups:
            got = measured[g.name] * g.replicas
            v = []
            if got != g.expected_bytes:
                v.append(Violation(
                    "memory", "accounting-mismatch", g.name,
                    f"A-traffic {got:,} bytes != solver accounting "
                    f"{g.expected_bytes:,} ({g.source}) — the step's sweeps "
                    f"and the bytes_per_pass counters have diverged"))
            report.add(apply_allowlist(v), CheckRecord(
                "memory", f"accounting:{g.name}", "ok",
                {**dataclasses.asdict(g), "measured_bytes": int(got)}))


def _run_lint_pass(report: AnalysisReport, lint_root):
    from repro_torch.analysis.allowlist import apply_allowlist
    from repro_torch.analysis.lint import lint_core

    violations = apply_allowlist(lint_core(lint_root))
    report.add(violations, CheckRecord(
        "lint", lint_root or "core/", "ok",
        {"n_violations": sum(not v.allowlisted for v in violations),
         "n_allowlisted": sum(v.allowlisted for v in violations)}))


def run_all(*, passes=ALL_PASSES, budget_bytes: int | None = None,
            device=None, lint_root: str | None = None) -> AnalysisReport:
    """Run the requested passes on ``device`` (``None``: the card, and
    raise without one) and return the aggregated report.
    ``budget_bytes=None`` is the device's own memory
    (``memory.device_budget``)."""
    from repro_torch.analysis.allowlist import stale_entries
    from repro_torch.analysis.memory import device_budget
    from repro_torch.core.operator import resolve_device

    dev = resolve_device(device).type
    if budget_bytes is None:
        budget_bytes = device_budget(dev)
    report = AnalysisReport()
    if "trace" in passes or "memory" in passes:
        _run_trace_passes(report, tuple(passes), budget_bytes, dev)
    if "lint" in passes:
        _run_lint_pass(report, lint_root)
    if set(ALL_PASSES) <= set(passes) and lint_root is None:
        # only a FULL default run can judge staleness: a partial run
        # legitimately misses the other passes' allowlist hits
        report.add(stale_entries(list(report.violations)),
                   CheckRecord("lint", "allowlist", "ok", {}))
    return report
