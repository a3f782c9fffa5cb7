"""Intentional exceptions to the contract checks — each with its why.

The analyzer's rules are strict by design; the few places the solver
*deliberately* steps outside them are enumerated HERE, with a written
justification, instead of weakening the pass that caught them.  Keys
are ``"<target>::<rule>"`` where ``target`` is the violation's target
(``core/<file>.py::<qualname>`` for lint, the trace tag for the trace/
memory passes).  An allowlisted violation still appears in the report
(marked, with its reason) but does not fail the run — so removing the
underlying exception later surfaces as a stale-allowlist entry, not as
silence.
"""
from __future__ import annotations

from repro_torch.analysis.report import Violation

__all__ = ["ALLOWLIST", "apply_allowlist", "stale_entries"]

ALLOWLIST: dict[str, str] = {
    # -- ANA001: the deflation engines' per-step stop tests -----------------
    # The JAX package runs the rank-one power loop inside lax.while_loop
    # on the device; the port's loop is Python, and reading the stop flag
    # each step is what keeps its step count the reference's (a lagged
    # read would run one step more).  Under force_iters it reads nothing.
    "core/tsvd.py::power_iterate_chain::ANA001":
        "the rank-one deflation engine's termination test, one read a "
        "power step by design (a lagged read would change the step count "
        "against the reference); force_iters reads nothing",
    "core/sparse.py::_sparse_deflation::ANA001":
        "the sparse deflation engine's termination test (the JAX "
        "package's engine is synchronous numpy end to end and has the "
        "same exception)",

    # -- ANA001: host-side serialization and staging ------------------------
    # to_tree converts the per-tier byte COUNTERS (host ints) to numpy
    # scalars for np.savez, at checkpoint boundaries only.
    "core/config.py::SolverState.to_tree::ANA001":
        "checkpoint serialization of host-side counters; runs at "
        "checkpoint boundaries, not per solver iteration",
    # _stage copies the caller's host array into the staged host blocks,
    # once, when the matrix is built: the np.asarray IS the work.
    "core/oom.py::HostBlockedMatrix._stage::ANA001":
        "one-time staging of a host array into the host blocks, before "
        "any solve; the host copy is the operation itself",
}


def apply_allowlist(violations: list) -> list:
    """Mark allowlisted violations in place; returns the same list."""
    for v in violations:
        reason = ALLOWLIST.get(f"{v.target}::{v.rule}")
        if reason is not None:
            v.allowlisted = True
            v.reason = reason
    return violations


def stale_entries(violations: list) -> list:
    """Allowlist keys that matched nothing this run.

    A stale entry means the exception it documented no longer exists —
    surfaced as its own violation so the allowlist shrinks with the
    code instead of fossilizing.
    """
    seen = {f"{v.target}::{v.rule}" for v in violations}
    out = []
    for key in sorted(set(ALLOWLIST) - seen):
        out.append(Violation(
            "lint", "stale-allowlist", key,
            "allowlist entry matched no violation this run; delete it "
            "(the exception it documented is gone)"))
    return out
