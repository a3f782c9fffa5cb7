"""Typed findings + machine-readable report for the static contract checks.

Every pass (trace contract, memory/traffic, repo lint) reduces to the
same two shapes:

* ``Violation``  — one broken invariant, pinned to a target (a traced
  step function, or a ``file::qualname`` for the lint pass) with the
  rule id and a human sentence.  A violation may be *allowlisted*: the
  exception is intentional, carries a written reason
  (``analysis/allowlist.py``), and does NOT fail the run — weakening a
  pass to hide a hit is exactly what the allowlist exists to prevent.
* ``CheckRecord`` — one check that ran (even when clean), with the
  measured facts (collective schedule, peak bytes, static vs accounting
  bytes) so the JSON report is a dataset, not just a verdict.

``AnalysisReport`` aggregates both, renders the human summary, and
serializes to the JSON consumed by CI and by ``launch/svd_check.py``
(the JAX package's ``repro/analysis/report.py``, the same JSON shape).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class Violation:
    """One broken contract invariant."""

    pass_name: str          # "trace" | "memory" | "lint"
    rule: str               # stable rule id, e.g. "collective-count"
    target: str             # trace tag or "path::qualname" (+ ":line")
    message: str            # human sentence: expected vs actual
    allowlisted: bool = False
    reason: str = ""        # the allowlist justification (when listed)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        mark = "ALLOWED" if self.allowlisted else "FAIL"
        s = f"[{mark}] {self.pass_name}/{self.rule} {self.target}: " \
            f"{self.message}"
        if self.allowlisted and self.reason:
            s += f" (allowlisted: {self.reason})"
        return s


@dataclasses.dataclass
class CheckRecord:
    """One check that ran, with its measured facts."""

    pass_name: str
    target: str
    status: str             # "ok" | "violation" | "skipped"
    details: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AnalysisReport:
    """Aggregated result of an analyzer run."""

    violations: list = dataclasses.field(default_factory=list)
    checks: list = dataclasses.field(default_factory=list)

    def add(self, violations, record: CheckRecord | None = None) -> None:
        self.violations.extend(violations)
        if record is not None:
            if any(not v.allowlisted for v in violations):
                record.status = "violation"
            self.checks.append(record)

    @property
    def failures(self) -> list:
        return [v for v in self.violations if not v.allowlisted]

    @property
    def allowed(self) -> list:
        return [v for v in self.violations if v.allowlisted]

    @property
    def ok(self) -> bool:
        return not self.failures

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "n_checks": len(self.checks),
            "n_violations": len(self.failures),
            "n_allowlisted": len(self.allowed),
            "violations": [v.to_dict() for v in self.failures],
            "allowlisted": [v.to_dict() for v in self.allowed],
            "checks": [c.to_dict() for c in self.checks],
        }

    def to_json(self, **kw: Any) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    def summary(self) -> str:
        lines = []
        by_pass: dict[str, list] = {}
        for c in self.checks:
            by_pass.setdefault(c.pass_name, []).append(c)
        for name in sorted(by_pass):
            recs = by_pass[name]
            n_bad = sum(r.status == "violation" for r in recs)
            n_skip = sum(r.status == "skipped" for r in recs)
            lines.append(f"[{name:6s}] {len(recs)} checks, "
                         f"{n_bad} violating, {n_skip} skipped")
        for v in self.failures:
            lines.append(str(v))
        for v in self.allowed:
            lines.append(str(v))
        verdict = "OK" if self.ok else "CONTRACT VIOLATIONS"
        lines.append(f"analysis: {verdict} "
                     f"({len(self.failures)} violations, "
                     f"{len(self.allowed)} allowlisted)")
        return "\n".join(lines)
