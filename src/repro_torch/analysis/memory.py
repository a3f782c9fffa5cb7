"""Memory/traffic pass: peak live bytes and A-traffic of one step.

Two estimates, both read off one recorded run of a step
(``analysis/trace_check.py::trace_step``):

* ``peak_live_bytes`` — the storages live during the step: the inputs'
  from entry, each op's outputs from their creation until the last
  tensor on them is freed.  It is held against a per-device budget: on
  the card its own ``total_memory``; on the CPU ``H100_80GB_BYTES``, the
  memory of the card the port targets (an NVIDIA H100 80GB HBM3).
  Library workspaces (cuBLAS, cuSOLVER) are allocated below the
  dispatcher and are not in the estimate.

* A-traffic — the bytes of A the step's sweeps read, from the kernels'
  own tally (``kernels/ops.py::thread_a_bytes``, on the card and on the
  CPU alike), or, for the host-streamed tiers, the bytes of the staged
  block the step was handed (``mode="staged"``: one H2D copy of the
  block serves both halves of the fused chain).  Summed over a backend's
  step traces it must equal the solver's OWN accounting (``chain_passes
  * op.bytes_per_pass``), so the static estimate and the runtime
  ``passes``/``bytes_moved`` counters cannot diverge: change one without
  the other and this pass fails.

Collective payload bytes come from the same record
(``core/collectives.py``), giving the cross-check that a bf16 sweep
moves HALF the bytes of A but IDENTICAL collective bytes (the all-reduce
payload stays the fp32 accumulator).
"""
from __future__ import annotations

from repro_torch.analysis.report import Violation

__all__ = ["H100_80GB_BYTES", "device_budget", "collective_payload_bytes",
           "check_memory"]

#: the budget on the CPU: 80 GB, the memory the NVIDIA H100 80GB HBM3 is
#: sold with (on the card the budget is its own ``total_memory``)
H100_80GB_BYTES = 80 * 10**9


def device_budget(device: str) -> int:
    """The peak-live budget of one step on ``device``."""
    if device == "cuda":
        import torch
        return int(torch.cuda.get_device_properties(0).total_memory)
    return H100_80GB_BYTES


def collective_payload_bytes(trace) -> int:
    """Bytes of every collective payload of the step (one rank's)."""
    return sum(int(c["bytes"]) for c in trace.collectives)


def check_memory(trace, tag: str, *, budget_bytes: int | None = None,
                 staged_bytes: int | None = None, mode: str = "sweeps"):
    """Peak and traffic of one trace, with the budget check.  Returns
    ``(violations, details)``.  ``mode="sweeps"`` measures A-traffic as
    the bytes the sweeps read; ``mode="staged"`` as the staged block
    handed to the step (``staged_bytes``), the sweeps' reads beside it."""
    violations = []
    peak = int(trace.peak_live_bytes)
    if budget_bytes is not None and peak > budget_bytes:
        violations.append(Violation(
            "memory", "budget", tag,
            f"estimated peak live bytes {peak:,} exceed the device budget "
            f"{budget_bytes:,}"))
    details = {"peak_live_bytes": peak,
               "resident_bytes": int(trace.resident_bytes),
               "collective_bytes": collective_payload_bytes(trace),
               "sweep_a_bytes": int(trace.a_bytes.get("a_bytes", 0))}
    details["a_read_bytes"] = (int(staged_bytes) if mode == "staged"
                               else details["sweep_a_bytes"])
    return violations, details
