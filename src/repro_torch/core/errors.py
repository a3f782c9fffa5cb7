"""Typed exception hierarchy for the SVD front door (PyTorch port).

The same classes, bases and messages as the JAX package's
``repro/core/errors.py``, so code catching ``InputError`` (or the
builtin it bridges to) behaves identically against either package.
Every error the solver raises on purpose derives from ``SVDError``; the
subclasses ALSO derive from the builtin type the same condition used to
raise (``InputError`` is a ``ValueError`` and a ``TypeError``,
``FaultExhaustedError`` a ``RuntimeError``, ...).

The ``*Fault`` leaf types at the bottom are the *injected* fault
signals the chaos harness (``core/faults.py``) raises at its injection
sites; they subclass the builtin the real failure would raise, so the
recovery paths cannot tell a drill from the real thing.
"""
from __future__ import annotations

import torch

__all__ = [
    "SVDError",
    "InputError",
    "FaultExhaustedError",
    "CheckpointCorruptError",
    "NumericalHealthError",
    "TransientIOFault",
    "H2DCopyFault",
    "DeviceOOMFault",
    "KilledFault",
    "is_oom_error",
]


class SVDError(Exception):
    """Base class for every error the solver raises deliberately."""


class InputError(SVDError, TypeError, ValueError):
    """The caller handed ``svd()``/``SVDConfig`` something unusable:
    an undispatchable type, an empty matrix, ``k`` out of range, or an
    invalid config knob.  Subclasses BOTH ``TypeError`` and
    ``ValueError`` so code catching either keeps working."""


class FaultExhaustedError(SVDError, RuntimeError):
    """A recovery path ran out of attempts: the numeric health guard
    rolled back ``health_retries`` times without a clean step, or an OOM
    hit the bottom of the tier-demotion ladder.  ``__cause__`` carries
    the last underlying failure."""


class CheckpointCorruptError(SVDError, RuntimeError):
    """A checkpoint step directory is unreadable (truncated npz, bad
    json, missing keys, non-finite iterate)."""


class NumericalHealthError(SVDError, ArithmeticError):
    """The health guard found NaN/Inf or orthogonality loss in the
    iterate.  Internal control-flow signal: the driver catches it and
    rolls back; after ``health_retries`` failures it re-raises as
    ``FaultExhaustedError``.  ``kind`` is ``"nonfinite"`` or
    ``"orth"``."""

    def __init__(self, msg: str, *, kind: str = "nonfinite"):
        super().__init__(msg)
        self.kind = kind


# ---------------------------------------------------------------------------
# Injected-fault signals (raised by core/faults.py at its injection
# sites; each subclasses what the real failure would raise)
# ---------------------------------------------------------------------------

class TransientIOFault(SVDError, OSError):
    """Injected stand-in for a transient disk-read error (EIO and
    friends) at the memmap staging hop."""


class H2DCopyFault(TransientIOFault):
    """Injected stand-in for a failed host->device block copy."""


class DeviceOOMFault(SVDError, RuntimeError):
    """Injected stand-in for the device allocator running dry.  The
    message carries the literal ``RESOURCE_EXHAUSTED`` token so
    ``is_oom_error`` classifies it exactly like the JAX package does."""

    def __init__(self, msg: str = ""):
        super().__init__(f"RESOURCE_EXHAUSTED: {msg or 'injected device OOM'}")


class KilledFault(SVDError, RuntimeError):
    """Injected process kill in ``mode='raise'``."""


def is_oom_error(e: BaseException) -> bool:
    """True iff ``e`` is a device out-of-memory condition: the injected
    ``DeviceOOMFault``, PyTorch's ``torch.cuda.OutOfMemoryError``, or an
    error whose message carries ``RESOURCE_EXHAUSTED``.  OOM is the
    tier-demotion ladder's job, never the I/O retry loop's."""
    if isinstance(e, (DeviceOOMFault, torch.cuda.OutOfMemoryError)):
        return True
    return "RESOURCE_EXHAUSTED" in str(e)
