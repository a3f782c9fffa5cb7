"""Atomic checkpointing of solver states (the JAX package's
``repro.checkpoint``, ported)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager"]
