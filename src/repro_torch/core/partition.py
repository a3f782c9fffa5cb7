"""Problem partitioning for the distributed/out-of-core SVD (paper §V-B).

The port's copy of the JAX package's ``repro/core/partition.py`` (pure
Python, same names and results).  The paper uses two 1-D partitions of
``A (m x n)``:

* **RSVD** (row / horizontal) when ``m >= n`` — each worker owns
  ``A[i0:i1, :]`` and the matching rows of ``U``; ``Sigma`` and ``V`` are
  replicated.
* **CSVD** (column / vertical) when ``n > m`` — each worker owns
  ``A[:, j0:j1]`` and the matching rows of ``V``; ``Sigma`` and ``U`` are
  replicated.

This module only does the shape bookkeeping (padding to divisibility,
batch boundaries for the out-of-core path, the reduced-task list of the
symmetric Gram).  ``symmetric_tasks`` is also the order in which the
``gram`` kernels (``csrc/gram_tasks.cuh``) enumerate their output tiles.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Partition:
    """Static description of how an ``m x n`` problem is laid out.

    Attributes:
      m, n:        logical (unpadded) matrix shape.
      n_workers:   number of shards along the distributed axis.
      row_major:   True => RSVD (rows sharded), False => CSVD (cols sharded).
      m_pad, n_pad: padded shape actually used on device (divisible).
      local_rows/local_cols: per-worker block shape (of the padded matrix).
    """

    m: int
    n: int
    n_workers: int
    row_major: bool
    m_pad: int
    n_pad: int

    @property
    def local_rows(self) -> int:
        return self.m_pad // self.n_workers if self.row_major else self.m_pad

    @property
    def local_cols(self) -> int:
        return self.n_pad if self.row_major else self.n_pad // self.n_workers

    @property
    def dist_dim(self) -> int:
        """Size of the sharded dimension (padded)."""
        return self.m_pad if self.row_major else self.n_pad

    @property
    def repl_dim(self) -> int:
        """Size of the replicated dimension (padded)."""
        return self.n_pad if self.row_major else self.m_pad


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def make_partition(m: int, n: int, n_workers: int, *, force_row: bool | None = None) -> Partition:
    """Pick RSVD vs CSVD per the paper rule and pad to divisibility.

    ``force_row`` overrides the automatic ``m >= n`` choice (used in tests
    to exercise both paths on the same matrix).
    """
    row_major = (m >= n) if force_row is None else force_row
    if row_major:
        m_pad = _round_up(m, n_workers)
        n_pad = n
    else:
        m_pad = m
        n_pad = _round_up(n, n_workers)
    return Partition(m=m, n=n, n_workers=n_workers, row_major=row_major,
                     m_pad=m_pad, n_pad=n_pad)


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """Out-of-memory batching plan for one worker's local block (paper §V-C).

    ``collinear=True`` batches along the *sharded* (large) dimension —
    blocks are ``b_s x n_local`` strips; ``collinear=False`` ("orthogonal")
    batches along the replicated dimension.  ``n_batches`` is the paper's
    ``n_b``; ``queue_size`` its ``q_s`` (number of concurrently-resident
    block buffers).
    """

    n_batches: int
    batch_size: int
    total: int
    queue_size: int
    collinear: bool

    def bounds(self, b: int) -> tuple[int, int]:
        lo = b * self.batch_size
        return lo, min(lo + self.batch_size, self.total)


def make_batch_plan(total: int, n_batches: int, *, queue_size: int = 2,
                    collinear: bool = False) -> BatchPlan:
    """Split ``total`` into ``n_batches`` contiguous batches (last ragged)."""
    if n_batches < 1:
        raise ValueError(f"n_batches must be >= 1, got {n_batches}")
    n_batches = min(n_batches, total)
    batch_size = math.ceil(total / n_batches)
    # Recompute the true batch count after ceil-rounding.
    n_eff = math.ceil(total / batch_size)
    return BatchPlan(n_batches=n_eff, batch_size=batch_size, total=total,
                     queue_size=max(1, min(queue_size, n_eff)), collinear=collinear)


def symmetric_tasks(n_batches: int) -> list[tuple[int, int]]:
    """Upper-triangle task list for the symmetric Gram (paper Fig 2c).

    ``B_ij = A_i^T A_j`` is computed only for ``i <= j``; the mirror block
    is obtained by transposition.  ``n_b (n_b + 1) / 2`` tasks instead of
    ``n_b^2`` — the paper's reduced-task trick.
    """
    return [(i, j) for j in range(n_batches) for i in range(j + 1)]
