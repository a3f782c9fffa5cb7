"""CSR blocks for the order tests of the sparse stream's kernels, and
``np.add.at`` over them: numpy only (no torch, no JAX), shared by
``test_torch_csr_order.py`` (the CPU model) and ``test_torch_cuda.py``
(the card).

A case is a dict: ``n`` (columns), ``blocks`` (a list of (off, col, val)
int32 / int32 / fp32 arrays in stream order, val already rounded to the
sweep dtype) and ``name``.  Dense operands over ``n`` rows are never made
here: ``touched`` lists the columns the blocks use, and the oracles work
on those rows alone, so a case may have n = 2^31 - 1.
"""
from __future__ import annotations

import numpy as np

#: the widths the order tests run: the solver's k, the warm sketch's l,
#: and odd ones (one lane, part of a lane, more than four lanes)
KS = (1, 3, 8, 16, 33)
#: the cases by name
CASES = ("ragged", "empty_block", "one_column", "one_column_long",
         "shared_blocks", "n_2^25", "n_2^31-1")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest bf16 (ties to even), back in fp32."""
    b = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return (b.astype(np.uint32) << 16).view(np.float32)


def _ragged(rng, rows, n, per_row, lo_col=0):
    counts = rng.integers(0, 2 * per_row, rows)
    counts[::7] = 0                                   # empty rows
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    col = rng.integers(lo_col, n, int(off[-1])).astype(np.int32)
    if col.size > 4:
        col[1::5] = col[0::5][:col[1::5].size]        # repeated columns
    return off, col


def make_case(name: str, bf16: bool, seed: int = 0) -> dict:
    """The CSR blocks of case ``name`` (see ``CASES``), values rounded
    to bf16 with ``bf16``."""
    rng = np.random.default_rng(seed + 100 * CASES.index(name))
    blocks = []
    if name == "ragged":
        n = 5000
        blocks.append(_ragged(rng, 601, n, 5))
    elif name == "empty_block":
        n = 300
        blocks.append((np.zeros(8, np.int32), np.zeros(0, np.int32)))
        blocks.append(_ragged(rng, 40, n, 3))
    elif name == "one_column":                  # a run as long as the block
        n = 4000
        off, col = _ragged(rng, 500, n, 6)
        blocks.append((off, np.full_like(col, n // 3)))
    elif name == "one_column_long":             # longer than a bucket chunk
        n = 1 << 20                             # (the kernel's 10240)
        off, col = _ragged(rng, 5000, n, 8)
        blocks.append((off, np.full_like(col, n - 1)))
    elif name == "shared_blocks":               # Z carried across blocks
        n = 64
        blocks += [_ragged(rng, r, n, 6) for r in (97, 33, 160)]
    elif name == "n_2^25":
        n = 1 << 25
        off, col = _ragged(rng, 700, n, 5)
        col[:3] = (n - 1, 1 << 24, 0)
        blocks.append((off, col))
    elif name == "n_2^31-1":
        n = 2 ** 31 - 1
        off, col = _ragged(rng, 500, n, 5, lo_col=n - 5000)
        col[:4] = (n - 1, 1 << 30, 0, n - 1)
        blocks.append((off, col))
    else:
        raise ValueError(name)
    out = []
    for off, col in blocks:
        val = rng.standard_normal(col.size).astype(np.float32)
        out.append((off, col, bf16_round(val) if bf16 else val))
    return {"name": name, "n": n, "blocks": out}


def touched(case: dict) -> np.ndarray:
    """The sorted distinct columns the case's blocks use."""
    cols = [col for _, col, _ in case["blocks"]]
    return np.unique(np.concatenate(cols)) if cols else np.zeros(0, np.int32)


def dense_rows(case: dict, k: int, bf16: bool, seed: int = 1) -> tuple:
    """Random (Q rows of the touched columns, Z's starting rows there,
    each block's Y): Q and Y rounded to bf16 with ``bf16``; Z fp32."""
    rng = np.random.default_rng(seed)
    u = touched(case)
    r = bf16_round if bf16 else (lambda x: x)
    Qu = r(rng.standard_normal((u.size, k)).astype(np.float32))
    Zu = rng.standard_normal((u.size, k)).astype(np.float32)
    Ys = [r(rng.standard_normal((len(off) - 1, k)).astype(np.float32))
          for off, _, _ in case["blocks"]]
    return Qu, Zu, Ys


def rows_of(off: np.ndarray) -> np.ndarray:
    """The block row of each nonzero."""
    return np.repeat(np.arange(len(off) - 1), np.diff(off))


def add_at_matmat(off, col, val, u, Qu) -> np.ndarray:
    """``A_b Q`` by ``np.add.at`` in stream order (Q given on the touched
    columns ``u``)."""
    out = np.zeros((len(off) - 1, Qu.shape[1]), np.float32)
    np.add.at(out, rows_of(off), val[:, None] * Qu[np.searchsorted(u, col)])
    return out


def add_at_rmatmat(off, col, val, u, Y, Zu) -> np.ndarray:
    """``Z += A_b^T Y`` by ``np.add.at`` in stream order on the touched
    rows of Z (``Zu`` on the columns ``u``); returns the new rows."""
    out = Zu.copy()
    np.add.at(out, np.searchsorted(u, col), val[:, None] * Y[rows_of(off)])
    return out
