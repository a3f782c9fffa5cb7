"""Deterministic, resumable synthetic LM data pipeline.

The port's own copy of the JAX package's ``repro/data/pipeline.py``
(plain numpy, imported from neither package's other modules): batches
are a pure function of ``(seed, step, global_batch)``, bitwise equal to
the JAX package's, so a run resumed from a checkpoint at step ``n``
sees the batches an uninterrupted run sees.

Token stream: a fixed random bigram Markov chain over the vocabulary
(each token has 8 likely successors, 10% random restarts), learnable
with a known entropy floor.  Audio batches are (B, K, S) grids of K
codebook streams; VLM batches add ``patch_embeds`` (B, P, D) fp32,
drawn from the same generator after the tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    family: str = "dense"       # audio -> (B, K, S) token grids
    num_codebooks: int = 1
    patch_positions: int = 0    # vlm -> patch embeds supplied
    d_model: int = 0


class SyntheticLMDataset:
    """Bigram-Markov token stream; batch(step) is pure and O(1) seekable."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        succ = rng.integers(0, cfg.vocab_size, size=(cfg.vocab_size, 8))
        self._succ = succ.astype(np.int32)

    def _tokens(self, rng, shape_prefix: tuple) -> np.ndarray:
        cfg = self.cfg
        n = int(np.prod(shape_prefix))
        cur = rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
        out = np.empty((n, cfg.seq_len), np.int32)
        for t in range(cfg.seq_len):
            out[:, t] = cur
            nxt_idx = rng.integers(0, 8, size=n)
            cur = self._succ[cur, nxt_idx]
            restart = rng.random(n) < 0.1
            cur = np.where(
                restart, rng.integers(0, cfg.vocab_size, size=n), cur)
        return out.reshape(*shape_prefix, cfg.seq_len)

    def batch(self, step: int) -> dict:
        """``{"tokens", "labels"}`` (B, S) int32 numpy arrays (audio:
        (B, K, S)); the labels are the tokens shifted by one, the first
        token wrapped last.  VLM: also ``patch_embeds`` (B, P, D)
        float32, standard normal."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        B = cfg.global_batch
        audio = cfg.family == "audio"
        toks = self._tokens(rng, (B, cfg.num_codebooks) if audio else (B,))
        labels = np.concatenate([toks[..., 1:], toks[..., :1]], axis=-1)
        out = {"tokens": toks, "labels": labels}
        if cfg.family == "vlm" and cfg.patch_positions:
            out["patch_embeds"] = rng.standard_normal(
                (B, cfg.patch_positions, cfg.d_model)).astype(np.float32)
        return out


def make_batch_iterator(cfg: DataConfig, start_step: int = 0):
    """Resumable iterator: yields (step, batch) from ``start_step``."""
    ds = SyntheticLMDataset(cfg)
    step = start_step
    while True:
        yield step, ds.batch(step)
        step += 1
