"""Synthetic token-stream data for the language models (the port's copy of
``repro/data/tokens.py``; numpy only).

Deterministic, learnable structure: an affine congruential walk with
random restarts.  Every *row* is a pure function of its global sample index
``step * batch_size + i`` (its own ``SeedSequence`` stream), so a data
rank makes exactly the rows it owns (``sample_shard``), bit for bit a
slice of the whole batch.  The rows are bit-equal to the reference's for
the same config.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    seed: int = 0
    restart_p: float = 0.05


class TokenDataset:
    def __init__(self, cfg: TokenDataConfig):
        self.cfg = cfg

    def _rows(self, idx: np.ndarray) -> dict:
        """Generate the rows with global sample indices ``idx``."""
        c = self.cfg
        v = c.vocab_size
        a, b = 31, 17
        rngs = [np.random.default_rng(
            np.random.SeedSequence([c.seed, 7, int(s)])) for s in idx]
        x = np.zeros((len(idx), c.seq_len + 1), np.int64)
        x[:, 0] = [r.integers(0, v) for r in rngs]
        restarts = np.stack([r.random(c.seq_len) < c.restart_p
                             for r in rngs]) if len(idx) else \
            np.zeros((0, c.seq_len), bool)
        fresh = np.stack([r.integers(0, v, c.seq_len) for r in rngs]) \
            if len(idx) else np.zeros((0, c.seq_len), np.int64)
        for t in range(c.seq_len):
            nxt = (x[:, t] * a + b) % v
            x[:, t + 1] = np.where(restarts[:, t], fresh[:, t], nxt)
        return {"tokens": x[:, :-1].astype(np.int32),
                "labels": x[:, 1:].astype(np.int32)}

    def sample_batch(self, step: int, batch_size: int) -> dict:
        idx = np.arange(batch_size, dtype=np.int64) + step * batch_size
        return self._rows(idx)

    def sample_shard(self, step: int, batch_size: int,
                     row_slice: slice = slice(None)) -> dict:
        """The rows ``row_slice`` of step ``step``'s batch only: bit for bit
        ``sample_batch(step, batch_size)`` sliced."""
        idx = (np.arange(batch_size, dtype=np.int64)
               + step * batch_size)[row_slice]
        return self._rows(idx)

    def io_bytes_per_rank(self, batch_size: int, n_ranks: int) -> int:
        """Modelled bytes per data rank and step (tokens and labels, int32):
        the row cut divides the read by the rank count."""
        return 2 * 4 * batch_size * self.cfg.seq_len // n_ranks
