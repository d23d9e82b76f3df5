"""Synthetic token data of the port's trainer: deterministic and packed.

The port's own copy of the reference package's ``repro.train.data``
(numpy only): a reproducible pseudo-corpus (a Zipfian token stream with
an induced bigram rule, so that a model has something to learn), packed
into fixed-length sequences and served as whole batches.  The same seed
gives the reference's batches bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticCorpus"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticCorpus:
    """Zipf-distributed token stream with a deterministic bigram rule:
    after token t, with probability 1/2 the next token is (7t + 3) %
    vocab, so the training loss visibly falls."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def _block(self, n: int) -> np.ndarray:
        cfg = self.cfg
        base = self.rng.zipf(cfg.zipf_a, size=n) % cfg.vocab_size
        follow = (base * 7 + 3) % cfg.vocab_size
        coin = self.rng.random(n) < 0.5
        out = base.copy()
        out[1:] = np.where(coin[1:], follow[:-1], base[1:])
        return out.astype(np.int32)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless ``{"tokens", "labels"}`` int32 batches ``(global_batch,
        seq_len)``, labels the tokens shifted by one."""
        cfg = self.cfg
        per = cfg.seq_len + 1
        while True:
            flat = self._block(cfg.global_batch * per)
            seqs = flat.reshape(cfg.global_batch, per)
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
