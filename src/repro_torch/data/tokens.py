"""Token data for the LM paths: the port's copy of ``repro/data/tokens.py``'s
deterministic synthetic corpus (zipfian unigrams with a learnable bigram
structure). Numpy, so both packages draw the same tokens from a seed."""
from __future__ import annotations

import numpy as np


class SyntheticCorpus:
    """Zipf-distributed tokens with a learnable bigram structure."""

    def __init__(self, vocab: int, seed: int = 0, order_mix: float = 0.7):
        self.vocab = vocab
        self.seed = seed
        self.order_mix = order_mix
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token prefers a small successor set
        self.succ = rng.integers(0, vocab, size=(vocab, 4))

    def batch(self, batch: int, seq: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 977 * step)
        out = np.empty((batch, seq), np.int64)
        out[:, 0] = rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(1, seq):
            use_bigram = rng.random(batch) < self.order_mix
            succ_pick = self.succ[out[:, t - 1],
                                  rng.integers(0, 4, size=batch)]
            uni = rng.choice(self.vocab, size=batch, p=self.unigram)
            out[:, t] = np.where(use_bigram, succ_pick, uni)
        return out
