"""Token data for the LM paths: the port's copy of ``repro/data/tokens.py``'s
deterministic synthetic corpus (zipfian unigrams with a learnable bigram
structure). Numpy, so both packages draw the same tokens from a seed.

The reference draws each unigram token with ``rng.choice(vocab,
p=unigram)``, which rebuilds the unigram's CDF on every call. The port
builds it once, as ``numpy.random.Generator.choice`` builds it (the
cumulative sum divided by its last entry), and draws with
``cdf.searchsorted(rng.random(n), side="right")``: the same uniform
draws through the same CDF, so the same tokens, without the per-step
work over the whole vocabulary."""
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
        cdf = np.cumsum(self.unigram)
        self.cdf = cdf / cdf[-1]

    def _unigram(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """``rng.choice(vocab, size=n, p=unigram)`` on the CDF built once."""
        return self.cdf.searchsorted(rng.random(n), side="right")

    def batch(self, batch: int, seq: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed + 977 * step)
        out = np.empty((batch, seq), np.int64)
        out[:, 0] = self._unigram(rng, batch)
        for t in range(1, seq):
            use_bigram = rng.random(batch) < self.order_mix
            succ_pick = self.succ[out[:, t - 1],
                                  rng.integers(0, 4, size=batch)]
            uni = self._unigram(rng, batch)
            out[:, t] = np.where(use_bigram, succ_pick, uni)
        return out
