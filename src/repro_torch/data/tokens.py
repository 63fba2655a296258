"""Token data for the LM paths: the port's copy of ``repro/data/tokens.py``'s
training batch iterator (``make_batch_iter``) and deterministic
synthetic corpus (zipfian unigrams with a learnable bigram structure).
Numpy, so both packages draw the same tokens from a seed.

The reference draws each unigram token with ``rng.choice(vocab,
p=unigram)``, which rebuilds the unigram's CDF on every call. The port
builds it once, as ``numpy.random.Generator.choice`` builds it (the
cumulative sum divided by its last entry), and draws with
``cdf.searchsorted(rng.random(n), side="right")``: the same uniform
draws through the same CDF, so the same tokens, without the per-step
work over the whole vocabulary.

Across ranks every rank draws the global batch and keeps its own rows
(``local_rows``), the reference's layout of a batch whose rows are
sharded over ``("pod", "data")``."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve


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


def local_rows(n_rows: int, index: int, n_shards: int,
               microbatches: int = 1) -> np.ndarray:
    """The global rows that batch shard ``index`` of ``n_shards`` holds,
    in microbatch order: the rows are cut in contiguous blocks over the
    shards (pod-major over ``("pod", "data")``, the shard's ``index``),
    and with ``microbatches`` n > 1 each global microbatch i (rows
    [i B/n, (i + 1) B/n), as the reference reshapes before the mesh
    splits it) is cut so: shard r's part of it is rows i B/n + r B/(n W)
    ... i B/n + (r + 1) B/(n W) - 1. Raises ``ValueError`` when the rows
    do not split so (the reference would keep them whole on every
    rank)."""
    per = n_rows // (microbatches * n_shards) if microbatches else 0
    if per == 0 or n_rows % (microbatches * n_shards):
        raise ValueError(f"a batch of {n_rows} rows does not split into "
                         f"{microbatches} microbatches over {n_shards} "
                         f"batch shards")
    mb = n_rows // microbatches
    return np.concatenate([np.arange(i * mb + index * per,
                                     i * mb + (index + 1) * per)
                           for i in range(microbatches)])


def make_batch_iter(cfg, *, global_batch: int, seq_len: int, seed: int = 0,
                    device=None, rows=None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields the training batches of ``Model.loss`` on ``device``
    (``None`` means CUDA), drawn as the reference's ``make_batch_iter``
    draws them: the corpus's tokens for step 0, 1, ..., and for the
    frontend stubs ``default_rng(seed + 1)`` normals, the encoder's
    (B, seq_len, d_model) ``frames`` with min(max_target_len, seq_len)
    decoder tokens, or a vlm's (B, F, d_model) ``embeds`` with seq_len - F
    tokens. ``rows`` (``local_rows``) keeps those rows of each batch."""
    dev = resolve(device)
    corpus = SyntheticCorpus(cfg.vocab, seed)
    rng = np.random.default_rng(seed + 1)
    step = 0
    while True:
        if cfg.family == "encdec":
            dec = min(cfg.max_target_len, seq_len)
            b = {"frames": rng.normal(0, 1, (global_batch, seq_len,
                                             cfg.d_model)).astype(np.float32),
                 "tokens": corpus.batch(global_batch, dec, step)}
        elif cfg.frontend_tokens:
            F = cfg.frontend_tokens
            b = {"embeds": rng.normal(0, 1, (global_batch, F, cfg.d_model)
                                      ).astype(np.float32),
                 "tokens": corpus.batch(global_batch, seq_len - F, step)}
        else:
            b = {"tokens": corpus.batch(global_batch, seq_len, step)}
        if rows is not None:
            b = {k: v[rows] for k, v in b.items()}
        yield {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        step += 1
