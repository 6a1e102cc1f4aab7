"""Synthetic LM token streams with learnable structure.

Markov-bigram + copy/induction patterns: a model that learns anything
drives loss well below the unigram entropy floor, so the end-to-end
training example shows a real learning curve on CPU.
"""
from __future__ import annotations

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0, order: int = 2):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        # sparse-ish bigram transition table: each token has few successors
        self.n_succ = 8
        self.succ = rng.integers(0, vocab, (vocab, self.n_succ))
        self.probs = rng.dirichlet(np.ones(self.n_succ) * 0.5, size=vocab)

    def batch(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        tok = rng.integers(0, self.vocab, batch)
        for t in range(seq):
            out[:, t] = tok
            choice = (rng.random(batch)[:, None] >
                      np.cumsum(self.probs[tok], -1)).sum(-1)
            choice = np.minimum(choice, self.n_succ - 1)
            tok = self.succ[tok, choice]
        return out
