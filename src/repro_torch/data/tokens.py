"""Synthetic LM token pipeline: deterministic, seekable (a numpy copy of
``repro/data/tokens.py``; the two give the same tokens bit for bit).

A Zipf-distributed Markov stream gives the loss curve realistic structure
(learnable bigram statistics) without external data. ``batch_at(step)`` is a
pure function of (seed, step), so a restarted job replays the exact same
data order: the property the restartable training loop relies on.
"""
from __future__ import annotations

import numpy as np


class SyntheticTokenStream:
    def __init__(self, vocab_size: int, *, seed: int = 0, zipf_a: float = 1.2,
                 n_states: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        # hidden-state bigram model: each state emits a zipf slice and moves
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        base = ranks ** (-zipf_a)
        self.n_states = n_states
        self.emit = np.stack([
            np.roll(base, rng.integers(0, vocab_size)) for _ in range(n_states)
        ])
        self.emit /= self.emit.sum(axis=1, keepdims=True)
        self.trans = rng.dirichlet(np.ones(n_states) * 0.5, size=n_states)

    def batch_at(self, step: int, batch: int, seq: int) -> dict:
        """{"tokens", "labels"}: (batch, seq) int32 numpy arrays, the labels
        the tokens shifted left by one."""
        rng = np.random.default_rng((self.seed, step))
        state = rng.integers(0, self.n_states, size=batch)
        toks = np.empty((batch, seq + 1), np.int32)
        for t in range(seq + 1):
            u = rng.random(batch)
            # per-row categorical draws via cdf inverse on the emit rows
            cdf = np.cumsum(self.emit[state], axis=1)
            toks[:, t] = (u[:, None] < cdf).argmax(axis=1)
            state = np.array([
                rng.choice(self.n_states, p=self.trans[s]) for s in state])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
