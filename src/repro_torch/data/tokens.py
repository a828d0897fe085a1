"""Synthetic token pipeline for LM training/serving examples.

Zipfian unigram stream with local n-gram structure (each document draws
from a doc-specific bigram table), so a model trained on it has real
signal to fit — loss decreases — while staying fully offline and
deterministic per seed.  A copy of the JAX package's ``data/tokens.py``
(numpy only): the same seed gives the same tokens.  The Zipf CDF is
summed once per stream instead of once per draw (the same array, so the
same tokens).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["TokenStream", "batches"]


@dataclasses.dataclass
class TokenStream:
    vocab: int
    seed: int = 0
    zipf_a: float = 1.2
    n_states: int = 64  # bigram-ish latent states

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        base = ranks ** (-self.zipf_a)
        self._base = base / base.sum()
        self._cdf = np.cumsum(self._base)
        self._perm = rng.permutation(self.vocab)
        # latent-state transition structure: each state prefers a token slice
        self._state_tokens = rng.integers(0, self.vocab, (self.n_states, 32))
        self._trans = rng.integers(0, self.n_states, (self.n_states,))

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq), np.int32)
        for b in range(batch):
            state = int(rng.integers(0, self.n_states))
            for t in range(seq):
                if rng.random() < 0.7:
                    tok = self._state_tokens[state, rng.integers(0, 32)]
                else:
                    tok = self._perm[np.searchsorted(self._cdf, rng.random())]
                out[b, t] = min(int(tok), self.vocab - 1)
                state = int(self._trans[state]) if rng.random() < 0.9 else int(
                    rng.integers(0, self.n_states)
                )
        return out


def batches(stream: TokenStream, *, batch: int, seq: int, steps: int, seed: int = 0):
    """Yield ``steps`` training batches: dict(tokens, labels)."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = stream.sample(rng, batch, seq + 1)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
