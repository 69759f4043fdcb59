"""Synthetic token pipeline for the LM train step (a numpy copy of
`repro.data.tokens`, byte-equal output).

Deterministic per-(client, batch) token streams with a simple Markov-ish
structure, so a model has something learnable.
"""
from __future__ import annotations

import numpy as np


def synthetic_token_batches(*, vocab: int, seq_len: int, batch: int,
                            num_batches: int, num_clients: int = 1,
                            seed: int = 0) -> np.ndarray:
    """(clients, num_batches, batch, seq_len+1) int32 tokens.

    Each position t+1 depends on t via a fixed random permutation with noise
    (~1.5 bits of learnable structure per token). The generator stream is
    the dataset's identity, so it stays the reference's unsalted one.
    """
    # analysis: allow[rng-unstructured-seed] the generator stream IS the
    # dataset's identity, the reference's unsalted draws
    rng = np.random.default_rng(seed)
    succ = rng.permutation(vocab)  # deterministic successor table
    out = np.empty((num_clients, num_batches, batch, seq_len + 1), np.int32)
    x = rng.integers(0, vocab, size=(num_clients, num_batches, batch))
    for t in range(seq_len + 1):
        out[..., t] = x
        noise = rng.random(x.shape) < 0.3
        x = np.where(noise, rng.integers(0, vocab, size=x.shape), succ[x])
    return out

