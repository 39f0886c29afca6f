"""Token data pipeline for the LM substrate: a deterministic synthetic
stream (Zipf-ish unigram + local repetition structure so models can learn)
with shift-by-one label alignment and sharded host loading."""
from __future__ import annotations

import numpy as np


def token_stream(vocab_size: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        yield int(rng.choice(vocab_size, p=probs))


def synthetic_lm_batch(batch: int, seq: int, vocab_size: int, seed: int = 0,
                       repeat_period: int = 16):
    """tokens/labels int32 [batch, seq+? -> seq]; labels are tokens shifted
    left by one (next-token).  A periodic copy pattern gives the model
    learnable structure (loss visibly decreases in the examples)."""
    rng = np.random.RandomState(seed)
    base = rng.zipf(1.5, size=(batch, seq + 1)).astype(np.int64)
    toks = (base % (vocab_size - 2)) + 1
    # inject copy structure: token at t == token at t - repeat_period
    for t in range(repeat_period, seq + 1, repeat_period):
        toks[:, t] = toks[:, t - repeat_period]
    tokens = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    return {"tokens": tokens, "labels": labels}
