"""Synthetic LM token pipeline: deterministic batches from a seed.

A copy of ``repro.data.tokens`` (numpy only).  A Markov-ish synthetic stream
gives non-trivial next-token structure; batches come with document
attributes for the DP corpus-statistics release.
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def synthetic_lm_batches(vocab_size: int, batch: int, seq_len: int,
                         seed: int = 0, n_sources: int = 8) -> Iterator[Dict]:
    rng = np.random.default_rng(seed)
    # low-rank bigram structure → learnable
    r = 16
    a = rng.standard_normal((min(vocab_size, 2048), r))
    b = rng.standard_normal((r, min(vocab_size, 2048)))
    logits = (a @ b) * 1.5
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    v_eff = probs.shape[0]
    while True:
        toks = np.zeros((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v_eff, batch)
        for t in range(seq_len):
            p = probs[toks[:, t]]
            c = p.cumsum(axis=1)
            u = rng.random((batch, 1))
            toks[:, t + 1] = (u > c).sum(axis=1)
        yield {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
            # document attributes for DP corpus stats: (source, length bucket)
            "doc_attrs": np.stack([
                rng.integers(0, n_sources, batch),
                np.full(batch, min(seq_len // 512, 7)),
            ], axis=1).astype(np.int32),
        }
