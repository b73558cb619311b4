"""Deterministic synthetic data pipelines — a copy of
``repro.train.data`` (numpy only; the port imports nothing of the
reference), so both packages draw the same batches bit for bit.

Every batch is a pure function of (seed, step) — restart-safe data
skipping comes for free: after restoring step N, the pipeline resumes at
batch N+1 with no state to persist (the paper-grade alternative for real
corpora is an offset manifest in the checkpoint; the interface below
carries the offset through ``state['data_step']``)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def lm_batch(step: int, batch: int, seq: int, vocab: int,
             seed: int = 0) -> Dict[str, np.ndarray]:
    """Zipf-ish token stream with local structure (next-token learnable)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = base % (vocab - 2) + 1
    # inject copy structure so a real signal exists: shift-by-1 spans
    src = np.roll(toks, 1, axis=1)
    mask = rng.random((batch, seq)) < 0.3
    toks = np.where(mask, src, toks)
    return {"tokens": toks.astype(np.int32)}


def dlrm_batch(step: int, batch: int, n_dense: int, n_sparse: int,
               vocab: int, bag: int = 1, seed: int = 0
               ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(np.uint64(seed * 9_176_549 + step))
    dense = rng.standard_normal((batch, n_dense)).astype(np.float32)
    sparse = (rng.zipf(1.2, size=(batch, n_sparse, bag)) - 1) % vocab
    # clicks correlated with a fixed random hyperplane over dense feats
    w = np.random.default_rng(seed + 7).standard_normal(n_dense)
    p = 1.0 / (1.0 + np.exp(-(dense @ w) * 0.7))
    labels = (rng.random(batch) < p).astype(np.float32)
    return {"dense": dense, "sparse": sparse.astype(np.int32),
            "labels": labels}
