"""Synthetic data sources (counterpart of ``repro.data.synthetic``).

Deterministic per (seed, step): numpy's ``default_rng((seed, step))``
draws the same arrays as the reference, so both packages see identical
batches.  Only the DLRM source is ported so far.
"""
from __future__ import annotations

import numpy as np

__all__ = ["dlrm_batch"]


def dlrm_batch(step: int, batch: int, vocab_sizes, multi_hot: int = 1,
               seed: int = 0):
    """One DLRM batch as numpy arrays (``synthetic.py:31-41``, copied
    exactly): dense [B, 13] f32, sparse [B, F, multi_hot] int32 with
    feature f's indices drawn in ``[0, vocab_sizes[f])``, label [B]
    int32."""
    rng = np.random.default_rng((seed, step))
    sparse = np.stack(
        [rng.integers(0, v, (batch, multi_hot)) for v in vocab_sizes],
        axis=1).astype(np.int32)
    return {
        "dense": rng.standard_normal((batch, 13)).astype(np.float32),
        "sparse": sparse,
        "label": rng.integers(0, 2, batch).astype(np.int32),
    }
