"""Synthetic data sources (counterpart of ``repro.data.synthetic``).

Deterministic per (seed, step): numpy's ``default_rng((seed, step))``
draws the same arrays as the reference, so both packages see identical
batches.
"""
from __future__ import annotations

import numpy as np

__all__ = ["lm_batch", "gnn_batch", "dlrm_batch"]


def lm_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """One LM batch as numpy arrays (``synthetic.py:11-16``, copied
    exactly): zipf(1.3) token ids modulo ``vocab``, tokens [B, S] and the
    next-token labels [B, S], int32."""
    rng = np.random.default_rng((seed, step))
    # zipf-ish marginals so the loss curve is non-trivial
    tok = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64) % vocab
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


def gnn_batch(step: int, graph, d_feat: int, n_classes: int, seed: int = 0):
    """One node-classification batch on ``graph`` (a host
    ``repro_torch.graph.Graph``) as numpy arrays (``synthetic.py:19-28``,
    copied exactly): node_feat [N, d_feat] f32, the by-src edge list src
    and dst [E] int32, in_degree [N] int32 and labels [N] int32 in
    ``[0, n_classes)``."""
    rng = np.random.default_rng((seed, step))
    n = graph.n_nodes
    return {
        "node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
        "src": np.asarray(graph.src, np.int32),
        "dst": np.asarray(graph.dst, np.int32),
        "in_degree": np.asarray(graph.in_degree, np.int32),
        "labels": rng.integers(0, n_classes, n).astype(np.int32),
    }


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
