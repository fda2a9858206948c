"""Synthetic graph generators (counterpart of ``repro.graph.generators``).

numpy with the same seeds and the same draws in the same order, so a
generator called with the same arguments returns the same arrays as its
``repro`` counterpart.  All return symmetric graphs with self loops
removed, the paper's input format (Sec. V-A).
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph

__all__ = ["regular_graph", "powerlaw_graph", "random_graph", "rmat_graph"]


def _finish(src, dst, n, rng, weighted, block_size):
    w = None
    if weighted:
        w = rng.uniform(1.0, 16.0, size=src.shape[0]).astype(np.float32)
    return Graph.from_coo(src, dst, n, weight=w, symmetrize=True,
                          block_size=block_size)


def _draw_targets(src, n, locality, rng, block_size):
    """Edge targets: with probability ``locality`` inside the source's
    block (a local neighbour, Eq. 4), else uniform over all vertices."""
    e = src.shape[0]
    local = rng.random(e) < locality
    blk = src // block_size
    lo = blk * block_size
    hi = np.minimum(lo + block_size, n)
    t_local = lo + rng.integers(0, block_size, size=e) % np.maximum(hi - lo, 1)
    t_remote = rng.integers(0, n, size=e)
    return np.where(local, t_local, t_remote)


def regular_graph(n: int, degree: int, locality: float = 0.5,
                  seed: int = 0, weighted: bool = False,
                  block_size: int = 256) -> Graph:
    """Near-regular graph: every vertex has ~``degree`` out-edges."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n, dtype=np.int64), degree)
    dst = _draw_targets(src, n, locality, rng, block_size)
    return _finish(src, dst, n, rng, weighted, block_size)


def powerlaw_graph(n: int, n_edges: int, alpha: float = 2.1,
                   max_degree: int | None = None, locality: float = 0.2,
                   hub_fraction: float = 1.0, degree_order: str = "shuffled",
                   seed: int = 0, weighted: bool = False,
                   block_size: int = 256) -> Graph:
    """Power-law (Zipf) degree sequence with configuration-model wiring.

    ``alpha`` is the Zipf exponent, ``max_degree`` caps hubs,
    ``hub_fraction`` packs hubs into the first tiles when below 1, and
    ``degree_order='sorted'`` keeps degrees rank-ordered by vertex id.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    weights = ranks ** (-alpha)
    deg = weights / weights.sum() * n_edges
    if max_degree is not None:
        deg = np.minimum(deg, max_degree)
    deg = np.maximum(deg, 1).astype(np.int64)
    if degree_order == "shuffled":
        n_hot = max(1, int(n * hub_fraction))
        perm = np.concatenate([
            rng.permutation(n_hot),
            n_hot + rng.permutation(n - n_hot),
        ]) if hub_fraction < 1.0 else rng.permutation(n)
        deg = deg[np.argsort(perm, kind="stable")]
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    dst = _draw_targets(src, n, locality, rng, block_size)
    return _finish(src, dst, n, rng, weighted, block_size)


def random_graph(n: int, n_edges: int, seed: int = 0, weighted: bool = False,
                 block_size: int = 256) -> Graph:
    """Erdos-Renyi-like uniform random graph."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=n_edges)
    dst = rng.integers(0, n, size=n_edges)
    return _finish(src, dst, n, rng, weighted, block_size)


def rmat_graph(scale: int, edge_factor: int = 8,
               a: float = 0.57, b: float = 0.19, c: float = 0.19,
               seed: int = 0, weighted: bool = False,
               block_size: int = 256) -> Graph:
    """Graph500-style R-MAT graph: ``2**scale`` vertices and about
    ``edge_factor * 2**scale`` edges before symmetrize and dedup."""
    n = 1 << scale
    e = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    for _ in range(scale):
        r = rng.random(e)
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = (((r >= a) & (r < a + b))
                   | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return _finish(src, dst, n, rng, weighted, block_size)
