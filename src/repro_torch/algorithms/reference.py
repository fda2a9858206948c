"""Pure-numpy oracles for BFS, SSSP and PageRank (a copy of
``repro.algorithms.reference:13-68``).  They read the host graph's
numpy arrays and share no code with the executor they check."""
from __future__ import annotations

import numpy as np

__all__ = ["bfs_np", "pagerank_np", "sssp_np"]


def bfs_np(g, source=0):
    """Level-synchronous BFS depths; -1 for unreachable vertices."""
    v = g.n_nodes
    row_ptr = np.asarray(g.row_ptr_out, np.int64)
    col = np.asarray(g.dst, np.int64)
    depth = np.full(v, -1, np.int32)
    depth[source] = 0
    frontier = [source]
    while frontier:
        nxt = []
        for u in frontier:
            for e in range(row_ptr[u], row_ptr[u + 1]):
                t = col[e]
                if depth[t] == -1:
                    depth[t] = depth[u] + 1
                    nxt.append(t)
        frontier = nxt
    return depth


def pagerank_np(g, damping=0.85, tol=1e-6, max_iters=256):
    v = g.n_nodes
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    out_deg = np.asarray(g.out_degree, np.float64)
    rank = np.full(v, 1.0 / v)
    inv = 1.0 / np.maximum(out_deg, 1)
    dangling = out_deg == 0
    for _ in range(max_iters):
        contrib = np.zeros(v)
        np.add.at(contrib, dst, rank[src] * inv[src])
        dm = rank[dangling].sum()
        new = (1 - damping) / v + damping * (contrib + dm / v)
        if np.abs(new - rank).sum() < tol:
            rank = new
            break
        rank = new
    return rank.astype(np.float32)


def sssp_np(g, source=0):
    """Bellman-Ford (graphs are symmetric; no negative weights)."""
    v = g.n_nodes
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    w = np.asarray(g.weight, np.float64)
    dist = np.full(v, np.inf)
    dist[source] = 0.0
    for _ in range(v):
        cand = dist[src] + w
        new = dist.copy()
        np.minimum.at(new, dst, cand)
        if np.array_equal(new, dist, equal_nan=True):
            break
        dist = new
    return dist.astype(np.float32)
