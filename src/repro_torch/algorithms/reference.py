"""Pure-numpy oracles of the seven applications (a copy of
``repro.algorithms.reference:13-142``).  They read the host graph's
numpy arrays and share no code with the executor they check."""
from __future__ import annotations

import numpy as np

__all__ = ["bfs_np", "pagerank_np", "sssp_np", "cc_np", "bc_np",
           "is_independent_set", "is_maximal_independent_set",
           "is_proper_coloring"]


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


def cc_np(g):
    """Min-vertex-id component labels via BFS union."""
    v = g.n_nodes
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    label = np.arange(v)
    changed = True
    while changed:
        new = label.copy()
        np.minimum.at(new, dst, label[src])
        np.minimum.at(new, src, label[dst])
        new = new[new]  # pointer jump
        changed = not np.array_equal(new, label)
        label = new
    return label.astype(np.int32)


def bc_np(g, root=0):
    """Brandes single-root dependency scores (unweighted)."""
    v = g.n_nodes
    row_ptr = np.asarray(g.row_ptr_out, np.int64)
    col = np.asarray(g.dst, np.int64)
    depth = np.full(v, -1, np.int64)
    sigma = np.zeros(v)
    depth[root], sigma[root] = 0, 1.0
    frontier = [root]
    order = [root]
    while frontier:
        nxt = []
        for u in frontier:
            for e in range(row_ptr[u], row_ptr[u + 1]):
                t = col[e]
                if depth[t] == -1:
                    depth[t] = depth[u] + 1
                    nxt.append(t)
                    order.append(t)
                if depth[t] == depth[u] + 1:
                    sigma[t] += sigma[u]
        frontier = nxt
    delta = np.zeros(v)
    for u in reversed(order):
        for e in range(row_ptr[u], row_ptr[u + 1]):
            t = col[e]
            if depth[t] == depth[u] + 1:
                delta[u] += sigma[u] / sigma[t] * (1.0 + delta[t])
    delta[root] = 0.0
    return delta.astype(np.float32)


def is_independent_set(g, member: np.ndarray) -> bool:
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    return not np.any(member[src] & member[dst])


def is_maximal_independent_set(g, member: np.ndarray) -> bool:
    if not is_independent_set(g, member):
        return False
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    # every non-member must have a member neighbor
    covered = np.zeros(g.n_nodes, bool)
    covered[dst[member[src]]] = True
    covered[src[member[dst]]] = True
    return bool(np.all(member | covered))


def is_proper_coloring(g, color: np.ndarray) -> bool:
    src = np.asarray(g.src, np.int64)
    dst = np.asarray(g.dst, np.int64)
    return bool(np.all(color >= 0)
                and not np.any(color[src] == color[dst]))
