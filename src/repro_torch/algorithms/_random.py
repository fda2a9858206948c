"""Default generators for programs with randomized init.

Counterpart of ``repro.algorithms._random`` (``_random.py:24``).
``coloring`` and ``mis`` draw random priorities in ``init``.  Without a
caller's generator, each graph gets one seeded from a per-algorithm
salt and the graph's exact size, so two different graphs draw different
priorities by default and a repeat of one graph draws the same ones.
``jax.random`` cannot be reproduced in torch: the port's draws differ
from the reference's, and its parity tests hand ``init`` the
reference's priorities instead.
"""
from __future__ import annotations

import torch

__all__ = ["graph_key", "permutation_priority"]


def graph_key(graph, salt: int) -> torch.Generator:
    """A fresh CPU generator for one graph: its (n, m) identity mixed
    into a per-algorithm salt."""
    datum = (int(graph.n_nodes) * 1000003 + int(graph.n_edges)) % (2 ** 31)
    return torch.Generator().manual_seed(int(salt) * 2 ** 31 + datum)


def permutation_priority(graph, key, salt: int) -> torch.Tensor:
    """A random permutation of the vertex ids as float32 priorities:
    unique, so the selection has no ties."""
    key = key if key is not None else graph_key(graph, salt)
    return torch.randperm(int(graph.n_nodes), generator=key).float()
