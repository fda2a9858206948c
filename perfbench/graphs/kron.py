"""GAP "kron": the Graph500 Kronecker generator.

Beamer, Asanovic, Patterson, "The GAP Benchmark Suite",
arXiv:1508.03619: ``edge_factor * 2**scale`` edges, A/B/C =
0.57/0.19/0.19 in GAP's configuration (keys ``a``, ``b``, ``c``).
"""
from __future__ import annotations

import torch


def n_nodes(cfg: dict) -> int:
    return 1 << cfg["scale"]


def kron_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               gen: torch.Generator, device) -> tuple:
    """``edge_factor * 2**scale`` Kronecker edges: at every level one
    uniform draw picks a quadrant with probabilities a, b, c and
    ``1 - a - b - c``, which sets one bit of the source and of the
    target."""
    m = edge_factor << scale
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    cuts = torch.tensor([a, a + b, a + b + c], device=device)
    for level in range(scale):
        u = torch.rand(m, generator=gen, device=device)
        quad = (u[:, None] > cuts).sum(1)
        src |= (quad >> 1) << level
        dst |= (quad & 1) << level
    return src, dst


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    return kron_edges(cfg["scale"], cfg["edge_factor"], cfg["a"], cfg["b"],
                      cfg["c"], gen, device)
