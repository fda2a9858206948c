"""GAP "urand": uniform random endpoints (Erdos-Renyi).

Beamer, Asanovic, Patterson, "The GAP Benchmark Suite",
arXiv:1508.03619: ``edge_factor * 2**scale`` edges, both endpoints of
each drawn uniformly.
"""
from __future__ import annotations

import torch


def n_nodes(cfg: dict) -> int:
    return 1 << cfg["scale"]


def urand_edges(scale: int, edge_factor: int, gen: torch.Generator,
                device) -> tuple:
    """``edge_factor * 2**scale`` edges with uniform endpoints."""
    m, v = edge_factor << scale, 1 << scale
    src = torch.randint(0, v, (m,), generator=gen, device=device)
    dst = torch.randint(0, v, (m,), generator=gen, device=device)
    return src, dst


def edges(cfg: dict, gen: torch.Generator, device) -> tuple:
    return urand_edges(cfg["scale"], cfg["edge_factor"], gen, device)
