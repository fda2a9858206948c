"""The benchmark's graphs, made in torch on one device.

A configuration names its generator by ``"generator"``, and the graph
is drawn by ``graphs/<generator>.py`` (:mod:`perfbench.graphs`), found
by file: its ``n_nodes(cfg)`` is the vertex count and its
``edges(cfg, gen, device)`` the undirected draw.  What every graph
shares is here: the edges are symmetrised with self-loops and
duplicates removed; SSSP's weights are uniform integers in
``cfg["weights"]``, drawn once per generated edge so that both
directions of an edge carry the same weight, and a duplicate keeps the
smallest.

The structure (edges, weights and the SSSP sources) comes from the
configuration's fixed ``structure_seed``; the run's ``--seed`` draws the
vertex labels and the order the sources are cycled in.  So every seed
runs the same graph under another labelling: the same work, in another
order of edges, blocks and chunks.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from perfbench.registry import HERE, load_module

__all__ = ["Coo", "generate", "symmetrize"]


@dataclasses.dataclass
class Coo:
    """An undirected graph as directed COO arrays on the host (int64
    endpoints, float32 integer weights), its vertex count, and the
    sources a program cycles through, in the run's order."""
    src: np.ndarray
    dst: np.ndarray
    weight: np.ndarray
    n_nodes: int
    sources: list

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


def symmetrize(src: torch.Tensor, dst: torch.Tensor, weight: torch.Tensor,
               n_nodes: int) -> tuple:
    """Both directions of every edge, no self-loops, and one edge per
    ordered pair, with the smallest weight of its duplicates.  Weights
    must be integers in ``[0, 255]``.  The result is sorted by
    ``(src, dst)``."""
    s = torch.cat([src, dst])
    d = torch.cat([dst, src])
    w = torch.cat([weight, weight])
    keep = s != d
    key = ((s[keep] * n_nodes + d[keep]) << 8) | w[keep]
    key = torch.sort(key).values
    pair = key >> 8
    first = torch.ones_like(pair, dtype=torch.bool)
    first[1:] = pair[1:] != pair[:-1]
    key = key[first]
    pair = key >> 8
    return pair // n_nodes, pair % n_nodes, key & 255


def generate(cfg: dict, seed: int, n_sources: int, device,
             here: Path = HERE) -> Coo:
    """The graph of configuration ``cfg`` labelled by ``seed``, with
    ``n_sources`` sources among the vertices of nonzero degree, drawn by
    the generator file ``<here>/graphs/<cfg["generator"]>.py``."""
    graph = load_module(Path(here) / "graphs" / f"{cfg['generator']}.py")
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(cfg["structure_seed"]))
    n = graph.n_nodes(cfg)
    src, dst = graph.edges(cfg, gen, device)
    low, high = cfg["weights"]
    weight = torch.randint(low, high + 1, src.shape, generator=gen,
                           device=device)
    src, dst, weight = symmetrize(src, dst, weight, n)
    del gen
    sources = torch.empty(0, dtype=torch.int64, device=device)
    if n_sources:
        deg = torch.bincount(src, minlength=n)
        cand = torch.nonzero(deg > 0).flatten()
        pick = torch.Generator(device=device)
        pick.manual_seed(int(cfg["structure_seed"]) + 1)
        order = torch.randperm(cand.shape[0], generator=pick, device=device)
        sources = cand[order[:n_sources]]
    run_gen = torch.Generator(device=device)
    run_gen.manual_seed(int(seed))
    labels = torch.randperm(n, generator=run_gen, device=device)
    cycle = torch.randperm(max(n_sources, 1), generator=run_gen,
                           device=device)[:n_sources]
    sources = labels[sources][cycle]
    return Coo(src=labels[src].cpu().numpy(), dst=labels[dst].cpu().numpy(),
               weight=weight.to(torch.float32).cpu().numpy(), n_nodes=n,
               sources=[int(s) for s in sources.tolist()])
