"""Breadth-First Search, the canonical direction-optimizing traversal.

Counterpart of ``repro.algorithms.bfs``.  Level-synchronous BFS with
the frontier protocol: the frontier and the unvisited set feed
``ctx.choose_direction``; sparse push iterations go through the
gathered path of ``ctx.propagate_sparse``.  Depths are int32 with -1
for unvisited; the MIN monoid over ``depth[src] + 1`` makes the
reduction direction-agnostic.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MIN,
                                             EdgePhase, VertexProgram)

__all__ = ["bfs"]

_UNSEEN = -1
_INT32_MAX = torch.iinfo(torch.int32).max


def bfs(source: int = 0, max_iters: int = 4096) -> VertexProgram:
    phase = EdgePhase(
        monoid=MIN,
        vprop=lambda st, src, w: st["depth"][src] + 1,
        spred=lambda st, src: st["active"][src],          # frontier only
        tpred=lambda st, dst: st["depth"][dst] == _UNSEEN,
        frontier=lambda st: st["active"],
        gatherable=True,  # spred == frontier membership
    )

    def frontier_init(graph):
        active = torch.zeros(graph.n_nodes, dtype=torch.bool)
        active[source] = True
        return active

    def init(graph, key=None):
        depth = torch.full((graph.n_nodes,), _UNSEEN, dtype=torch.int32)
        depth[source] = 0
        return {"depth": depth, "active": frontier_init(graph),
                FRONTIER_DIR_KEY: torch.tensor(False),
                FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC,
                                               dtype=torch.float32)}

    def step(ctx, st, it):
        unvisited = st["depth"] == _UNSEEN
        pull = ctx.choose_direction(phase.frontier(st), st[FRONTIER_DIR_KEY],
                                    unvisited=unvisited)
        cand, occ = ctx.propagate_sparse(st, phase, pull, dtype=torch.int32)
        newly = unvisited & (cand < _INT32_MAX)
        depth = torch.where(newly, cand, st["depth"]).to(torch.int32)
        return {"depth": depth, "active": newly, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return ~cur["active"].any(-1)

    return VertexProgram(
        name="BFS", init=init, step=step, converged=converged,
        extract=lambda st: st["depth"], weighted=False, max_iters=max_iters,
        frontier_init=frontier_init,
        frontier_update=lambda st: st["active"],
    )
