"""PageRank (Table III: static traversal, symmetric control, source
information).

Counterpart of ``repro.algorithms.pagerank``.  Topology-driven: every
vertex is active every iteration, so the frontier protocol sees a
saturated all-ones mask and dynamic configs settle on pull.  ``inv_v``
carries ``1/V`` as a float32 scalar in the state, as the reference
does.  The rank update is float arithmetic whose rounding depends on
how it is fused, so ranks agree with the reference to a tolerance, not
bit for bit, and the iteration count may differ by one.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, SUM,
                                             EdgePhase, VertexProgram)

__all__ = ["pagerank"]


def pagerank(damping: float = 0.85, tol: float = 1e-6,
             max_iters: int = 256) -> VertexProgram:
    phase = EdgePhase(
        monoid=SUM,
        vprop=lambda st, src, w: st["rank"][src] * st["inv_out"][src],
        frontier=lambda st: st["active"],
        # every source contributes every iteration, so the sparse gather
        # would be unsound
        gatherable=False,
    )

    def init(graph, key=None):
        v = graph.n_nodes
        out_deg = torch.as_tensor(graph.out_degree)
        return {
            "rank": torch.full((v,), 1.0 / v, dtype=torch.float32),
            "inv_out": (1.0 / torch.clamp(out_deg, min=1)).float(),
            "dangling": out_deg == 0,
            "inv_v": torch.tensor(1.0 / v, dtype=torch.float32),
            "active": torch.ones(v, dtype=torch.bool),
            FRONTIER_DIR_KEY: torch.tensor(False),
            FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC, dtype=torch.float32),
        }

    def step(ctx, st, it):
        pull = ctx.choose_direction(st["active"], st[FRONTIER_DIR_KEY])
        reduced, occ = ctx.propagate_sparse(st, phase, pull)
        inv_v = ctx.align_per_graph(st["inv_v"])
        dangling_mass = ctx.align_per_graph(
            ctx.per_graph_sum(torch.where(st["dangling"], st["rank"], 0.0)))
        rank = torch.where(
            st["active"],
            (1.0 - damping) * inv_v
            + damping * (reduced + dangling_mass * inv_v),
            0.0)
        return {**st, "rank": rank, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return (prev["rank"] - cur["rank"]).abs().sum(-1) < tol

    return VertexProgram(
        name="PR", init=init, step=step, converged=converged,
        extract=lambda st: st["rank"], weighted=False, max_iters=max_iters,
        frontier_init=lambda g: torch.ones(g.n_nodes, dtype=torch.bool),
        frontier_update=lambda st: st["active"],
    )
