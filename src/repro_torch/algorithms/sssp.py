"""Single-Source Shortest Path: frontier-based Bellman-Ford relaxation
with a MIN monoid (Table III: static, source control, source info).

Counterpart of ``repro.algorithms.sssp``.  The frontier (vertices whose
distance improved last iteration) drives the dynamic configs'
direction; with no monotone unvisited set, the push->pull trigger is
the frontier-edge-density test.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MIN,
                                             EdgePhase, VertexProgram)

__all__ = ["sssp"]


def sssp(source: int = 0, max_iters: int = 4096) -> VertexProgram:
    phase = EdgePhase(
        monoid=MIN,
        vprop=lambda st, src, w: st["dist"][src] + w,
        spred=lambda st, src: st["active"][src],  # frontier only
        frontier=lambda st: st["active"],
        gatherable=True,  # spred == frontier membership
    )

    def frontier_init(graph):
        active = torch.zeros(graph.n_nodes, dtype=torch.bool)
        active[source] = True
        return active

    def init(graph, key=None):
        dist = torch.full((graph.n_nodes,), float("inf"), dtype=torch.float32)
        dist[source] = 0.0
        return {"dist": dist, "active": frontier_init(graph),
                FRONTIER_DIR_KEY: torch.tensor(False),
                FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC,
                                               dtype=torch.float32)}

    def step(ctx, st, it):
        pull = ctx.choose_direction(phase.frontier(st), st[FRONTIER_DIR_KEY])
        cand, occ = ctx.propagate_sparse(st, phase, pull)
        dist = torch.minimum(st["dist"], cand)
        active = dist < st["dist"]
        return {"dist": dist, "active": active, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return ~cur["active"].any(-1)

    # Certificate (``sssp.py:48-70``): one dense O(E) relaxation over the
    # finite-distance sources.  At a fixpoint every reached non-source
    # vertex's distance equals min(dist[u] + w) bit for bit (the same
    # float32 add the run made, reduced by an exact MIN).
    cert_phase = EdgePhase(
        monoid=MIN,
        vprop=lambda st, src, w: st["dist"][src] + w,
        spred=lambda st, src: torch.isfinite(st["dist"][src]),
    )

    def certificate(ctx, st):
        d = st["dist"]
        cand = ctx.propagate(st, cert_phase)
        reach = torch.isfinite(cand)
        is_src = torch.arange(d.shape[0], device=d.device) == source
        ok = torch.where(reach, (d == cand) | is_src, torch.isinf(d) | is_src)
        return ok.all() & ~st["active"].any()

    return VertexProgram(
        name="SSSP", init=init, step=step, converged=converged,
        extract=lambda st: st["dist"], weighted=True, max_iters=max_iters,
        frontier_init=frontier_init,
        frontier_update=lambda st: st["active"],
        # the MIN fixpoint only ever improves distances
        monotone={"dist": "non_increasing"},
        sentinels={"dist_nonnegative": lambda p, c: (c["dist"] >= 0.0).all()},
        certificate=certificate,
    )
