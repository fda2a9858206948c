"""Graph Coloring (CLR, Jones-Plassmann): Table III, static traversal,
symmetric control, target information.

Counterpart of ``repro.algorithms.coloring``.  Round r: every
uncolored vertex whose priority beats every uncolored neighbour takes
color r.  The uncolored set is a shrinking frontier and ``spred``
restricts sources to it, so the phase is ``gatherable``: dynamic
configs start pull on the saturated frontier and hand the tail to
sparse push iterations.  ``it`` is a device int32 scalar; the round
number written into ``color`` comes from it on the device.

Priorities as in :mod:`repro_torch.algorithms.mis`:
``init(graph, key=None, priority=None)`` takes the reference's when the
parity tests give them, else draws ``torch.randperm``.  Given the same
priorities the port is bit-identical to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms._random import permutation_priority
from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MAX,
                                             EdgePhase, VertexProgram)

__all__ = ["coloring"]


def coloring(max_iters: int = 512) -> VertexProgram:
    phase = EdgePhase(
        monoid=MAX,
        vprop=lambda st, src, w: st["priority"][src],
        spred=lambda st, src: st["color"][src] < 0,
        tpred=lambda st, dst: st["color"][dst] < 0,
        frontier=lambda st: st["color"] < 0,
        gatherable=True,  # spred == frontier membership
    )

    def init(graph, key=None, priority=None):
        v = graph.n_nodes
        priority = (permutation_priority(graph, key, salt=1)
                    if priority is None
                    else torch.as_tensor(priority, dtype=torch.float32))
        return {"color": torch.full((v,), -1, dtype=torch.int32),
                "priority": priority,
                FRONTIER_DIR_KEY: torch.tensor(False),
                FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC,
                                               dtype=torch.float32)}

    def step(ctx, st, it):
        pull = ctx.choose_direction(phase.frontier(st),
                                    st[FRONTIER_DIR_KEY])
        max_nbr, occ = ctx.propagate_sparse(st, phase, pull)
        # -inf when no uncolored neighbour
        win = (st["color"] < 0) & (st["priority"] > max_nbr)
        color = torch.where(win, ctx.per_vertex(it.to(torch.int32)),
                            st["color"])
        return {**st, "color": color, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return (cur["color"] >= 0).all(-1)

    return VertexProgram(
        name="CLR", init=init, step=step, converged=converged,
        extract=lambda st: st["color"], weighted=False, max_iters=max_iters,
        frontier_init=lambda g: torch.ones(g.n_nodes, dtype=torch.bool),
        frontier_update=lambda st: st["color"] < 0,
    )
