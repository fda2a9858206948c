"""Maximal Independent Set (MIS, Luby): Table III, static traversal,
symmetric control, symmetric information.

Counterpart of ``repro.algorithms.mis``.  Two edge phases per round:
the least priority among undecided neighbours, then the broadcast of
freshly selected vertices.  Status: 0 undecided, 1 in the set, 2
removed.  The undecided set is the frontier and ``phase_min``'s
``spred`` restricts sources to it, so the min reduce is ``gatherable``;
the mark broadcast follows the same direction densely (its sources are
another mask).

Priorities are a random permutation of the vertex ids as float32, so
there are no ties.  ``jax.random.permutation`` cannot be reproduced in
torch: ``init(graph, key=None, priority=None)`` takes the priorities
when given (the parity tests hand it the reference's), else draws
``torch.randperm`` from ``key`` or the graph's default generator.
Given the same priorities the port is bit-identical to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms._random import permutation_priority
from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MAX, MIN,
                                             EdgePhase, VertexProgram)

__all__ = ["mis"]


def mis(max_iters: int = 256) -> VertexProgram:
    phase_min = EdgePhase(
        monoid=MIN,
        vprop=lambda st, src, w: st["priority"][src],
        spred=lambda st, src: st["status"][src] == 0,
        tpred=lambda st, dst: st["status"][dst] == 0,
        frontier=lambda st: st["status"] == 0,
        gatherable=True,  # spred == frontier membership
    )
    phase_mark = EdgePhase(
        monoid=MAX,
        vprop=lambda st, src, w: torch.ones_like(src, dtype=torch.float32),
        spred=lambda st, src: st["status"][src] == 1,
        tpred=lambda st, dst: st["status"][dst] == 0,
        frontier=lambda st: st["status"] == 1,
    )

    def init(graph, key=None, priority=None):
        v = graph.n_nodes
        priority = (permutation_priority(graph, key, salt=0)
                    if priority is None
                    else torch.as_tensor(priority, dtype=torch.float32))
        return {"status": torch.zeros(v, dtype=torch.int32),
                "priority": priority,
                FRONTIER_DIR_KEY: torch.tensor(False),
                FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC,
                                               dtype=torch.float32)}

    def step(ctx, st, it):
        pull = ctx.choose_direction(phase_min.frontier(st),
                                    st[FRONTIER_DIR_KEY])
        min_nbr, occ = ctx.propagate_sparse(st, phase_min, pull)
        select = (st["status"] == 0) & (st["priority"] < min_nbr)
        st1 = {**st, "status": torch.where(select, 1, st["status"])}
        marked = ctx.propagate_dynamic(st1, phase_mark, pull)
        status = torch.where((st1["status"] == 0) & (marked > 0), 2,
                             st1["status"])
        return {**st1, "status": status, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return ~(cur["status"] == 0).any(-1)

    # Certificate (``mis.py:84-101``): an O(E) max-reduce marks vertices
    # with an in-set neighbour: independence, maximality, completeness.
    cert_phase = EdgePhase(
        monoid=MAX,
        vprop=lambda st, src, w: torch.ones_like(src, dtype=torch.float32),
        spred=lambda st, src: st["status"][src] == 1,
    )

    def certificate(ctx, st):
        s = st["status"]
        nbr_in_mis = ctx.propagate(st, cert_phase) > 0
        independent = ~((s == 1) & nbr_in_mis).any()
        maximal = ((s != 2) | nbr_in_mis).all()
        decided = ~(s == 0).any()
        valid = ((s >= 0) & (s <= 2)).all()
        return independent & maximal & decided & valid

    return VertexProgram(
        name="MIS", init=init, step=step, converged=converged,
        extract=lambda st: st["status"] == 1, weighted=False,
        max_iters=max_iters,
        # a padding row of undecided zeros would never converge
        state_pad={"status": 2},
        frontier_init=lambda g: torch.ones(g.n_nodes, dtype=torch.bool),
        frontier_update=lambda st: st["status"] == 0,
        # Luby rounds only decide vertices; decided statuses and the
        # priorities never change
        sentinels={
            "status_frozen": lambda p, c: ((p["status"] == 0)
                                           | (c["status"] == p["status"])
                                           ).all(),
            "status_range": lambda p, c: ((c["status"] >= 0)
                                          & (c["status"] <= 2)).all(),
            "priority_frozen": lambda p, c: (c["priority"]
                                             == p["priority"]).all(),
        },
        certificate=certificate,
    )
