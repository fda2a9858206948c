"""Connected Components (CC), a dynamic traversal (Table III: '-').

Counterpart of ``repro.algorithms.cc``.  ECL-CC style rounds
(Jaiganesh & Burtscher [26]): *hooking*, a min-label reduce over the
edges whose direction alternates per round (``(it % 2) == 1`` pulls,
through ``ctx.dynamic_direction``, so a static config keeps its own
and the trace reports what ran), then *pointer jumping*,
``label[v] <- label[label[v]]``, which chases transitive edges that are
not in the graph.  ``it`` is a device int32 scalar under both engines,
so the alternation is a device value the fused engine branches on.
Labels are int32 vertex ids and every operation is exact: the port is
bit-identical to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, MIN,
                                             EdgePhase, VertexProgram)

__all__ = ["cc"]

_JUMPS_PER_ROUND = 2


def cc(max_iters: int = 512) -> VertexProgram:
    phase = EdgePhase(
        monoid=MIN,
        vprop=lambda st, src, w: st["label"][src],
    )

    def init(graph, key=None):
        return {"label": torch.arange(graph.n_nodes, dtype=torch.int32),
                FRONTIER_DIR_KEY: torch.tensor(False),
                FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC,
                                               dtype=torch.float32)}

    def step(ctx, st, it):
        pull = ctx.dynamic_direction((it % 2) == 1)
        nbr_min, occ = ctx.propagate_sparse(st, phase, pull,
                                            dtype=torch.int32)
        label = torch.minimum(st["label"], nbr_min)
        # labels are local ids; a batched context shifts them to rows
        off = ctx.vertex_offsets()
        for _ in range(_JUMPS_PER_ROUND):
            label = label[(label + off).long()]
        return {**st, "label": label, FRONTIER_DIR_KEY: pull,
                FRONTIER_OCC_KEY: occ}

    def converged(prev, cur):
        return (prev["label"] == cur["label"]).all(-1)

    def in_range(lab):
        return ((lab >= 0)
                & (lab <= torch.arange(lab.shape[0], device=lab.device))).all()

    # Certificate (``cc.py:71-81``): every label lies in [0, own id], the
    # labels are pointer-jumping-stable (label[label] == label), and the
    # min-label reduce over the edges returns each vertex's own label.
    def certificate(ctx, st):
        lab = st["label"]
        nbr = ctx.propagate(st, phase, dtype=torch.int32)
        has_nbr = nbr < torch.iinfo(torch.int32).max
        at = torch.clamp(lab, 0, lab.shape[0] - 1).long()  # safe gather
        root_fixed = (lab[at] == lab).all()
        edges_agree = (~has_nbr | (nbr == lab)).all()
        return in_range(lab) & root_fixed & edges_agree

    return VertexProgram(
        name="CC", init=init, step=step, converged=converged,
        extract=lambda st: st["label"], weighted=False, max_iters=max_iters,
        frontier_init=lambda g: torch.ones(g.n_nodes, dtype=torch.bool),
        frontier_update=lambda st: torch.ones_like(st["label"],
                                                   dtype=torch.bool),
        monotone={"label": "non_increasing"},
        sentinels={"label_range": lambda p, c: in_range(c["label"])},
        certificate=certificate,
    )
