"""Betweenness Centrality (BC, Brandes, one root): Table III, static
traversal, source control, symmetric information.

Counterpart of ``repro.algorithms.bc``.  One uniform step holds two
stages behind ``ctx.cond_per_graph``: the forward BFS accumulating
shortest-path counts ``sigma``, then the backward, level by level
dependency accumulation ``delta[v] = sigma[v] * sum over successors w
of (1 + delta[w]) / sigma[w]``.  Both stages are frontier phases, so
dynamic configs direction-optimize both sweeps.  Under the fused
engine the stage choice is a pair of IF nodes like the direction and
the gather fit inside it.

``cur_level`` and ``phase`` are int32 scalars; the phases compare
depths against the per-vertex broadcast ``st["lvl"]`` that ``step``
adds for the duration of a step.  The sums are float32 (``sigma`` is
integral and exact up to 2**24; ``delta`` is not), so the port agrees
with the reference to a tolerance.
"""
from __future__ import annotations

import torch

from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, SUM,
                                             EdgePhase, VertexProgram)

__all__ = ["bc"]


def bc(root: int = 0, max_iters: int = 4096) -> VertexProgram:
    fwd = EdgePhase(
        monoid=SUM,
        vprop=lambda st, src, w: st["sigma"][src],
        spred=lambda st, src: st["depth"][src] == st["lvl"][src],
        tpred=lambda st, dst: st["depth"][dst] == -1,
        frontier=lambda st: st["depth"] == st["lvl"],
        gatherable=True,  # spred == frontier membership
    )
    bwd = EdgePhase(
        monoid=SUM,
        vprop=lambda st, src, w: (1.0 + st["delta"][src])
        / torch.clamp(st["sigma"][src], min=1e-30),
        spred=lambda st, src: st["depth"][src] == st["lvl"][src] + 1,
        tpred=lambda st, dst: st["depth"][dst] == st["lvl"][dst],
        frontier=lambda st: st["depth"] == st["lvl"] + 1,
        gatherable=True,  # spred == frontier membership
    )

    def init(graph, key=None):
        v = graph.n_nodes
        depth = torch.full((v,), -1, dtype=torch.int32)
        depth[root] = 0
        sigma = torch.zeros(v, dtype=torch.float32)
        sigma[root] = 1.0
        return {
            "depth": depth, "sigma": sigma,
            "delta": torch.zeros(v, dtype=torch.float32),
            "cur_level": torch.tensor(0, dtype=torch.int32),
            "phase": torch.tensor(0, dtype=torch.int32),  # 0 fwd, 1 bwd
            FRONTIER_DIR_KEY: torch.tensor(False),
            FRONTIER_OCC_KEY: torch.tensor(DENSE_OCC, dtype=torch.float32),
        }

    def step(ctx, st, it):
        def forward(st):
            pull = ctx.choose_direction(fwd.frontier(st),
                                        st[FRONTIER_DIR_KEY],
                                        unvisited=st["depth"] == -1)
            contrib, occ = ctx.propagate_sparse(st, fwd, pull)
            newly = (st["depth"] == -1) & (contrib > 0)
            depth = torch.where(newly, st["lvl"] + 1, st["depth"])
            sigma = torch.where(newly, contrib, st["sigma"])
            any_new = ctx.per_graph_any(newly)
            # forward done: the deepest level is cur_level, and backward
            # starts one above it (its delta is identically zero)
            return {
                **st, "depth": depth, "sigma": sigma,
                "phase": torch.where(any_new, 0, 1).to(torch.int32),
                "cur_level": torch.where(any_new, st["cur_level"] + 1,
                                         st["cur_level"] - 1),
                FRONTIER_DIR_KEY: pull, FRONTIER_OCC_KEY: occ,
            }

        def backward(st):
            pull = ctx.choose_direction(bwd.frontier(st),
                                        st[FRONTIER_DIR_KEY])
            red, occ = ctx.propagate_sparse(st, bwd, pull)
            hit = st["depth"] == st["lvl"]
            delta = torch.where(hit, st["sigma"] * red, st["delta"])
            return {**st, "delta": delta,
                    "cur_level": st["cur_level"] - 1,
                    FRONTIER_DIR_KEY: pull, FRONTIER_OCC_KEY: occ}

        def without_lvl(stage):
            # the broadcast lives for one step only
            return lambda s: {k: t for k, t in stage(s).items()
                              if k != "lvl"}

        st = {**st, "lvl": ctx.per_vertex(st["cur_level"])}
        return ctx.cond_per_graph(st["phase"] == 0, without_lvl(forward),
                                  without_lvl(backward), st)

    def converged(prev, cur):
        return (cur["phase"] == 1) & (cur["cur_level"] < 0)

    def extract(st):
        # dependency scores; the root's own is excluded by convention
        delta = st["delta"].clone()
        delta[root] = 0.0
        return delta

    def frontier_init(graph):
        active = torch.zeros(graph.n_nodes, dtype=torch.bool)
        active[root] = True
        return active

    return VertexProgram(
        name="BC", init=init, step=step, converged=converged,
        extract=extract, weighted=False, max_iters=max_iters,
        # padding depth is no level and not unvisited (-1)
        state_pad={"depth": -2},
        frontier_init=frontier_init,
        frontier_update=lambda st: st["depth"] == st["cur_level"],
    )
