"""Fanout neighbor sampler (GraphSAGE-style) for the ``minibatch_lg`` shape.

Counterpart of ``repro.graph.sampler``.  Sampling is ragged host work
over the CSC order, drawn from ``np.random.default_rng(seed)`` exactly as
the reference draws, so the same graph, fanouts and seed give the same
blocks bit for bit.  The blocks are fixed-shape padded numpy arrays that
a model moves to the card in one copy each.  A graph whose arrays are
tensors (on the card after :meth:`Graph.to`) is read back to the host
once, when the sampler is made.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph, host_array

__all__ = ["SampledBlock", "NeighborSampler"]


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One hop: for each of B seed nodes, up to `fanout` sampled in-edges.

    Padded with sentinel node id == n_nodes; `edge_mask` marks real edges.
    Layout matches the push executor: edges listed target-major so the
    aggregation is a segment reduction over `dst_local`.
    """
    seeds: np.ndarray        # [B] global node ids of this hop's targets
    src_global: np.ndarray   # [B*fanout] sampled source ids (global)
    dst_local: np.ndarray    # [B*fanout] target index in [0, B)
    edge_mask: np.ndarray    # [B*fanout] bool
    fanout: int


class NeighborSampler:
    def __init__(self, g: Graph, fanouts: tuple[int, ...], seed: int = 0):
        self.row_ptr = host_array(g.row_ptr_in).astype(np.int64)
        self.col = host_array(g.src_in).astype(np.int64)
        self.n_nodes = g.n_nodes
        self.fanouts = tuple(fanouts)
        self._rng = np.random.default_rng(seed)

    def sample_hop(self, seeds: np.ndarray, fanout: int) -> SampledBlock:
        b = seeds.shape[0]
        starts = self.row_ptr[seeds]
        degs = self.row_ptr[seeds + 1] - starts
        # uniform with replacement (standard GraphSAGE), vectorised
        offs = self._rng.integers(0, 2**62, size=(b, fanout))
        offs = np.where(degs[:, None] > 0, offs % np.maximum(degs, 1)[:, None], 0)
        idx = starts[:, None] + offs
        src = self.col[np.minimum(idx, self.col.shape[0] - 1)]
        mask = (degs[:, None] > 0) & (np.arange(fanout)[None, :] <
                                      np.maximum(degs, fanout)[:, None])
        mask &= degs[:, None] > 0
        src = np.where(mask, src, self.n_nodes)
        dst_local = np.repeat(np.arange(b, dtype=np.int64), fanout)
        return SampledBlock(
            seeds=seeds.astype(np.int64),
            src_global=src.reshape(-1),
            dst_local=dst_local,
            edge_mask=mask.reshape(-1),
            fanout=fanout,
        )

    def sample(self, seeds: np.ndarray) -> list[SampledBlock]:
        """Multi-hop: returns blocks outermost-hop-first.  Each hop's
        frontier is the (padded) union of sampled sources."""
        blocks: list[SampledBlock] = []
        frontier = np.asarray(seeds, dtype=np.int64)
        for f in self.fanouts:
            blk = self.sample_hop(frontier, f)
            blocks.append(blk)
            nxt = blk.src_global[blk.edge_mask]
            frontier = np.unique(np.concatenate([frontier, nxt]))
        return blocks
