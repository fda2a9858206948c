"""Graph partitioning for distributed (multi-device) execution.

Counterpart of ``repro.graph.partition``: the same two layouts, the same
dtypes and the same padding, array for array.

- ``partition_edges_1d``: the by-src edges dealt round-robin over the
  devices; each device accumulates a partial vertex array over its own
  edges and one reduction combines them (the *owned*, DeNovo-analogue
  schedule at cluster scale).
- ``partition_vertices``: contiguous vertex ranges per device ("owner
  computes"), each device holding the CSC edges whose target it owns
  (the *llc* schedule: every message goes to the target's owner).

Both are host layout steps: they return numpy arrays (int32 ids,
float32 weights), padded to a rectangular ``[D, Ep]`` with ``Ep`` a
multiple of 8 and the sentinel target ``n_nodes``.  A graph whose arrays
are tensors (on the card after :meth:`Graph.to`) is read back to the
host first.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graph.structure import Graph, host_array

__all__ = ["EdgePartition", "VertexPartition", "partition_edges_1d",
           "partition_vertices"]


@dataclasses.dataclass(frozen=True)
class EdgePartition:
    """[D, Ep] edge arrays padded with a sentinel target ``n_nodes``."""
    src: np.ndarray      # [D, Ep] int32
    dst: np.ndarray      # [D, Ep] int32
    weight: np.ndarray   # [D, Ep] float32
    n_devices: int
    n_nodes: int
    edges_per_device: int


@dataclasses.dataclass(frozen=True)
class VertexPartition:
    """Contiguous vertex ranges; per-device edge lists grouped by owner of
    ``dst`` (so each device receives exactly the updates it owns)."""
    vertex_offsets: np.ndarray   # [D+1] int32
    src: np.ndarray              # [D, Ep] int32
    dst: np.ndarray              # [D, Ep] int32 (global ids)
    weight: np.ndarray           # [D, Ep] float32
    n_devices: int
    n_nodes: int
    edges_per_device: int


def _pad_groups(groups, sentinel_dst, n_devices):
    ep = max(1, max(g[0].shape[0] for g in groups))
    # round up to a multiple of 8 lanes for friendlier layouts
    ep = (ep + 7) // 8 * 8
    src = np.zeros((n_devices, ep), dtype=np.int32)
    dst = np.full((n_devices, ep), sentinel_dst, dtype=np.int32)
    w = np.zeros((n_devices, ep), dtype=np.float32)
    for d, (s, t, ww) in enumerate(groups):
        k = s.shape[0]
        src[d, :k], dst[d, :k], w[d, :k] = s, t, ww
    return src, dst, w, ep


def partition_edges_1d(g: Graph, n_devices: int) -> EdgePartition:
    s, t, w = (host_array(a) for a in (g.src, g.dst, g.weight))
    groups = [(s[d::n_devices], t[d::n_devices], w[d::n_devices])
              for d in range(n_devices)]
    src, dst, ww, ep = _pad_groups(groups, g.n_nodes, n_devices)
    return EdgePartition(src, dst, ww, n_devices, g.n_nodes, ep)


def partition_vertices(g: Graph, n_devices: int) -> VertexPartition:
    s, t, w = (host_array(a) for a in (g.src_in, g.dst_in, g.weight_in))
    per = (g.n_nodes + n_devices - 1) // n_devices
    offsets = np.minimum(np.arange(n_devices + 1) * per, g.n_nodes)
    owner = np.minimum(t // per, n_devices - 1)
    groups = []
    for d in range(n_devices):
        m = owner == d
        groups.append((s[m], t[m], w[m]))
    src, dst, ww, ep = _pad_groups(groups, g.n_nodes, n_devices)
    return VertexPartition(offsets.astype(np.int32), src, dst, ww,
                           n_devices, g.n_nodes, ep)
