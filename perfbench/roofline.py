"""Peaks of the card and the bytes the measured work needs.

Bytes are counted from the graph's V and E and the runs' iterations,
never from a kernel's arguments: each index and value read once, each
vertex's result written once, in 4-byte words.
"""
from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "WORD", "seg_reduce_bytes",
           "seg_reduce_roofline", "iteration_bytes", "edge_phase_bytes"]

#: NVIDIA H100 SXM's HBM3 bandwidth (data sheet), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
WORD = 4


def seg_reduce_bytes(n_edges: int, n_segments: int, d: int = 1) -> int:
    """One K1 / K2 launch over ``n_edges`` binned edges: a ``[E, d]``
    value and a segment id per edge read, ``[n_segments, d]`` written."""
    return WORD * (n_edges * (d + 1) + n_segments * d)


def seg_reduce_roofline(rec, *name_parts: str):
    """The profiled launches of the kernel whose name holds all
    ``name_parts``, against their bytes bound, in %: each launch reduces
    a whole edge order of ``rec``'s graph.  None without a launch."""
    times = rec.profile.kernels(*name_parts) if rec.profile else []
    if not times:
        return None
    need = len(times) * seg_reduce_bytes(rec.n_edges, rec.n_nodes)
    return 100.0 * need / HBM_BYTES_PER_S / sum(times)


def iteration_bytes(n_nodes: int, n_edges: int, occupancy: float,
                    capacity: int) -> float:
    """One iteration of an edge phase.  A dense iteration (``occupancy``
    < 0) needs all E edges, a sparse one ``occupancy * capacity``; each
    edge an index and a value, and each vertex it can reach one result
    written."""
    if occupancy < 0:
        edges, reach = n_edges, n_nodes
    else:
        edges = occupancy * capacity
        reach = min(n_nodes, edges)
    return WORD * (2 * edges + reach)


def edge_phase_bytes(runs, n_nodes: int, n_edges: int,
                     capacity: int) -> float:
    """All the iterations of ``runs`` (each with ``iterations`` and an
    ``occupancy_trace``, or None for a program without one: all
    dense)."""
    total = 0.0
    for r in runs:
        occ = r.occupancy_trace or [-1.0] * r.iterations
        total += sum(iteration_bytes(n_nodes, n_edges, o, capacity)
                     for o in occ[:r.iterations])
    return total
