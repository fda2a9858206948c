"""Graph container for push/pull vertex-centric execution.

Counterpart of ``repro.graph.structure``.  The graph keeps both edge
orderings of the same edge set plus the owned order:

- **by-src (CSR) order** for push (an unsorted scatter over ``dst``);
- **by-dst (CSC) order** for pull (a reduction over sorted ``dst``);
- **owned order**: the by-src order binned by *target block* of
  ``block_size`` vertices, so a kernel can accumulate one block's
  updates locally and write them back once (the DeNovo analogue).

Construction is numpy on the host and the arrays stay host numpy
(int32 / float32).  :meth:`Graph.to` makes the device copy the executor
works on.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels.segment_reduce.ops import bin_edges_by_block

__all__ = ["Graph", "GraphStats", "graph_stats", "validate_graph",
           "graph_from_arrays", "ARRAY_FIELDS"]

#: The per-edge and per-vertex array fields of :class:`Graph`, in order.
ARRAY_FIELDS = ("src", "dst", "weight", "row_ptr_out", "src_in", "dst_in",
                "weight_in", "row_ptr_in", "out_degree", "in_degree",
                "perm_owned", "block_ptr")
_FLOAT_FIELDS = ("weight", "weight_in")


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed (symmetric, per the paper's input format) graph.

    Arrays are host numpy, or torch tensors on one device after
    :meth:`to`.
    """

    # --- by-src (CSR / push) order -------------------------------------
    src: np.ndarray          # [E] int32, non-decreasing
    dst: np.ndarray          # [E] int32
    weight: np.ndarray       # [E] float32
    row_ptr_out: np.ndarray  # [V+1] int32
    # --- by-dst (CSC / pull) order -------------------------------------
    src_in: np.ndarray       # [E] int32
    dst_in: np.ndarray       # [E] int32, non-decreasing
    weight_in: np.ndarray    # [E] float32
    row_ptr_in: np.ndarray   # [V+1] int32
    # --- degrees --------------------------------------------------------
    out_degree: np.ndarray   # [V] int32
    in_degree: np.ndarray    # [V] int32
    # --- owned (DeNovo-analogue) target-block binned by-src order -------
    perm_owned: np.ndarray   # [E] int32: indices into by-src arrays
    block_ptr: np.ndarray    # [n_blocks+1] int32: edge offsets per dst block
    # --- static metadata -------------------------------------------------
    n_nodes: int
    n_edges: int
    block_size: int

    @classmethod
    def from_coo(cls, src, dst, n_nodes: int, weight=None,
                 block_size: int = 256, symmetrize: bool = False,
                 remove_self_loops: bool = True) -> "Graph":
        """Build from a COO edge list (``repro.graph.structure:67-132``).

        The same numpy steps in the same order, so the same input gives
        the same arrays bit for bit.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float32)
        weight = np.asarray(weight, dtype=np.float32)

        if symmetrize:
            src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
            weight = np.concatenate([weight, weight])
        if remove_self_loops:
            keep = src != dst
            src, dst, weight = src[keep], dst[keep], weight[keep]
        # de-duplicate, keeping the minimum weight (SSSP semantics)
        key = src * n_nodes + dst
        order = np.lexsort((weight, key))
        key_s = key[order]
        first = np.ones(key_s.shape[0], dtype=bool)
        first[1:] = key_s[1:] != key_s[:-1]
        order = order[first]
        src, dst, weight = src[order], dst[order], weight[order]

        e = src.shape[0]
        perm_src = np.lexsort((dst, src))
        s_src, d_src, w_src = src[perm_src], dst[perm_src], weight[perm_src]
        row_ptr_out = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(row_ptr_out, s_src + 1, 1)
        row_ptr_out = np.cumsum(row_ptr_out)
        perm_dst = np.lexsort((src, dst))
        s_dst, d_dst, w_dst = src[perm_dst], dst[perm_dst], weight[perm_dst]
        row_ptr_in = np.zeros(n_nodes + 1, dtype=np.int64)
        np.add.at(row_ptr_in, d_dst + 1, 1)
        row_ptr_in = np.cumsum(row_ptr_in)

        out_degree = np.diff(row_ptr_out)
        in_degree = np.diff(row_ptr_in)

        # owned order: stable-sort by dst block, keeping by-src order
        # inside each block (push's dense source reads)
        perm_owned, block_ptr = bin_edges_by_block(d_src, n_nodes,
                                                   block_size)

        i32 = lambda a: np.asarray(a, dtype=np.int32)
        return cls(
            src=i32(s_src), dst=i32(d_src), weight=np.float32(w_src),
            row_ptr_out=i32(row_ptr_out),
            src_in=i32(s_dst), dst_in=i32(d_dst), weight_in=np.float32(w_dst),
            row_ptr_in=i32(row_ptr_in),
            out_degree=i32(out_degree), in_degree=i32(in_degree),
            perm_owned=i32(perm_owned), block_ptr=i32(block_ptr),
            n_nodes=int(n_nodes), n_edges=int(e), block_size=int(block_size),
        )

    def to(self, device) -> "Graph":
        """A copy whose arrays are torch tensors on ``device``."""
        device = torch.device(device)
        return dataclasses.replace(self, **{
            name: torch.as_tensor(np.asarray(getattr(self, name))).to(device)
            for name in ARRAY_FIELDS})

    def edges_owned(self):
        """``(src, dst, weight)`` permuted into the owned order."""
        perm = self.perm_owned
        if isinstance(perm, torch.Tensor):
            perm = perm.long()
        return self.src[perm], self.dst[perm], self.weight[perm]


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Size and out-degree summary of a graph
    (``repro.graph.structure:153-163``)."""

    n_nodes: int
    n_edges: int
    max_degree: int
    avg_degree: float
    std_degree: float

    @cached_property
    def as_dict(self):
        return dataclasses.asdict(self)


def graph_stats(g: Graph) -> GraphStats:
    """:class:`GraphStats` of ``g`` (``repro.graph.structure:234-242``).

    Computed on the host from the int32 out-degrees, mean and std in
    numpy float64 as in the reference, so the figures are equal, not
    just close, wherever the graph's arrays live.
    """
    deg = host_array(g.out_degree)
    return GraphStats(
        n_nodes=g.n_nodes,
        n_edges=g.n_edges,
        max_degree=int(deg.max()) if deg.size else 0,
        avg_degree=float(deg.mean()) if deg.size else 0.0,
        std_degree=float(deg.std()) if deg.size else 0.0,
    )


def host_array(a) -> np.ndarray:
    """A graph array as host numpy, wherever it lives."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def graph_from_arrays(arrays: Dict[str, np.ndarray], n_nodes: int,
                      n_edges: int, block_size: int) -> Graph:
    """Build the port's :class:`Graph` from another graph's arrays.

    ``arrays`` maps every name in :data:`ARRAY_FIELDS` to a numpy array,
    for example the fields of a ``repro`` graph taken with
    ``np.asarray``.  This carries a graph across unchanged, so both
    packages can run on the very same edge orders.
    """
    missing = [name for name in ARRAY_FIELDS if name not in arrays]
    if missing:
        raise KeyError(f"graph_from_arrays: missing arrays {missing}")
    fields = {
        name: np.asarray(arrays[name],
                         np.float32 if name in _FLOAT_FIELDS else np.int32)
        for name in ARRAY_FIELDS}
    return Graph(**fields, n_nodes=int(n_nodes), n_edges=int(n_edges),
                 block_size=int(block_size))


def validate_graph(g: Graph) -> list:
    """Structural-soundness check (``repro.graph.structure:166``).

    Returns a list of human-readable defects, empty when the graph is
    well formed: negative or decreasing row offsets, dangling edge
    endpoints, non-finite weights, inconsistent array lengths.
    Host-side numpy only.
    """
    errors: list = []
    n, m = int(g.n_nodes), int(g.n_edges)
    if n < 0 or m < 0:
        return [f"negative graph size (n={n}, m={m})"]

    def arr(name):
        a = getattr(g, name)
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)

    sides = [("row_ptr_out", "src", "dst", "weight", "out_degree"),
             ("row_ptr_in", "src_in", "dst_in", "weight_in", "in_degree")]
    for rp_name, s_name, d_name, w_name, deg_name in sides:
        rp, s, d, w, deg = (arr(rp_name), arr(s_name), arr(d_name),
                            arr(w_name), arr(deg_name))
        for name, a, want in ((rp_name, rp, n + 1), (s_name, s, m),
                              (d_name, d, m), (w_name, w, m),
                              (deg_name, deg, n)):
            if a.shape[:1] != (want,):
                errors.append(f"{name}: length {a.shape[0] if a.ndim else 0}"
                              f" != expected {want}")
        if rp.shape[:1] != (n + 1,) or s.shape[:1] != (m,):
            continue  # length errors above make index checks misleading
        if rp.size and int(rp[0]) != 0:
            errors.append(f"{rp_name}[0] = {int(rp[0])} != 0")
        bad_rp = False
        if np.any(rp < 0):
            errors.append(f"{rp_name}: negative offsets")
            bad_rp = True
        if np.any(np.diff(rp) < 0):
            drop = int(np.argmax(np.diff(rp) < 0))
            errors.append(
                f"{rp_name}: offsets decrease at row {drop} "
                f"({int(rp[drop])} -> {int(rp[drop + 1])}); row offsets "
                "must be monotone non-decreasing")
            bad_rp = True
        if not bad_rp and rp.size and int(rp[-1]) != m:
            errors.append(f"{rp_name}[-1] = {int(rp[-1])} != n_edges {m}")
        for name, ids in ((s_name, s), (d_name, d)):
            if ids.size and (ids.min() < 0 or ids.max() >= n):
                errors.append(f"{name}: endpoint ids outside [0, {n}) "
                              "(dangling edge)")
        if not np.all(np.isfinite(w)):
            errors.append(f"{w_name}: non-finite weights (NaN/inf)")
        if (deg.shape[:1] == (n,) and not np.any(np.diff(rp) < 0)
                and not np.array_equal(np.diff(rp), deg)):
            errors.append(f"{deg_name} inconsistent with {rp_name} diffs")
    return errors
