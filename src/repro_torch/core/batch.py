"""Batched execution of many graphs as one block-diagonal graph.

Counterpart of ``repro.core.batch``.  No single configuration wins
everywhere, so serving answers many (small) graphs under many
configurations, and a run per graph pays its launches and polls per
graph.  This module packs B graphs of one padding bucket into one
block-diagonal graph and drives them together:

- **Packing** (:func:`pack_graphs`, numpy on the host, the reference's
  arrays exactly).  Graph *i* owns vertex rows ``[i*n_q, (i+1)*n_q)``
  and edge rows ``[i*m_q, (i+1)*m_q)``; padding vertices carry only
  self-loops, so every destination segment belongs to one graph and the
  reducers (the blocked kernels K1/K2 included) run unchanged on the
  packed edge orders.
- **Per-graph semantics** (:class:`BatchedEdgeContext`).  A program
  runs against the same ``ctx`` API as sequentially; the direction
  choice and the sparse-gather occupancy are computed per graph from
  each graph's own frontier and true ``(n, m)``, bit-identical to the
  sequential rule, while the packed execution (which edge order to
  scan, whether to take the packed gather) is one batch-level choice
  made on the device and taken through the inner
  :class:`~repro_torch.core.executor.EdgeContext`'s ``branch``, so that
  under capture it is a pair of IF nodes.  That choice is
  result-neutral for min/max and integer sums; float sums (PR, BC) may
  differ in the last bits from a sequential run.
- **Convergence masking** (:func:`run_fused_batch`).  The fused engine
  (:mod:`repro_torch.core.capture`) replays guarded steps that carry
  per-graph iteration counts, ``done`` flags and ``[B, limit]`` trace
  buffers; a graph's rows freeze once it converges, and the batch stops
  once every graph has.  Unbatched results equal sequential ``run``:
  states, iteration counts and traces.
- **Slices** (:func:`run_batch_slice`): the same loop resumed from
  carried per-graph counters for at most ``slice_len`` iterations, the
  runner of a continuous-batching scheduler.

Plan-cache kinds: ``"batch_pack"`` (the pack, anchored on the first
member graph) and ``"batch_context"`` (the bound context, on the packed
graph); the captured graphs go under ``"exec_fn"`` on the packed graph.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.config_space import SystemConfig, UpdateProp
from repro_torch.core.executor import (STATS, EdgeContext, RunResult,
                                       _normalize_autotune, _trace_flags)
from repro_torch.core.frontier import ALPHA, choose_direction_batch
from repro_torch.core.plan_cache import PLAN_CACHE
from repro_torch.core.vertex_program import (DENSE_OCC, EdgePhase,
                                             VertexProgram)
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels.segment_reduce import bin_edges_by_block

__all__ = ["MIN_BUCKET_N", "MIN_BUCKET_M", "bucket_shape", "bucket_key",
           "pack_graphs", "get_graph_batch", "GraphBatch",
           "BatchedEdgeContext", "BatchSlice", "run_fused_batch",
           "run_batch_slice"]

#: Smallest padded vertex and edge bucket, so that a bucket's ``[B,
#: n_q]`` rows never degenerate to widths a ``[B]`` leaf could take.
MIN_BUCKET_N = 8
MIN_BUCKET_M = 16

State = Dict[str, torch.Tensor]


def _next_pow2(x: int) -> int:
    return 1 << max(0, (int(x) - 1).bit_length())


def bucket_shape(n_nodes: int, m_edges: int) -> Tuple[int, int]:
    """Padded shape ``(n_q, m_q)`` of one graph (``batch.py:85-102``):
    powers of two, at most 2x padding; when edges need padding the
    vertex quantum leaves at least one padding vertex to carry them."""
    n, m = int(n_nodes), int(m_edges)
    n_q = _next_pow2(max(n, MIN_BUCKET_N))
    m_q = _next_pow2(max(m, MIN_BUCKET_M))
    if m_q > m and n_q == n:
        n_q *= 2
    return n_q, m_q


def bucket_key(graph: Graph) -> Tuple[int, int, int]:
    """The bucket a graph batches under: ``(n_q, m_q, block_size)``."""
    n_q, m_q = bucket_shape(graph.n_nodes, graph.n_edges)
    return (n_q, m_q, int(graph.block_size))


def _padded_local(g: Graph, n_q: int, m_q: int) -> dict:
    """One graph's arrays padded to ``(n_q, m_q)`` in local ids
    (``batch.py:116-147``): padding edges are sorted self-loops spread
    over the padding vertices, so both edge orders stay sorted."""
    n, m = g.n_nodes, g.n_edges
    pad_n, pad_m = n_q - n, m_q - m
    if pad_m and not pad_n:
        raise ValueError("padding edges need at least one padding vertex "
                         f"(n={n} == n_q={n_q} but m={m} < m_q={m_q})")
    a = np.asarray
    if pad_m:
        pv = np.sort(np.arange(pad_m, dtype=np.int64) % pad_n) + n
    else:
        pv = np.zeros(0, np.int64)
    counts = np.bincount(pv - n, minlength=pad_n) if pad_n \
        else np.zeros(0, np.int64)
    ones = np.ones(pad_m, np.float32)
    rp_pad = np.cumsum(counts)
    return {
        "src": np.concatenate([a(g.src), pv]),
        "dst": np.concatenate([a(g.dst), pv]),
        "weight": np.concatenate([a(g.weight), ones]),
        "row_ptr_out": np.concatenate([a(g.row_ptr_out), m + rp_pad]),
        "src_in": np.concatenate([a(g.src_in), pv]),
        "dst_in": np.concatenate([a(g.dst_in), pv]),
        "weight_in": np.concatenate([a(g.weight_in), ones]),
        "row_ptr_in": np.concatenate([a(g.row_ptr_in), m + rp_pad]),
        "out_degree": np.concatenate([a(g.out_degree), counts]),
        "in_degree": np.concatenate([a(g.in_degree), counts]),
    }


@dataclasses.dataclass
class GraphBatch:
    """B graphs packed block-diagonally into one padded :class:`Graph`.

    Graph *i* holds vertices ``[i*n_q, i*n_q + n_i)`` and edges
    ``[i*m_q, i*m_q + m_i)`` of ``packed``; ``n_nodes_b`` and
    ``n_edges_b`` are the true sizes.  The batch holds its first member
    weakly (the ``"batch_pack"`` entry is anchored on it, so the entry
    and all that hangs on the packed graph go when it is collected) and
    the other members strongly, so that their ids cannot be recycled.
    """
    packed: Graph
    n_q: int
    m_q: int
    n_nodes_b: np.ndarray
    n_edges_b: np.ndarray
    _anchor: Any = dataclasses.field(repr=False, default=None)
    _pinned: tuple = dataclasses.field(repr=False, default=())

    @property
    def size(self) -> int:
        return int(self.n_nodes_b.shape[0])

    @property
    def n_total(self) -> int:
        return self.size * self.n_q

    def _pack(self, states: Sequence[dict], pad: Optional[dict], cat, full,
              stack) -> dict:
        if len(states) != self.size:
            raise ValueError(f"expected {self.size} states, "
                             f"got {len(states)}")
        ns = [int(n) for n in self.n_nodes_b]
        pad = pad or {}

        def leaf(fill, leaves):
            if leaves[0].ndim == 0:
                return stack(leaves)
            rows = []
            for x, n in zip(leaves, ns):
                if x.shape[0] != n:
                    raise ValueError(
                        "state leaves must be per-vertex ([n, ...]) or "
                        f"scalar; got shape {tuple(x.shape)} for a graph "
                        f"with {n} vertices")
                p = self.n_q - n
                rows.append(cat([x, full((p,) + tuple(x.shape[1:]), fill,
                                         x)]) if p else x)
            return cat(rows)

        return {k: leaf(pad.get(k, 0), [s[k] for s in states])
                for k in states[0]}

    def pack_state(self, states: Sequence[State],
                   pad: Optional[dict] = None) -> State:
        """Pack per-graph state dicts of tensors into the block-diagonal
        layout (``batch.py:190-235``): ``[n_i, ...]`` leaves become one
        ``[B*n_q, ...]`` leaf whose padding rows hold ``pad.get(key, 0)``
        (a program's ``state_pad``), scalar leaves stack to ``[B]``."""
        states = [{k: torch.as_tensor(v) for k, v in s.items()}
                  for s in states]
        return self._pack(
            states, pad, torch.cat,
            lambda shape, fill, x: torch.full(shape, fill, dtype=x.dtype,
                                              device=x.device),
            torch.stack)

    def pack_state_host(self, states: Sequence[dict],
                        pad: Optional[dict] = None) -> Dict[str, np.ndarray]:
        """:meth:`pack_state` on numpy arrays: the same layout and
        values, no device work (``batch.py:255-291``)."""
        states = [{k: np.asarray(v) for k, v in s.items()} for s in states]
        return self._pack(
            states, pad, np.concatenate,
            lambda shape, fill, x: np.full(shape, fill, x.dtype), np.stack)

    def _unpack(self, packed: dict, cut) -> List[dict]:
        outs = []
        for i in range(self.size):
            lo, n = i * self.n_q, int(self.n_nodes_b[i])
            outs.append({k: cut(a, lo, n, i) for k, a in packed.items()})
        return outs

    def _is_vertex_leaf(self, a) -> bool:
        return a.ndim > 0 and a.shape[0] == self.n_total

    def unpack_state(self, packed: State) -> List[State]:
        """Per-graph state dicts of a packed state (views; the padding
        rows dropped): :meth:`pack_state`'s inverse."""
        return self._unpack(packed, lambda a, lo, n, i: (
            a[lo:lo + n] if self._is_vertex_leaf(a) else a[i]))

    def unpack_state_host(self, packed: dict) -> List[Dict[str, np.ndarray]]:
        """:meth:`unpack_state` to numpy copies: one device read per
        leaf."""
        host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in packed.items()}
        return self._unpack(host, lambda a, lo, n, i: (
            a[lo:lo + n].copy() if self._is_vertex_leaf(a)
            else a[i].copy()))


def pack_graphs(graphs: Sequence[Graph]) -> GraphBatch:
    """Pack graphs of one block size into one block-diagonal padded
    :class:`Graph` (``batch.py:313-373``).  The by-src and by-dst orders
    are concatenations of the per-graph orders; the owned order is
    re-binned on the packed ids, since graph offsets need not fall on
    block boundaries."""
    graphs = tuple(graphs)
    if not graphs:
        raise ValueError("pack_graphs needs at least one graph")
    block_size = graphs[0].block_size
    if any(g.block_size != block_size for g in graphs):
        raise ValueError("all graphs in a batch must share block_size")
    shapes = [bucket_shape(g.n_nodes, g.n_edges) for g in graphs]
    n_q = max(s[0] for s in shapes)
    m_q = max(s[1] for s in shapes)
    if any(m_q > g.n_edges and n_q == g.n_nodes for g in graphs):
        n_q *= 2  # room for the padding vertex the larger m_q needs
    locs = [_padded_local(g, n_q, m_q) for g in graphs]
    b = len(graphs)

    def cat(name, off=0):
        return np.concatenate([loc[name] + i * off
                               for i, loc in enumerate(locs)])

    def row_ptr(name):
        return np.concatenate(
            [loc[name][:-1] + i * m_q for i, loc in enumerate(locs)]
            + [np.array([b * m_q], np.int64)])

    dst = cat("dst", n_q)
    perm_owned, block_ptr = bin_edges_by_block(dst, b * n_q, block_size)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    packed = Graph(
        src=i32(cat("src", n_q)), dst=i32(dst),
        weight=np.float32(cat("weight")), row_ptr_out=i32(row_ptr(
            "row_ptr_out")),
        src_in=i32(cat("src_in", n_q)), dst_in=i32(cat("dst_in", n_q)),
        weight_in=np.float32(cat("weight_in")),
        row_ptr_in=i32(row_ptr("row_ptr_in")),
        out_degree=i32(cat("out_degree")), in_degree=i32(cat("in_degree")),
        perm_owned=i32(perm_owned), block_ptr=i32(block_ptr),
        n_nodes=b * n_q, n_edges=b * m_q, block_size=int(block_size))
    return GraphBatch(
        packed=packed, n_q=n_q, m_q=m_q,
        n_nodes_b=np.asarray([g.n_nodes for g in graphs], np.int64),
        n_edges_b=np.asarray([g.n_edges for g in graphs], np.int64),
        _anchor=weakref.ref(graphs[0]), _pinned=graphs[1:])


def get_graph_batch(graphs: Sequence[Graph]) -> GraphBatch:
    """Cached :func:`pack_graphs`: one pack per ordered tuple of graphs,
    anchored on the first (``batch.py:376-389``)."""
    graphs = tuple(graphs)
    if not graphs:
        raise ValueError("get_graph_batch needs at least one graph")
    return PLAN_CACHE.get(graphs[0], "batch_pack",
                          tuple(id(g) for g in graphs),
                          lambda: pack_graphs(graphs))


# ---------------------------------------------------------------------------
class BatchedEdgeContext:
    """A batch of graphs bound to one :class:`SystemConfig` on one
    device (``batch.py:392-666``): the ``ctx`` API of
    :class:`~repro_torch.core.executor.EdgeContext` with per-graph
    meaning.  Scalars of a graph become ``[B]``; the reductions run once
    over the packed edge orders through :attr:`inner`, the packed
    graph's ``EdgeContext``.

    The engine's control (:attr:`control`) is the inner context's, so
    the batch-level execution choices it makes with ``branch`` become IF
    nodes under capture.  Every ``[B]`` and ``[B*n_q]`` constant is made
    here, once: a captured step may not copy a host value.
    """

    def __init__(self, batch: GraphBatch, config: SystemConfig,
                 use_kernels: bool = False,
                 sparse_edge_capacity: Optional[int] = None,
                 autotune=None, device=None):
        self.device = resolve_device(device)
        dev = self.device
        self.config = config
        self.B = batch.size
        self.n_q = batch.n_q
        self.m_q = batch.m_q
        self.n_total = batch.n_total
        #: the caller's capacity (exec-fn key material): two per-graph
        #: capacities may give one packed capacity
        self.cap_key = (None if sparse_edge_capacity is None
                        else int(sparse_edge_capacity))
        n_b, m_b = batch.n_nodes_b, batch.n_edges_b
        if sparse_edge_capacity is None:
            caps = np.minimum(m_b, np.maximum(16, -(-m_b // int(ALPHA))))
        else:
            caps = np.full(self.B, int(sparse_edge_capacity), np.int64)
        self._disabled = self.cap_key == 0
        if self._disabled:
            inner_cap: Optional[int] = 0
        elif sparse_edge_capacity is None:
            inner_cap = None  # the packed graph's default
        else:
            inner_cap = min(batch.packed.n_edges,
                            int(sparse_edge_capacity) * self.B)
        self.inner = EdgeContext.create(
            batch.packed, config, use_kernels=use_kernels,
            sparse_edge_capacity=inner_cap,
            autotune=_normalize_autotune(autotune), device=dev)
        self.host_syncs = 0

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        self.n_nodes_b = i32(n_b)
        self.n_edges_b = i32(m_b)
        self.cap_b = i32(caps)
        self.vcap_b = i32(np.maximum(1, np.minimum(n_b, caps)))
        # occupancy = m_f times the float32 reciprocal of each graph's
        # capacity, as EdgeContext.propagate_sparse computes it
        self._inv_cap_b = torch.as_tensor(
            np.float32(1.0) / np.maximum(1, caps).astype(np.float32),
            device=dev)
        self._out_deg_rows = self.inner._out_degree.reshape(self.B, self.n_q)
        self._dense_b = torch.full((self.B,), DENSE_OCC, dtype=torch.float32,
                                   device=dev)
        self._static_pull_b = torch.full(
            (self.B,), config.prop is UpdateProp.PULL, device=dev)
        self._offsets = (torch.arange(self.B, dtype=torch.int32, device=dev)
                         * self.n_q).repeat_interleave(self.n_q)

    @classmethod
    def create(cls, batch: GraphBatch, config: SystemConfig,
               use_kernels: bool = False,
               sparse_edge_capacity: Optional[int] = None,
               autotune=None, device=None) -> "BatchedEdgeContext":
        """Cached constructor (``"batch_context"`` on the packed graph)."""
        device = resolve_device(device)
        cap = (None if sparse_edge_capacity is None
               else int(sparse_edge_capacity))
        mode = _normalize_autotune(autotune)
        return PLAN_CACHE.get(
            batch.packed, "batch_context",
            (config, bool(use_kernels), cap, mode, str(device)),
            lambda: cls(batch, config, use_kernels=use_kernels,
                        sparse_edge_capacity=cap, autotune=mode,
                        device=device))

    # the engine's control is the inner context's
    @property
    def control(self):
        return self.inner.control

    @control.setter
    def control(self, value) -> None:
        self.inner.control = value

    # ------------------------------------------------------------------
    def choose_direction(self, frontier: torch.Tensor, prev_pull,
                         unvisited: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """``[B]`` per-graph directions (True = pull), each row the
        sequential rule on that graph's own frontier and size."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._static_pull_b
        rows = frontier.reshape(self.B, self.n_q)
        urows = (unvisited.reshape(self.B, self.n_q)
                 if unvisited is not None else None)
        return choose_direction_batch(rows, self._out_deg_rows,
                                      self.n_edges_b, self.n_nodes_b,
                                      prev_pull, unvisited=urows)

    def dynamic_direction(self, want_pull) -> torch.Tensor:
        """``[B]`` flags of an algorithm-chosen direction; a static
        config's direction wins."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._static_pull_b
        if not isinstance(want_pull, torch.Tensor):
            return self.inner._flags[bool(want_pull)].expand(self.B)
        return want_pull.to(torch.bool).expand(self.B)

    # ------------------------------------------------------------------
    # Per-graph helpers: scalars are [B], reductions row-wise over each
    # graph's n_q columns.  Padding stays inert by construction (zero or
    # state_pad fills, padding-false masks).
    @property
    def true_n_nodes(self) -> torch.Tensor:
        return self.n_nodes_b

    def per_vertex(self, x) -> torch.Tensor:
        """A scalar or ``[B]`` per-graph values -> ``[B*n_q]``, each
        graph's rows (padding too) holding its value."""
        x = torch.as_tensor(x, device=self.device)
        if x.dim() == 0:
            return x.expand(self.n_total)
        rest = tuple(x.shape[1:])
        return x.reshape((self.B, 1) + rest).expand(
            (self.B, self.n_q) + rest).reshape((self.n_total,) + rest)

    def align_per_graph(self, x) -> torch.Tensor:
        return self.per_vertex(x)

    def per_graph_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.B, self.n_q) + tuple(x.shape[1:])).sum(1)

    def per_graph_any(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.B, self.n_q) + tuple(x.shape[1:])).any(1)

    def vertex_offsets(self) -> torch.Tensor:
        """``[B*n_q]`` first packed row of each vertex's graph."""
        return self._offsets

    def cond_per_graph(self, pred, true_fn, false_fn, state):
        """Both branches run on the packed state and each graph keeps
        its own branch's rows: graphs may disagree, so no IF node."""
        return self.freeze(torch.as_tensor(pred).to(torch.bool),
                           true_fn(state), false_fn(state))

    # ------------------------------------------------------------------
    def _frontier_edges_b(self, mask: torch.Tensor) -> torch.Tensor:
        rows = mask.reshape(self.B, self.n_q)
        return torch.where(rows, self._out_deg_rows, 0).sum(
            1, dtype=torch.int32)

    def _majority(self, pull_b: torch.Tensor,
                  m_f: torch.Tensor) -> torch.Tensor:
        m_pull = torch.where(pull_b, m_f, 0).sum(dtype=torch.int64)
        m_push = torch.where(pull_b, 0, m_f).sum(dtype=torch.int64)
        return m_pull > m_push

    def _exec_direction(self, state, phase: EdgePhase,
                        pull_b) -> torch.Tensor:
        """The batch's one packed execution direction, a device bool:
        the edge-weighted majority of the per-graph choices (a graph with
        an empty frontier votes with weight 0).  Result-neutral for
        min/max and integer sums."""
        pull_b = torch.as_tensor(pull_b, device=self.device).to(torch.bool)
        if pull_b.dim() == 0:
            return pull_b
        if phase.frontier is None:
            return pull_b.sum(dtype=torch.int32) * 2 > self.B
        return self._majority(pull_b,
                              self._frontier_edges_b(phase.frontier(state)))

    def propagate(self, state, phase: EdgePhase, direction=None,
                  dtype=torch.float32) -> torch.Tensor:
        return self.inner.propagate(state, phase, direction, dtype)

    def propagate_dynamic(self, state, phase: EdgePhase, pull,
                          dtype=torch.float32) -> torch.Tensor:
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self.inner.propagate_dynamic(
                state, phase, self.inner._flags[0], dtype)
        return self.inner.propagate_dynamic(
            state, phase, self._exec_direction(state, phase, pull), dtype)

    def propagate_sparse(self, state, phase: EdgePhase, pull,
                         dtype=torch.float32):
        """``(reduced [B*n_q], occupancy [B])`` (``batch.py:585-623``).

        Each graph's occupancy has its sequential meaning: ``m_f / cap``
        against its own capacity where its sequential run would have
        taken the gathered push path, -1.0 elsewhere.  The reduction
        runs once over the packed graph (the packed gather when the
        whole batch's frontier fits the packed capacity).
        """
        if (self.config.prop is not UpdateProp.PUSH_PULL
                or phase.frontier is None or not phase.gatherable
                or self._disabled):
            return (self.propagate_dynamic(state, phase, pull, dtype),
                    self._dense_b)
        pull_b = torch.as_tensor(pull, device=self.device).to(torch.bool)
        pull_b = pull_b.expand(self.B)
        rows = phase.frontier(state).reshape(self.B, self.n_q)
        m_f = torch.where(rows, self._out_deg_rows, 0).sum(
            1, dtype=torch.int32)
        n_f = rows.sum(1, dtype=torch.int32)
        fits = (n_f <= self.vcap_b) & (m_f <= self.cap_b) & ~pull_b
        occ = torch.where(fits, m_f.float() * self._inv_cap_b,
                          self._dense_b)
        out, _ = self.inner.propagate_sparse(
            state, phase, self._majority(pull_b, m_f), dtype)
        return out, occ

    # ------------------------------------------------------------------
    def per_graph_view(self, state: State) -> State:
        """``[B*n_q, ...]`` leaves as ``[B, n_q, ...]`` rows; ``[B]``
        leaves as they are."""
        return {k: (a.reshape((self.B, self.n_q) + tuple(a.shape[1:]))
                    if a.dim() and a.shape[0] == self.n_total else a)
                for k, a in state.items()}

    def converged_per_graph(self, program: VertexProgram, prev: State,
                            new: State) -> torch.Tensor:
        """``[B]`` verdicts: the program's own ``converged`` on per-graph
        row views (it reduces over the last axis only)."""
        conv = program.converged(self.per_graph_view(prev),
                                 self.per_graph_view(new))
        if tuple(conv.shape) != (self.B,):
            raise ValueError(
                f"{program.name}: converged gave shape {tuple(conv.shape)} "
                f"on [{self.B}, {self.n_q}] rows; a batched program's "
                "converged reduces over the last axis only")
        return conv

    def freeze(self, done_b: torch.Tensor, old: State, new: State) -> State:
        """``old`` for the graphs whose ``done_b`` is set, ``new`` for
        the rest: extra batch iterations never touch a converged
        graph."""
        def keep(o):
            if o.dim() and o.shape[0] == self.n_total:
                k = done_b.reshape(self.B, 1).expand(self.B, self.n_q)
                return k.reshape((self.n_total,) + (1,) * (o.dim() - 1))
            return done_b.reshape((self.B,) + (1,) * (o.dim() - 1))
        return {k: torch.where(keep(o), o, new[k]) for k, o in old.items()}


# ---------------------------------------------------------------------------
def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of an engine buffer (never a view of it: on the CPU
    ``.numpy()`` would share the buffer the next run overwrites)."""
    return t.detach().cpu().numpy().copy()


def _per_graph_results(batch: GraphBatch, state: State, it_b, done_b, dirs,
                       occs, seconds: float, launches: int
                       ) -> List[RunResult]:
    """Unbatch a finished batch into per-graph results (after the
    timer)."""
    it_b, done_b = _host(it_b), _host(done_b)
    dirs = None if dirs is None else _host(dirs)
    occs = None if occs is None else _host(occs)
    out = []
    for i, st in enumerate(batch.unpack_state(state)):
        k = int(it_b[i])
        out.append(RunResult(
            state={key: t.clone() for key, t in st.items()}, iterations=k,
            seconds=seconds / batch.size, converged=bool(done_b[i]),
            direction_trace=None if dirs is None else "".join(
                "T" if d else "S" for d in dirs[i, :k]),
            occupancy_trace=None if occs is None else [
                float(o) for o in occs[i, :k]],
            engine="batched", dispatches=launches, host_syncs=launches))
    return out


def run_fused_batch(program: VertexProgram, batch: GraphBatch,
                    bctx: BatchedEdgeContext, state: State,
                    limit: int) -> List[RunResult]:
    """Drive the whole batch to convergence on the fused engine
    (``batch.py:668-754``): ``ceil(iterations / STEPS_PER_LAUNCH)``
    replays of one captured graph of guarded steps, one poll each (the
    reference's ``lax.while_loop`` is one dispatch).

    The guard is ``(it < limit) & ~all(done_b)``; a step runs the
    program, takes each graph's verdict, freezes the graphs already
    done, advances ``it_b`` of the others, writes column ``it`` of the
    ``[B, limit]`` traces, and folds the verdicts into ``done_b``.
    Each result's ``seconds`` is the batch's wall time over B.
    """
    from repro_torch.core import capture
    traced, occ_traced = _trace_flags(program, state)
    ex = capture.cached_engine(
        program, bctx.inner,
        ("batched", bctx.B, bctx.n_q, bctx.m_q, limit, traced, occ_traced,
         bctx.cap_key),
        lambda: capture.build_batch(program, bctx, state, limit, traced,
                                    occ_traced))
    ex.reset(state)
    launches, _, seconds = capture.drive(ex, limit)
    STATS.add(launches)
    bctx.host_syncs += launches
    return _per_graph_results(batch, ex.state, ex.it_b, ex.done, ex.dirs,
                              ex.occs, seconds, launches)


@dataclasses.dataclass
class BatchSlice:
    """One slice's outputs (``batch.py:757-774``).  ``advanced[i]``
    iterations of graph *i* ran in the slice, with trace columns
    ``dir_cols[i, :advanced[i]]`` and ``occ_cols[i, :advanced[i]]``
    (None where the program records none).  ``state`` stays packed on
    the device for the next slice; ``converged_b`` is per-graph
    convergence (reaching ``limit_b`` does not set it)."""
    state: State
    it_b: np.ndarray
    converged_b: np.ndarray
    advanced: np.ndarray
    dir_cols: Optional[np.ndarray]
    occ_cols: Optional[np.ndarray]
    seconds: float
    dispatches: int = 0


def run_batch_slice(program: VertexProgram, batch: GraphBatch,
                    bctx: BatchedEdgeContext, state: State, it_b, done_b,
                    limit_b, slice_len: int) -> BatchSlice:
    """Advance the packed batch by at most ``slice_len`` iterations
    (``batch.py:777-874``), resuming each graph from its own counter.

    ``program.step`` gets the per-graph ``it_b`` (``[B]`` int32), so a
    graph that joined later sees 0, 1, 2, ... as its sequential run
    would.  A graph stops once it converges or reaches its own
    ``limit_b``; ``done_b`` marks parked slots, frozen from the start.
    The loop stops at ``slice_len`` or once every slot has stopped: on
    the card, at most ``ceil(slice_len / STEPS_PER_LAUNCH)`` replays of
    one captured graph whose guarded steps each check ``(s < slice_len)
    & ~all(stopped)``.  The three per-graph inputs may be host arrays or
    tensors; they are copied to the device before the timer starts.
    """
    from repro_torch.core import capture
    dev = bctx.device
    traced, occ_traced = _trace_flags(program, state)

    def dev_vec(x, dtype):
        return torch.as_tensor(np.array(x) if not isinstance(
            x, torch.Tensor) else x).to(device=dev, dtype=dtype).reshape(
                bctx.B)

    it_in = dev_vec(it_b, torch.int32)
    it_start = _host(it_in)
    ex = capture.cached_engine(
        program, bctx.inner,
        ("batched_slice", bctx.B, bctx.n_q, bctx.m_q, slice_len, traced,
         occ_traced, bctx.cap_key),
        lambda: capture.build_slice(program, bctx, state, slice_len, traced,
                                    occ_traced))
    ex.load(state, it_in, dev_vec(done_b, torch.bool),
            dev_vec(limit_b, torch.int32))
    launches, _, seconds = capture.drive(ex, slice_len)
    STATS.add(launches)
    bctx.host_syncs += launches
    it_out = _host(ex.it_b)
    return BatchSlice(
        state={k: t.clone() for k, t in ex.state.items()}, it_b=it_out,
        converged_b=_host(ex.done), advanced=it_out - it_start,
        dir_cols=_host(ex.dirs) if traced else None,
        occ_cols=_host(ex.occs) if occ_traced else None,
        seconds=seconds, dispatches=launches)
