"""Configuration-specialized execution of vertex programs (paper Sec. II).

Counterpart of ``repro.core.executor``.  :class:`EdgeContext` binds a
graph to a :class:`SystemConfig` on one device and exposes
``propagate``, the single entry point through which an algorithm's
edge-propagated updates execute.  The config picks:

- the edge order and reduction (push: by-src order, unsorted scatter;
  pull: by-dst order; owned: dst-block-binned order);
- the accumulation locality (coherence: one global scatter, or the
  block-owned accumulation of the blocked reducer);
- the chunk schedule (consistency: DRF0 / DRF1 / DRFrlx).

``use_kernels=True`` sends the owned push order and the pull order
through :class:`~repro_torch.kernels.segment_reduce.BlockedSegmentReducer`,
whose CUDA kernels own each output block in shared memory.

Dynamic (``PUSH_PULL``) configs keep both edge orders live and pick one
per iteration.  The reference picks inside one compiled program with
``lax.cond``; eager PyTorch reads the device's choice on the host
instead.  Every such read is a host sync, counted on the context and
reported as :attr:`RunResult.host_syncs`: one per iteration for the
convergence test, one more per iteration for a dynamic config's
direction, and one more on each sparse push iteration for the fit of
the gathered edge list.

``run`` drives a program to convergence with the host engine: one step
per iteration with a blocking convergence read in between.  The fused
engine (the whole loop captured on the device) is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.coherence import segment_reduce, segment_reduce_owned
from repro_torch.core.config_space import (Coherence, Consistency,
                                           SystemConfig, UpdateProp)
from repro_torch.core.consistency import scheduled_reduce
from repro_torch.core.frontier import (ALPHA, choose_direction,
                                       dense_to_sparse,
                                       gather_frontier_edges)
from repro_torch.core.plan_cache import PLAN_CACHE
from repro_torch.core.vertex_program import (FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, EdgePhase,
                                             VertexProgram, dense_occupancy)
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph
from repro_torch.kernels.autotune import build_reducer
from repro_torch.kernels.segment_reduce import (DEFAULT_PLAN,
                                                gathered_segment_reduce)

__all__ = ["EdgeContext", "RunResult", "run", "resolve_device"]


def _check_autotune(autotune) -> None:
    """Accept the ``autotune=`` values that mean "off"; the reference's
    other modes are not ported yet."""
    if autotune in (None, False, "off"):
        return
    if autotune in (True, "heuristic", "measure"):
        raise NotImplementedError(
            "autotune: the tiling-plan tuner is not ported yet "
            "(ROADMAP.md, queue 1, item 4); use autotune='off'")
    raise ValueError(f"unknown autotune mode {autotune!r}; expected "
                     "'off', 'heuristic', 'measure' or a bool")


def _pad_reshape(arr: torch.Tensor, n_chunks: int, fill) -> torch.Tensor:
    e = arr.shape[0]
    ec = -(-e // n_chunks)  # ceil
    pad = ec * n_chunks - e
    if pad:
        arr = torch.cat([arr, arr.new_full((pad,), fill)])
    return arr.reshape(n_chunks, ec)


class EdgeContext:
    """Graph + SystemConfig bound together on one device; reusable
    across iterations and runs."""

    #: Direction a ``PUSH_PULL`` config uses for a phase that resolved
    #: none (no frontier, no explicit ``direction=``).
    DEFAULT_DYNAMIC_DIRECTION = UpdateProp.PUSH

    @staticmethod
    def default_sparse_capacity(graph: Graph) -> int:
        """Default sparse-gather edge capacity: ``ceil(E/alpha)``."""
        return min(graph.n_edges,
                   max(16, -(-graph.n_edges // int(ALPHA))))

    @classmethod
    def create(cls, graph: Graph, config: SystemConfig,
               use_kernels: bool = False,
               sparse_edge_capacity: Optional[int] = None,
               autotune=None, device=None) -> "EdgeContext":
        """Cached constructor: reuse the bound context of a repeated
        (graph, config, use_kernels, capacity, device) cell."""
        _check_autotune(autotune)
        device = resolve_device(device)
        if sparse_edge_capacity is None:
            sparse_edge_capacity = cls.default_sparse_capacity(graph)
        cap = int(sparse_edge_capacity)

        def build():
            ctx = cls(graph, config, use_kernels=use_kernels,
                      sparse_edge_capacity=cap, device=device)
            # a cache-owned context must not pin its graph, or the
            # cache's eviction on collection could never fire
            ctx._graph_strong = None
            return ctx

        return PLAN_CACHE.get(
            graph, "context",
            (config, bool(use_kernels), cap, str(device)), build)

    def __init__(self, graph: Graph, config: SystemConfig,
                 use_kernels: bool = False,
                 sparse_edge_capacity: Optional[int] = None,
                 autotune=None, device=None):
        _check_autotune(autotune)
        self.device = resolve_device(device)
        dev = str(self.device)
        self._graph_strong: Optional[Graph] = graph
        self._graph_ref = weakref.ref(graph)
        self.config = config
        self.use_kernels = bool(use_kernels)
        self.n_nodes = graph.n_nodes
        self.n_edges = graph.n_edges
        #: blocking device-to-host reads made so far (see module doc)
        self.host_syncs = 0
        cache = PLAN_CACHE
        g = cache.get(graph, "device", (dev,), lambda: graph.to(self.device))
        if sparse_edge_capacity is None:
            sparse_edge_capacity = self.default_sparse_capacity(graph)
        self.sparse_edge_capacity = int(sparse_edge_capacity)
        self._sparse_vertex_capacity = max(
            1, min(self.n_nodes, self.sparse_edge_capacity))
        # occupancy = m_f times the float32 reciprocal of the capacity:
        # the reference's compiled division by a constant rounds that
        # way, and the occupancy trace must match it bit for bit
        self._inv_capacity = float(np.float32(1.0) / np.float32(
            max(1, self.sparse_edge_capacity)))
        self._row_ptr_out = g.row_ptr_out
        self._csr_raw = (g.src, g.dst, g.weight)
        self._out_degree = g.out_degree
        n_chunks = 1 if config.consistency is Consistency.DRF0 \
            else config.n_chunks
        v = graph.n_nodes
        self._static_pull = torch.tensor(config.prop is UpdateProp.PULL,
                                         device=self.device)
        self._dense_occ = dense_occupancy(self.device)

        # Chunked edge orders per direction, int64 ids for indexing and
        # scatter.  Padding edges carry the sentinel id V on both
        # endpoints and reduce into the extra segment V.
        def chunked(edges):
            src, dst, w = edges
            return (_pad_reshape(src.long(), n_chunks, v),
                    _pad_reshape(dst.long(), n_chunks, v),
                    _pad_reshape(w, n_chunks, 0.0))

        # the whole edge order for the blocked kernels, with int64
        # endpoints so that gathering state by them converts nothing per
        # iteration
        def raw(edges):
            src, dst, w = edges
            return src.long(), dst.long(), w

        self._reducer = None
        self._pull_reducer = None
        self._gather_plan = None
        if (config.prop is UpdateProp.PUSH_PULL
                and self.sparse_edge_capacity > 0):
            self._gather_plan = DEFAULT_PLAN
        if config.coherence is Coherence.DENOVO:
            owned = cache.get(graph, "edges_owned", (dev,), g.edges_owned)
            self._push_edges = cache.get(graph, "chunked",
                                         ("owned", n_chunks, dev),
                                         lambda: chunked(owned))
            if use_kernels and config.prop is not UpdateProp.PULL:
                self._owned_raw = cache.get(graph, "raw", ("owned", dev),
                                            lambda: raw(owned))
                self._reducer = cache.get(
                    graph, "owned_reducer", (DEFAULT_PLAN, dev),
                    lambda: build_reducer(graph, "owned", DEFAULT_PLAN,
                                          device=self.device))
        else:
            self._push_edges = cache.get(
                graph, "chunked", ("csr", n_chunks, dev),
                lambda: chunked((g.src, g.dst, g.weight)))
        self._pull_edges = cache.get(
            graph, "chunked", ("csc", n_chunks, dev),
            lambda: chunked((g.src_in, g.dst_in, g.weight_in)))
        if use_kernels and config.prop is not UpdateProp.PUSH:
            self._pull_raw = cache.get(
                graph, "raw", ("csc", dev),
                lambda: raw((g.src_in, g.dst_in, g.weight_in)))
            self._pull_reducer = cache.get(
                graph, "pull_reducer", (DEFAULT_PLAN, dev),
                lambda: build_reducer(graph, "pull", DEFAULT_PLAN,
                                      device=self.device))
        self.n_chunks = n_chunks

    @property
    def graph(self) -> Optional[Graph]:
        """The host graph, or None once a cache-owned context's graph
        has been collected."""
        return self._graph_strong or self._graph_ref()

    def _read(self, flag: torch.Tensor) -> bool:
        """Read a device bool on the host: one counted host sync."""
        self.host_syncs += 1
        return bool(flag)

    # ------------------------------------------------------------------
    def resolve_direction(self,
                          direction: Optional[UpdateProp] = None
                          ) -> UpdateProp:
        """Explicit ``direction`` > the config's static direction >
        :data:`DEFAULT_DYNAMIC_DIRECTION`."""
        direction = direction or self.config.prop
        if direction is UpdateProp.PUSH_PULL:
            direction = self.DEFAULT_DYNAMIC_DIRECTION
        return direction

    def choose_direction(self, frontier: torch.Tensor, prev_pull,
                         unvisited: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
        """Bool scalar (True = pull) for this iteration's direction; a
        static config returns its fixed direction."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._static_pull
        return choose_direction(frontier, self._out_degree, self.n_edges,
                                self.n_nodes, prev_pull, unvisited=unvisited)

    def dynamic_direction(self, want_pull) -> torch.Tensor:
        """An algorithm-chosen direction as this context's flag: a static
        config's direction wins."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._static_pull
        return torch.as_tensor(want_pull, dtype=torch.bool,
                               device=self.device)

    # ------------------------------------------------------------------
    # Per-graph helpers: trivial here; a batched context would give
    # them per-graph meaning on packed arrays.
    @property
    def true_n_nodes(self):
        return self.n_nodes

    def per_vertex(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).expand(self.n_nodes)

    def align_per_graph(self, x):
        return x

    def per_graph_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum()

    def per_graph_any(self, x: torch.Tensor) -> torch.Tensor:
        return x.any()

    def vertex_offsets(self) -> int:
        return 0

    # ------------------------------------------------------------------
    def propagate(self, state, phase: EdgePhase,
                  direction: Optional[UpdateProp] = None,
                  dtype=torch.float32) -> torch.Tensor:
        """Execute one edge-propagated reduction; returns [V] reduced."""
        return self._propagate(state, phase, self.resolve_direction(direction),
                               dtype)

    def propagate_dynamic(self, state, phase: EdgePhase, pull,
                          dtype=torch.float32) -> torch.Tensor:
        """``propagate`` with the direction given by a bool tensor
        (True = pull).  A static config ignores it; a dynamic one reads
        it on the host and runs that one direction."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._propagate(state, phase,
                                   self.resolve_direction(None), dtype)
        direction = UpdateProp.PULL if self._read(pull) else UpdateProp.PUSH
        return self._propagate(state, phase, direction, dtype)

    def propagate_sparse(self, state, phase: EdgePhase, pull,
                         dtype=torch.float32):
        """``propagate_dynamic`` with an O(m_f) sparse-gather fast path
        (``executor.py:457-519``).

        Returns ``(reduced [V], occupancy)``: ``occupancy`` is
        ``m_f / sparse_edge_capacity`` when the iteration ran the
        gathered path, -1.0 when it ran a dense scan.  The sparse path
        runs only for a dynamic config, a ``gatherable`` phase, a push
        iteration, and a frontier whose vertex and edge lists fit their
        capacities; an overflow takes the dense path.
        """
        dense_occ = self._dense_occ
        if (self.config.prop is not UpdateProp.PUSH_PULL
                or phase.frontier is None or not phase.gatherable
                or self.sparse_edge_capacity == 0):
            return self.propagate_dynamic(state, phase, pull, dtype), dense_occ
        if self._read(pull):
            return self._propagate(state, phase, UpdateProp.PULL,
                                   dtype), dense_occ
        front = dense_to_sparse(phase.frontier(state),
                                self._sparse_vertex_capacity)
        edges = gather_frontier_edges(front.ids, self._row_ptr_out,
                                      self.sparse_edge_capacity)
        fits = ~front.overflowed & ~edges.overflowed
        occ = torch.where(fits, edges.count.float() * self._inv_capacity,
                          dense_occ)
        if self._read(fits):
            return self._propagate_gathered(state, phase, edges.edge_ids,
                                            dtype), occ
        return self._propagate(state, phase, UpdateProp.PUSH, dtype), occ

    def _propagate_gathered(self, state, phase: EdgePhase,
                            edge_ids: torch.Tensor, dtype) -> torch.Tensor:
        """Push reduction over a gathered ``[cap_e]`` edge subset; -1
        ids and predicate-failing edges go to the trash segment."""
        src, dst, w = self._csr_raw
        valid = edge_ids >= 0
        at = torch.where(valid, edge_ids, 0).long()
        sv, tv, wv = src[at], dst[at], w[at]
        keep = valid
        if phase.spred is not None:
            keep = keep & phase.spred(state, sv)
        if phase.tpred is not None:
            keep = keep & phase.tpred(state, tv)
        msg = phase.vprop(state, sv, wv).to(dtype)
        ids = torch.where(keep, tv, -1)
        return gathered_segment_reduce(msg, ids, self.n_nodes,
                                       phase.monoid.name,
                                       plan=self._gather_plan)

    def _propagate(self, state, phase: EdgePhase, direction: UpdateProp,
                   dtype) -> torch.Tensor:
        cfg = self.config
        pull = direction is UpdateProp.PULL
        v = self.n_nodes
        monoid = phase.monoid
        ident = monoid.identity(dtype)

        reducer = self._pull_reducer if pull else self._reducer
        if reducer is not None:
            # blocked kernel over the whole edge set in block-binned
            # order; masked edges contribute the identity
            so, do, wo = self._pull_raw if pull else self._owned_raw
            msg = phase.vprop(state, so, wo).to(dtype)
            mask = None
            if phase.spred is not None:
                mask = phase.spred(state, so)
            if phase.tpred is not None:
                keep = phase.tpred(state, do)
                mask = keep if mask is None else mask & keep
            if mask is None:
                return reducer.reduce(msg, monoid.name)
            return reducer.masked(msg, mask, monoid.name, ident=ident)

        src_c, dst_c, w_c = self._pull_edges if pull else self._push_edges

        def chunk_reduce(i):
            src, dst, w = src_c[i], dst_c[i], w_c[i]
            sv = torch.clamp(src, max=v - 1)
            tv = torch.clamp(dst, max=v - 1)
            mask = (src < v) & (dst < v)
            if phase.spred is not None:
                mask = mask & phase.spred(state, sv)
            if phase.tpred is not None:
                mask = mask & phase.tpred(state, tv)
            msg = torch.where(mask, phase.vprop(state, sv, w).to(dtype), ident)
            if pull:
                # by-dst order: masked edges already carry the identity
                # and padding edges carry dst = v themselves
                return segment_reduce(msg, dst, v + 1, monoid)
            ids = torch.where(mask, dst, v)
            if cfg.coherence is Coherence.DENOVO:
                return segment_reduce_owned(msg, ids, v + 1, monoid)
            return segment_reduce(msg, ids, v + 1, monoid)

        out = scheduled_reduce(chunk_reduce, self.n_chunks,
                               cfg.consistency, monoid)
        return out[:v]


@dataclasses.dataclass
class RunResult:
    state: Any
    iterations: int
    seconds: float
    converged: bool
    #: per-iteration direction letters ("S" = push, "T" = pull) for
    #: frontier-aware programs; None otherwise.
    direction_trace: Optional[str] = None
    #: per-iteration sparse-gather occupancy (-1.0 for a dense
    #: iteration); None for programs without the protocol.
    occupancy_trace: Optional[List[float]] = None
    #: which execution engine produced this result.
    engine: str = "host"
    #: timed program steps this run issued (one per iteration).
    dispatches: int = 0
    #: blocking device-to-host reads inside the timed loop.
    host_syncs: int = 0
    #: "converged" | "iter_limit".
    outcome: Optional[str] = None
    #: name of the config this run executed under.
    config_name: Optional[str] = None

    def __post_init__(self):
        if self.outcome is None:
            self.outcome = "converged" if self.converged else "iter_limit"

    @property
    def sparse_iterations(self) -> Optional[int]:
        """How many iterations ran the O(m_f) gathered path."""
        if self.occupancy_trace is None:
            return None
        return sum(1 for o in self.occupancy_trace if o >= 0.0)

    def extract(self, program: VertexProgram):
        return program.extract(self.state)


def _trace_flags(program: VertexProgram, state) -> tuple:
    traced = (program.frontier_update is not None
              and FRONTIER_DIR_KEY in state)
    return traced, traced and FRONTIER_OCC_KEY in state


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_host(program: VertexProgram, ctx: EdgeContext, state,
              limit: int) -> RunResult:
    """One step per iteration plus a blocking convergence read between
    steps (``executor.py:705-755``).  One untimed step on a copy of the
    state builds the kernels and warms the caches first.  Trace scalars
    are kept on the device and read once, after the timer stops."""
    program.step(ctx, {k: t.clone() for k, t in state.items()}, 0)
    _synchronize(ctx.device)
    traced, occ_traced = _trace_flags(program, state)
    dir_raw: List[torch.Tensor] = []
    occ_raw: List[torch.Tensor] = []
    syncs = ctx.host_syncs
    t0 = time.perf_counter()
    it, done = 0, False
    while it < limit:
        new = program.step(ctx, state, it)
        done_dev = program.converged(state, new)
        state = new
        it += 1
        if traced:
            dir_raw.append(state[FRONTIER_DIR_KEY])
        if occ_traced:
            occ_raw.append(state[FRONTIER_OCC_KEY])
        done = ctx._read(done_dev)
        if done:
            break
    _synchronize(ctx.device)
    dt = time.perf_counter() - t0
    syncs = ctx.host_syncs - syncs
    trace = occ_trace = None
    if traced:
        trace = "".join("T" if d else "S"
                        for d in torch.stack(dir_raw).tolist())
    if occ_traced:
        occ_trace = torch.stack(occ_raw).tolist()
    return RunResult(state=state, iterations=it, seconds=dt, converged=done,
                     direction_trace=trace, occupancy_trace=occ_trace,
                     engine="host", dispatches=it, host_syncs=syncs)


def run(program: VertexProgram, graph: Graph, config: SystemConfig,
        max_iters: Optional[int] = None, use_kernels: bool = False,
        sparse_edge_capacity: Optional[int] = None,
        engine: str = "host", autotune=None, device=None) -> RunResult:
    """Iterate ``program`` on ``graph`` under ``config`` to convergence
    (``executor.py:830``).

    ``device`` defaults to CUDA; without a CUDA device this raises
    ``RuntimeError`` unless ``device='cpu'`` is passed.
    ``use_kernels=True`` runs the owned push order and the pull order
    through the blocked CUDA reducers (on a CPU device, through their
    plain versions).  ``engine`` is "host"; "fused" is not ported yet.
    ``autotune`` accepts only "off".  The reference's resilience,
    batching and specialization knobs are not accepted yet.
    """
    if engine not in ("fused", "host"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'fused' or 'host'")
    if engine == "fused":
        raise NotImplementedError(
            "engine='fused' (the whole loop captured as a CUDA graph) is "
            "not ported yet: ROADMAP.md, queue 1, 'Next slice', item 1; "
            "use engine='host'")
    device = resolve_device(device)
    ctx = EdgeContext.create(graph, config, use_kernels=use_kernels,
                             sparse_edge_capacity=sparse_edge_capacity,
                             autotune=autotune, device=device)
    state = {k: torch.as_tensor(t).to(device)
             for k, t in program.init(graph).items()}
    res = _run_host(program, ctx, state, max_iters or program.max_iters)
    res.config_name = config.name
    return res
