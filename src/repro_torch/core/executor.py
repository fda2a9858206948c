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

Every data-dependent choice of a step (the direction of a dynamic
config, the fit of the gathered edge list, BC's phase) goes through one
primitive, :meth:`EdgeContext.branch`.  The reference picks inside one
compiled program with ``lax.cond``.  Here the engine decides how:

- the host engine reads the device's bool on the host and runs one
  branch; every such read is a host sync, counted on the context and
  reported as :attr:`RunResult.host_syncs`;
- the fused engine (:mod:`repro_torch.core.capture`) records the two
  branches as conditional IF nodes of a CUDA graph, so nothing is read
  on the host inside a step.

``run`` drives a program to convergence with either engine; "fused",
the default as in the reference, replays a captured graph of
:data:`~repro_torch.core.capture.STEPS_PER_LAUNCH` guarded steps and
polls ``done`` once per replay.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, List, Optional

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
from repro_torch.kernels.autotune import autotune_plan, build_reducer
from repro_torch.kernels.segment_reduce import (DEFAULT_PLAN,
                                                gathered_segment_reduce)

__all__ = ["EdgeContext", "RunResult", "run", "run_batch", "resolve_device"]


def _normalize_autotune(autotune) -> str:
    """The ``autotune=`` knob as "off", "heuristic" or "measure"
    (``executor.py:118-127``)."""
    if autotune in (None, False, "off"):
        return "off"
    if autotune is True:
        return "measure"
    if autotune in ("heuristic", "measure"):
        return autotune
    raise ValueError(f"unknown autotune mode {autotune!r}; expected "
                     "'off', 'heuristic', 'measure' or a bool")


def _capturing() -> bool:
    """True while the current CUDA stream is capturing a graph."""
    return (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing())


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
        (graph, config, use_kernels, capacity, autotune, device) cell."""
        mode = _normalize_autotune(autotune)
        device = resolve_device(device)
        if sparse_edge_capacity is None:
            sparse_edge_capacity = cls.default_sparse_capacity(graph)
        cap = int(sparse_edge_capacity)

        def build():
            ctx = cls(graph, config, use_kernels=use_kernels,
                      sparse_edge_capacity=cap, autotune=mode,
                      device=device)
            # a cache-owned context must not pin its graph, or the
            # cache's eviction on collection could never fire
            ctx._graph_strong = None
            return ctx

        return PLAN_CACHE.get(
            graph, "context",
            (config, bool(use_kernels), cap, mode, str(device)), build)

    def __init__(self, graph: Graph, config: SystemConfig,
                 use_kernels: bool = False,
                 sparse_edge_capacity: Optional[int] = None,
                 autotune=None, device=None):
        self.autotune = _normalize_autotune(autotune)
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
        # device constants made once: a step captured into a CUDA graph
        # may not copy a host value to the device
        self._flags = (torch.tensor(False, device=self.device),
                       torch.tensor(True, device=self.device))
        self._static_pull = self._flags[config.prop is UpdateProp.PULL]
        self._dense_occ = dense_occupancy(self.device)
        #: how :meth:`branch` runs while an engine drives a step: None
        #: for the host engine's eager read, else an engine's control
        #: (:mod:`repro_torch.core.capture`)
        self.control = None

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
            self._gather_plan = self._resolve_plan(
                graph, "gathered", self.sparse_edge_capacity)
        if config.coherence is Coherence.DENOVO:
            owned = cache.get(graph, "edges_owned", (dev,), g.edges_owned)
            self._push_edges = cache.get(graph, "chunked",
                                         ("owned", n_chunks, dev),
                                         lambda: chunked(owned))
            if use_kernels and config.prop is not UpdateProp.PULL:
                self._owned_raw = cache.get(graph, "raw", ("owned", dev),
                                            lambda: raw(owned))
                plan = self._resolve_plan(graph, "owned")
                self._reducer = cache.get(
                    graph, "owned_reducer", (plan, dev),
                    lambda: build_reducer(graph, "owned", plan,
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
            plan = self._resolve_plan(graph, "pull")
            self._pull_reducer = cache.get(
                graph, "pull_reducer", (plan, dev),
                lambda: build_reducer(graph, "pull", plan,
                                      device=self.device))
        self.n_chunks = n_chunks

    def _resolve_plan(self, graph: Graph, order: str,
                      cap_e: Optional[int] = None):
        """This context's tiling plan for one edge order
        (``executor.py:286-296``): the default when autotune is off, and
        for the gathered order under "heuristic" (the degree model has
        no view of the scatter split); else the tuner's."""
        if self.autotune == "off":
            return DEFAULT_PLAN
        if order == "gathered" and self.autotune == "heuristic":
            return DEFAULT_PLAN
        return autotune_plan(graph, order=order, kind="mixed",
                             mode=self.autotune, cap_e=cap_e,
                             device=self.device)

    @property
    def plan_signature(self) -> tuple:
        """The resolved tiling plans (``executor.py:298-307``): part of
        the fused engine's key, so that two contexts that differ only in
        their plans never share a captured graph."""
        def sig(red):
            return red.plan.astuple() if red is not None else None
        return (sig(self._reducer), sig(self._pull_reducer),
                self._gather_plan.astuple()
                if self._gather_plan is not None else None)

    @property
    def graph(self) -> Optional[Graph]:
        """The host graph, or None once a cache-owned context's graph
        has been collected."""
        return self._graph_strong or self._graph_ref()

    def _read(self, flag: torch.Tensor) -> bool:
        """Read a device bool on the host: one counted host sync.  Raises
        inside a CUDA graph capture, where a host read is a bug."""
        if _capturing():
            raise RuntimeError(
                "EdgeContext._read: a host read of a device value inside a "
                "CUDA graph capture; route the choice through "
                "EdgeContext.branch")
        self.host_syncs += 1
        return bool(flag)

    def branch(self, pred: torch.Tensor, true_fn: Callable[[], Any],
               false_fn: Callable[[], Any]):
        """``true_fn()`` if the device bool ``pred`` holds, else
        ``false_fn()``: the one primitive of every data-dependent choice
        in a step (the reference's ``lax.cond``).

        Both functions take no argument and return tensors (or dicts and
        tuples of them) of the same structure, shapes and dtypes.  The
        host engine reads ``pred`` (one counted host sync) and runs one
        function; under the fused engine :attr:`control` decides (two
        conditional IF nodes when capturing a CUDA graph).
        """
        if self.control is None:
            return true_fn() if self._read(pred) else false_fn()
        return self.control.branch(pred, true_fn, false_fn)

    def cond_per_graph(self, pred, true_fn, false_fn, state):
        """Per-graph two-way branch over a whole state dict
        (``executor.py:418``): sequentially, :meth:`branch` with
        ``pred`` a bool scalar."""
        return self.branch(torch.as_tensor(pred).reshape(()),
                           lambda: true_fn(state), lambda: false_fn(state))

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
        if isinstance(want_pull, torch.Tensor):
            return want_pull.to(dtype=torch.bool).reshape(())
        return self._flags[bool(want_pull)]

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
        (True = pull).  A static config ignores it; a dynamic one runs
        the chosen direction through :meth:`branch`."""
        if self.config.prop is not UpdateProp.PUSH_PULL:
            return self._propagate(state, phase,
                                   self.resolve_direction(None), dtype)
        return self.branch(
            pull,
            lambda: self._propagate(state, phase, UpdateProp.PULL, dtype),
            lambda: self._propagate(state, phase, UpdateProp.PUSH, dtype))

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

        def dense_pull():
            return (self._propagate(state, phase, UpdateProp.PULL, dtype),
                    dense_occ)

        def push():
            front = dense_to_sparse(phase.frontier(state),
                                    self._sparse_vertex_capacity)
            edges = gather_frontier_edges(front.ids, self._row_ptr_out,
                                          self.sparse_edge_capacity)
            fits = ~front.overflowed & ~edges.overflowed
            occ = torch.where(fits,
                              edges.count.float() * self._inv_capacity,
                              dense_occ)
            out = self.branch(
                fits,
                lambda: self._propagate_gathered(state, phase,
                                                 edges.edge_ids, dtype),
                lambda: self._propagate(state, phase, UpdateProp.PUSH,
                                        dtype))
            return out, occ

        return self.branch(pull, dense_pull, push)

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
    #: which execution engine produced this result ("fused" | "host").
    engine: str = "fused"
    #: timed dispatches this run issued: one step per iteration for the
    #: host engine, one graph launch per ``STEPS_PER_LAUNCH`` iterations
    #: for the fused engine (the reference's fused engine makes one).
    dispatches: int = 0
    #: blocking device-to-host reads inside the timed loop (the fused
    #: engine: one poll of ``done`` per launch).
    host_syncs: int = 0
    #: "converged" | "iter_limit" | "faulted" (the last only from the
    #: resilience layer).
    outcome: Optional[str] = None
    #: name of the config this run executed under.
    config_name: Optional[str] = None
    #: a resilient run's fault record: ``history`` (one entry per failed
    #: attempt or rejected checkpoint), ``recovered`` and, when faulted,
    #: ``final``; None for runs that never faulted.
    fault: Optional[dict] = None
    #: executions a resilient run made, the first included.
    attempts: int = 1
    #: a resilient run's accounting over its attempts: segments, their
    #: boundaries' host seconds and bytes read, and on the card the
    #: stream ms (between CUDA events, issue gaps included) of the
    #: sentinels, certificates and snapshot copies.
    resilience: Optional[dict] = None

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


def _decode_traces(dirs: Optional[torch.Tensor],
                   occs: Optional[torch.Tensor]) -> tuple:
    """Direction letters and occupancy floats of per-iteration trace
    tensors (None where the program records none)."""
    trace = None if dirs is None else "".join(
        "T" if d else "S" for d in dirs.tolist())
    return trace, None if occs is None else occs.tolist()


def _run_host(program: VertexProgram, ctx: EdgeContext, state,
              limit: int) -> RunResult:
    """One step per iteration plus a blocking convergence read between
    steps (``executor.py:705-755``).  One untimed step on a copy of the
    state builds the kernels and warms the caches first.  ``it`` reaches
    the step as a device int32 scalar, as the reference's traced
    counter: a view into one ``arange`` made before the timer, so the
    counter costs no launch per iteration.  Trace scalars stay on the
    device and are read once, after the timer stops."""
    its = torch.arange(max(limit, 1), dtype=torch.int32, device=ctx.device)
    program.step(ctx, {k: t.clone() for k, t in state.items()}, its[0])
    _synchronize(ctx.device)
    traced, occ_traced = _trace_flags(program, state)
    dir_raw: List[torch.Tensor] = []
    occ_raw: List[torch.Tensor] = []
    syncs = ctx.host_syncs
    t0 = time.perf_counter()
    it, done = 0, False
    while it < limit:
        new = program.step(ctx, state, its[it])
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
    trace, occ_trace = _decode_traces(
        torch.stack(dir_raw) if traced else None,
        torch.stack(occ_raw) if occ_traced else None)
    return RunResult(state=state, iterations=it, seconds=dt, converged=done,
                     direction_trace=trace, occupancy_trace=occ_trace,
                     engine="host", dispatches=it, host_syncs=syncs)


def run(program: VertexProgram, graph: Graph, config: SystemConfig,
        key: Optional[torch.Generator] = None,
        max_iters: Optional[int] = None, use_kernels: bool = False,
        sparse_edge_capacity: Optional[int] = None,
        engine: str = "fused", autotune=None, device=None,
        checkpoint_every: int = 0, retry=None, sentinels: bool = True,
        ring_capacity: Optional[int] = None, fault_injector=None,
        checkpoint_dir: Optional[str] = None) -> RunResult:
    """Iterate ``program`` on ``graph`` under ``config`` to convergence
    (``executor.py:830``).

    ``device`` defaults to CUDA; without a CUDA device this raises
    ``RuntimeError`` unless ``device='cpu'`` is passed.
    ``use_kernels=True`` runs the owned push order and the pull order
    through the blocked CUDA reducers (on a CPU device, through their
    plain versions).  ``key`` is a ``torch.Generator`` handed to
    ``program.init(graph, key)`` for programs with randomized init.

    ``engine`` picks the convergence loop: "fused" (default) replays a
    captured CUDA graph of guarded steps with one blocking read of
    ``done`` per replay (:mod:`repro_torch.core.capture`; on a CPU
    device the same guarded steps run eagerly); "host" is the
    step-per-iteration oracle it is tested against.  Both give the same
    states, iteration counts and traces.  ``autotune`` picks the blocked
    reducers' plans: "off" (or None, False) the default plan,
    "heuristic" one from the graph's degree features, "measure" (or
    True) the fastest of a timed sweep (:mod:`repro_torch.kernels.autotune`;
    on the card CUDA events, and a disk cache under
    ``results/torch/``).  Plans change times, never results.

    Resilience knobs (any of them set hands off to
    :func:`repro_torch.core.resilience.run_resilient`, whose results
    equal the plain engines'): ``checkpoint_every=K`` runs the loop in
    K-iteration segments whose boundaries snapshot the state into a host
    checkpoint ring and check the program's sentinels (and, at
    convergence, its certificate); ``retry=RetryPolicy(...)`` rolls back
    and re-executes on a failure, walking the degradation chain
    (autotuned to default plans, sparse to dense frontier, fused to host
    engine); ``sentinels=False`` turns the battery off;
    ``ring_capacity`` bounds the ring; ``fault_injector`` is the seeded
    fault harness's hook (:mod:`repro_torch.testing.faults`);
    ``checkpoint_dir`` spills every boundary to an on-disk
    :class:`~repro_torch.core.durability.CheckpointStore` and resumes a
    killed run from it.  The reference's ``specialize`` is not accepted
    yet; many graphs at once go through :func:`run_batch`.
    """
    if engine not in ("fused", "host"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'fused' or 'host'")
    device = resolve_device(device)
    if (checkpoint_every or retry is not None or fault_injector is not None
            or checkpoint_dir is not None):
        from repro_torch.core.resilience import run_resilient
        res = run_resilient(
            program, graph, config, key=key, max_iters=max_iters,
            use_kernels=use_kernels,
            sparse_edge_capacity=sparse_edge_capacity, engine=engine,
            autotune=autotune, device=device,
            checkpoint_every=checkpoint_every, retry=retry,
            sentinels=sentinels, ring_capacity=ring_capacity,
            fault_injector=fault_injector, checkpoint_dir=checkpoint_dir)
        res.config_name = config.name
        return res
    ctx = EdgeContext.create(graph, config, use_kernels=use_kernels,
                             sparse_edge_capacity=sparse_edge_capacity,
                             autotune=autotune, device=device)
    init = program.init(graph, key) if key is not None \
        else program.init(graph)
    state = {k: torch.as_tensor(t).to(device) for k, t in init.items()}
    limit = max_iters or program.max_iters
    if engine == "fused":
        from repro_torch.core.capture import run_fused
        res = run_fused(program, ctx, state, limit)
    else:
        res = _run_host(program, ctx, state, limit)
    res.config_name = config.name
    return res


def run_batch(program: VertexProgram, graphs, config: SystemConfig,
              keys: Optional[list] = None, max_iters: Optional[int] = None,
              use_kernels: bool = False,
              sparse_edge_capacity: Optional[int] = None, autotune=None,
              max_batch: Optional[int] = None,
              device=None) -> List[RunResult]:
    """Run ``program`` on many graphs as block-diagonal packed batches
    (``executor.py:921-1000``; the reference's ``specialize`` is not
    ported).

    Graphs are grouped by padding bucket
    (:func:`~repro_torch.core.batch.bucket_key`); each group, cut into
    parts of at most ``max_batch`` graphs, is packed once (cached per
    tuple of graphs) and driven to convergence by
    :func:`~repro_torch.core.batch.run_fused_batch`.  Results come back
    in input order with ``engine="batched"``; states, iteration counts
    and traces equal each graph's sequential :func:`run` for min/max
    and integer-sum programs, and agree to float tolerance for PR and
    BC.  ``seconds`` is the batch's wall time over its size and
    ``dispatches`` its launches.

    ``keys`` gives one ``torch.Generator`` per graph for programs with
    random init.  Without them each graph draws from its own default
    generator (``algorithms/_random.py:graph_key``), so a batched run
    equals that graph's sequential ``run``; the reference folds the
    batch index into one key instead, which ``jax.random`` alone can
    reproduce.  ``sparse_edge_capacity`` is per graph (0 disables the
    gathered path batch-wide); the other knobs mean what they mean on
    :func:`run`, and ``device`` defaults to CUDA.
    """
    from repro_torch.core.batch import (BatchedEdgeContext, bucket_key,
                                        get_graph_batch, run_fused_batch)
    graphs = list(graphs)
    if keys is not None and len(keys) != len(graphs):
        raise ValueError(f"{len(keys)} keys for {len(graphs)} graphs")
    if max_batch is not None and max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    device = resolve_device(device)
    limit = max_iters or program.max_iters
    groups: dict = {}
    for i, g in enumerate(graphs):
        groups.setdefault(bucket_key(g), []).append(i)
    results: List[Optional[RunResult]] = [None] * len(graphs)
    for idxs in groups.values():
        step = max_batch or len(idxs)
        for lo in range(0, len(idxs), step):
            part = idxs[lo:lo + step]
            batch = get_graph_batch(tuple(graphs[i] for i in part))
            bctx = BatchedEdgeContext.create(
                batch, config, use_kernels=use_kernels,
                sparse_edge_capacity=sparse_edge_capacity,
                autotune=autotune, device=device)
            states = [program.init(graphs[i]) if keys is None
                      else program.init(graphs[i], keys[i]) for i in part]
            packed = batch.pack_state_host(
                [{k: torch.as_tensor(t).numpy() for k, t in s.items()}
                 for s in states], pad=program.state_pad)
            packed = {k: torch.from_numpy(v).to(device)
                      for k, v in packed.items()}
            for i, r in zip(part, run_fused_batch(program, batch, bctx,
                                                  packed, limit)):
                r.config_name = config.name
                results[i] = r
    return results
