"""The fused engine: the convergence loop as a replayed CUDA graph.

Counterpart of ``repro.core.executor._run_fused`` (``executor.py:758-827``).
The reference runs the whole loop as one ``lax.while_loop``: one
dispatch and one host sync per run.  Here a step is recorded into a
CUDA graph with conditional IF nodes (:class:`CudaGraph`, over
``csrc/graph_if.cu``; the PyTorch 2.11 of the card has no
``CUDAGraph.begin_capture_to_if_node``).  A WHILE node would need a
device-side loop condition written by a kernel of its own body, so the
loop is one graph of :data:`STEPS_PER_LAUNCH` *guarded steps*, replayed
until ``done``::

    live = (it < limit) & ~done
    if live:                                  # an IF node
        new = program.step(ctx, st, it)       # its choices: IF nodes
        done = program.converged(st, new)
        dir_buf[it], occ_buf[it] = new's trace scalars
        st <- new; it += 1

The state, ``it``, ``done`` and the ``[limit]`` trace buffers are static
device tensors that the graph reads and writes in place.  After each
replay the host reads ``done`` (the run's only blocking reads) and
stops at ``done`` or once the replays have covered ``limit`` steps.
Once ``live`` is false a guarded step costs only its predicate kernels:
the freeze that ``run_fused_batch`` makes with selects (``batch.py:668``).

Inside a step, :meth:`EdgeContext.branch` records ``if (pred) true_fn``
and ``if (!pred) false_fn`` as two IF nodes; the false branch writes its
outputs into the true branch's, as ``if_else_node`` of
``torch/_higher_order_ops/cudagraph_conditional_nodes.py`` does.  Every
allocation made while recording goes to the graph's own memory pool,
which lives as long as the graph.
Before capture, one guarded step runs eagerly on copies of the buffers
with *both* branches of every choice taken, so that every kernel is
loaded and every library initialized outside the capture, and with
synchronizing operations made to raise, so that a step that reads the
device on the host fails there and not inside a capture.  The captured
graph is cached in ``PLAN_CACHE`` ("exec_fn", as
``executor.py:682-702``), keyed on the program, the context's config,
kernels, capacity and resolved plans (``plan_signature``), the device
and the limit, so repeats skip the capture and a context with other
plans never replays a graph recorded over another's reducers.

The batched loops of :mod:`repro_torch.core.batch` reuse the same
guarded step, warm-up and capture with buffers of their own
(:class:`_FusedBatch`: ``[B]`` done flags and iteration counts,
``[B, limit]`` traces; :class:`_FusedSlice`: a slice resumed from
carried per-graph counters), and so do checkpointed runs
(:class:`_FusedSegment`: the guarded step also stops at a device
``seg_end``, so one graph serves every segment of
:mod:`repro_torch.core.resilience`).

On a CPU device the same guarded steps run eagerly,
:data:`STEPS_PER_LAUNCH` per "launch", with the predicates read on the
host where the card's IF nodes read them on the device: only the polls
count as host syncs.  The caller asked for the CPU, so this is not a
fallback; it holds the freeze, the trace buffers and the counting
against the host engine in the CPU tests.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import time
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree

from repro_torch import spans
from repro_torch.core.executor import (STATS, EdgeContext, RunResult,
                                       _decode_traces, _synchronize,
                                       _trace_flags)
from repro_torch.core.plan_cache import PLAN_CACHE
from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, VertexProgram)
from repro_torch.kernels._build import load

__all__ = ["STEPS_PER_LAUNCH", "CudaGraph", "SOURCE", "run_fused",
           "cached_engine", "drive", "build_batch", "build_slice",
           "build_segment"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "graph_if.cu"

#: Guarded steps per captured graph, so a run makes
#: ``ceil(iterations / STEPS_PER_LAUNCH)`` launches and as many polls.
#: Chosen from the sweep of ``chip_smoke.py`` (PERF.md).
STEPS_PER_LAUNCH = 8
#: Captured graphs kept per host graph (least recently used dropped).
EXEC_FN_CAPACITY = 64


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_error_string.argtypes = [i]
    lib.graph_error_string.restype = ctypes.c_char_p
    for name, args in (("graph_init", []), ("graph_capture_begin", [p]),
                       ("graph_capture_end", [p, ctypes.POINTER(p)]),
                       ("graph_instantiate", [p, ctypes.POINTER(p)]),
                       ("graph_capture_status",
                        [p, ctypes.POINTER(ctypes.c_int)]),
                       ("graph_launch", [p, p]), ("graph_destroy", [p, p]),
                       ("graph_if_begin", [p, p, p]),
                       ("graph_if_end", [p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, i
    _check(lib, lib.graph_init(), "loading the IF-node kernel")
    return lib


def _check(lib, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.graph_error_string(err).decode()})")


class CudaGraph:
    """A CUDA graph recorded from PyTorch ops on ``device``, with
    conditional IF nodes.

    :meth:`capture` records the current thread's ops on a side stream;
    inside it, :meth:`begin_capture_to_if_node` (named as PyTorch's own
    method of later versions) appends an IF node on a device bool and
    records what follows into its body, on a stream of its nesting
    depth, until :meth:`end_capture_to_conditional_node`.  Every
    allocation made while recording comes from the graph's own memory
    pool, so replays never share memory with later eager work.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            self._pool = torch.cuda.MemPool()
        self._streams = []   # [0] the capture, [d] IF bodies at depth d
        self._parents = []   # the stream each open IF body returns to
        self._graph = self._exec = None

    def _stream(self, depth: int) -> torch.cuda.Stream:
        while len(self._streams) <= depth:
            self._streams.append(torch.cuda.Stream(self.device))
        return self._streams[depth]

    @contextlib.contextmanager
    def capture(self):
        """Record the ops of the ``with`` body; the graph is ready to
        :meth:`replay` once it exits."""
        if self._exec is not None:
            raise RuntimeError("CudaGraph: already captured")
        lib = _library()
        outer = torch.cuda.current_stream(self.device)
        stream = self._stream(0)
        stream.wait_stream(outer)
        with torch.cuda.use_mem_pool(self._pool, self.device), \
                torch.cuda.stream(stream):
            _check(lib, lib.graph_capture_begin(stream.cuda_stream),
                   "beginning a capture")
            graph = ctypes.c_void_p()
            try:
                yield self
                if self._parents:
                    raise RuntimeError("CudaGraph: an IF body is still open")
            except BaseException as exc:
                self._abort(lib, exc)
                raise
            _check(lib, lib.graph_capture_end(stream.cuda_stream,
                                              ctypes.byref(graph)),
                   "ending the capture")
        exe = ctypes.c_void_p()
        err = lib.graph_instantiate(graph, ctypes.byref(exe))
        if err:
            lib.graph_destroy(graph, None)
            _check(lib, err, "instantiating the graph")
        self._graph, self._exec = graph, exe
        outer.wait_stream(stream)

    def _abort(self, lib, exc: BaseException) -> None:
        """End a capture that ``exc`` interrupted, open IF bodies first,
        and drop what it recorded.  A capture that CUDA invalidated (an
        operation it does not allow) is left open instead: ending the
        captures of an IF body and its parent then crashed the process,
        or left the next capture failing, on the H100 (driver
        580.159.03), in either order."""
        open_streams = [self._stream(d)
                        for d in range(len(self._parents) + 1)]
        status = ctypes.c_int()
        for s in open_streams:
            if (not lib.graph_capture_status(s.cuda_stream,
                                             ctypes.byref(status))
                    and status.value == 2):
                raise RuntimeError(
                    "a CUDA graph capture was invalidated by an operation "
                    "it does not allow; its streams are left capturing, "
                    "so this process cannot use the device again") from exc
        for s in reversed(open_streams[1:]):
            lib.graph_if_end(s.cuda_stream)
        self._parents.clear()
        graph = ctypes.c_void_p()
        if not lib.graph_capture_end(open_streams[0].cuda_stream,
                                     ctypes.byref(graph)):
            lib.graph_destroy(graph, None)

    def begin_capture_to_if_node(self, pred: torch.Tensor) -> None:
        """Append an IF node on the device bool scalar ``pred`` and
        record the ops that follow into its body."""
        if (pred.dtype != torch.bool or pred.dim() != 0
                or pred.device != self.device):
            raise ValueError("an IF node's predicate must be a bool scalar "
                             f"on {self.device}, got {pred.dtype} "
                             f"{tuple(pred.shape)} on {pred.device}")
        lib = _library()
        parent = torch.cuda.current_stream(self.device)
        child = self._stream(len(self._parents) + 1)
        _check(lib, lib.graph_if_begin(parent.cuda_stream, pred.data_ptr(),
                                       child.cuda_stream),
               "adding an IF node")
        self._parents.append(parent)
        torch.cuda.set_stream(child)

    def end_capture_to_conditional_node(self) -> None:
        """Close the innermost open IF body; recording goes on after its
        node."""
        lib = _library()
        child = self._stream(len(self._parents))
        parent = self._parents.pop()
        err = lib.graph_if_end(child.cuda_stream)
        torch.cuda.set_stream(parent)
        _check(lib, err, "ending an IF body")

    def replay(self) -> None:
        """Launch the graph on the current stream."""
        _check(_library(), _library().graph_launch(
            self._exec, torch.cuda.current_stream(self.device).cuda_stream),
            "launching the graph")

    def __del__(self):
        # the executable goes before the pool its allocations live in
        if self._exec is not None:
            _library().graph_destroy(self._graph, self._exec)
            self._graph = self._exec = None


def _alike(a, b) -> tuple:
    """The leaves of two branch outputs, checked to agree in structure,
    shape and dtype (a copy would broadcast or cast silently)."""
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    if sa != sb:
        raise TypeError(f"branch outputs differ in structure: {sa} vs {sb}")
    for x, y in zip(la, lb):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise TypeError(f"branch outputs differ: {tuple(x.shape)} "
                            f"{x.dtype} vs {tuple(y.shape)} {y.dtype}")
    return la, lb


class _Eager:
    """CPU control: each IF node's predicate read on the host."""

    def branch(self, pred, true_fn, false_fn):
        return true_fn() if bool(pred) else false_fn()

    def when(self, pred, fn) -> None:
        if bool(pred):
            fn()


class _Warm:
    """Warm-up control: every branch runs, whatever its predicate."""

    def branch(self, pred, true_fn, false_fn):
        out = true_fn()
        _alike(out, false_fn())
        return out

    def when(self, pred, fn) -> None:
        fn()


class _Capture:
    """Capture control: each choice becomes conditional IF nodes of
    ``graph``."""

    def __init__(self, graph: CudaGraph):
        self.graph = graph

    def when(self, pred: torch.Tensor, fn):
        # on an error the body stays open: CudaGraph.capture ends it
        self.graph.begin_capture_to_if_node(pred)
        out = fn()
        self.graph.end_capture_to_conditional_node()
        return out

    def branch(self, pred, true_fn, false_fn):
        pred = pred.reshape(())
        # fresh outputs: a branch may return a context constant or a
        # state buffer, which the other branch's copy must not overwrite
        out = self.when(pred,
                        lambda: pytree.tree_map(torch.clone, true_fn()))

        def other():
            for dst, src in zip(*_alike(out, false_fn())):
                dst.copy_(src)

        self.when(torch.logical_not(pred), other)
        return out


@contextlib.contextmanager
def _controlled(ctx: EdgeContext, control):
    before, ctx.control = ctx.control, control
    try:
        yield
    finally:
        ctx.control = before


@dataclasses.dataclass(eq=False)
class _Fused:
    """A run's static buffers, and the graph of guarded steps over them
    (None on a CPU device)."""
    program: VertexProgram
    ctx: EdgeContext
    limit: int
    steps: int
    state: Dict[str, torch.Tensor]
    it: torch.Tensor                      # int32 scalar
    done: torch.Tensor                    # bool scalar
    dirs: Optional[torch.Tensor]          # [limit] bool
    occs: Optional[torch.Tensor]          # [limit] float32
    graph: Any = None

    def copy(self) -> "_Fused":
        """The buffers cloned, no graph: the warm-up's copy."""
        def clone(v):
            if isinstance(v, torch.Tensor):
                return v.clone()
            if isinstance(v, dict):
                return {k: t.clone() for k, t in v.items()}
            return v
        return dataclasses.replace(self, graph=None, **{
            f.name: clone(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if f.name not in ("program", "ctx", "graph")})

    def reset(self, state: Dict[str, torch.Tensor]) -> None:
        """Load a run's initial state, ``it = 0``, ``done = False`` and
        empty traces."""
        for k, buf in self.state.items():
            if state[k].shape != buf.shape or state[k].dtype != buf.dtype:
                raise ValueError(f"state {k!r}: {tuple(state[k].shape)} "
                                 f"{state[k].dtype}, the captured run has "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(state[k])
        self.it.zero_()
        self.done.fill_(False)
        if self.dirs is not None:
            self.dirs.fill_(False)
        if self.occs is not None:
            self.occs.fill_(DENSE_OCC)

    def guarded_step(self, control) -> None:
        """One step of the loop, run only while the run is live."""
        live = (self.it < self.limit) & ~self.done
        control.when(live, self._step)

    def _checked(self, new: Dict[str, torch.Tensor]) -> None:
        """A step's output must match the state buffers exactly."""
        st = self.state
        if set(new) != set(st):
            raise ValueError(f"{self.program.name}: step returned keys "
                             f"{sorted(new)}, the state has {sorted(st)}")
        for k, t in new.items():
            if t.shape != st[k].shape or t.dtype != st[k].dtype:
                raise TypeError(f"{self.program.name}: step returned {k!r} "
                                f"as {tuple(t.shape)} {t.dtype}, the state "
                                f"holds {tuple(st[k].shape)} {st[k].dtype}")

    def _trace(self, new: Dict[str, torch.Tensor]) -> None:
        """Write a step's trace scalars (``[B]`` columns when batched)
        at column ``it`` of the trace buffers, a device index."""
        at = self.it.reshape(1).long()
        for buf, key in ((self.dirs, FRONTIER_DIR_KEY),
                         (self.occs, FRONTIER_OCC_KEY)):
            if buf is not None:
                buf.index_copy_(buf.dim() - 1, at, new[key].reshape(
                    tuple(buf.shape[:-1]) + (1,)))

    def _commit(self, new: Dict[str, torch.Tensor]) -> None:
        for k, buf in self.state.items():
            buf.copy_(new[k])
        self.it.add_(1)

    def _step(self) -> None:
        st = self.state
        new = self.program.step(self.ctx, st, self.it)
        self._checked(new)
        self.done.copy_(self.program.converged(st, new))
        self._trace(new)
        self._commit(new)

    def launch(self) -> None:
        """One dispatch: a replay of the graph on the card, the same
        guarded steps run eagerly on the CPU."""
        if self.graph is not None:
            self.graph.replay()
            return
        control = _Eager()
        with _controlled(self.ctx, control):
            for _ in range(self.steps):
                self.guarded_step(control)

    def poll(self) -> bool:
        """The blocking read of ``done`` after a launch."""
        return bool(self.done)


@dataclasses.dataclass(eq=False)
class _FusedBatch(_Fused):
    """:func:`~repro_torch.core.batch.run_fused_batch`'s buffers
    (``batch.py:668-754``): ``done`` is ``[B]``, ``it_b`` the
    per-graph iterations, the traces ``[B, limit]``; ``ctx`` is a
    :class:`~repro_torch.core.batch.BatchedEdgeContext`."""
    it_b: Optional[torch.Tensor] = None   # [B] int32

    def reset(self, state: Dict[str, torch.Tensor]) -> None:
        super().reset(state)
        self.it_b.zero_()

    def guarded_step(self, control) -> None:
        live = (self.it < self.limit) & ~self.done.all()
        control.when(live, self._step)

    def _step(self) -> None:
        st, ctx, done = self.state, self.ctx, self.done
        new = self.program.step(ctx, st, self.it)
        self._checked(new)
        conv = ctx.converged_per_graph(self.program, st, new)
        merged = ctx.freeze(done, st, new)
        self.it_b.add_((~done).int())
        self._trace(merged)
        done.logical_or_(conv)
        self._commit(merged)

    def poll(self) -> bool:
        return bool(self.done.all())


@dataclasses.dataclass(eq=False)
class _FusedSlice(_Fused):
    """:func:`~repro_torch.core.batch.run_batch_slice`'s buffers
    (``batch.py:777-874``): ``it`` counts the slice's steps s and
    ``limit`` is ``slice_len``; ``done`` is ``[B]`` convergence in the
    slice, ``it_b`` the carried per-graph counters, ``parked`` the
    parked slots, ``limit_b`` each graph's own limit."""
    it_b: Optional[torch.Tensor] = None      # [B] int32
    parked: Optional[torch.Tensor] = None    # [B] bool
    limit_b: Optional[torch.Tensor] = None   # [B] int32

    def load(self, state, it_b, parked, limit_b) -> None:
        self.reset(state)
        self.it_b.copy_(it_b)
        self.parked.copy_(parked)
        self.limit_b.copy_(limit_b)

    def _stopped(self) -> torch.Tensor:
        return self.parked | self.done | (self.it_b >= self.limit_b)

    def guarded_step(self, control) -> None:
        live = (self.it < self.limit) & ~self._stopped().all()
        control.when(live, self._step)

    def _step(self) -> None:
        st, ctx = self.state, self.ctx
        frozen = self._stopped()
        new = self.program.step(ctx, st, self.it_b)
        self._checked(new)
        conv = ctx.converged_per_graph(self.program, st, new)
        merged = ctx.freeze(frozen, st, new)
        self.it_b.add_((~frozen).int())
        self.done.logical_or_(conv & ~frozen)
        self._trace(merged)
        self._commit(merged)

    def poll(self) -> bool:
        return bool(self._stopped().all())


@dataclasses.dataclass(eq=False)
class _FusedSegment(_Fused):
    """A checkpointed run's buffers (``resilience.py:336-383``): the
    guarded step also stops at the device scalar ``seg_end``, so one
    captured graph serves every segment of every attempt.  ``limit``
    sizes the trace buffers; ``staging`` holds the pinned host buffers of
    the boundary reads (:mod:`repro_torch.core.resilience`)."""
    seg_end: Optional[torch.Tensor] = None   # int32 scalar
    staging: dict = dataclasses.field(default_factory=dict)

    def guarded_step(self, control) -> None:
        live = (self.it < self.seg_end) & ~self.done
        control.when(live, self._step)

    def load(self, cp) -> None:
        """Write a checkpoint (host numpy state, ``it``, ``done``, trace
        buffers) into the static buffers, as :meth:`_FusedSlice.load`."""
        self.reset({k: torch.as_tensor(v) for k, v in cp.state.items()})
        self.it.fill_(int(cp.it))
        self.done.fill_(bool(cp.done))
        if self.dirs is not None:
            self.dirs.copy_(torch.as_tensor(cp.dir_buf))
        if self.occs is not None:
            self.occs.copy_(torch.as_tensor(cp.occ_buf))

    def load_state(self, state) -> None:
        """Write a host state into the state buffers, position kept."""
        for k, buf in self.state.items():
            buf.copy_(torch.as_tensor(state[k]))

    def advance(self, lo: int, seg_end: int) -> tuple:
        """Replay from iteration ``lo`` up to ``seg_end`` or convergence:
        at most ``ceil((seg_end - lo) / steps)`` replays, one poll each.
        Returns (replays, done)."""
        self.seg_end.fill_(seg_end)
        launches, done, _ = drive(self, seg_end - lo)
        return launches, done


@contextlib.contextmanager
def _no_host_reads(device: torch.device):
    """On the card, make a synchronizing operation (a host read of a
    device value) raise: the warm-up finds such a read in a step before
    the capture does, while a failed capture is still cheap to avoid."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _buffers(ctx, state, limit: int, traced: bool, occ_traced: bool,
             rows: tuple = ()) -> dict:
    """A run's static buffers: the state, ``it``, ``done`` and the trace
    buffers, with ``rows`` (``(B,)`` when batched) leading ``done`` and
    the traces."""
    dev = ctx.device
    return dict(
        state={k: t.clone() for k, t in state.items()},
        it=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros(rows, dtype=torch.bool, device=dev),
        dirs=(torch.zeros(rows + (limit,), dtype=torch.bool, device=dev)
              if traced else None),
        occs=(torch.full(rows + (limit,), DENSE_OCC, dtype=torch.float32,
                         device=dev) if occ_traced else None))


def _build(program: VertexProgram, ctx: EdgeContext, state, limit: int,
           traced: bool, occ_traced: bool) -> _Fused:
    return _capture(_Fused(program=program, ctx=ctx, limit=limit,
                           steps=STEPS_PER_LAUNCH,
                           **_buffers(ctx, state, limit, traced,
                                      occ_traced)))


def build_batch(program: VertexProgram, bctx, state, limit: int,
                traced: bool, occ_traced: bool) -> _FusedBatch:
    """The batched run's buffers and graph (see :func:`_capture`)."""
    return _capture(_FusedBatch(
        program=program, ctx=bctx, limit=limit, steps=STEPS_PER_LAUNCH,
        it_b=torch.zeros(bctx.B, dtype=torch.int32, device=bctx.device),
        **_buffers(bctx, state, limit, traced, occ_traced, (bctx.B,))))


def build_slice(program: VertexProgram, bctx, state, slice_len: int,
                traced: bool, occ_traced: bool) -> _FusedSlice:
    """A slice's buffers and graph (see :func:`_capture`)."""
    dev, b = bctx.device, bctx.B
    return _capture(_FusedSlice(
        program=program, ctx=bctx, limit=slice_len, steps=STEPS_PER_LAUNCH,
        it_b=torch.zeros(b, dtype=torch.int32, device=dev),
        parked=torch.zeros(b, dtype=torch.bool, device=dev),
        limit_b=torch.zeros(b, dtype=torch.int32, device=dev),
        **_buffers(bctx, state, slice_len, traced, occ_traced, (b,))))


def build_segment(program: VertexProgram, ctx: EdgeContext, state,
                  limit: int, traced: bool,
                  occ_traced: bool) -> _FusedSegment:
    """A checkpointed run's buffers and graph (see :func:`_capture`)."""
    return _capture(_FusedSegment(
        program=program, ctx=ctx, limit=limit, steps=STEPS_PER_LAUNCH,
        seg_end=torch.zeros((), dtype=torch.int32, device=ctx.device),
        **_buffers(ctx, state, limit, traced, occ_traced)))


def _capture(ex: _Fused) -> _Fused:
    """The warm-up with every branch taken, then on the card the capture
    of :data:`STEPS_PER_LAUNCH` guarded steps over ``ex``'s buffers."""
    ctx = ex.ctx
    dev = ctx.device
    warm, control = ex.copy(), _Warm()
    with _controlled(ctx, control), _no_host_reads(dev):
        warm.guarded_step(control)
    del warm
    if dev.type == "cuda":
        _synchronize(dev)
        graph = CudaGraph(dev)
        control = _Capture(graph)
        with torch.cuda.device(dev), graph.capture(), \
                _controlled(ctx, control):
            for _ in range(ex.steps):
                ex.guarded_step(control)
        ex.graph = graph
    return ex


def cached_engine(program: VertexProgram, ctx: EdgeContext, params: tuple,
                  build) -> _Fused:
    """``build()``'s engine, cached under ``"exec_fn"`` on ``ctx``'s
    graph (``executor.py:682-702``).  The key names the program, the
    context's config, kernels, capacity, resolved plans
    (``plan_signature``) and device, ``params`` and
    :data:`STEPS_PER_LAUNCH`; the entry holds the program, so that its
    id cannot be recycled while the entry lives."""
    key = (id(program), ctx.config, ctx.use_kernels,
           ctx.sparse_edge_capacity, ctx.plan_signature,
           str(ctx.device)) + params + (STEPS_PER_LAUNCH,)
    g = ctx.graph
    if g is None:
        return build()
    return PLAN_CACHE.get(g, "exec_fn", key, lambda: (program, build()),
                          capacity=EXEC_FN_CAPACITY)[1]


def drive(ex: _Fused, limit: int) -> tuple:
    """The timed loop: launch and poll until the run is done or the
    launches have covered ``limit`` steps.  Returns ``(launches, done,
    seconds)``."""
    dev = ex.ctx.device
    _synchronize(dev)
    t0 = time.perf_counter()
    launches, done = 0, False
    while not done and launches * ex.steps < limit:
        ex.launch()
        launches += 1
        done = ex.poll()
    _synchronize(dev)
    return launches, done, time.perf_counter() - t0


def run_fused(program: VertexProgram, ctx: EdgeContext, state,
              limit: int, phases: Dict[str, float]) -> RunResult:
    """Drive ``program`` to convergence with the fused engine.  The
    timed region holds the launches and their polls; decoding ``it`` and
    the traces comes after the timer stops.  ``phases`` receives the
    engine's lookup (and build, on a miss) as ``run.engine``, the reset
    as ``run.reset``, :func:`drive`'s own seconds as ``run.drive`` and
    the decoding and the state's clone as ``run.finish``;
    ``RunResult.captures`` is 1 when the lookup built the engine."""
    traced, occ_traced = _trace_flags(program, state)
    built = []

    def build():
        built.append(True)
        return _build(program, ctx, state, limit, traced, occ_traced)

    with spans.phase(phases, "run.engine"):
        ex = cached_engine(program, ctx, (limit, traced, occ_traced), build)
    with spans.phase(phases, "run.reset"):
        ex.reset(state)
    with spans.span(spans.PREFIX + "run.drive"):
        launches, done, dt = drive(ex, limit)
    phases["run.drive"] = dt
    with spans.phase(phases, "run.finish"):
        STATS.add(launches)
        ctx.host_syncs += launches
        it = int(ex.it)
        trace, occ_trace = _decode_traces(
            ex.dirs[:it] if traced else None,
            ex.occs[:it] if occ_traced else None)
        return RunResult(state={k: t.clone() for k, t in ex.state.items()},
                         iterations=it, seconds=dt, converged=done,
                         direction_trace=trace, occupancy_trace=occ_trace,
                         engine="fused", dispatches=launches,
                         host_syncs=launches, captures=len(built))
