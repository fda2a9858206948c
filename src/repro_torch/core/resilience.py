"""Checkpointed runs, sentinels, certificates and recovery.

Counterpart of ``repro.core.resilience``.  ``run(..., checkpoint_every=K)``
(or any other resilience knob) hands off to :func:`run_resilient`:

- **Segments.**  The fused engine's guarded step also stops at a device
  scalar ``seg_end`` (:class:`~repro_torch.core.capture._FusedSegment`),
  so ONE captured CUDA graph per (program, context, limit, traces) serves
  every segment of every attempt, the reference's "one compiled
  executable" (``resilience.py:336-383``).  A segment is at most
  ``ceil((seg_end - it) / STEPS_PER_LAUNCH)`` replays with one poll each;
  the per-iteration math is the plain engine's, so a checkpointed run
  equals the plain run.
- **Boundaries.**  After a segment the sentinels run eagerly on the
  device against a device clone of the segment's start state (and, when
  the run converged, the certificate), then ONE blocking read brings the
  state, the trace buffers, ``it``, ``done`` and the flags to the host
  together: on the card, non-blocking copies into pinned staging buffers
  and one stream synchronize.  The host copies become a
  :class:`Checkpoint` in the :class:`CheckpointRing` and, with
  ``checkpoint_dir``, a generation of the on-disk
  :class:`~repro_torch.core.durability.CheckpointStore`.
- **Sentinels.**  A NaN guard over float state, the program's
  ``monotone`` monitors, its custom ``sentinels`` and an occupancy-window
  check, in the reference's order.  A converged state is also proved by
  the program's O(E) ``certificate``, which catches dropped updates that
  no boundary sentinel can see.
- **Recovery.**  :class:`RetryPolicy` rolls back one checkpoint deeper
  per retry and walks the degradation chain: retry as is, then
  ``autotune="off"``, then ``sparse_edge_capacity=0`` on dynamic
  configs, then ``engine="host"``.  An exhausted retry returns a
  structured ``outcome="faulted"`` result with its fault history, never
  a silently wrong state.

Port differences: the reference's fused segment is one dispatch; here it
is up to ``ceil(K / STEPS_PER_LAUNCH)`` replays, each polled, and
``RunResult.dispatches`` counts replays.  The run's ``key`` is a
``torch.Generator``.  ``RunResult.seconds`` covers the segments and their
boundaries (sentinels, certificate, snapshot); the reference times the
dispatches only.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.capture import (_no_host_reads, build_segment,
                                      cached_engine)
from repro_torch.core.config_space import SystemConfig, UpdateProp
from repro_torch.core.executor import (EdgeContext, RunResult,
                                       _decode_traces, _normalize_autotune,
                                       _synchronize, _trace_flags)
from repro_torch.core.vertex_program import (DENSE_OCC, FRONTIER_DIR_KEY,
                                             FRONTIER_OCC_KEY, VertexProgram)
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph

__all__ = ["Checkpoint", "CheckpointRing", "RetryPolicy", "ExecutionFault",
           "FaultInjector", "run_resilient", "build_sentinels",
           "check_state_host", "check_certificate",
           "DEFAULT_CHECKPOINT_EVERY", "DEFAULT_RING_CAPACITY"]

#: Default segment length: most pinned workloads converge in a couple
#: of segments at this interval.
DEFAULT_CHECKPOINT_EVERY = 32

#: Default :class:`CheckpointRing` capacity: the pinned initial snapshot
#: plus the three newest boundaries.
DEFAULT_RING_CAPACITY = 4


class ExecutionFault(RuntimeError):
    """Structured execution failure: ``code`` plus a detail dict."""

    def __init__(self, code: str, detail: Optional[dict] = None):
        self.code = code
        self.detail = dict(detail or {})
        super().__init__(f"{code}: {self.detail}" if self.detail else code)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Recovery policy for :func:`run_resilient`.

    ``max_attempts`` counts executions, the first included; retry ``a``
    sleeps ``backoff_s * a`` seconds, rolls back ``a`` checkpoints
    (clamped at the ring's pinned initial snapshot) and runs the ``a``-th
    rung of the degradation chain.
    """
    max_attempts: int = 3
    backoff_s: float = 0.0


@dataclasses.dataclass
class Checkpoint:
    """One snapshot: host numpy state plus loop and trace position."""
    it: int
    done: bool
    state: Any                          # dict of host numpy arrays
    dir_buf: Optional[np.ndarray]       # [limit] bool, traced programs
    occ_buf: Optional[np.ndarray]       # [limit] float32, occ-traced


class CheckpointRing:
    """The pinned *initial* snapshot plus the ``capacity - 1`` newest
    boundaries; ``capacity=1`` is a cold restart."""

    def __init__(self, capacity: int = DEFAULT_RING_CAPACITY):
        if capacity < 1:
            raise ValueError(
                f"CheckpointRing capacity must be >= 1, got "
                f"capacity={capacity}")
        self.capacity = capacity
        self._first: Optional[Checkpoint] = None
        self._ring: deque = deque(maxlen=capacity - 1)

    def push(self, cp: Checkpoint) -> None:
        if self._first is None:
            self._first = cp
        else:
            self._ring.append(cp)

    def latest(self) -> Checkpoint:
        if self._first is None:
            raise IndexError("empty CheckpointRing")
        return self._ring[-1] if self._ring else self._first

    def rollback(self, depth: int) -> Checkpoint:
        """Discard the ``depth`` newest snapshots and return the new
        latest; clamps at the pinned initial snapshot."""
        for _ in range(depth):
            if self._ring:
                self._ring.pop()
        return self.latest()

    def __len__(self) -> int:
        return (0 if self._first is None else 1) + len(self._ring)


class FaultInjector:
    """Injection points of :func:`run_resilient` for the seeded fault
    harness (:mod:`repro_torch.testing.faults`).  The base is a no-op;
    ``knob_overrides`` forces execution knobs."""
    knob_overrides: dict = {}

    def on_compile(self, knobs: dict) -> None:
        """Before an attempt builds or fetches its engine."""

    def before_segment(self, it: int) -> None:
        """Before each segment; raise to emulate a runner exception."""

    def perturb(self, it: int, state, checkpoint_state) -> Optional[Any]:
        """After a segment: a corrupted copy of the host state, or None."""
        return None


# ----------------------------------------------------------------------
# sentinels


def build_sentinels(program: VertexProgram) -> List[tuple]:
    """The program's battery as ``[(name, (prev, cur) -> ok)]``: the NaN
    guard over float state (NaN only: +inf is legitimate state), the
    ``monotone`` monitors sorted by key, then the custom sentinels
    sorted by name."""
    fns: List[tuple] = []

    def nan_guard(prev, cur):
        bad = [torch.isnan(t).any() for t in cur.values()
               if t.is_floating_point()]
        if not bad:
            return next(iter(cur.values())).new_ones((), dtype=torch.bool)
        return ~torch.stack(bad).any()

    fns.append(("nan", nan_guard))
    for key, order in sorted((program.monotone or {}).items()):
        if order == "non_increasing":
            fn = lambda p, c, k=key: (c[k] <= p[k]).all()  # noqa: E731
        elif order == "non_decreasing":
            fn = lambda p, c, k=key: (c[k] >= p[k]).all()  # noqa: E731
        else:
            raise ValueError(f"unknown monotone order {order!r} for "
                             f"state key {key!r}")
        fns.append((f"monotone:{key}", fn))
    for name in sorted(program.sentinels or {}):
        fns.append((name, program.sentinels[name]))
    return fns


def _sentinel_flags(sentinel_fns, prev, cur, occs, lo, hi, limit: int,
                    occ_traced: bool) -> torch.Tensor:
    """Stacked health flags on the device (True = healthy), with the
    occupancy check over the trace window ``[lo, hi)`` when the program
    traces occupancy; ``hi`` may be a device scalar."""
    flags = [fn(prev, cur).to(torch.bool).reshape(())
             for _, fn in sentinel_fns]
    if occ_traced and occs is not None:
        idx = torch.arange(limit, device=occs.device)
        window = (idx >= lo) & (idx < hi)
        # the dense sentinel or a gather fill fraction in [0, 1]; NaN
        # fails both
        valid = (occs == DENSE_OCC) | ((occs >= 0.0) & (occs <= 1.0 + 1e-5))
        flags.append((~window | valid).all())
    if not flags:
        return next(iter(cur.values())).new_zeros((0,), dtype=torch.bool)
    return torch.stack(flags)


def _sentinel_names(sentinel_fns, occ_traced) -> List[str]:
    return [n for n, _ in sentinel_fns] + (["occupancy"] if occ_traced
                                           else [])


def check_state_host(program: VertexProgram, prev, cur) -> List[str]:
    """Pure-numpy NaN and monotonicity guards on host snapshots; returns
    the tripped names."""
    tripped: List[str] = []
    for leaf in cur.values():
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and np.isnan(a).any():
            tripped.append("nan")
            break
    for key, order in sorted((program.monotone or {}).items()):
        p, c = np.asarray(prev[key]), np.asarray(cur[key])
        if order == "non_increasing":
            if np.any(c > p):
                tripped.append(f"monotone:{key}")
        elif np.any(c < p):
            tripped.append(f"monotone:{key}")
    return tripped


def check_certificate(program: VertexProgram, ctx: EdgeContext,
                      state) -> Optional[bool]:
    """The program's converged-state certificate on ``state`` (host arrays
    or tensors), read with one host sync; None when it declares none."""
    if program.certificate is None:
        return None
    dev = ctx.device
    st = {k: torch.as_tensor(v).to(dev) for k, v in state.items()}
    with _no_host_reads(dev):
        ok = _certify(program, ctx, st)
    return bool(ok)


def _certify(program, ctx, state) -> torch.Tensor:
    return program.certificate(ctx, state).to(torch.bool).reshape(())


# ----------------------------------------------------------------------
# segmented execution


class _SentinelTrip(Exception):
    """A sentinel or the certificate rejected a segment."""

    def __init__(self, sentinels: List[str], lo: int, hi: int,
                 attempt: int, engine: str):
        self.detail = {"kind": "sentinel", "sentinels": list(sentinels),
                       "segment": [int(lo), int(hi)], "iteration": int(hi),
                       "attempt": int(attempt), "engine": engine}
        super().__init__(f"sentinel trip {sentinels} in segment "
                         f"[{lo}, {hi})")


@dataclasses.dataclass
class _Accounting:
    """A run's counts over all its attempts (``RunResult.resilience``):
    segments, boundaries' host seconds and bytes read, and on the card
    the stream ms between timing events (the host's issue gaps included)
    of the sentinels, certificates and snapshot copies."""
    seconds: float = 0.0
    dispatches: int = 0
    host_syncs: int = 0
    segments: int = 0
    boundary_seconds: float = 0.0
    snapshot_bytes: int = 0
    sentinel_ms: Optional[float] = None
    certificate_ms: Optional[float] = None
    snapshot_ms: Optional[float] = None

    def add_ms(self, name: str, ms: float) -> None:
        setattr(self, name, (getattr(self, name) or 0.0) + ms)


def _mark(device: torch.device):
    """A recorded timing event on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _host_arrays(state) -> Dict[str, np.ndarray]:
    return {k: torch.as_tensor(v).cpu().numpy().copy()
            for k, v in state.items()}


def _device_state(state, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in state.items()}


def _read(tensors: Dict[str, torch.Tensor], staging: dict,
          marks: list) -> Dict[str, np.ndarray]:
    """Host copies of ``tensors`` with ONE blocking read.  On the card:
    non-blocking copies into pinned staging buffers (kept in ``staging``
    for the next boundary), a timing event appended to ``marks`` once
    they are issued, one stream synchronize, then numpy copies, since
    the staging buffers are overwritten at the next boundary."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        return {k: t.numpy().copy() for k, t in tensors.items()}
    for k, t in tensors.items():
        buf = staging.get(k)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = staging[k] = torch.empty(t.shape, dtype=t.dtype,
                                           pin_memory=True)
        buf.copy_(t, non_blocking=True)
    marks.append(_mark(dev))
    torch.cuda.current_stream(dev).synchronize()
    return {k: staging[k].numpy().copy() for k in tensors}


class _HostSegments:
    """The host engine's rung: one step per iteration and a blocking read
    of ``done`` after each, as ``executor.py:_run_host``; ``it`` reaches
    the step as a view into one device ``arange``.  The trace scalars and
    ``it``/``done`` live in device buffers, as the fused engine's, so
    that one boundary code serves both."""

    def __init__(self, program, ctx, state, limit, traced, occ_traced):
        dev = ctx.device
        self.program, self.ctx = program, ctx
        self.its = torch.arange(max(limit, 1), dtype=torch.int32, device=dev)
        program.step(ctx, {k: t.clone() for k, t in state.items()},
                     self.its[0])
        _synchronize(dev)
        self.state = state
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.dirs = (torch.zeros(limit, dtype=torch.bool, device=dev)
                     if traced else None)
        self.occs = (torch.full((limit,), DENSE_OCC, dtype=torch.float32,
                                device=dev) if occ_traced else None)
        self._it = 0
        self.staging: dict = {}   # pinned buffers of the boundary reads

    def load(self, cp: Checkpoint) -> None:
        self.load_state(cp.state)
        self._it = int(cp.it)
        self.it.fill_(self._it)
        self.done.fill_(bool(cp.done))
        if self.dirs is not None:
            self.dirs.copy_(torch.from_numpy(cp.dir_buf))
        if self.occs is not None:
            self.occs.copy_(torch.from_numpy(cp.occ_buf))

    def load_state(self, state) -> None:
        self.state = _device_state(state, self.ctx.device)

    def advance(self, lo: int, seg_end: int) -> tuple:
        """Steps up to ``seg_end`` or convergence, one read of ``done``
        each; returns (steps, done)."""
        steps, done = 0, False
        while self._it < seg_end:
            new = self.program.step(self.ctx, self.state, self.its[self._it])
            done_dev = self.program.converged(self.state, new)
            self.state = new
            if self.dirs is not None:
                self.dirs[self._it] = new[FRONTIER_DIR_KEY]
            if self.occs is not None:
                self.occs[self._it] = new[FRONTIER_OCC_KEY]
            self._it += 1
            steps += 1
            done = self.ctx._read(done_dev)
            if done:
                break
        self.it.fill_(self._it)
        self.done.fill_(done)
        return steps, done


def _runner(program, ctx, cp: Checkpoint, limit, traced, occ_traced,
            engine):
    """The attempt's engine: the cached captured segment graph, or the
    host engine's stepper."""
    if engine == "host":
        return _HostSegments(program, ctx, _device_state(cp.state,
                                                         ctx.device),
                             limit, traced, occ_traced)
    return cached_engine(
        program, ctx, ("segment", limit, traced, occ_traced),
        lambda: build_segment(program, ctx, _device_state(cp.state,
                                                          ctx.device),
                              limit, traced, occ_traced))


def _tripped(names: List[str], flags) -> List[str]:
    arr = np.asarray(flags, bool)
    return [names[i] for i in np.where(~arr)[0]]


def _degradation_chain(knobs0: dict, config: SystemConfig) -> List[dict]:
    """Rung ``a`` is the knob set of retry ``a + 1``: retry as is, then
    ``autotune="off"``, then no sparse gather (dynamic configs), then the
    host engine; rungs that change nothing are skipped
    (``resilience.py:428``)."""
    chain = [dict(knobs0)]

    def add(**delta):
        cand = {**chain[-1], **delta}
        if cand not in chain:
            chain.append(cand)

    if knobs0["autotune"] != "off":
        add(autotune="off")
    if (config.prop is UpdateProp.PUSH_PULL
            and knobs0["sparse_edge_capacity"] != 0):
        add(sparse_edge_capacity=0)
    if chain[-1]["engine"] == "fused":
        add(engine="host")
    return chain


def _host_traces(dir_buf, occ_buf, it: int) -> tuple:
    return _decode_traces(None if dir_buf is None else dir_buf[:it],
                          None if occ_buf is None else occ_buf[:it])


def _boundary(runner, program, ctx, sentinel_fns, prev, lo, limit,
              occ_traced, certify: bool, acct: _Accounting,
              state_only: bool = False) -> dict:
    """The sentinels (and with ``certify`` the certificate) on the device,
    then one read of the flags with, unless ``state_only``, the state,
    ``it``, ``done`` and the trace buffers.  The eager evaluation runs
    with host reads made to raise on the card."""
    dev = ctx.device
    t0 = time.perf_counter()
    marks = [_mark(dev)]
    tensors: Dict[str, torch.Tensor] = {}
    with _no_host_reads(dev):
        if sentinel_fns or occ_traced:
            tensors["flags"] = _sentinel_flags(
                sentinel_fns, prev, runner.state, runner.occs, lo, runner.it,
                limit, occ_traced)
        marks.append(_mark(dev))
        if certify:
            tensors["cert"] = _certify(program, ctx, runner.state)
        marks.append(_mark(dev))
    if not state_only:
        tensors.update({f"state:{k}": t for k, t in runner.state.items()})
        tensors["it"], tensors["done"] = runner.it, runner.done
        if runner.dirs is not None:
            tensors["dirs"] = runner.dirs
        if runner.occs is not None:
            tensors["occs"] = runner.occs
    host = _read(tensors, runner.staging, marks)
    acct.host_syncs += 1
    acct.boundary_seconds += time.perf_counter() - t0
    acct.snapshot_bytes += sum(t.element_size() * t.numel()
                               for t in tensors.values())
    if marks[0] is not None:
        for name, a, b in (("sentinel_ms", 0, 1), ("certificate_ms", 1, 2),
                           ("snapshot_ms", 2, 3)):
            acct.add_ms(name, marks[a].elapsed_time(marks[b]))
    return host


def _segment_loop(program, ctx, cp, limit, K, ring, sentinel_fns, injector,
                  acct, attempt, traced, occ_traced, engine,
                  store=None) -> RunResult:
    """Drive segments from checkpoint ``cp`` to convergence or the limit,
    pushing each boundary into ``ring`` (and ``store``); raises
    :class:`_SentinelTrip`, or whatever the injector raises, on failure
    (``resilience.py:460``)."""
    names = _sentinel_names(sentinel_fns, occ_traced)
    check = bool(names)
    certify = check and program.certificate is not None
    runner = _runner(program, ctx, cp, limit, traced, occ_traced, engine)
    runner.load(cp)
    it, done = cp.it, cp.done
    prev_host = cp.state
    dir_buf, occ_buf = cp.dir_buf, cp.occ_buf
    cert_ok, segments = True, 0
    t0 = time.perf_counter()
    try:
        while it < limit and not done:
            lo = it
            seg_end = min(it + K, limit)
            if injector is not None:
                injector.before_segment(it)
            prev = {k: t.clone() for k, t in runner.state.items()}
            # either engine reads ``done`` once per dispatch
            dispatches, done = runner.advance(lo, seg_end)
            segments += 1
            acct.dispatches += dispatches
            acct.host_syncs += dispatches
            acct.segments += 1
            host = _boundary(runner, program, ctx, sentinel_fns, prev, lo,
                             limit, occ_traced, certify and done, acct)
            it, done = int(host["it"]), bool(host["done"])
            host_state = {k: host[f"state:{k}"] for k in runner.state}
            dir_buf, occ_buf = host.get("dirs"), host.get("occs")
            if injector is not None:
                p = injector.perturb(it, host_state, prev_host)
                if p is not None:
                    # the flags above describe the state before the
                    # perturbation: load it into the engine, check again
                    host_state = p
                    runner.load_state(p)
                    host.update(_boundary(
                        runner, program, ctx, sentinel_fns, prev, lo, limit,
                        occ_traced, certify and done, acct, state_only=True))
            if check:
                bad = _tripped(names, host["flags"])
                if bad:
                    raise _SentinelTrip(bad, lo, it, attempt, engine)
            cert_ok = bool(host.get("cert", True))
            boundary = Checkpoint(it=it, done=done, state=host_state,
                                  dir_buf=dir_buf, occ_buf=occ_buf)
            ring.push(boundary)
            if store is not None:
                store.save(boundary)
            prev_host = host_state
        if done and certify and not segments:
            # resumed from a converged checkpoint: no segment ran
            cert_ok = check_certificate(program, ctx, runner.state)
            acct.host_syncs += 1
        if done and not cert_ok:
            raise _SentinelTrip(["certificate"], it, it, attempt, engine)
    finally:
        acct.seconds += time.perf_counter() - t0
    trace, occ_trace = _host_traces(dir_buf, occ_buf, it)
    return RunResult(state={k: t.clone() for k, t in runner.state.items()},
                     iterations=it, seconds=acct.seconds, converged=done,
                     direction_trace=trace, occupancy_trace=occ_trace,
                     engine=engine, dispatches=acct.dispatches,
                     host_syncs=acct.host_syncs, attempts=attempt + 1)


def run_resilient(program: VertexProgram, graph: Graph,
                  config: SystemConfig,
                  key: Optional[torch.Generator] = None,
                  max_iters: Optional[int] = None, use_kernels: bool = False,
                  sparse_edge_capacity: Optional[int] = None,
                  engine: str = "fused", autotune=None, device=None,
                  checkpoint_every: int = 0,
                  retry: Optional[RetryPolicy] = None,
                  sentinels: bool = True,
                  ring_capacity: Optional[int] = None,
                  fault_injector: Optional[FaultInjector] = None,
                  checkpoint_dir: Optional[str] = None) -> RunResult:
    """Checkpointed, sentinel-guarded, retrying counterpart of
    :func:`repro_torch.core.executor.run` (``resilience.py:553``).

    Results equal the plain engines'; ``RunResult.outcome`` is
    "converged", "iter_limit" or "faulted" (history under
    ``RunResult.fault``), ``RunResult.attempts`` the executions made and
    ``RunResult.resilience`` the boundaries' accounting.
    ``checkpoint_dir`` spills every boundary to a
    :class:`~repro_torch.core.durability.CheckpointStore` and resumes a
    killed run from the newest intact generation, bit-identical to an
    uninterrupted run; corrupt or foreign generations are recorded in
    the fault history and skipped.
    """
    if engine not in ("fused", "host"):
        raise ValueError(f"unknown engine {engine!r}; "
                         "expected 'fused' or 'host'")
    device = resolve_device(device)
    limit = max_iters or program.max_iters
    K = int(checkpoint_every) if checkpoint_every else \
        DEFAULT_CHECKPOINT_EVERY
    if K < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {K}")
    knobs0 = {"engine": engine,
              "autotune": _normalize_autotune(autotune),
              "sparse_edge_capacity": sparse_edge_capacity,
              "use_kernels": bool(use_kernels)}
    injector = fault_injector
    if injector is not None and getattr(injector, "knob_overrides", None):
        knobs0.update(injector.knob_overrides)
    chain = _degradation_chain(knobs0, config)
    max_attempts = retry.max_attempts if retry is not None else 1
    if max_attempts < 1:
        raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")

    capacity = ring_capacity or DEFAULT_RING_CAPACITY
    store = None
    faults: List[dict] = []
    ring = CheckpointRing(capacity)
    if checkpoint_dir is not None:
        from repro_torch.core.durability import (CheckpointStore,
                                                 _serialize_key,
                                                 graph_fingerprint)
        # the graph by content hash and the generator's state before
        # init consumes it: a same-shape graph or another seed never
        # resumes this run
        store = CheckpointStore(
            checkpoint_dir, keep=capacity,
            fingerprint={"program": program.name, "config": config.name,
                         "n_nodes": int(graph.n_nodes),
                         "n_edges": int(graph.n_edges),
                         "graph_sha256": graph_fingerprint(graph),
                         "key": _serialize_key(key),
                         "limit": int(limit), "k": int(K)})
        disk_cps, disk_faults = store.load_all()
        faults.extend(disk_faults)
        for disk_cp in disk_cps:
            ring.push(disk_cp)
    if len(ring):
        # resumed: boundaries fall on the same multiples of K, so the
        # remaining segments are the ones the killed run would have run
        seed_cp = ring.latest()
        traced = seed_cp.dir_buf is not None
        occ_traced = seed_cp.occ_buf is not None
    else:
        state0 = program.init(graph, key) if key is not None \
            else program.init(graph)
        traced, occ_traced = _trace_flags(program, state0)
        initial = Checkpoint(
            it=0, done=False, state=_host_arrays(state0),
            dir_buf=np.zeros((limit,), bool) if traced else None,
            occ_buf=(np.full((limit,), DENSE_OCC, np.float32)
                     if occ_traced else None))
        ring.push(initial)
        if store is not None:
            store.save(initial)
    sentinel_fns = build_sentinels(program) if sentinels else []
    acct = _Accounting()
    attempt = 0
    while True:
        knobs = knobs0 if attempt == 0 \
            else chain[min(attempt - 1, len(chain) - 1)]
        # each retry rolls back one checkpoint deeper: boundaries of the
        # failed attempt passed their checks but may carry a corruption
        # only the certificate sees
        cp = ring.rollback(attempt) if attempt else ring.latest()
        try:
            ctx = EdgeContext.create(
                graph, config, use_kernels=knobs["use_kernels"],
                sparse_edge_capacity=knobs["sparse_edge_capacity"],
                autotune=knobs["autotune"], device=device)
            if injector is not None:
                injector.on_compile(knobs)
            res = _segment_loop(program, ctx, cp, limit, K, ring,
                                sentinel_fns, injector, acct, attempt,
                                traced, occ_traced, knobs["engine"],
                                store=store)
            if faults:
                res.fault = {"history": faults, "recovered": True}
            res.resilience = dataclasses.asdict(acct)
            return res
        except _SentinelTrip as trip:
            faults.append(trip.detail)
        except Exception as err:  # noqa: BLE001 (recovery is the point)
            faults.append({"kind": "exception", "error": repr(err),
                           "attempt": attempt,
                           "engine": knobs["engine"]})
        attempt += 1
        if attempt >= max_attempts:
            cp = ring.latest()
            trace, occ_trace = _host_traces(cp.dir_buf, cp.occ_buf, cp.it)
            return RunResult(
                state=_device_state(cp.state, device), iterations=cp.it,
                seconds=acct.seconds, converged=False,
                direction_trace=trace, occupancy_trace=occ_trace,
                engine=knobs["engine"], dispatches=acct.dispatches,
                host_syncs=acct.host_syncs, outcome="faulted",
                fault={"history": faults, "final": faults[-1],
                       "recovered": False},
                attempts=attempt, resilience=dataclasses.asdict(acct))
        if retry is not None and retry.backoff_s:
            time.sleep(retry.backoff_s * attempt)
