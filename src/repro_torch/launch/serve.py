"""Streaming graph-serving gateway with continuous batching.

Counterpart of ``repro.launch.serve``.  No single (coherence,
consistency, push/pull) configuration wins across workloads, so a
serving front end admits a live stream of heterogeneous ``(program,
graph, config)`` queries and runs each on a packed batch of its kind,
scheduled per iteration slice:

- **Admission.**  :meth:`ContinuousScheduler.submit` validates the graph
  (:func:`~repro_torch.graph.structure.validate_graph`: a malformed query
  gets a structured :class:`AdmissionError` before it touches a batch),
  applies bounded-queue backpressure (:class:`GatewayBackpressure`),
  sheds a deadline it cannot meet (:class:`OverloadError`) and enqueues a
  :class:`Ticket` on the request's **lane**: the (program, config,
  knobs, :func:`~repro_torch.core.batch.bucket_key`) class whose members
  pack together.
- **Continuous batching.**  A lane keeps a *roster* of up to
  ``max_batch`` packed slots.  Every round admits waiting tickets into
  free slots and advances the roster by one slice of at most
  ``slice_len`` iterations (:func:`~repro_torch.core.batch.
  run_batch_slice`: on the card, up to ``ceil(slice_len /
  STEPS_PER_LAUNCH)`` replays of one captured graph); converged requests
  retire at the slice boundary and new graphs join the next slice.  Each
  request carries its own iteration counter and freeze mask, so results
  equal a sequential :func:`~repro_torch.core.executor.run` whatever
  cohort a request shared (PR, a float sum, to tolerance).
- **Fault containment.**  Lane states are host numpy between slices and
  committed only after the slice's sentinels pass
  (:func:`~repro_torch.core.resilience.check_state_host`; a converged
  slot must also pass its program's certificate), so a runner exception
  rolls back for free: the slice is retried whole under
  :class:`~repro_torch.core.resilience.RetryPolicy`, then slot by slot in
  B = 1 batches, and only a slot that still fails is quarantined
  (outcome ``"faulted"``, an :class:`~repro_torch.core.resilience.
  ExecutionFault` on :meth:`Ticket.result`).  A per-lane circuit breaker
  routes repeatedly failing rosters solo until a packed probe is clean.
  A kernel that cannot be built (:class:`~repro_torch.kernels._build.
  KernelBuildError`) is not a request's fault: it is raised, never
  contained.
- **Plan-cache warmth.**  A roster whose membership does not change
  reuses its pack (``"batch_pack"``), bound context (``"batch_context"``)
  and captured slice graph (``"exec_fn"``), so a steady-state slice is
  host packing, one copy to the device, the replays and one read back.
  Every membership change builds a new pack, context and, on the card,
  a new capture with its own memory pool.

Port differences: ``use_kernels=`` replaces ``use_pallas=``; ``device=``
defaults to CUDA and raises without it (the tests pass ``"cpu"``); the
worker of :class:`GraphGateway` sets the device before its first CUDA
call and is the only thread that touches the card (the API hands out
host numpy).  ``RunResult.dispatches`` counts a request's committed
slices, as the reference's; the replays inside the slices are counted
in :class:`GatewayStats` (``replays``), beside the slices' host seconds
and the certificates' seconds.

Quickstart::

    with GraphGateway(device="cuda") as gw:
        t = gw.submit(bfs(), graph, SystemConfig.from_name("DG1"))
        result = t.result()          # RunResult, equal to run()

``python -m repro_torch.launch.serve`` runs a self-contained demo.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import sys
import threading
import time
import warnings
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.batch import (BatchedEdgeContext, bucket_key,
                                    get_graph_batch, run_batch_slice)
from repro_torch.core.config_space import SystemConfig
from repro_torch.core.executor import (EdgeContext, RunResult,
                                       _normalize_autotune)
from repro_torch.core.plan_cache import PLAN_CACHE
from repro_torch.core.resilience import (ExecutionFault, RetryPolicy,
                                         check_certificate, check_state_host)
from repro_torch.core.vertex_program import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.graph.structure import Graph, validate_graph
from repro_torch.kernels._build import KernelBuildError

__all__ = ["GraphGateway", "ContinuousScheduler", "Ticket", "GatewayStats",
           "AdmissionError", "GatewayBackpressure", "OverloadError",
           "CancelledError", "main"]


class AdmissionError(ValueError):
    """A request rejected at admission, before touching any batch.

    ``code`` is a stable machine-readable class (``"invalid_graph"``),
    ``errors`` the structural defects
    :func:`~repro_torch.graph.structure.validate_graph` found.
    """

    def __init__(self, code: str, errors: List[str]):
        super().__init__(f"{code}: " + "; ".join(errors))
        self.code = code
        self.errors = list(errors)


class GatewayBackpressure(RuntimeError):
    """Raised by ``submit`` when ``max_queue`` requests already wait:
    arrivals exceed service.  Callers retry with backoff or shed."""


class OverloadError(RuntimeError):
    """A deadline-carrying request shed at admission: the projected
    delay (waves of queued work ahead times the observed service time,
    both from :class:`GatewayStats`) already exceeds its ``deadline_s``.

    ``code`` is ``"overload_shed"``; ``detail`` holds the projection.
    Requests without a deadline are never shed.
    """

    def __init__(self, code: str, detail: Optional[Dict[str, Any]] = None):
        self.code = code
        self.detail = dict(detail or {})
        super().__init__(f"{code}: {self.detail}" if self.detail else code)


class CancelledError(RuntimeError):
    """Raised by :meth:`Ticket.result` for a cancelled request."""


def _host_state(state) -> Dict[str, np.ndarray]:
    """A program's init state (CPU tensors) as host numpy arrays."""
    return {k: torch.as_tensor(v).numpy() for k, v in state.items()}


# ---------------------------------------------------------------------------
class Ticket:
    """One in-flight request: a future plus its lifecycle timestamps
    (``enqueued_at`` -> ``admitted_at`` -> ``first_dispatch_at`` ->
    ``completed_at``, on the gateway's clock)."""

    _ids = itertools.count()

    def __init__(self, program: VertexProgram, graph: Graph,
                 config: SystemConfig, key, max_iters: Optional[int],
                 deadline_s: Optional[float]):
        self.id = next(self._ids)
        #: journal-scoped id, stable across process restarts; set at
        #: submit when the scheduler keeps a write-ahead journal
        self.jid: Optional[str] = None
        #: recovery payload ``(state, it, meta)`` from the ticket's newest
        #: persisted checkpoint, used instead of ``program.init``
        self._restore = None
        self.program = program
        self.graph = graph
        self.config = config
        #: "caller", or the ``specialize=`` tier that resolved ``config``
        self.config_source = "caller"
        self.key = key
        self.max_iters = max_iters
        self.deadline_s = deadline_s
        self.enqueued_at: Optional[float] = None
        self.admitted_at: Optional[float] = None
        self.first_dispatch_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self.cancelled = False
        self._event = threading.Event()
        self._result: Optional[RunResult] = None
        self._error: Optional[BaseException] = None
        self._on_cancel = None
        self._dispatches = 0
        self._trace: List[str] = []
        self._occs: List[float] = []
        self._traced = False
        self._occ_traced = False

    def cancel(self) -> None:
        """Request cancellation: honoured at the next slice boundary
        (mid-flight) or the next admission round (still queued)."""
        self.cancelled = True
        if self._on_cancel is not None:
            self._on_cancel()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RunResult:
        """The request's :class:`RunResult` (blocks up to ``timeout``).

        Raises :class:`CancelledError` for a cancelled request, the
        structured fault of a quarantined one, and ``TimeoutError`` when
        the result is not ready in time (a bare
        :class:`ContinuousScheduler` advances only in ``poll()``).
        """
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not finished")
        if self._error is not None:
            raise self._error
        return self._result

    def _finish(self, result: Optional[RunResult],
                error: Optional[BaseException], now: float) -> None:
        self.completed_at = now
        self._result, self._error = result, error
        self._event.set()


# ---------------------------------------------------------------------------
@dataclasses.dataclass
class GatewayStats:
    """Aggregated request-lifecycle instrumentation.

    Counters cover every terminal outcome (completed = converged +
    iteration-limited + timed out + faulted); the latency and occupancy
    samples feed :meth:`snapshot`'s p50/p99 and throughput.  Beside the
    reference's schema: ``replays`` (graph replays inside the slices),
    ``slice_seconds`` (wall time of the committed slices, packing to the
    last commit: ``dispatch_seconds`` is their replays' share and
    ``certificate_seconds`` their certificates', the rest host work),
    and ``certificates``, the fixpoint checks of converged slots.
    """
    #: service-time samples kept for the shedding projection, bounded so
    #: one congestion episode ages out
    SERVICE_WINDOW = 32

    submitted: int = 0
    admitted: int = 0
    completed: int = 0
    converged: int = 0
    timed_out: int = 0
    cancelled: int = 0
    faulted: int = 0
    rejected: int = 0
    backpressure_rejections: int = 0
    shed: int = 0
    #: admissions whose config a ``specialize=`` tier resolved
    specialized: int = 0
    recovered_tickets: int = 0
    breaker_opens: int = 0
    breaker_closes: int = 0
    breaker_probes: int = 0
    solo_degraded_slices: int = 0
    slices: int = 0
    roster_rebuilds: int = 0
    slice_retries: int = 0
    sentinel_trips: int = 0
    quarantined: int = 0
    replays: int = 0
    certificates: int = 0
    dispatch_seconds: float = 0.0
    recovery_seconds: float = 0.0
    slice_seconds: float = 0.0
    certificate_seconds: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    service_times_s: List[float] = dataclasses.field(default_factory=list)
    queue_delays_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: List[float] = dataclasses.field(default_factory=list)
    requests: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    first_enqueue_at: Optional[float] = None
    last_complete_at: Optional[float] = None

    def record_submit(self, t: Ticket) -> None:
        self.submitted += 1
        if self.first_enqueue_at is None:
            self.first_enqueue_at = t.enqueued_at

    def record_slice(self, active: int, roster: int, seconds: float,
                     replays: int = 0) -> None:
        self.slices += 1
        self.replays += replays
        self.dispatch_seconds += seconds
        self.occupancy.append(active / max(1, roster))

    def record_done(self, t: Ticket, outcome: str) -> None:
        self.completed += 1 if outcome != "cancelled" else 0
        if outcome == "converged":
            self.converged += 1
        elif outcome == "timed_out":
            self.timed_out += 1
        elif outcome == "cancelled":
            self.cancelled += 1
        elif outcome == "faulted":
            self.faulted += 1
        self.last_complete_at = t.completed_at
        if outcome != "cancelled":
            self.latencies_s.append(t.completed_at - t.enqueued_at)
            if t.admitted_at is not None:
                self.service_times_s.append(t.completed_at - t.admitted_at)
                del self.service_times_s[:-self.SERVICE_WINDOW]
        if t.admitted_at is not None:
            self.queue_delays_s.append(t.admitted_at - t.enqueued_at)
        self.requests.append({
            "id": t.id, "outcome": outcome,
            "enqueued_at": t.enqueued_at, "admitted_at": t.admitted_at,
            "first_dispatch_at": t.first_dispatch_at,
            "completed_at": t.completed_at,
            "dispatches": t._dispatches,
        })

    @staticmethod
    def _pct(xs: List[float], q: float) -> Optional[float]:
        return float(np.percentile(np.asarray(xs), q)) if xs else None

    def projected_delay_s(self, queued_ahead: int,
                          max_batch: int) -> Optional[float]:
        """Projected time until a request arriving behind
        ``queued_ahead`` waiting requests would finish: admission waves
        (its own included) times the mean *service* time
        (``completed_at - admitted_at``) of the newest ``SERVICE_WINDOW``
        completions.  None until an admitted request has completed: a
        cold gateway never sheds."""
        if not self.service_times_s:
            return None
        waves = (queued_ahead + max_batch) // max_batch
        return waves * float(np.mean(self.service_times_s))

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able summary dict (the serving metrics schema)."""
        lat = self.latencies_s
        window = ((self.last_complete_at - self.first_enqueue_at)
                  if lat and self.last_complete_at is not None
                  and self.first_enqueue_at is not None else None)
        ms = lambda s: None if s is None else s * 1e3  # noqa: E731
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "completed": self.completed, "converged": self.converged,
            "timed_out": self.timed_out, "cancelled": self.cancelled,
            "faulted": self.faulted, "rejected": self.rejected,
            "backpressure_rejections": self.backpressure_rejections,
            "shed": self.shed,
            "specialized": self.specialized,
            "recovered_tickets": self.recovered_tickets,
            "breaker_opens": self.breaker_opens,
            "breaker_closes": self.breaker_closes,
            "breaker_probes": self.breaker_probes,
            "solo_degraded_slices": self.solo_degraded_slices,
            "slices": self.slices,
            "roster_rebuilds": self.roster_rebuilds,
            "slice_retries": self.slice_retries,
            "sentinel_trips": self.sentinel_trips,
            "quarantined": self.quarantined,
            "replays": self.replays,
            "certificates": self.certificates,
            "dispatch_seconds": self.dispatch_seconds,
            "recovery_seconds": self.recovery_seconds,
            "slice_seconds": self.slice_seconds,
            "certificate_seconds": self.certificate_seconds,
            "latency_p50_ms": ms(self._pct(lat, 50)),
            "latency_p99_ms": ms(self._pct(lat, 99)),
            "queue_delay_p50_ms": ms(self._pct(self.queue_delays_s, 50)),
            "mean_occupancy": (float(np.mean(self.occupancy))
                               if self.occupancy else None),
            "throughput_rps": (self.completed / window
                               if window else None),
        }


# ---------------------------------------------------------------------------
class _Breaker:
    """Per-lane circuit breaker over slice health.

    - **closed**: packed-roster slices; ``threshold`` consecutive faulty
      slices (a runner exception or a sentinel trip anywhere in the
      roster) open it.
    - **open**: every active slot advances solo (B = 1 slices, equal
      results, only batching lost); after ``cooldown`` solo rounds it
      half-opens.
    - **half-open**: the next dispatch is one packed *probe*; a clean
      probe closes the breaker, a faulty one reopens it.
    """

    def __init__(self, threshold: int = 3, cooldown: int = 4):
        if threshold < 1 or cooldown < 1:
            raise ValueError("breaker threshold and cooldown must be >= 1")
        self.threshold = int(threshold)
        self.cooldown = int(cooldown)
        self.state = "closed"
        self.failures = 0
        self._cool = 0

    def route(self) -> str:
        """How the next dispatch runs: "packed", "solo" or "probe"."""
        if self.state == "open":
            return "solo"
        if self.state == "half_open":
            return "probe"
        return "packed"

    def tick(self, stats: GatewayStats) -> None:
        """One solo-degraded round elapsed while open."""
        self._cool -= 1
        if self._cool <= 0:
            self.state = "half_open"

    def record_fault(self, stats: GatewayStats) -> None:
        self.failures += 1
        if (self.state == "half_open"
                or (self.state == "closed"
                    and self.failures >= self.threshold)):
            self.state = "open"
            self._cool = self.cooldown
            self.failures = 0
            stats.breaker_opens += 1

    def record_clean(self, stats: GatewayStats) -> None:
        if self.state == "half_open":
            self.state = "closed"
            stats.breaker_closes += 1
        self.failures = 0


# ---------------------------------------------------------------------------
class _Lane:
    """One (program, config, knobs, bucket) service class.

    ``roster`` is the ordered tuple of graphs the packed batch is built
    from.  A slot whose ticket retired stays in the roster as a parked
    placeholder (its rows frozen by the slice's done mask), so the
    pack, context and captured graph survive request churn; only a
    *membership* change (a new graph claiming a slot, or the roster
    growing toward ``max_batch``) rebuilds them.
    """

    def __init__(self, program: VertexProgram, config: SystemConfig,
                 use_kernels: bool, cap: Optional[int], autotune,
                 device: torch.device, journal=None,
                 breaker: Optional[_Breaker] = None):
        self.program = program
        self.config = config
        self.use_kernels = use_kernels
        self.cap = cap
        self.autotune = autotune
        self.device = device
        self.journal = journal
        self.breaker = breaker if breaker is not None else _Breaker()
        self.queue: deque = deque()
        self.roster: List[Graph] = []
        self.tickets: List[Optional[Ticket]] = []
        self.states: List[Any] = []
        self.it_b: List[int] = []
        self.limit_b: List[int] = []
        self.batch = None
        self.bctx = None

    def _context(self, batch) -> BatchedEdgeContext:
        return BatchedEdgeContext.create(
            batch, self.config, use_kernels=self.use_kernels,
            sparse_edge_capacity=self.cap, autotune=self.autotune,
            device=self.device)

    # -- admission ------------------------------------------------------
    def _claim_slot(self, graph: Graph, max_batch: int) -> Optional[int]:
        free = [i for i, t in enumerate(self.tickets) if t is None]
        for i in free:  # cache-warm: same graph already in the roster
            if self.roster[i] is graph:
                return i
        if free:
            self.roster[free[0]] = graph
            return free[0]
        if len(self.roster) < max_batch:
            self.roster.append(graph)
            self.tickets.append(None)
            self.states.append(None)
            self.it_b.append(0)
            self.limit_b.append(0)
            return len(self.roster) - 1
        return None

    def admit(self, max_batch: int, clock, stats: GatewayStats) -> bool:
        """Drain waiting tickets into free roster slots; True when at
        least one ticket was admitted this round."""
        before = tuple(id(g) for g in self.roster)
        admitted = False
        while self.queue:
            t = self.queue[0]
            if t.cancelled:
                self.queue.popleft()
                t._finish(None, CancelledError(f"request {t.id} cancelled "
                                               "while queued"), clock())
                stats.record_done(t, "cancelled")
                if self.journal is not None and t.jid is not None:
                    self.journal.record_retire(t.jid, "cancelled")
                continue
            slot = self._claim_slot(t.graph, max_batch)
            if slot is None:
                break
            self.queue.popleft()
            self.tickets[slot] = t
            if t._restore is not None:
                # journal recovery: state, iteration counter and
                # cumulative traces come from the ticket's newest
                # persisted slice boundary
                st, it0, meta = t._restore
                self.states[slot] = st
                self.it_b[slot] = int(it0)
                t._dispatches = int(meta.get("dispatches", 0))
                if meta.get("trace") is not None:
                    t._traced = True
                    t._trace = list(meta["trace"])
                if meta.get("occs") is not None:
                    t._occ_traced = True
                    t._occs = list(meta["occs"])
                t._restore = None
            elif t.key is None:
                # a default-key init depends on the graph alone, so
                # repeat traffic reuses it (read-only: packing copies it)
                self.states[slot] = PLAN_CACHE.get(
                    t.graph, "init_state", (id(self.program),),
                    lambda: _host_state(self.program.init(t.graph)))
                self.it_b[slot] = 0
            else:
                self.states[slot] = _host_state(
                    self.program.init(t.graph, t.key))
                self.it_b[slot] = 0
            self.limit_b[slot] = int(t.max_iters if t.max_iters is not None
                                     else self.program.max_iters)
            t.admitted_at = clock()
            stats.admitted += 1
            admitted = True
            if self.journal is not None and t.jid is not None:
                self.journal.record_admit(t.jid)
        if tuple(id(g) for g in self.roster) != before:
            self.batch = get_graph_batch(tuple(self.roster))
            self.bctx = self._context(self.batch)
            stats.roster_rebuilds += 1
        return admitted

    # -- execution ------------------------------------------------------
    def dispatch(self, slice_len: int, clock, stats: GatewayStats,
                 retry: Optional[RetryPolicy] = None,
                 sentinels: bool = True, injector=None) -> bool:
        """One slice over the roster; retires finished requests at the
        slice boundary.  True when work was done.

        The pre-slice host states are the rollback point and the
        sentinels' baseline: a failed slice is retried whole under
        ``retry``, then slot by slot in B = 1 batches, and only a slot
        that still fails is quarantined.  The breaker routes every slot
        solo while open, until a half-open packed probe is clean.
        """
        active = [i for i, t in enumerate(self.tickets) if t is not None]
        if not active:
            return False
        now = clock()
        for i in active:
            if self.tickets[i].first_dispatch_at is None:
                self.tickets[i].first_dispatch_at = now
        prev = {i: self.states[i] for i in active}
        route = self.breaker.route()
        if route == "solo":
            stats.solo_degraded_slices += 1
            for i in active:
                self._solo_advance(i, prev[i], slice_len, clock, stats,
                                   sentinels, injector)
            self.breaker.tick(stats)
            return True
        if route == "probe":
            stats.breaker_probes += 1
        trips_before = stats.sentinel_trips
        t0 = time.perf_counter()
        try:
            if injector is not None:
                injector.before_slice([self.tickets[i].id for i in active])
            sl = self._run_slice(slice_len)
        except KernelBuildError:
            raise
        except Exception:  # noqa: BLE001 — containment is the point
            self.breaker.record_fault(stats)
            self._recover(active, prev, slice_len, clock, stats, retry,
                          sentinels, injector)
            return True
        self._commit_slice(active, prev, sl, t0, clock, stats, sentinels,
                           injector)
        if stats.sentinel_trips > trips_before:
            self.breaker.record_fault(stats)
        else:
            self.breaker.record_clean(stats)
        return True

    def _run_slice(self, slice_len: int):
        parked = np.asarray([t is None for t in self.tickets])
        packed = self.batch.pack_state_host(self.states,
                                            pad=self.program.state_pad)
        packed = {k: torch.from_numpy(v).to(self.device)
                  for k, v in packed.items()}
        return run_batch_slice(
            self.program, self.batch, self.bctx, packed,
            np.asarray(self.it_b, np.int32), parked,
            np.asarray(self.limit_b, np.int32), slice_len)

    def _commit_slice(self, active: List[int], prev: Dict[int, Any], sl,
                      t0: float, clock, stats: GatewayStats,
                      sentinels: bool, injector) -> None:
        """Unpack a packed slice's states and commit every active slot;
        ``t0`` is when the slice began packing."""
        self.states = self.batch.unpack_state_host(sl.state)
        stats.record_slice(len(active), len(self.roster), sl.seconds,
                           sl.dispatches)
        now = clock()
        for i in active:
            self._commit_slot(i, i, sl, self.states[i], prev[i], now,
                              stats, sentinels, injector)
        stats.slice_seconds += time.perf_counter() - t0

    def _commit_slot(self, i: int, b: int, sl, st, prev, now: float,
                     stats: GatewayStats, sentinels: bool,
                     injector) -> None:
        """Commit roster slot ``i`` from row ``b`` of slice ``sl``, or
        quarantine it if a sentinel (or, at convergence, the program's
        certificate) rejects the new state."""
        t = self.tickets[i]
        if injector is not None:
            p = injector.perturb_slot(t.id, st)
            if p is not None:
                st = p
        if sentinels:
            tripped = check_state_host(self.program, prev, st)
            if tripped:
                stats.sentinel_trips += 1
                self.states[i] = prev  # keep the clean pre-slice state
                self._quarantine(i, now, ExecutionFault("sentinel", {
                    "ticket": t.id, "sentinels": tripped,
                    "iteration": int(sl.it_b[b])}), stats)
                return
        self.states[i] = st
        self.it_b[i] = int(sl.it_b[b])
        adv = int(sl.advanced[b])
        t._dispatches += 1
        if sl.dir_cols is not None:
            t._traced = True
            t._trace.extend("T" if x else "S"
                            for x in sl.dir_cols[b, :adv])
        if sl.occ_cols is not None:
            t._occ_traced = True
            t._occs.extend(float(o) for o in sl.occ_cols[b, :adv])
        if self.journal is not None and t.jid is not None:
            # durable slice boundary: sentinel-checked states only, so
            # recovery always resumes from a clean boundary
            self.journal.record_commit(
                t.jid, self.it_b[i], st, t._dispatches,
                "".join(t._trace) if t._traced else None,
                list(t._occs) if t._occ_traced else None)
        if t.cancelled:
            self._retire(i, now, "cancelled", stats)
        elif bool(sl.converged_b[b]):
            if sentinels and not self._certified(i, stats):
                stats.sentinel_trips += 1
                self._quarantine(i, now, ExecutionFault("certificate", {
                    "ticket": t.id, "iteration": self.it_b[i]}), stats)
            else:
                self._retire(i, now, "converged", stats)
        elif self.it_b[i] >= self.limit_b[i]:
            self._retire(i, now, "iteration_limit", stats)
        elif (t.deadline_s is not None
              and now >= t.enqueued_at + t.deadline_s):
            # deadlines fire at slice boundaries only: the request keeps
            # the state of its last completed slice
            self._retire(i, now, "timed_out", stats)

    def _certified(self, i: int, stats: GatewayStats) -> bool:
        """The program's fixpoint certificate on a converged slot, on the
        slot's own graph's (cached) context: the O(E) proof that catches
        dropped updates no boundary sentinel sees.  Vacuous without a
        certificate."""
        if self.program.certificate is None:
            return True
        t0 = time.perf_counter()
        ctx = EdgeContext.create(
            self.roster[i], self.config, use_kernels=self.use_kernels,
            sparse_edge_capacity=self.cap, autotune=self.autotune,
            device=self.device)
        ok = check_certificate(self.program, ctx, self.states[i])
        stats.certificates += 1
        stats.certificate_seconds += time.perf_counter() - t0
        return ok is not False

    def _recover(self, active: List[int], prev: Dict[int, Any],
                 slice_len: int, clock, stats: GatewayStats,
                 retry: Optional[RetryPolicy], sentinels: bool,
                 injector) -> None:
        """A slice raised before its states were committed: retry the
        roster whole (``retry.max_attempts`` tries in all), then advance
        each slot alone; a slot that fails even alone is quarantined."""
        t0 = time.perf_counter()
        stats.slice_retries += 1
        tries = (retry.max_attempts if retry is not None else 1) - 1
        for _ in range(tries):
            t_slice = time.perf_counter()
            try:
                if injector is not None:
                    injector.before_slice(
                        [self.tickets[i].id for i in active])
                sl = self._run_slice(slice_len)
            except KernelBuildError:
                raise
            except Exception:  # noqa: BLE001
                stats.slice_retries += 1
                continue
            self._commit_slice(active, prev, sl, t_slice, clock, stats,
                               sentinels, injector)
            stats.recovery_seconds += time.perf_counter() - t0
            return
        for i in active:
            self._solo_advance(i, prev[i], slice_len, clock, stats,
                               sentinels, injector)
        stats.recovery_seconds += time.perf_counter() - t0

    def _solo_advance(self, i: int, prev, slice_len: int, clock,
                      stats: GatewayStats, sentinels: bool,
                      injector) -> None:
        """Advance roster slot ``i`` alone in a B = 1 batch: the tail of
        slice recovery and of open-breaker routing.  Per-slot counters
        make it equal to the packed slice; a slot that fails even alone
        is quarantined."""
        t = self.tickets[i]
        t0 = time.perf_counter()
        try:
            if injector is not None:
                injector.before_slice([t.id])
            batch = get_graph_batch((self.roster[i],))
            packed = batch.pack_state_host(
                [self.states[i]], pad=self.program.state_pad)
            packed = {k: torch.from_numpy(v).to(self.device)
                      for k, v in packed.items()}
            sl = run_batch_slice(
                self.program, batch, self._context(batch), packed,
                np.asarray([self.it_b[i]], np.int32),
                np.asarray([False]),
                np.asarray([self.limit_b[i]], np.int32), slice_len)
        except KernelBuildError:
            raise
        except Exception as err:  # noqa: BLE001
            self._quarantine(i, clock(), ExecutionFault(
                "slice_exception",
                {"ticket": t.id, "error": repr(err)}), stats)
            return
        st = batch.unpack_state_host(sl.state)[0]
        stats.record_slice(1, 1, sl.seconds, sl.dispatches)
        self._commit_slot(i, 0, sl, st, prev, clock(), stats,
                          sentinels, injector)
        stats.slice_seconds += time.perf_counter() - t0

    def _retire(self, i: int, now: float, outcome: str,
                stats: GatewayStats) -> None:
        t = self.tickets[i]
        self.tickets[i] = None
        if outcome == "cancelled":
            t._finish(None, CancelledError(
                f"request {t.id} cancelled mid-flight"), now)
        else:
            t._finish(RunResult(
                state=self.states[i],
                iterations=self.it_b[i],
                seconds=now - t.enqueued_at,
                converged=(outcome == "converged"),
                direction_trace="".join(t._trace) if t._traced else None,
                occupancy_trace=t._occs if t._occ_traced else None,
                engine="gateway", dispatches=t._dispatches,
                timed_out=(outcome == "timed_out"),
                config_name=t.config.name,
                config_source=t.config_source), None, now)
        stats.record_done(t, outcome)
        if self.journal is not None and t.jid is not None:
            self.journal.record_retire(t.jid, outcome)

    def _quarantine(self, i: int, now: float, err: ExecutionFault,
                    stats: GatewayStats) -> None:
        """Terminal containment of one slot: free it (the roster keeps
        the parked placeholder, so the cohabitants' plans survive) and
        surface the structured fault on the ticket."""
        t = self.tickets[i]
        self.tickets[i] = None
        t._finish(None, err, now)
        stats.quarantined += 1
        stats.record_done(t, "faulted")
        if self.journal is not None and t.jid is not None:
            self.journal.record_retire(t.jid, "faulted")

    def pending(self) -> bool:
        return bool(self.queue) or any(t is not None for t in self.tickets)


# ---------------------------------------------------------------------------
class ContinuousScheduler:
    """The gateway's deterministic core: no threads, no clock beyond the
    injectable ``clock``.

    ``submit`` validates and enqueues; each ``poll()`` is one scheduling
    round: admit waiting requests into every lane, then advance every
    lane with active work by one slice.  Tests drive this class
    directly; :class:`GraphGateway` runs it on a worker thread.
    ``device`` defaults to CUDA and raises ``RuntimeError`` without it.
    """

    def __init__(self, max_batch: int = 8, slice_len: int = 4,
                 max_queue: int = 256, clock=time.monotonic,
                 retry: Optional[RetryPolicy] = RetryPolicy(max_attempts=2),
                 sentinels: bool = True, fault_injector=None,
                 journal_dir=None, breaker_threshold: int = 3,
                 breaker_cooldown: int = 4, device=None):
        if max_batch < 1 or slice_len < 1 or max_queue < 1:
            raise ValueError("max_batch, slice_len and max_queue must "
                             "be >= 1")
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.slice_len = int(slice_len)
        self.max_queue = int(max_queue)
        self.clock = clock
        self.retry = retry
        self.sentinels = bool(sentinels)
        self.fault_injector = fault_injector
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown = int(breaker_cooldown)
        self.journal = None
        if journal_dir is not None:
            from repro_torch.launch.journal import WriteAheadJournal
            self.journal = WriteAheadJournal(journal_dir)
        self.stats = GatewayStats()
        self._lanes: Dict[tuple, _Lane] = {}

    def queued(self) -> int:
        return sum(len(lane.queue) for lane in self._lanes.values())

    def _lane(self, program, config, use_kernels, cap, mode,
              graph) -> _Lane:
        key = (id(program), config, bool(use_kernels), cap, mode,
               bucket_key(graph))
        lane = self._lanes.get(key)
        if lane is None:
            lane = self._lanes[key] = _Lane(
                program, config, bool(use_kernels), cap, mode, self.device,
                journal=self.journal,
                breaker=_Breaker(self.breaker_threshold,
                                 self.breaker_cooldown))
        return lane

    def submit(self, program: VertexProgram, graph: Graph,
               config: SystemConfig, *, key=None,
               max_iters: Optional[int] = None,
               deadline_s: Optional[float] = None,
               use_kernels: bool = False,
               sparse_edge_capacity: Optional[int] = None,
               autotune=None, specialize=None) -> Ticket:
        """Admit one query; returns its :class:`Ticket`.

        Raises :class:`AdmissionError` for a structurally invalid graph,
        :class:`GatewayBackpressure` when the queue is full and
        :class:`OverloadError` for a deadline the projected delay already
        exceeds, all before the request touches a lane.  ``key`` is a
        ``torch.Generator`` for programs with random init.
        ``specialize`` ("off", "static", "learned") resolves the config at
        admission through
        :func:`~repro_torch.core.specialize_learned.resolve_config`, after
        the admission checks; the resolved config picks the lane, is
        journaled, and is stamped on the result.
        """
        errors = validate_graph(graph)
        if errors:
            self.stats.rejected += 1
            raise AdmissionError("invalid_graph", errors)
        if self.queued() >= self.max_queue:
            self.stats.backpressure_rejections += 1
            raise GatewayBackpressure(
                f"{self.queued()} requests already queued "
                f"(max_queue={self.max_queue})")
        if deadline_s is not None:
            delay = self.stats.projected_delay_s(self.queued(),
                                                 self.max_batch)
            if delay is not None and delay > deadline_s:
                self.stats.shed += 1
                raise OverloadError("overload_shed", {
                    "projected_delay_s": delay,
                    "deadline_s": float(deadline_s),
                    "queued": self.queued(),
                    "max_batch": self.max_batch})
        cap = (None if sparse_edge_capacity is None
               else int(sparse_edge_capacity))
        mode = _normalize_autotune(autotune)
        config_source = "caller"
        if specialize not in (None, False, "off"):
            from repro_torch.core.specialize_learned import resolve_config
            config, config_source = resolve_config(program, graph, config,
                                                   specialize)
            if config_source != "caller":
                self.stats.specialized += 1
        lane = self._lane(program, config, use_kernels, cap, mode, graph)
        t = Ticket(program, graph, config, key, max_iters, deadline_s)
        t.config_source = config_source
        t.enqueued_at = self.clock()
        if self.journal is not None:
            # the resolved config is journaled, so recovery replays the
            # decision without the model file; the knob names are the
            # reference's
            t.jid = self.journal.record_submit(
                program, graph, config, key=key, max_iters=max_iters,
                deadline_s=deadline_s,
                knobs={"use_pallas": bool(use_kernels),
                       "sparse_edge_capacity": cap, "autotune": mode,
                       "config_source": config_source})
        lane.queue.append(t)
        self.stats.record_submit(t)
        return t

    def recover(self, journal_dir) -> List[Ticket]:
        """Replay a write-ahead journal and re-admit every unfinished
        ticket; returns the recovered tickets in submit order.

        Each resumes from its newest intact persisted slice boundary (at
        iteration 0 when none survives), its graph rebuilt bit for bit
        from the journal's graph store, so driving the scheduler to idle
        gives results equal to the uninterrupted gateway's.  Replay
        appends nothing (recovering twice is idempotent); ``deadline_s``
        clocks restart now.  Later activity journals to ``journal_dir``.
        Tickets already live in this scheduler are never re-admitted.
        """
        from repro_torch.algorithms import REGISTRY
        from repro_torch.core.durability import _deserialize_key
        from repro_torch.launch.journal import WriteAheadJournal
        self.journal = WriteAheadJournal(journal_dir)
        for lane in self._lanes.values():
            lane.journal = self.journal
        live_jids = {t.jid for lane in self._lanes.values()
                     for t in [*lane.queue, *lane.tickets]
                     if t is not None and t.jid is not None}
        programs: Dict[str, VertexProgram] = {}
        recovered: List[Ticket] = []
        for jid, rec in self.journal.unfinished().items():
            if jid in live_jids:
                continue
            sub = rec["submit"]
            program = programs.setdefault(sub["program"],
                                          REGISTRY[sub["program"]]())
            graph = self.journal.load_graph(sub["graph"])
            config = SystemConfig.from_name(sub["config"])
            knobs = sub["knobs"]
            t = Ticket(program, graph, config,
                       _deserialize_key(sub["key"]), sub["max_iters"],
                       sub["deadline_s"])
            t.config_source = knobs.get("config_source", "caller")
            t.jid = jid
            t.enqueued_at = self.clock()
            cp, _ckpt_faults = self.journal.store_for(jid).load_latest()
            if cp is not None:
                meta = next((c for c in reversed(rec["commits"])
                             if c["it"] == cp.it), {})
                t._restore = (cp.state, cp.it, meta)
            lane = self._lane(program, config, knobs["use_pallas"],
                              knobs["sparse_edge_capacity"],
                              knobs["autotune"], graph)
            lane.queue.append(t)
            self.stats.record_submit(t)
            self.stats.recovered_tickets += 1
            recovered.append(t)
        return recovered

    def poll(self) -> int:
        """One scheduling round; returns how many slices dispatched."""
        for lane in self._lanes.values():
            lane.admit(self.max_batch, self.clock, self.stats)
        return sum(lane.dispatch(self.slice_len, self.clock, self.stats,
                                 retry=self.retry, sentinels=self.sentinels,
                                 injector=self.fault_injector)
                   for lane in self._lanes.values())

    def pending(self) -> bool:
        return any(lane.pending() for lane in self._lanes.values())

    def reset_stats(self) -> GatewayStats:
        """Swap in a fresh :class:`GatewayStats` (returns the old one);
        lanes, rosters and captured graphs stay warm."""
        old, self.stats = self.stats, GatewayStats()
        return old

    def run_until_idle(self, max_rounds: int = 1_000_000) -> None:
        for _ in range(max_rounds):
            if not self.pending():
                return
            self.poll()
        raise RuntimeError(f"gateway not idle after {max_rounds} rounds")


# ---------------------------------------------------------------------------
class GraphGateway:
    """Threaded front end over :class:`ContinuousScheduler`.

    ``submit`` is safe from any thread and returns a :class:`Ticket` at
    once; one worker thread runs scheduling rounds while work is pending
    and does every piece of device work (it sets the scheduler's device
    first).  Use as a context manager or call ``start()``/``close()``;
    ``drain()`` blocks until every accepted request is terminal.  On the
    card, the worker's warm-ups, captures and certificates set the
    process-wide sync-debug mode to "error": another thread that makes a
    synchronizing CUDA call meanwhile raises, so callers keep to the host
    arrays the API hands out while the gateway runs.
    """

    def __init__(self, max_batch: int = 8, slice_len: int = 4,
                 max_queue: int = 256, clock=time.monotonic,
                 retry: Optional[RetryPolicy] = RetryPolicy(max_attempts=2),
                 sentinels: bool = True, fault_injector=None,
                 journal_dir=None, breaker_threshold: int = 3,
                 breaker_cooldown: int = 4, device=None):
        self._sched = ContinuousScheduler(
            max_batch=max_batch, slice_len=slice_len, max_queue=max_queue,
            clock=clock, retry=retry, sentinels=sentinels,
            fault_injector=fault_injector, journal_dir=journal_dir,
            breaker_threshold=breaker_threshold,
            breaker_cooldown=breaker_cooldown, device=device)
        self._wake = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> "GraphGateway":
        if self._thread is None:
            self._stop = False
            self._thread = threading.Thread(target=self._loop,
                                            name="graph-gateway",
                                            daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Finish in-flight work, then stop the worker thread."""
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "GraphGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- API ------------------------------------------------------------
    def submit(self, program: VertexProgram, graph: Graph,
               config: SystemConfig, **kw) -> Ticket:
        with self._wake:
            if self._thread is None or self._stop:
                raise RuntimeError("gateway is not running "
                                   "(use `with GraphGateway() as gw`)")
            t = self._sched.submit(program, graph, config, **kw)
            t._on_cancel = self._kick
            self._wake.notify_all()
            return t

    def recover(self, journal_dir) -> List[Ticket]:
        """Replay ``journal_dir``'s journal and re-admit every unfinished
        ticket (:meth:`ContinuousScheduler.recover`); wakes the worker."""
        with self._wake:
            tickets = self._sched.recover(journal_dir)
            for t in tickets:
                t._on_cancel = self._kick
            self._wake.notify_all()
            return tickets

    def stats(self) -> Dict[str, Any]:
        with self._wake:
            return self._sched.stats.snapshot()

    def reset_stats(self) -> None:
        with self._wake:
            self._sched.reset_stats()

    def drain(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._wake:
                if not self._sched.pending():
                    return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError("gateway still busy after drain timeout")
            time.sleep(1e-4)

    def _kick(self) -> None:
        with self._wake:
            self._wake.notify_all()

    def _loop(self) -> None:
        if self._sched.device.type == "cuda":
            torch.cuda.set_device(self._sched.device)
        while True:
            with self._wake:
                while not self._stop and not self._sched.pending():
                    self._wake.wait(timeout=0.05)
                if self._stop and not self._sched.pending():
                    return
                self._sched.poll()


# ---------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a == "--arch" or a.startswith("--arch=") for a in argv):
        warnings.warn(
            "the LM serving demo moved to repro_torch.launch.lm_demo; "
            "`python -m repro_torch.launch.serve --arch ...` forwards there "
            "and will be removed", DeprecationWarning, stacklevel=2)
        from repro_torch.launch import lm_demo
        return lm_demo.main(argv)

    ap = argparse.ArgumentParser(
        description="streaming graph-serving gateway demo")
    ap.add_argument("--app", default="BFS")
    ap.add_argument("--config", default="DG1")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--pool", type=int, default=6,
                    help="distinct graphs cycled through the stream")
    ap.add_argument("--scale", type=int, default=5,
                    help="R-MAT scale of the pool graphs")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--slice-len", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from repro_torch.algorithms import REGISTRY
    from repro_torch.graph import rmat_batch

    prog = REGISTRY[args.app]()
    config = SystemConfig.from_name(args.config)
    pool = rmat_batch(args.pool, args.scale, seed=7,
                      weighted=prog.weighted)
    with GraphGateway(max_batch=args.max_batch, slice_len=args.slice_len,
                      device=args.device) as gw:
        tickets = [gw.submit(prog, pool[i % len(pool)], config)
                   for i in range(args.requests)]
        results = [t.result(timeout=600) for t in tickets]
        snap = gw.stats()
    print(f"{args.app}/{args.config}: {len(results)} requests, "
          f"{snap['slices']} slices, {snap['replays']} replays, "
          f"{snap['roster_rebuilds']} roster rebuilds")
    print(f"p50 {snap['latency_p50_ms']:.1f} ms  "
          f"p99 {snap['latency_p99_ms']:.1f} ms  "
          f"throughput {snap['throughput_rps']:.1f} req/s  "
          f"occupancy {snap['mean_occupancy']:.2f}")


if __name__ == "__main__":
    main()
