"""Seeded fault injectors for the resilience layer.

Counterpart of ``repro.testing.faults``.  Each injector subclasses
:class:`repro_torch.core.resilience.FaultInjector` and corrupts exactly
one thing, deterministically (a ``numpy`` Generator seeded per
instance, drawing on host snapshots exactly as the reference's do), at a
declared point of the run:

============  =========================================================
mode          what it does
============  =========================================================
``nan``       overwrites a slice of the largest float state leaf with
              NaN at a segment boundary (caught by the NaN sentinel)
``bitflip``   XORs bit 30 into a few entries of the largest non-bool
              state leaf (caught by range, frozen or monotone sentinels)
``stale``     reverts a random subset of vertices to their values at
              the last checkpoint (dropped updates: invisible to the
              boundary sentinels, caught by the certificate or absorbed
              by an attractive fixpoint)
``exception`` raises :class:`InjectedFault` before a segment
``overflow``  forces ``sparse_edge_capacity=1`` so every sparse gather
              overflows into the dense path (result-invariant)
``compile``   raises from the attempt's build step while the engine
              matches (recovery must degrade to another engine)
============  =========================================================

``once=True`` (the default of the state perturbations) fires a mode a
single time, so the re-execution after a rollback is clean.
:class:`ProcessKillFault` raises :class:`SimulatedProcessDeath`, a
``BaseException`` that no retry net catches.

Gateway-side injectors (``faults.py:264-334``: :class:`SliceExceptionFault`,
:class:`SliceNaNFault`, :class:`GatewayKillFault`) target the slices of a
continuous-batching lane (:mod:`repro_torch.launch.serve`): recovery must
quarantine only the offending slot, or come back from the journal.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core.resilience import FaultInjector

__all__ = ["InjectedFault", "SimulatedProcessDeath", "NaNFault",
           "BitFlipFault", "StaleUpdateFault", "RunnerExceptionFault",
           "SparseOverflowFault", "CompileFault", "ProcessKillFault",
           "SliceFaultInjector", "SliceExceptionFault", "SliceNaNFault",
           "GatewayKillFault", "FAULT_MODES", "make_fault"]


class InjectedFault(RuntimeError):
    """The exception every forced-failure injector raises — tests can
    distinguish injected crashes from genuine bugs."""


class SimulatedProcessDeath(BaseException):
    """A process boundary, not a fault: deliberately a ``BaseException``
    so it escapes *every* in-process recovery net (``run_resilient``'s
    retry loop and the gateway's slice containment both catch
    ``Exception`` only) exactly the way ``SIGKILL`` would.  The chaos
    harness and crash-recovery tests catch it one frame above the
    "process", then restart from durable state — anything the killed
    process would have needed to survive must already be on disk."""


def _copy_state(state):
    return {k: np.array(v, copy=True) for k, v in state.items()}


def _array_items(state, float_only=False, skip_bool=True):
    items = []
    for k in sorted(state):
        a = np.asarray(state[k])
        if skip_bool and a.dtype == np.bool_:
            continue
        if float_only and not np.issubdtype(a.dtype, np.floating):
            continue
        items.append((k, a))
    return items


class NaNFault(FaultInjector):
    """Overwrite ``fraction`` of the largest float state leaf with NaN
    at the first segment boundary at/after ``at_iteration``."""

    def __init__(self, at_iteration: int = 1, fraction: float = 0.05,
                 seed: int = 0, once: bool = True):
        self.at_iteration = at_iteration
        self.fraction = fraction
        self.once = once
        self._rng = np.random.default_rng(seed)
        self.fired = 0

    def perturb(self, it, state, checkpoint_state):
        if it < self.at_iteration or (self.once and self.fired):
            return None
        floats = _array_items(state, float_only=True)
        if not floats:
            return None
        key, _ = max(floats, key=lambda kv: kv[1].size)
        out = _copy_state(state)
        a = out[key].reshape(-1)
        k = max(1, int(a.size * self.fraction))
        idx = self._rng.choice(a.size, size=min(k, a.size), replace=False)
        a[idx] = np.nan
        self.fired += 1
        return out


class BitFlipFault(FaultInjector):
    """XOR bit 30 into ``n_flips`` random entries of the largest
    non-bool state leaf — a corrupted store, not a plausible value."""

    def __init__(self, at_iteration: int = 1, n_flips: int = 3,
                 seed: int = 0, once: bool = True):
        self.at_iteration = at_iteration
        self.n_flips = n_flips
        self.once = once
        self._rng = np.random.default_rng(seed)
        self.fired = 0

    def perturb(self, it, state, checkpoint_state):
        if it < self.at_iteration or (self.once and self.fired):
            return None
        arrays = _array_items(state)
        if not arrays:
            return None
        key, _ = max(arrays, key=lambda kv: kv[1].size)
        out = _copy_state(state)
        a = out[key].reshape(-1)
        idx = self._rng.choice(a.size, size=min(self.n_flips, a.size),
                               replace=False)
        bits = a[idx].view(np.uint32 if a.dtype.itemsize == 4
                           else np.uint64)
        a[idx] = (bits ^ np.array(1 << 30, bits.dtype)).view(a.dtype)
        self.fired += 1
        return out


class StaleUpdateFault(FaultInjector):
    """Revert ``fraction`` of the vertices to their last-checkpoint
    values across every per-vertex leaf — the DRFrlx dropped-update
    hazard.  The reverted values equal the checkpoint's, so boundary
    sentinels structurally cannot see this; only the convergence
    certificate (or an attractive fixpoint re-absorbing it) can."""

    def __init__(self, at_iteration: int = 1, fraction: float = 0.25,
                 seed: int = 0, once: bool = True):
        self.at_iteration = at_iteration
        self.fraction = fraction
        self.once = once
        self._rng = np.random.default_rng(seed)
        self.fired = 0

    def perturb(self, it, state, checkpoint_state):
        if it < self.at_iteration or (self.once and self.fired):
            return None
        dims = [np.asarray(v).shape[0] for v in state.values()
                if np.asarray(v).ndim >= 1]
        if not dims:
            return None
        v = max(dims)
        rows = self._rng.choice(v, size=max(1, int(v * self.fraction)),
                                replace=False)
        out = _copy_state(state)
        for k in out:
            cur, old = out[k], np.asarray(checkpoint_state[k])
            if cur.ndim >= 1 and cur.shape[0] == v:
                cur[rows] = old[rows]
        self.fired += 1
        return out


class RunnerExceptionFault(FaultInjector):
    """Raise :class:`InjectedFault` before the segment dispatch at/after
    ``at_iteration`` (``times=None`` keeps failing every segment)."""

    def __init__(self, at_iteration: int = 0, times: Optional[int] = 1):
        self.at_iteration = at_iteration
        self.times = times
        self.fired = 0

    def before_segment(self, it):
        if it < self.at_iteration:
            return
        if self.times is not None and self.fired >= self.times:
            return
        self.fired += 1
        raise InjectedFault(f"injected runner exception at iteration {it}")


class SparseOverflowFault(FaultInjector):
    """Force a one-edge sparse gather capacity: every sparse iteration
    overflows and must take the dense fallback — results must be
    unchanged (the overflow path is the first rung of the degradation
    story and predates this PR)."""
    knob_overrides = {"sparse_edge_capacity": 1}


class CompileFault(FaultInjector):
    """Fail the attempt's build step while the engine matches
    ``engine`` — recovery must degrade to a different engine."""

    def __init__(self, engine: str = "fused"):
        self.engine = engine
        self.fired = 0

    def on_compile(self, knobs):
        if knobs.get("engine") == self.engine:
            self.fired += 1
            raise InjectedFault(
                f"injected compile failure for engine={self.engine!r}")


class ProcessKillFault(FaultInjector):
    """Kill the process at/after ``at_iteration`` by raising
    :class:`SimulatedProcessDeath` — the retry net cannot catch it, so
    everything in memory (the :class:`~repro_torch.core.resilience.
    CheckpointRing` included) is lost.  Only state already spilled
    through ``checkpoint_dir`` survives.

    ``point`` picks the worst moment: ``"segment_start"`` dies before a
    dispatch (the previous boundary is safely on disk — resume replays
    nothing), ``"after_segment"`` dies after a segment executed but
    *before* its boundary checkpoint was persisted — that segment's
    work is genuinely lost and must be replayed on resume (the chaos
    benchmark's lost-work measurement)."""

    def __init__(self, at_iteration: int = 1, times: Optional[int] = 1,
                 point: str = "segment_start"):
        if point not in ("segment_start", "after_segment"):
            raise ValueError(f"unknown kill point {point!r}")
        self.at_iteration = at_iteration
        self.times = times
        self.point = point
        self.fired = 0

    def _maybe_kill(self, it):
        if it < self.at_iteration:
            return
        if self.times is not None and self.fired >= self.times:
            return
        self.fired += 1
        raise SimulatedProcessDeath(
            f"simulated process death at iteration {it}")

    def before_segment(self, it):
        if self.point == "segment_start":
            self._maybe_kill(it)

    def perturb(self, it, state, checkpoint_state):
        if self.point == "after_segment":
            self._maybe_kill(it)
        return None


# ----------------------------------------------------------------------
# gateway-side (continuous-batching slice) injectors


class SliceFaultInjector(FaultInjector):
    """Marker base for injectors targeting gateway slices."""


class SliceExceptionFault(SliceFaultInjector):
    """Fail every slice dispatch whose roster holds ``ticket_id`` (the
    solo isolation retry included, so the slot can only be
    quarantined).  With ``ticket_id=None``, fail the first ``times``
    slice dispatches outright."""

    def __init__(self, ticket_id: Optional[int] = None,
                 times: Optional[int] = None):
        self.ticket_id = ticket_id
        self.times = times
        self.fired = 0

    def before_slice(self, ticket_ids: List[int]):
        if self.ticket_id is not None and self.ticket_id not in ticket_ids:
            return
        if self.times is not None and self.fired >= self.times:
            return
        self.fired += 1
        raise InjectedFault(
            f"injected slice failure (tickets={ticket_ids})")


class SliceNaNFault(SliceFaultInjector):
    """Corrupt one ticket's unpacked state with NaN after a slice: the
    per-slot sentinel must quarantine exactly that slot."""

    def __init__(self, ticket_id: int, once: bool = True):
        self.ticket_id = ticket_id
        self.once = once
        self.fired = 0

    def perturb_slot(self, ticket_id, state):
        if ticket_id != self.ticket_id or (self.once and self.fired):
            return None
        floats = _array_items(state, float_only=True)
        if not floats:
            return None
        key, _ = max(floats, key=lambda kv: kv[1].size)
        out = _copy_state(state)
        out[key].reshape(-1)[:1] = np.nan
        self.fired += 1
        return out


class GatewayKillFault(SliceFaultInjector):
    """Kill the gateway before its ``after_slices + 1``-th slice dispatch
    (counted across lanes) with :class:`SimulatedProcessDeath`: rosters,
    parked slots and queues die with it, and recovery must come from the
    write-ahead journal and the per-ticket checkpoint stores alone."""

    def __init__(self, after_slices: int = 2, times: Optional[int] = 1):
        self.after_slices = after_slices
        self.times = times
        self.fired = 0
        self._slices = 0

    def before_slice(self, ticket_ids: List[int]):
        self._slices += 1
        if self._slices <= self.after_slices:
            return
        if self.times is not None and self.fired >= self.times:
            return
        self.fired += 1
        raise SimulatedProcessDeath(
            f"simulated gateway death before slice {self._slices} "
            f"(tickets={ticket_ids})")


#: mode name -> injector factory (the fault-matrix test iterates this)
FAULT_MODES = {
    "nan": NaNFault,
    "bitflip": BitFlipFault,
    "stale": StaleUpdateFault,
    "exception": RunnerExceptionFault,
    "overflow": SparseOverflowFault,
    "compile": CompileFault,
}


def make_fault(mode: str, **kwargs) -> FaultInjector:
    """Instantiate one of :data:`FAULT_MODES` by name."""
    if mode not in FAULT_MODES:
        raise ValueError(f"unknown fault mode {mode!r}; "
                         f"expected one of {sorted(FAULT_MODES)}")
    return FAULT_MODES[mode](**kwargs)
