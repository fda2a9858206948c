"""The port's gateway under overload (``tests/test_overload.py``'s
contracts), on the CPU: deadline-aware shedding from the service-time
projection, the per-lane circuit breaker (open -> solo-degraded ->
half-open probe -> closed, results equal throughout, its counters equal
to the reference's scheduler on the same graphs), and the race of
``cancel()`` against retirement.
"""
import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.launch.serve as jserve
import repro.testing.faults as jfaults
from repro.graph import rmat_graph as j_rmat
from repro_torch.algorithms import REGISTRY
from repro_torch.core import SystemConfig
from repro_torch.graph import rmat_graph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.launch import serve
from repro_torch.launch.serve import (CancelledError, ContinuousScheduler,
                                      GatewayStats, OverloadError, Ticket,
                                      _Breaker)
from repro_torch.testing.faults import InjectedFault, SliceFaultInjector

CPU = "cpu"
CFG = SystemConfig.from_name("DG1")


def _graph(seed=3):
    return rmat_graph(scale=6, edge_factor=8, seed=seed, weighted=False)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states_equal(a, b):
    return set(a) == set(b) and all(
        np.array_equal(_host(a[k]), _host(b[k])) for k in a)


def _packed_only(base):
    """A fault of packed-roster slices only (B = 1 slices succeed): the
    cohabitation failure the breaker routes around, for either
    package's injector base and exception."""
    injected = InjectedFault if base is SliceFaultInjector \
        else jfaults.InjectedFault

    class PackedOnlyFault(base):
        def __init__(self, times=None):
            self.times = times
            self.fired = 0

        def before_slice(self, ticket_ids):
            if len(ticket_ids) < 2:
                return
            if self.times is not None and self.fired >= self.times:
                return
            self.fired += 1
            raise injected(f"packed cohabitation failure "
                           f"(tickets={ticket_ids})")
    return PackedOnlyFault


PackedOnlyFault = _packed_only(SliceFaultInjector)


# ---------------------------------------------------------------------------
class TestShedding:
    def _loaded(self, service_times=(1.0, 1.0)):
        sched = ContinuousScheduler(max_batch=2, slice_len=2, device=CPU)
        sched.stats.service_times_s.extend(service_times)
        return sched, REGISTRY["BFS"](), CFG, _graph()

    def test_hopeless_deadline_is_shed(self):
        sched, program, config, g = self._loaded()
        for _ in range(4):
            sched.submit(program, g, config)
        with pytest.raises(OverloadError) as ei:
            sched.submit(program, g, config, deadline_s=0.5)
        assert ei.value.code == "overload_shed"
        assert ei.value.detail["projected_delay_s"] > 0.5
        assert ei.value.detail["queued"] == 4
        assert sched.stats.shed == 1
        assert sched.stats.snapshot()["shed"] == 1

    def test_feasible_deadline_is_admitted(self):
        sched, program, config, g = self._loaded()
        for _ in range(4):
            sched.submit(program, g, config)
        t = sched.submit(program, g, config, deadline_s=100.0)
        assert t is not None and sched.stats.shed == 0

    def test_no_deadline_never_shed(self):
        sched, program, config, g = self._loaded(service_times=(50.0,))
        for _ in range(8):
            sched.submit(program, g, config)
        assert sched.stats.shed == 0

    def test_cold_gateway_never_sheds(self):
        sched = ContinuousScheduler(max_batch=2, slice_len=2, device=CPU)
        program, g = REGISTRY["BFS"](), _graph()
        for _ in range(6):
            sched.submit(program, g, CFG, deadline_s=1e-9)
        assert sched.stats.shed == 0

    def test_projection_math(self):
        s = GatewayStats()
        assert s.projected_delay_s(0, 4) is None
        s.service_times_s.extend([2.0, 4.0])
        assert s.projected_delay_s(0, 4) == 3.0
        assert s.projected_delay_s(7, 4) == 6.0
        assert s.projected_delay_s(8, 4) == 9.0

    def test_projection_ignores_queue_wait(self):
        s = GatewayStats()
        t = Ticket(None, None, None, None, None, None)
        t.enqueued_at, t.admitted_at = 0.0, 99.0
        t.completed_at = 100.0
        s.record_done(t, "converged")
        assert s.latencies_s == [100.0]
        assert s.projected_delay_s(0, 4) == 1.0

    def test_service_window_is_bounded(self):
        s = GatewayStats()
        n = GatewayStats.SERVICE_WINDOW + 8
        assert GatewayStats.SERVICE_WINDOW == \
            jserve.GatewayStats.SERVICE_WINDOW
        for i in range(n):
            t = Ticket(None, None, None, None, None, None)
            t.enqueued_at = t.admitted_at = float(i)
            t.completed_at = float(i) + (100.0 if i < 8 else 1.0)
            s.record_done(t, "converged")
        assert len(s.service_times_s) == GatewayStats.SERVICE_WINDOW
        assert len(s.latencies_s) == n
        assert s.projected_delay_s(0, 4) == 1.0

    def test_post_congestion_queue_drained_admits_again(self):
        sched, program, config, g = self._loaded(service_times=(0.1,))
        sched.stats.latencies_s.extend([50.0] * 8)
        assert sched.queued() == 0
        t = sched.submit(program, g, config, deadline_s=1.0)
        assert t is not None and sched.stats.shed == 0

    def test_shed_request_leaves_no_lane_state(self):
        sched, program, config, g = self._loaded()
        for _ in range(4):
            sched.submit(program, g, config)
        queued_before = sched.queued()
        with pytest.raises(OverloadError):
            sched.submit(program, g, config, deadline_s=1e-9)
        assert sched.queued() == queued_before
        sched.run_until_idle()
        assert sched.stats.converged == 4


# ---------------------------------------------------------------------------
class TestBreakerUnit:
    def test_state_machine_walk(self):
        stats = GatewayStats()
        b = _Breaker(threshold=2, cooldown=2)
        assert b.route() == "packed"
        b.record_fault(stats)
        assert b.state == "closed"
        b.record_fault(stats)
        assert b.state == "open" and b.route() == "solo"
        assert stats.breaker_opens == 1
        b.tick(stats)
        assert b.route() == "solo"
        b.tick(stats)
        assert b.state == "half_open" and b.route() == "probe"
        b.record_clean(stats)
        assert b.state == "closed" and stats.breaker_closes == 1

    def test_faulty_probe_reopens(self):
        stats = GatewayStats()
        b = _Breaker(threshold=1, cooldown=1)
        b.record_fault(stats)
        b.tick(stats)
        assert b.state == "half_open"
        b.record_fault(stats)
        assert b.state == "open" and stats.breaker_opens == 2

    def test_clean_slice_resets_consecutive_count(self):
        stats = GatewayStats()
        b = _Breaker(threshold=2, cooldown=2)
        b.record_fault(stats)
        b.record_clean(stats)
        b.record_fault(stats)
        assert b.state == "closed"

    def test_rejects_degenerate_params(self):
        with pytest.raises(ValueError):
            _Breaker(threshold=0)
        with pytest.raises(ValueError):
            _Breaker(cooldown=0)


BREAKER_COUNTERS = ("breaker_opens", "breaker_closes", "breaker_probes",
                    "solo_degraded_slices", "slices", "slice_retries",
                    "quarantined", "converged")


def _breaker_run(mod, graphs, times, cooldown):
    """SSSP with one-iteration slices (work left for the solo rounds and
    the probe) under a packed-only fault."""
    if mod is serve:
        program, config, fault = REGISTRY["SSSP"](), CFG, PackedOnlyFault
        kw = {"device": CPU}
    else:
        program = japps.REGISTRY["SSSP"]()
        config = jcore.SystemConfig.from_name("DG1")
        fault, kw = _packed_only(jfaults.SliceFaultInjector), {}
    sched = mod.ContinuousScheduler(
        max_batch=4, slice_len=1, breaker_threshold=2,
        breaker_cooldown=cooldown, fault_injector=fault(times=times), **kw)
    tickets = [sched.submit(program, g, config) for g in graphs]
    sched.run_until_idle()
    return tickets, sched.stats


def _sssp_pool():
    return [rmat_graph(scale=7, edge_factor=8, seed=s, weighted=True)
            for s in (3, 4, 5, 6)]


class TestBreakerIntegration:
    def test_packed_fault_opens_breaker_and_degrades_solo(self):
        graphs = _sssp_pool()
        clean = ContinuousScheduler(max_batch=4, slice_len=1, device=CPU)
        ref = [clean.submit(REGISTRY["SSSP"](), g, CFG) for g in graphs]
        clean.run_until_idle()
        tickets, s = _breaker_run(serve, graphs, None, 2)
        assert s.breaker_opens >= 1
        assert s.solo_degraded_slices > 0
        assert s.quarantined == 0
        for rt, t in zip(ref, tickets):
            assert t.result(0).converged
            assert _states_equal(rt.result(0).state, t.result(0).state)

    def test_breaker_closes_after_fault_clears(self):
        tickets, s = _breaker_run(serve, _sssp_pool(), 3, 1)
        assert s.breaker_opens == 1
        assert s.breaker_probes >= 1
        assert s.breaker_closes == 1
        assert all(t.result(0).converged for t in tickets)

    def test_breaker_walk_equals_the_reference(self):
        """The same packed-only fault through both schedulers: the same
        opens, probes, closes, solo rounds and slices, and equal
        results."""
        ref_graphs = [j_rmat(scale=7, edge_factor=8, seed=s, weighted=True)
                      for s in (3, 4, 5, 6)]
        port_graphs = [graph_from_arrays(
            {f: np.asarray(getattr(g, f)) for f in ARRAY_FIELDS},
            g.n_nodes, g.n_edges, g.block_size) for g in ref_graphs]
        ref_t, ref_s = _breaker_run(jserve, ref_graphs, 3, 1)
        port_t, port_s = _breaker_run(serve, port_graphs, 3, 1)
        for k in BREAKER_COUNTERS:
            assert getattr(port_s, k) == getattr(ref_s, k), k
        for rt, pt in zip(ref_t, port_t):
            assert pt.result(0).iterations == rt.result(0).iterations
            assert _states_equal(pt.result(0).state, rt.result(0).state)

    def test_breaker_counters_in_snapshot(self):
        snap = ContinuousScheduler(device=CPU).stats.snapshot()
        for key in ("breaker_opens", "breaker_closes", "breaker_probes",
                    "solo_degraded_slices", "shed", "recovered_tickets"):
            assert snap[key] == 0


# ---------------------------------------------------------------------------
class TestCancelRetirementRace:
    def test_cancel_racing_retirement_property(self, monkeypatch):
        """Seeded interleavings of ``cancel()`` against retirement: every
        ticket finishes exactly once and ``result()`` never deadlocks."""
        finishes = {}
        orig = Ticket._finish

        def counting_finish(self, result, error, now):
            finishes[self.id] = finishes.get(self.id, 0) + 1
            orig(self, result, error, now)

        monkeypatch.setattr(Ticket, "_finish", counting_finish)
        program = REGISTRY["BFS"]()
        graphs = [_graph(seed=s) for s in (3, 4)]
        for seed in range(8):
            rng = np.random.default_rng(seed)
            finishes.clear()
            sched = ContinuousScheduler(max_batch=2, slice_len=1,
                                        device=CPU)
            tickets = [sched.submit(program, graphs[i % 2], CFG)
                       for i in range(4)]
            victim = tickets[int(rng.integers(len(tickets)))]
            cancel_at = int(rng.integers(12))
            for round_ in range(10_000):
                if round_ == cancel_at:
                    victim.cancel()
                    victim.cancel()
                if not sched.pending():
                    break
                sched.poll()
            if victim.cancelled and not victim.done():
                sched.poll()
            for t in tickets:
                assert t.done(), (seed, t.id)
                assert finishes[t.id] == 1, (seed, t.id)
                if t is victim and t.cancelled and t._error is not None:
                    with pytest.raises(CancelledError):
                        t.result(0)
                else:
                    assert t.result(0).converged
            s = sched.stats
            assert s.cancelled + s.completed == len(tickets)
