"""The port's gateway under bad inputs and mid-flight faults
(``tests/test_serve_faults.py``'s contracts), on the CPU.

Malformed graphs are rejected at admission with a structured
``AdmissionError`` and never reach an in-flight batch; cancellation
retires cleanly queued or mid-flight; a deadline returns the partial
state of the last completed slice, flagged ``timed_out``; a full queue
pushes back without losing accepted work.  A NaN or a runner exception
inside a packed slice quarantines only the offending slot while every
cohabitant finishes equal to its sequential ``run``; the same faults
through the reference's scheduler, on the same graphs, give the same
outcomes and the same ``GatewayStats`` counters.  A kernel that cannot
be built is raised, never contained.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.launch.serve as jserve
import repro.testing.faults as jfaults
from repro.graph import rmat_graph as j_rmat
from repro_torch.algorithms import REGISTRY
from repro_torch.core import SystemConfig, run
from repro_torch.core.resilience import ExecutionFault
from repro_torch.graph import grid_graph, rmat_graph
from repro_torch.graph.structure import (ARRAY_FIELDS, graph_from_arrays,
                                         validate_graph)
from repro_torch.kernels._build import KernelBuildError
from repro_torch.launch import serve
from repro_torch.launch.serve import (AdmissionError, CancelledError,
                                      ContinuousScheduler,
                                      GatewayBackpressure)
import repro_torch.testing.faults as tfaults

CFG = SystemConfig.from_name("DG1")
CPU = "cpu"


def _sched(**kw):
    return ContinuousScheduler(device=CPU, **kw)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(_host(a[k]), _host(b[k])), k


@pytest.fixture(scope="module")
def good_pair():
    """A same-bucket pair: a fault beside one must leave the other's
    in-batch result untouched."""
    return [rmat_graph(5, 8, seed=1, weighted=True),
            grid_graph(7, seed=0, weighted=True)]


def _corrupt(g, **field_edits):
    return dataclasses.replace(g, **field_edits)


def _neg_offsets(g):
    rp = np.asarray(g.row_ptr_out).copy()
    rp[1] = -3
    return _corrupt(g, row_ptr_out=rp)


def _dangling_edge(g):
    dst = np.asarray(g.dst).copy()
    dst[0] = g.n_nodes + 5
    return _corrupt(g, dst=dst)


def _nan_weights(g):
    w = np.asarray(g.weight).copy()
    w[::7] = np.nan
    return _corrupt(g, weight=w)


def _short_degree(g):
    return _corrupt(g, out_degree=np.asarray(g.out_degree)[:-1])


def _decreasing_offsets(g):
    rp = np.asarray(g.row_ptr_out).copy()
    rp[2] = rp[3] + 1
    return _corrupt(g, row_ptr_out=rp)


FAULTS = {"negative_offsets": _neg_offsets,
          "decreasing_offsets": _decreasing_offsets,
          "dangling_edge": _dangling_edge,
          "nan_weights": _nan_weights,
          "length_mismatch": _short_degree}


class TestAdmissionRejection:
    @pytest.mark.parametrize("fault", sorted(FAULTS))
    def test_malformed_graph_rejected_with_structured_error(
            self, good_pair, fault):
        bad = FAULTS[fault](good_pair[0])
        assert validate_graph(bad)
        sched = _sched()
        with pytest.raises(AdmissionError) as exc:
            sched.submit(REGISTRY["BFS"](), bad, CFG)
        assert exc.value.code == "invalid_graph"
        assert exc.value.errors
        assert sched.stats.rejected == 1
        assert sched.stats.submitted == 0
        assert not sched.pending()

    def test_valid_graph_passes_validator(self, good_pair):
        assert validate_graph(good_pair[0]) == []

    def test_negative_and_decreasing_offsets_reported_distinctly(
            self, good_pair):
        neg = validate_graph(_neg_offsets(good_pair[0]))
        assert any("negative offsets" in e for e in neg), neg
        dec = validate_graph(_decreasing_offsets(good_pair[0]))
        assert any("decrease at row 2" in e for e in dec), dec
        assert not any("negative offsets" in e for e in dec), dec

    def test_rejection_never_poisons_in_flight_batch(self, good_pair):
        prog = REGISTRY["BFS"]()
        seq = [run(prog, g, CFG, device=CPU) for g in good_pair]
        sched = _sched(max_batch=4, slice_len=2)
        tickets = [sched.submit(prog, g, CFG) for g in good_pair]
        sched.poll()
        for fault in FAULTS.values():
            with pytest.raises(AdmissionError):
                sched.submit(prog, fault(good_pair[0]), CFG)
        sched.run_until_idle()
        for t, s in zip(tickets, seq):
            res = t.result(timeout=1)
            assert res.converged and res.iterations == s.iterations
            _same_state(res.state, s.state)


class TestCancellation:
    def test_cancel_while_queued(self, good_pair):
        sched = _sched()
        t = sched.submit(REGISTRY["BFS"](), good_pair[0], CFG)
        t.cancel()
        sched.poll()
        with pytest.raises(CancelledError):
            t.result(timeout=1)
        assert sched.stats.cancelled == 1
        assert sched.stats.completed == 0
        assert not sched.pending()

    def test_cancel_mid_flight_retires_cleanly(self, good_pair):
        prog = REGISTRY["BFS"]()
        seq = run(prog, good_pair[1], CFG, device=CPU)
        sched = _sched(max_batch=4, slice_len=1)
        t_cancel = sched.submit(prog, good_pair[0], CFG)
        t_mate = sched.submit(prog, good_pair[1], CFG)
        sched.poll()
        assert not t_cancel.done()
        t_cancel.cancel()
        sched.run_until_idle()
        with pytest.raises(CancelledError):
            t_cancel.result(timeout=1)
        res = t_mate.result(timeout=1)
        assert res.iterations == seq.iterations and res.converged
        _same_state(res.state, seq.state)


class TestDeadlines:
    def test_expired_deadline_returns_flagged_partial_state(
            self, good_pair):
        prog = REGISTRY["BFS"]()
        g_slow, g_mate = good_pair[1], good_pair[0]
        full = run(prog, g_slow, CFG, device=CPU)
        seq_mate = run(prog, g_mate, CFG, device=CPU)
        slice_len = 2
        assert full.iterations > slice_len
        sched = _sched(max_batch=4, slice_len=slice_len)
        t_dead = sched.submit(prog, g_slow, CFG, deadline_s=0.0)
        t_mate = sched.submit(prog, g_mate, CFG)
        sched.run_until_idle()
        res = t_dead.result(timeout=1)
        assert res.timed_out and not res.converged
        assert res.outcome == "timed_out"
        assert res.iterations == slice_len
        partial = run(prog, g_slow, CFG, max_iters=res.iterations,
                      device=CPU)
        _same_state(res.state, partial.state)
        assert sched.stats.timed_out == 1
        mate = t_mate.result(timeout=1)
        assert mate.converged and not mate.timed_out
        assert mate.iterations == seq_mate.iterations
        _same_state(mate.state, seq_mate.state)

    def test_generous_deadline_never_fires(self, good_pair):
        sched = _sched(max_batch=2, slice_len=4)
        t = sched.submit(REGISTRY["BFS"](), good_pair[0], CFG,
                         deadline_s=3600.0)
        sched.run_until_idle()
        res = t.result(timeout=1)
        assert res.converged and not res.timed_out
        assert sched.stats.timed_out == 0


class TestBackpressure:
    def test_bounded_queue_rejects_excess_then_recovers(self, good_pair):
        prog = REGISTRY["BFS"]()
        sched = _sched(max_batch=2, slice_len=4, max_queue=2)
        accepted = [sched.submit(prog, good_pair[i % 2], CFG)
                    for i in range(2)]
        with pytest.raises(GatewayBackpressure):
            sched.submit(prog, good_pair[0], CFG)
        assert sched.stats.backpressure_rejections == 1
        sched.run_until_idle()
        late = sched.submit(prog, good_pair[0], CFG)
        sched.run_until_idle()
        for t in accepted + [late]:
            assert t.result(timeout=1).converged

    def test_iteration_limit_outcome(self, good_pair):
        prog = REGISTRY["BFS"]()
        seq = run(prog, good_pair[1], CFG, max_iters=3, device=CPU)
        assert not seq.converged
        sched = _sched(max_batch=2, slice_len=3)
        t = sched.submit(prog, good_pair[1], CFG, max_iters=3)
        sched.run_until_idle()
        res = t.result(timeout=1)
        assert not res.converged and not res.timed_out
        assert res.iterations == seq.iterations == 3
        _same_state(res.state, seq.state)


# ---------------------------------------------------------------------------
def _fault_pool(mod_rmat):
    return [mod_rmat(5, 8, seed=s, weighted=True) for s in (1, 2, 3, 4)]


def _faulted_run(mod, app, graphs, scenario):
    """One lane of four tickets under ``scenario``; returns (tickets,
    stats)."""
    sched = mod.ContinuousScheduler(
        max_batch=4, slice_len=3,
        **({"device": CPU} if mod is serve else {}))
    faults = jfaults if mod is jserve else tfaults
    registry = japps.REGISTRY if mod is jserve else REGISTRY
    config = (jcore.SystemConfig if mod is jserve else SystemConfig) \
        .from_name("DG1")
    prog = registry[app]()
    tickets = [sched.submit(prog, g, config) for g in graphs]
    if scenario == "nan":
        sched.fault_injector = faults.SliceNaNFault(ticket_id=tickets[1].id)
    elif scenario == "transient":
        sched.fault_injector = faults.SliceExceptionFault(times=1)
    elif scenario == "persistent":
        sched.fault_injector = faults.SliceExceptionFault(
            ticket_id=tickets[2].id)
    sched.run_until_idle()
    return tickets, sched.stats


#: scenario -> (app, the quarantined ticket or None, its fault code)
SCENARIOS = {"nan": ("SSSP", 1, "sentinel"),
             "transient": ("BFS", None, None),
             "persistent": ("BFS", 2, "slice_exception")}
FAULT_COUNTERS = ("slices", "slice_retries", "sentinel_trips",
                  "quarantined", "faulted", "completed", "converged",
                  "breaker_opens", "solo_degraded_slices")


class TestExecutionFaults:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_fault_contained_to_one_slot(self, scenario):
        """Only the offending slot is quarantined, with a structured
        fault; every cohabitant equals its sequential run."""
        app, bad, code = SCENARIOS[scenario]
        graphs = _fault_pool(rmat_graph)
        tickets, stats = _faulted_run(serve, app, graphs, scenario)
        prog = REGISTRY[app]()
        for j, (g, t) in enumerate(zip(graphs, tickets)):
            if j == bad:
                with pytest.raises(ExecutionFault) as exc:
                    t.result(timeout=1)
                assert exc.value.code == code
                assert exc.value.detail["ticket"] == t.id
                continue
            res, solo = t.result(timeout=1), run(prog, g, CFG, device=CPU)
            assert res.converged and res.iterations == solo.iterations, j
            _same_state(res.state, solo.state)
        assert stats.quarantined == stats.faulted == (bad is not None)
        assert stats.completed == len(graphs)
        if scenario == "nan":
            assert stats.sentinel_trips == 1
        else:
            assert stats.slice_retries >= 1 and stats.recovery_seconds > 0

    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    def test_fault_counters_equal_the_reference(self, scenario):
        app, bad, _ = SCENARIOS[scenario]
        ref_t, ref_s = _faulted_run(jserve, app, _fault_pool(j_rmat),
                                    scenario)
        port_graphs = [graph_from_arrays(
            {f: np.asarray(getattr(g, f)) for f in ARRAY_FIELDS},
            g.n_nodes, g.n_edges, g.block_size) for g in _fault_pool(j_rmat)]
        port_t, port_s = _faulted_run(serve, app, port_graphs, scenario)
        for k in FAULT_COUNTERS:
            assert getattr(port_s, k) == getattr(ref_s, k), k
        for j, (rt, pt) in enumerate(zip(ref_t, port_t)):
            if j == bad:
                assert pt._error.code == rt._error.code
                continue
            _same_state(pt.result(0).state, rt.result(0).state)

    def test_empty_snapshot_schema_is_none_safe(self):
        snap = _sched().stats.snapshot()
        for key in ("faulted", "quarantined", "slice_retries",
                    "sentinel_trips", "recovery_seconds", "replays",
                    "certificates"):
            assert snap[key] == 0, key
        for key in ("latency_p50_ms", "latency_p99_ms",
                    "queue_delay_p50_ms", "mean_occupancy",
                    "throughput_rps"):
            assert snap[key] is None, key
        assert snap["completed"] == 0 and snap["submitted"] == 0

    def test_a_kernel_build_failure_is_raised_not_contained(
            self, good_pair, monkeypatch):
        def broken(*a, **kw):
            raise KernelBuildError("nvcc failed on segment_reduce.cu")
        monkeypatch.setattr(serve, "run_batch_slice", broken)
        sched = _sched(max_batch=2, slice_len=2)
        t = sched.submit(REGISTRY["BFS"](), good_pair[0], CFG)
        with pytest.raises(KernelBuildError):
            sched.poll()
        assert not t.done() and sched.stats.quarantined == 0
