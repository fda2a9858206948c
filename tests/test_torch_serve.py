"""The port's streaming gateway against ``repro.launch.serve``
(``tests/test_serve.py``'s contracts), on the CPU.

Differential: the port's ``ContinuousScheduler`` and the reference's
serve the same stream (staggered arrivals over two lanes, an iteration
limit, a deadline and a mid-flight cancel, on one deterministic clock)
over the same graphs, carried across with ``graph_from_arrays``; every
ticket's outcome, state, iterations, traces and committed slices and
the ``GatewayStats`` counters must agree, bit for bit for BFS, SSSP and
CC and to float tolerance for PR.  Each result must also equal the
port's sequential ``run``, whatever cohort it shared (MIS and CLR too:
their default keys depend on the graph alone), through the threaded
front end as well; steady repeat traffic rebuilds nothing.
"""
import itertools
import sys
import threading

import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.launch.serve as jserve
from repro.graph import grid_graph as j_grid, rmat_graph as j_rmat
from repro_torch.algorithms import REGISTRY
from repro_torch.core import PLAN_CACHE, SystemConfig, run
from repro_torch.core.batch import bucket_key
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.launch import serve
from repro_torch.launch.serve import ContinuousScheduler, GraphGateway

CFG = SystemConfig.from_name("DG1")
CPU = "cpu"


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def ref_pool():
    """Two same-bucket graphs (one lane, B = 2) and one of another
    bucket (its own lane), as the reference's fixture."""
    return [j_rmat(5, 8, seed=1, weighted=True),
            j_grid(7, seed=0, weighted=True),
            j_rmat(7, 8, seed=2, weighted=True)]


@pytest.fixture(scope="module")
def pool(ref_pool):
    graphs = [_port(g) for g in ref_pool]
    assert bucket_key(graphs[0]) == bucket_key(graphs[1])
    assert bucket_key(graphs[0]) != bucket_key(graphs[2])
    return graphs


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _state_equal(a, b, exact=True):
    assert set(a) == set(b)
    for k in a:
        x, y = _host(a[k]), _host(b[k])
        assert x.dtype == y.dtype, k
        if exact:
            assert np.array_equal(x, y), k
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def _gateway_matches_sequential(res, seq, exact=True):
    assert res.engine == "gateway"
    assert res.converged == seq.converged
    assert res.iterations == seq.iterations
    assert res.direction_trace == seq.direction_trace
    assert res.occupancy_trace == seq.occupancy_trace
    assert not res.timed_out
    _state_equal(res.state, seq.state, exact=exact)


def _seq(prog, g, **kw):
    return run(prog, g, CFG, device=CPU, **kw)


# ---------------------------------------------------------------------------
# differential: the same stream through both packages

#: the counters both schemas share (the port adds replays and seconds)
COUNTERS = ("submitted", "admitted", "completed", "converged", "timed_out",
            "cancelled", "faulted", "rejected", "backpressure_rejections",
            "shed", "slices", "roster_rebuilds", "slice_retries",
            "sentinel_trips", "quarantined", "breaker_opens",
            "breaker_closes", "breaker_probes", "solo_degraded_slices")


def _ticking():
    """A clock that advances one second per reading: both packages read
    it at the same points, so timestamps and deadlines agree."""
    c = itertools.count()
    return lambda: float(next(c))


def _stream(mod, program, graphs, config):
    """Staggered arrivals over two lanes, an iteration limit, a deadline
    and a mid-flight cancel; returns (tickets, scheduler)."""
    kw = {"device": CPU} if mod is serve else {}
    sched = mod.ContinuousScheduler(max_batch=4, slice_len=2,
                                    clock=_ticking(), **kw)
    g0, g1, g2 = graphs
    # the deadline arrives while the gateway is cold (never shed) and
    # expires at its first slice boundary
    arrivals = {0: [(g0, {}), (g1, {"max_iters": 1}),
                    (g2, {"deadline_s": 4.0})],
                1: [(g2, {})],
                2: [(g1, {}), (g0, {})]}
    tickets = []
    for rnd in range(4):
        for g, extra in arrivals.get(rnd, []):
            tickets.append(sched.submit(program, g, config, **extra))
        if rnd == 2:
            tickets[3].cancel()             # one slice into its run
        sched.poll()
    sched.run_until_idle()
    return tickets, sched


def _outcome(t):
    try:
        r = t.result(0)
    except Exception as err:  # noqa: BLE001
        return type(err).__name__, None
    return r.outcome, r


@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "PR"])
def test_scheduler_equals_the_reference_on_one_stream(ref_pool, pool, app):
    exact = app != "PR"
    ref_t, ref_s = _stream(jserve, japps.REGISTRY[app](), ref_pool,
                           jcore.SystemConfig.from_name("DG1"))
    port_t, port_s = _stream(serve, REGISTRY[app](), pool, CFG)
    assert len(ref_t) == len(port_t)
    for rt, pt in zip(ref_t, port_t):
        (ro, rr), (po, pr) = _outcome(rt), _outcome(pt)
        assert po == ro
        assert (pt.enqueued_at, pt.admitted_at, pt.first_dispatch_at,
                pt.completed_at) == (rt.enqueued_at, rt.admitted_at,
                                     rt.first_dispatch_at, rt.completed_at)
        if rr is None:
            continue
        assert (pr.iterations, pr.converged, pr.timed_out, pr.dispatches,
                pr.direction_trace, pr.occupancy_trace) == \
            (rr.iterations, rr.converged, rr.timed_out, rr.dispatches,
             rr.direction_trace, rr.occupancy_trace)
        _state_equal(pr.state, rr.state, exact=exact)
    rs, ps = ref_s.stats.snapshot(), port_s.stats.snapshot()
    for k in COUNTERS:
        assert ps[k] == rs[k], k
    assert ps["mean_occupancy"] == rs["mean_occupancy"]
    assert [(r["outcome"], r["dispatches"]) for r in port_s.stats.requests] \
        == [(r["outcome"], r["dispatches"]) for r in ref_s.stats.requests]
    outcomes = {o for o, _ in map(_outcome, port_t)}
    assert {"converged", "iter_limit", "timed_out",
            "CancelledError"} <= outcomes
    assert ps["slices"] <= ps["replays"]  # >= one replay per slice


# ---------------------------------------------------------------------------
class TestBitIdenticalThroughGateway:
    @pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "CLR", "MIS",
                                     "PR"])
    def test_staggered_arrivals_match_sequential(self, pool, app):
        prog = REGISTRY[app]()
        seq = {id(g): _seq(prog, g) for g in pool}
        sched = ContinuousScheduler(max_batch=4, slice_len=3, device=CPU)
        arrivals = {0: [pool[0]], 1: [pool[2]], 2: [pool[1], pool[0]]}
        tickets = []
        for rnd in range(4):
            for g in arrivals.get(rnd, []):
                tickets.append((g, sched.submit(prog, g, CFG)))
            sched.poll()
        sched.run_until_idle()
        for g, t in tickets:
            _gateway_matches_sequential(t.result(timeout=1), seq[id(g)],
                                        exact=(app != "PR"))

    def test_cohort_independence(self, pool):
        prog = REGISTRY["BFS"]()
        g = pool[0]
        solo_sched = ContinuousScheduler(max_batch=1, slice_len=2,
                                         device=CPU)
        t_solo = solo_sched.submit(prog, g, CFG)
        solo_sched.run_until_idle()
        cohort = ContinuousScheduler(max_batch=4, slice_len=2, device=CPU)
        t_in = cohort.submit(prog, g, CFG)
        cohort.submit(prog, pool[1], CFG)
        cohort.poll()                          # duo in flight
        t_late = cohort.submit(prog, g, CFG)   # joins mid-stream
        cohort.run_until_idle()
        for t in (t_solo, t_in, t_late):
            _gateway_matches_sequential(t.result(timeout=1), _seq(prog, g))


class TestRandomizedProgramDeterminism:
    @pytest.mark.parametrize("app", ["CLR", "MIS"])
    def test_keys_independent_of_cohort_and_order(self, pool, app):
        prog = REGISTRY[app]()
        g = pool[0]
        seq = _seq(prog, g)
        for order in ([g, pool[1]], [pool[1], g], [g]):
            sched = ContinuousScheduler(max_batch=4, slice_len=3,
                                        device=CPU)
            ts = {id(x): sched.submit(prog, x, CFG) for x in order}
            sched.run_until_idle()
            _gateway_matches_sequential(ts[id(g)].result(timeout=1), seq)

    @pytest.mark.parametrize("app", ["CLR", "MIS"])
    def test_explicit_generator_matches_sequential(self, pool, app):
        prog = REGISTRY[app]()
        g = pool[1]
        seq = _seq(prog, g, key=torch.Generator().manual_seed(5))
        sched = ContinuousScheduler(max_batch=4, slice_len=3, device=CPU)
        sched.submit(prog, pool[0], CFG)
        t = sched.submit(prog, g, CFG, key=torch.Generator().manual_seed(5))
        sched.run_until_idle()
        _gateway_matches_sequential(t.result(timeout=1), seq)


class TestThreadedGateway:
    def test_concurrent_clients(self, pool):
        """More client threads than slots, with a short switch interval:
        every request answered once and equal to its sequential run."""
        prog = REGISTRY["BFS"]()
        seq = {id(g): _seq(prog, g) for g in pool}
        n_req, n_clients = 24, 8
        results = [None] * n_req
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with GraphGateway(max_batch=4, slice_len=4, device=CPU) as gw:
                def client(k):
                    for i in range(k, n_req, n_clients):
                        g = pool[i % len(pool)]
                        results[i] = (g, gw.submit(prog, g, CFG)
                                      .result(timeout=120))
                threads = [threading.Thread(target=client, args=(k,))
                           for k in range(n_clients)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=120)
                assert not any(th.is_alive() for th in threads)
                snap = gw.stats()
        finally:
            sys.setswitchinterval(interval)
        for g, res in results:
            _gateway_matches_sequential(res, seq[id(g)])
        assert snap["submitted"] == snap["completed"] == n_req
        assert snap["converged"] == n_req
        assert snap["throughput_rps"] > 0

    def test_submit_requires_running_gateway(self, pool):
        gw = GraphGateway(device=CPU)
        with pytest.raises(RuntimeError, match="not running"):
            gw.submit(REGISTRY["BFS"](), pool[0], CFG)

    def test_device_defaults_to_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GraphGateway()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousScheduler()


class TestPlanCacheWarmth:
    def test_steady_state_repeat_traffic_rebuilds_nothing(self, pool):
        prog = REGISTRY["BFS"]()
        sched = ContinuousScheduler(max_batch=2, slice_len=4, device=CPU)
        for g in pool[:2]:
            sched.submit(prog, g, CFG)
        sched.run_until_idle()
        assert sched.stats.roster_rebuilds >= 1      # initial growth
        sched.reset_stats()
        kinds = ("batch_pack", "batch_context", "init_state", "exec_fn")
        before = {k: PLAN_CACHE.kind_stats(k) for k in kinds}
        for g in pool[:2]:
            sched.submit(prog, g, CFG)
        sched.run_until_idle()
        assert sched.stats.roster_rebuilds == 0
        after = {k: PLAN_CACHE.kind_stats(k) for k in kinds}
        for k in kinds:
            assert after[k]["misses"] == before[k]["misses"], k
        assert after["init_state"]["hits"] >= \
            before["init_state"]["hits"] + 2          # memoized init

    def test_lanes_split_by_config_knobs_and_bucket(self, pool):
        prog = REGISTRY["BFS"]()
        sched = ContinuousScheduler(max_batch=4, slice_len=2, device=CPU)
        sched.submit(prog, pool[0], CFG)
        sched.submit(prog, pool[1], CFG)              # same lane
        sched.submit(prog, pool[2], CFG)              # other bucket
        sched.submit(prog, pool[0], SystemConfig.from_name("SG0"))
        sched.submit(prog, pool[0], CFG, use_kernels=True)
        assert len(sched._lanes) == 4
        sched.run_until_idle()


class TestLifecycleInstrumentation:
    def test_timestamps_and_snapshot_schema(self, pool):
        prog = REGISTRY["BFS"]()
        sched = ContinuousScheduler(max_batch=2, slice_len=2, device=CPU)
        t = sched.submit(prog, pool[0], CFG)
        sched.run_until_idle()
        res = t.result(timeout=1)
        assert res.dispatches >= 1
        assert (t.enqueued_at <= t.admitted_at <= t.first_dispatch_at
                <= t.completed_at)
        snap = sched.stats.snapshot()
        assert set(jserve.GatewayStats().snapshot()) <= set(snap)
        assert snap["completed"] == snap["converged"] == 1
        assert snap["latency_p50_ms"] > 0
        assert 0 < snap["mean_occupancy"] <= 1
        assert snap["replays"] >= snap["slices"] == res.dispatches
        assert snap["certificates"] == 1          # BFS has a certificate
        assert snap["slice_seconds"] >= snap["dispatch_seconds"] > 0
        assert sched.stats.requests[0]["outcome"] == "converged"

    def test_result_timeout_when_not_polled(self, pool):
        sched = ContinuousScheduler(device=CPU)
        t = sched.submit(REGISTRY["BFS"](), pool[0], CFG)
        with pytest.raises(TimeoutError):
            t.result(timeout=0.01)


class TestEntryPoint:
    def test_arch_forwards_to_lm_demo_with_deprecation(self, monkeypatch):
        # the reference's rule (tests/test_serve.py:218-226): --arch goes
        # to the LM demo with its argv unchanged, and warns
        from repro_torch.launch import lm_demo
        called = {}
        monkeypatch.setattr(lm_demo, "main",
                            lambda argv: called.setdefault("argv", argv))
        with pytest.warns(DeprecationWarning, match="lm_demo"):
            serve.main(["--arch", "starcoder2-7b", "--gen", "1"])
        assert called["argv"] == ["--arch", "starcoder2-7b", "--gen", "1"]

    def test_demo_serves_on_the_cpu(self, capsys):
        serve.main(["--requests", "6", "--pool", "3", "--device", "cpu"])
        out = capsys.readouterr().out
        assert "BFS/DG1: 6 requests" in out and "p99" in out


def test_serve_and_chaos_harnesses_on_the_cpu():
    """Both harnesses at their smoke sizes: the record's structure, and
    every bit-identity and containment check holding."""
    from repro_torch.benchmarks.chaos import run_chaos_bench
    from repro_torch.benchmarks.serve import run_serve_bench
    s = run_serve_bench(out_path=None, smoke=True, repeats=1, device=CPU)
    for mode in ("closed", "open"):
        m = s["modes"][mode]
        assert m["throughput_speedup"] > 0 and m["p99_gain"] > 0
        assert m["gateway"]["roster_rebuilds"] == 0  # warm after warm-up
    c = run_chaos_bench(out_path=None, smoke=True, device=CPU)
    assert c["summary"]["n_bit_identical"] == c["summary"][
        "n_identity_checks"] == 4
    assert c["core"]["agrees"] and c["core"]["lost_work_ratio"] < 1
    assert c["overload"]["contained"]
