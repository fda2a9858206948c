"""The trace, bytes and idle arithmetic on synthetic traces and
records."""
import pytest

from perfbench import registry, roofline, trace
from perfbench.run import Record, RunRecord


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.RUN_SPAN, "user_annotation", 100.0, 100.0),
    _x(trace.RUN_SPAN, "user_annotation", 250.0, 50.0),
    _x("cudaGraphLaunch", "cuda_runtime", 105.0, 5.0),
    _x("cudaStreamSynchronize", "cuda_runtime", 110.0, 80.0),
    _x("aten::copy_", "cpu_op", 190.0, 15.0),
    _x("seg_reduce_kernel<SumF32>", "kernel", 110.0, 40.0),
    _x("elementwise", "kernel", 140.0, 20.0),   # overlaps the one above
    _x("Memcpy DtoH", "gpu_memcpy", 195.0, 5.0),
    _x("seg_reduce_kernel<MinMax<true, true>>", "kernel", 260.0, 30.0),
    _x("before the window", "kernel", 0.0, 50.0),
    _x("gpu annotation", "gpu_user_annotation", 100.0, 200.0),
]


def test_busy_union_and_window():
    p = trace.profile_from_events(EVENTS)
    assert p.window_s == pytest.approx(200e-6)
    # [110, 160] + [195, 200] + [260, 290]
    assert p.busy_s == pytest.approx(85e-6)
    assert p.kernels("seg_reduce_kernel", "Sum") == [pytest.approx(40e-6)]
    assert p.kernels("seg_reduce_kernel", "MinMax") == [pytest.approx(30e-6)]


def test_idle_gaps_by_host_activity():
    p = trace.profile_from_events(EVENTS)
    gaps = dict((k, v) for k, v in p.top(p.idle_gaps))
    # [100, 110] under the launch, [160, 195] under the synchronize
    # (midpoint 177.5), [200, 260] between the runs (midpoint 230: no
    # host event), [290, 300] under the second run's span
    assert gaps["cudaGraphLaunch"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(35e-6)
    assert gaps["idle host"] == pytest.approx(60e-6)
    assert gaps[trace.RUN_SPAN] == pytest.approx(10e-6)
    assert sum(gaps.values()) == pytest.approx(p.window_s - p.busy_s)
    b = p.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0][0] == "seg_reduce_kernel<SumF32>"


def test_no_span_or_no_device_op_reads_nothing():
    assert trace.profile_from_events(EVENTS[2:]) is None
    assert trace.profile_from_events(EVENTS[:5]) is None


def _record(profile, runs):
    return Record(n_nodes=1000, n_edges=16000, sparse_capacity=800,
                  setup_s=1.0, graph_build_s=0.5, warm_s=0.25, window_s=2.0,
                  runs=runs, profile=profile, profiled_runs=runs)


def _rr(wall, secs, iters, dirs=None, occ=None, outcome="converged"):
    return RunRecord(0, wall, secs, iters, dirs, occ, outcome)


def test_roofline_bytes():
    assert roofline.seg_reduce_bytes(10, 3) == 4 * (20 + 3)
    assert roofline.seg_reduce_bytes(10, 3, d=8) == 4 * (90 + 24)
    assert roofline.iteration_bytes(100, 1000, -1.0, 50) == 4 * (2000 + 100)
    assert roofline.iteration_bytes(100, 1000, 0.5, 50) == 4 * (50 + 25)
    runs = [_rr(0.1, 0.09, 3, occ=[-1.0, 0.5, 0.5]), _rr(0.1, 0.09, 2)]
    assert roofline.edge_phase_bytes(runs, 100, 1000, 50) == pytest.approx(
        3 * 4 * 2100 + 2 * 4 * 75)


def test_readers_on_a_synthetic_record():
    bench = registry.load()
    p = trace.profile_from_events(EVENTS)
    runs = [_rr(0.020, 0.015, 10, "SSTTTTTTSS", [0.1, 0.2] + [-1.0] * 8),
            _rr(0.030, 0.027, 12, "S" * 12, [0.5] * 12),
            _rr(0.500, 0.400, 99, None, None, outcome="iter_limit")]
    rec = _record(p, runs)
    read = {m: bench.reader(m).read(rec) for m in (
        "evps", "run_p95_ms", "host_ms_per_run", "iters_per_run",
        "pull_iter_share", "sparse_iter_share", "k1_roofline",
        "k2_roofline", "device_idle_share", "edge_bw_share", "setup_s",
        "graph_build_s", "warm_s", "peak_mem_gib")}
    assert read["evps"] == pytest.approx(17000 * 2 / 2.0 / 1e6)
    assert read["host_ms_per_run"] == pytest.approx(4.0)
    assert read["iters_per_run"] == pytest.approx(11.0)
    assert read["pull_iter_share"] == pytest.approx(100 * 6 / 22)
    assert read["sparse_iter_share"] == pytest.approx(100 * 14 / 22)
    need = roofline.seg_reduce_bytes(16000, 1000)
    assert read["k1_roofline"] == pytest.approx(
        100 * need / roofline.HBM_BYTES_PER_S / 40e-6)
    assert read["k2_roofline"] == pytest.approx(
        100 * need / roofline.HBM_BYTES_PER_S / 30e-6)
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 85 / 200))
    need = roofline.edge_phase_bytes(runs, 1000, 16000, 800)
    assert read["edge_bw_share"] == pytest.approx(
        100 * need / roofline.HBM_BYTES_PER_S / 85e-6)
    assert read["run_p95_ms"] > 30.0
    assert read["peak_mem_gib"] is None
    assert (read["setup_s"], read["graph_build_s"], read["warm_s"]) == (
        1.0, 0.5, 0.25)


@pytest.mark.parametrize("split", ["pr", "sssp"])
def test_split_names_read_their_quantity(split):
    bench = registry.load()
    p = trace.profile_from_events(EVENTS)
    rec = _record(p, [_rr(0.020, 0.015, 10, "SSTTTTTTSS",
                          [0.1, 0.2] + [-1.0] * 8)])
    for q in ("evps", "run_p95_ms", "host_ms_per_run", "iters_per_run",
              "device_idle_share", "edge_bw_share"):
        assert bench.reader(f"{q}.{split}").read(rec) == \
            bench.reader(q).read(rec), q


def test_trace_readers_without_a_profile_read_nothing():
    bench = registry.load()
    rec = _record(None, [_rr(0.02, 0.01, 3)])
    for m in ("k1_roofline", "k2_roofline", "device_idle_share",
              "edge_bw_share", "pull_iter_share", "sparse_iter_share"):
        assert bench.reader(m).read(rec) is None, m
