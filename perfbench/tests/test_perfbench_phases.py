"""Idle time by program span on synthetic traces, the program's phases
and captures as ``python3 -m perfbench.phases`` reads them, and on the
card the spans of a profiled run."""
import json

import pytest

from perfbench import phases, registry, trace
from perfbench.tests.conftest import small_cell
from repro_torch.core.executor import RUN_PHASES


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _span(name, ts, dur):
    return _x(phases.PREFIX + name, "user_annotation", ts, dur)


EVENTS = [
    _x(trace.RUN_SPAN, "user_annotation", 100.0, 300.0),
    _span("run", 110.0, 280.0),
    _span("run.init", 120.0, 40.0),
    _span("run.upload", 160.0, 10.0),
    _span("run.drive", 200.0, 150.0),
    _span("run.finish", 360.0, 20.0),
    _x("cudaGraphLaunch", "cuda_runtime", 205.0, 5.0),
    _x("moe.route", "user_annotation", 100.0, 300.0),   # not the program's
    _x(phases.PREFIX + "run", "gpu_user_annotation", 100.0, 300.0),
    _x("before the window", "kernel", 50.0, 55.0),      # [100, 105] in it
    _x("under init", "kernel", 140.0, 10.0),
    _x("Memcpy HtoD", "gpu_memcpy", 165.0, 45.0),
    _x("replayed", "kernel", 220.0, 120.0),
    _x("after the window", "kernel", 395.0, 55.0),      # [395, 400] in it
]
#: the gaps: [105, 140] outside 5, the parent 10, init 20; [150, 165]
#: init 10, upload 5; [210, 220] drive 10; [340, 395] drive 10, the
#: parent 10, finish 20, the parent 10, outside 5
IDLE = {"run": 30.0, "run.init": 30.0, "run.upload": 5.0,
        "run.drive": 20.0, "run.finish": 20.0}


def test_idle_by_span_splits_every_gap():
    idle = phases.idle_by_span(EVENTS)
    want = {phases.PREFIX + k: v * 1e-6 for k, v in IDLE.items()}
    want[phases.OUTSIDE] = 10e-6
    assert idle == pytest.approx(want)
    p = trace.profile_from_events(EVENTS)
    assert p.window_s == pytest.approx(300e-6)
    assert sum(idle.values()) == pytest.approx(p.window_s - p.busy_s)


def test_idle_by_span_lists_spans_without_idle_time():
    # [180, 185] lies under the copy [165, 210]: the device is busy
    idle = phases.idle_by_span(EVENTS + [_span("run.reset", 180.0, 5.0)])
    assert idle[phases.PREFIX + "run.reset"] == 0.0
    assert idle == pytest.approx({**phases.idle_by_span(EVENTS),
                                  phases.PREFIX + "run.reset": 0.0})


def test_idle_by_span_without_spans_or_device_ops():
    assert phases.idle_by_span(EVENTS[1:]) is None
    assert phases.idle_by_span(EVENTS[:9]) is None
    # a program without the spans: everything is outside
    plain = [e for e in EVENTS
             if not e["name"].startswith(phases.PREFIX)]
    p = trace.profile_from_events(plain)
    assert phases.idle_by_span(plain) == pytest.approx(
        {phases.OUTSIDE: p.window_s - p.busy_s})


def test_load_idle_by_span(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert phases.load_idle_by_span(path) == phases.idle_by_span(EVENTS)


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_trace_cell_on_the_cpu(name):
    """On the CPU the command reads the program's phases and captures;
    with no device operation in the trace it reads no idle time."""
    cell = small_cell(name)
    out = phases.trace_cell(registry.load(), cell, 2**31 + 99, 0.2, 2,
                            "cpu")
    json.dumps(out)
    assert out["runs"] >= 1
    assert list(out["phases_ms"]) == list(RUN_PHASES)
    assert all(v >= 0.0 for v in out["phases_ms"].values())
    assert 0.0 < out["capture_s"] <= out["warm_s"]
    assert out["window_s"] is None and out["idle_by_span_s"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_profiled_run_on_the_card(cuda_device, tmp_path, name):
    """Every graph launch of a profiled run lies inside its
    ``repro_torch.run.drive`` span, and the idle time under init, upload
    and drive is part of the window's."""
    import torch

    from perfbench import generators
    from repro_torch import algorithms
    from repro_torch.core import SystemConfig, run
    from repro_torch.graph import Graph

    bench = registry.load()
    cell = small_cell(name, scale=10)
    coo = generators.generate(cell.config, 2**31 + 7,
                              cell.mix.get("sources", 0), cuda_device)
    graph = Graph.from_coo(coo.src, coo.dst, coo.n_nodes, weight=coo.weight)
    kw = ({cell.mix["source_arg"]: coo.sources[0]} if coo.sources else {})
    program = getattr(algorithms, cell.mix["program"])(**cell.mix["args"],
                                                       **kw)
    config = SystemConfig.from_name(cell.mix["config"])

    def once():
        return run(program, graph, config, use_kernels=True,
                   engine="fused", autotune="off", device=cuda_device)

    assert once().captures == 1
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        results = [once() for _ in range(3)]
    assert [r.captures for r in results] == [0, 0, 0]
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    drives = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"] == phases.PREFIX + "run.drive"]
    launches = [e for e in events if e.get("ph") == "X"
                and e["name"] == "cudaGraphLaunch"]
    assert len(drives) == 3 and len(launches) >= 3
    assert sum(r.dispatches for r in results) == len(launches)
    for e in launches:
        assert any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi
                   for lo, hi in drives), e

    out = phases.trace_cell(bench, cell, 2**31 + 7, 0.5, 4, cuda_device)
    idle = out["idle_by_span_s"]
    under = sum(idle[phases.PREFIX + k]
                for k in ("run.init", "run.upload", "run.drive"))
    assert 0.0 <= under <= out["window_s"] - out["busy_s"] + 1e-9
    assert sum(idle.values()) == pytest.approx(
        out["window_s"] - out["busy_s"])
    assert 0.0 < out["capture_s"] <= out["warm_s"]
