"""The port's fused engine against its host engine, on the CPU.

The port's counterpart of the contracts of ``tests/test_engine.py``.
On a CPU device the fused engine runs the same guarded steps it
captures on the card, ``STEPS_PER_LAUNCH`` per launch, with the IF
nodes' predicates read on the host.  It must equal the host engine bit
for bit (state, iteration count, direction and occupancy traces) for
the exact apps, and to the apps' tolerances for PageRank and BC
(float sums); make one launch and one poll per ``STEPS_PER_LAUNCH``
iterations; stop at ``max_iters``; and run programs without the
frontier protocol.  A recording stand-in for ``capture.CudaGraph``
pins which IF nodes a captured step holds.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.graph import random_graph, regular_graph
from repro_torch.algorithms import REGISTRY
from repro_torch.core import (ALL_CONFIGS, MIN, PLAN_CACHE, EdgeContext,
                              EdgePhase, SystemConfig, VertexProgram, run)
from repro_torch.core import capture
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CONFIG_NAMES = [c.name for c in ALL_CONFIGS]
KERNEL_CONFIGS = ["SD1", "TG0", "DG1", "DD1"]
EXACT_APPS = ["BFS", "SSSP", "CC", "MIS", "CLR"]
K = capture.STEPS_PER_LAUNCH


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def graph():
    return _port(regular_graph(96, 4, locality=0.4, seed=1, weighted=True,
                               block_size=32))


@pytest.fixture(scope="module")
def rand_graph():
    return _port(random_graph(64, 400, seed=0, weighted=True,
                              block_size=32))


def _both(app, g, cfg, **kw):
    program = REGISTRY[app]()
    config = SystemConfig.from_name(cfg)
    host = run(program, g, config, engine="host", device="cpu", **kw)
    fused = run(program, g, config, device="cpu", **kw)
    assert host.engine == "host" and fused.engine == "fused"
    return fused, host


def _assert_counts(fused, k=K):
    assert fused.dispatches == math.ceil(fused.iterations / k)
    assert fused.host_syncs == fused.dispatches


def _assert_identical(fused, host, k=K):
    assert fused.iterations == host.iterations
    assert fused.converged == host.converged
    assert fused.outcome == host.outcome
    assert fused.direction_trace == host.direction_trace
    assert fused.occupancy_trace == host.occupancy_trace
    assert set(fused.state) == set(host.state)
    for key, want in host.state.items():
        got = fused.state[key]
        assert got.dtype == want.dtype, key
        assert torch.equal(got, want), key
    _assert_counts(fused, k)


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("app", EXACT_APPS)
def test_fused_equals_host_on_every_config(graph, app, cfg):
    fused, host = _both(app, graph, cfg)
    assert fused.converged
    _assert_identical(fused, host)


@pytest.mark.parametrize("cfg", KERNEL_CONFIGS)
@pytest.mark.parametrize("app", EXACT_APPS)
def test_fused_equals_host_with_kernels(rand_graph, app, cfg):
    _assert_identical(*_both(app, rand_graph, cfg, use_kernels=True))


@pytest.mark.parametrize("cfg", ["SG0", "TD1", "DG1", "DD1"])
@pytest.mark.parametrize("app", ["PR", "BC"])
def test_float_apps_agree_to_tolerance(rand_graph, app, cfg):
    fused, host = _both(app, rand_graph, cfg, use_kernels=cfg != "SG0")
    assert fused.converged and host.converged
    _assert_counts(fused)
    assert abs(fused.iterations - host.iterations) <= 1
    n = min(fused.iterations, host.iterations)
    assert fused.direction_trace[:n] == host.direction_trace[:n]
    key = "rank" if app == "PR" else "delta"
    np.testing.assert_allclose(fused.state[key].numpy(),
                               host.state[key].numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("limit", [1, 3, 4, 5, 11])
def test_iteration_limit_stops_both_engines(graph, limit, monkeypatch):
    # four guarded steps per launch, so that limits fall before, on and
    # after a launch's end within CLR's 14 iterations on this graph
    monkeypatch.setattr(capture, "STEPS_PER_LAUNCH", 4)
    program = REGISTRY["CLR"]()
    config = SystemConfig.from_name("DD1")
    host = run(program, graph, config, engine="host", device="cpu",
               max_iters=limit)
    fused = run(program, graph, config, device="cpu", max_iters=limit)
    assert host.outcome == fused.outcome == "iter_limit"
    assert not fused.converged and fused.iterations == limit
    _assert_identical(fused, host, k=4)


def test_a_frontierless_program_runs_without_traces(rand_graph):
    # min-label propagation with no frontier protocol: no trace keys
    phase = EdgePhase(monoid=MIN, vprop=lambda st, src, w: st["x"][src])
    program = VertexProgram(
        name="CC",
        init=lambda g: {"x": torch.arange(g.n_nodes, dtype=torch.int32)},
        step=lambda ctx, st, it: {"x": torch.minimum(
            st["x"], ctx.propagate(st, phase, dtype=torch.int32))},
        converged=lambda prev, cur: (prev["x"] == cur["x"]).all(),
        extract=lambda st: st["x"])
    config = SystemConfig.from_name("SD1")
    host = run(program, rand_graph, config, engine="host", device="cpu")
    fused = run(program, rand_graph, config, device="cpu")
    assert fused.direction_trace is None and fused.occupancy_trace is None
    assert fused.converged
    _assert_identical(fused, host)


def test_host_engine_reads_every_branch_and_fused_only_polls(rand_graph):
    fused, host = _both("BFS", rand_graph, "DD1")
    pushes = host.direction_trace.count("S")
    # host: convergence + direction every iteration, the fit on pushes
    assert host.host_syncs == 2 * host.iterations + pushes
    assert host.dispatches == host.iterations
    assert fused.host_syncs == fused.dispatches < host.host_syncs
    _assert_counts(fused)


def test_read_raises_inside_a_capture(rand_graph, monkeypatch):
    ctx = EdgeContext(rand_graph, SystemConfig.from_name("DD1"),
                      device="cpu")
    flag = torch.tensor(True)
    assert ctx._read(flag) and ctx.host_syncs == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        ctx._read(flag)
    assert ctx.host_syncs == 1


def test_branch_outputs_must_agree(rand_graph):
    ctx = EdgeContext(rand_graph, SystemConfig.from_name("DD1"),
                      device="cpu")
    flag = torch.tensor(True)
    a, b = torch.zeros(3), torch.zeros(3, dtype=torch.int32)
    with capture._controlled(ctx, capture._Warm()):
        with pytest.raises(TypeError, match="differ"):
            ctx.branch(flag, lambda: a, lambda: b)
        with pytest.raises(TypeError, match="structure"):
            ctx.branch(flag, lambda: (a, a), lambda: a)
        assert ctx.branch(flag, lambda: a, lambda: a + 1) is a
    assert ctx.control is None


def test_a_step_that_changes_the_state_layout_is_refused(rand_graph):
    program = REGISTRY["BFS"]()
    bad = dataclasses.replace(program, step=lambda ctx, st, it: {
        **program.step(ctx, st, it),
        "depth": program.step(ctx, st, it)["depth"].long()})
    with pytest.raises(TypeError, match="depth"):
        run(bad, rand_graph, SystemConfig.from_name("SG0"), device="cpu")


def test_the_engine_is_cached_per_program(rand_graph):
    program = REGISTRY["SSSP"]()
    config = SystemConfig.from_name("DD1")
    PLAN_CACHE.clear()  # count this graph's entries only
    first = run(program, rand_graph, config, device="cpu")
    again = run(program, rand_graph, config, device="cpu")
    assert PLAN_CACHE.kinds()["exec_fn"] == 1
    # a result owns its state: the next run does not overwrite it
    assert first.state["dist"] is not again.state["dist"]
    assert torch.equal(first.state["dist"], again.state["dist"])
    run(REGISTRY["SSSP"](), rand_graph, config, device="cpu")
    assert PLAN_CACHE.kinds()["exec_fn"] == 2


def test_dispatch_benchmark_covers_every_config(tmp_path):
    from repro_torch.benchmarks.dispatch import run_dispatch
    out = tmp_path / "BENCH_dispatch.json"
    rec = run_dispatch(out, repeats=1, device="cpu", scale=6)
    assert list(rec["configs"]) == CONFIG_NAMES
    for cell in rec["configs"].values():
        host, fused = cell["host"], cell["fused"]
        assert fused["iterations"] == host["iterations"] > 0
        assert host["dispatches"] == host["iterations"]
        assert fused["dispatches"] == fused["host_syncs"] \
            == math.ceil(fused["iterations"] / K)
        assert cell["fused_speedup"] > 0
    assert rec["summary"]["n_configs"] == 18
    assert json.loads(out.read_text())["card"] == "cpu"


def test_plan_cache_capacity_drops_the_least_recent():
    from repro_torch.core import PlanCache
    cache, g = PlanCache(), regular_graph(8, 2, seed=0)
    for i in range(4):
        cache.get(g, "exec_fn", i, lambda: i, capacity=2)
    cache.get(g, "exec_fn", 2, lambda: None, capacity=2)  # a hit
    cache.get(g, "exec_fn", 4, lambda: 4, capacity=2)
    assert cache.kinds() == {"exec_fn": 2}
    assert cache.get(g, "exec_fn", 2, lambda: "rebuilt") == 2


class _RecordingGraph:
    """Stands in for ``capture.CudaGraph`` during a capture: records
    each IF node's nesting depth.  Both bodies of a choice run eagerly,
    so only the structure is meaningful."""

    def __init__(self):
        self.depth, self.nodes = 0, []

    def begin_capture_to_if_node(self, pred):
        assert pred.dtype == torch.bool and pred.dim() == 0
        self.depth += 1
        self.nodes.append(self.depth)

    def end_capture_to_conditional_node(self):
        self.depth -= 1


@pytest.mark.parametrize("app,cfg,nodes,depth", [
    ("BFS", "SD1", 1, 1),    # live only: a static config has no choice
    ("BFS", "DD1", 5, 3),    # live > direction (2) > fit (2, in push)
    ("CC", "DG0", 3, 2),     # live > direction; no gatherable frontier
    ("MIS", "DD1", 7, 3),    # + the mark broadcast's direction
    ("BC", "SD1", 3, 2),     # live > phase
    ("BC", "DD1", 11, 4),    # live > phase > direction > fit
])
def test_capture_records_if_nodes(rand_graph, app, cfg, nodes, depth):
    program = REGISTRY[app]()
    ctx = EdgeContext(rand_graph, SystemConfig.from_name(cfg), device="cpu")
    state = program.init(rand_graph)
    traced, occ = capture._trace_flags(program, state)
    ex = capture._build(program, ctx, state, 16, traced, occ)
    recorder = _RecordingGraph()
    control = capture._Capture(recorder)
    with capture._controlled(ctx, control):
        ex.guarded_step(control)
    assert len(recorder.nodes) == nodes and max(recorder.nodes) == depth
    assert recorder.depth == 0 and ctx.host_syncs == 0
