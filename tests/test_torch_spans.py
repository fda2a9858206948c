"""``RunResult.phases``, ``captures`` and the ``repro_torch.*`` profiler
ranges of ``run()``, on the CPU.

Every run times its host phases (``RUN_PHASES``) whether or not a
profiler runs; ``phases["run.drive"]`` is ``RunResult.seconds``.  With
no profiler running no ``record_function`` is entered; under one, the
call is a ``repro_torch.run`` range holding one range per phase, in
order.  ``captures`` counts the fused engine's ``"exec_fn"`` misses.
"""
import json
import time

import pytest
import torch

from repro_torch import spans
from repro_torch.algorithms import pagerank, sssp
from repro_torch.core import PLAN_CACHE, SystemConfig, run
from repro_torch.core.executor import RUN_PHASES
from repro_torch.graph.generators import rmat_graph
from repro_torch.models import moe

ENGINES = ["fused", "host"]
APPS = {"PR": lambda: pagerank(), "SSSP": lambda: sssp(source=0)}
CONFIG = {"PR": "TG0", "SSSP": "DD0"}


@pytest.fixture(scope="module")
def graph():
    return rmat_graph(7, weighted=True, block_size=32, seed=3)


def _run(program, graph, app, engine):
    return run(program, graph, SystemConfig.from_name(CONFIG[app]),
               use_kernels=True, engine=engine, device="cpu")


def _lacks(engine):
    """The phases an engine has no work for: the host engine resets no
    buffers."""
    return {"run.reset"} if engine == "host" else set()


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_phases_time_the_run(graph, app, engine):
    program = APPS[app]()
    t0 = time.perf_counter()
    res = _run(program, graph, app, engine)
    wall = time.perf_counter() - t0
    assert res.converged
    assert tuple(res.phases) == RUN_PHASES
    assert all(s >= 0.0 for s in res.phases.values())
    assert res.phases["run.drive"] == res.seconds
    assert sum(res.phases.values()) <= wall
    for name in _lacks(engine):
        assert res.phases[name] == 0.0
    # the phases are the run's own: a second run keeps a dict of its own
    again = _run(program, graph, app, engine)
    assert again.phases is not res.phases
    assert again.phases["run.drive"] == again.seconds


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_captures_count_engine_builds(graph, app, engine):
    program = APPS[app]()
    got = [_run(program, graph, app, engine).captures for _ in range(2)]
    PLAN_CACHE.clear()
    got.append(_run(program, graph, app, engine).captures)
    # the host engine builds no engine: its warm step runs every time
    assert got == ([1, 0, 1] if engine == "fused" else [0, 0, 0])


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_no_range_without_a_profiler(monkeypatch, graph, app, engine):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    res = _run(APPS[app](), graph, app, engine)
    assert res.converged and tuple(res.phases) == RUN_PHASES


def test_moe_stages_use_the_same_helper(monkeypatch):
    """The MoE layer's stage ranges open through ``spans.span``: with no
    profiler running none enters ``record_function``; under one, each
    opens under its own name."""
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: pytest.fail(f"{name} entered"))
    ranges = moe._ranges()
    for _ in moe.STAGES:
        next(ranges)
    ranges.close()
    monkeypatch.undo()
    opened = []
    real = torch.profiler.record_function

    def recording(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        ranges = moe._ranges()
        for _ in moe.STAGES:
            next(ranges)
        ranges.close()
        with spans.span("moe.attention"):
            pass
    assert opened == list(moe.STAGES) + ["moe.attention"]


def test_phase_adds_host_seconds():
    phases = {}
    for _ in range(3):
        with spans.phase(phases, "x"):
            time.sleep(0.001)
    assert set(phases) == {"x"} and phases["x"] >= 0.003
    with pytest.raises(KeyError):
        with spans.phase(phases, "y"):
            raise KeyError("y")
    assert phases["y"] >= 0.0


@pytest.mark.parametrize("app", sorted(APPS))
@pytest.mark.parametrize("engine", ENGINES)
def test_profiler_sees_the_phases_nested(tmp_path, graph, app, engine):
    program = APPS[app]()
    _run(program, graph, app, engine)        # the engine is built
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = _run(program, graph, app, engine)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ours = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(spans.PREFIX)),
                  key=lambda e: e["ts"])
    parents = [e for e in ours if e["name"] == "repro_torch.run"]
    assert len(parents) == 1
    lo, hi = parents[0]["ts"], parents[0]["ts"] + parents[0]["dur"]
    kids = [e for e in ours if e is not parents[0]]
    want = [spans.PREFIX + p for p in RUN_PHASES if p not in _lacks(engine)]
    assert [e["name"] for e in kids] == want
    end = lo
    for e in kids:   # in order, inside the parent, none overlapping
        assert end <= e["ts"] and e["ts"] + e["dur"] <= hi
        end = e["ts"] + e["dur"]
    assert res.phases["run.drive"] == res.seconds
