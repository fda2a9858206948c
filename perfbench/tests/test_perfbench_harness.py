"""The harness: BENCHMARK.json against its schema, every file found by
name, the result line's schema, the no-JAX check, faults in the timed
path turning ``correct`` false, and a cell, mix, configuration and
metric added with new files and entries only."""
import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import registry, run as harness
from perfbench.tests.conftest import ROOT, small_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_schema():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["perfbench"]
    assert 1 <= spec["run_seconds"] <= 51
    n_cells = len(spec["workloads"])
    budget = ((2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180
              + 1200)
    assert budget <= 43200
    names = [c["name"] for c in spec["configs"]]
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    assert len(set(c["source"] for c in spec["configs"])) == len(names)
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in spec["workloads"]} == set(names)
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        # every cell the metric lists reports the metric it moves
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    every = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [w["traffic"] for w in spec["workloads"]]
             + list(e2e) + [m["name"] for m in spec["per_layer"]])
    assert all(NAME.match(n) for n in every)
    assert len(set(every) - {w["traffic"] for w in spec["workloads"]}) == \
        len(every) - n_cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert registry.load().per_layer(w["name"]), w["name"]
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("cell", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_every_file_found_by_name(cell):
    bench = registry.load()
    c = bench.cell(cell)
    assert (bench.here / "graphs" / f"{c.config['generator']}.py").is_file()
    assert set(c.limits) and c.mix["program"]
    ref = bench.reference(c.mix["program"])
    assert callable(ref.solve) and callable(ref.readings)
    for m in bench.end_to_end(cell) + bench.per_layer(cell):
        assert callable(bench.reader(m["name"]).read)
    with pytest.raises(KeyError):
        bench.cell("no.such.cell")


def test_forbidden_modules_compare_whole_top_level_names():
    f = harness.forbidden_modules
    assert f(["repro_torch", "repro_torch.core", "numpy", "jaxtyping",
              "reprox.a"]) == []
    assert f(["jax.numpy", "repro.core.executor", "flax", "jaxlib.xla"]) \
        == ["flax", "jax", "jaxlib", "repro"]


def test_main_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "kron19.pr.TG0", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_checkout_without_src_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/ the
    command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "perfbench.run", "--workload",
         "kron19.pr.TG0", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _schema(result, trace):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_on_the_cpu(name, trace):
    bench = registry.load()
    result = harness.run_cell(bench, small_cell(name), 2**31 + 99, 0.3,
                              bool(trace), "cpu")
    _schema(result, trace)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    want = {m["name"] for m in (bench.per_layer(name) if trace
                                else bench.end_to_end(name))}
    have = set(result["metrics"])
    assert have <= want
    # on the CPU nothing reads the device: no memory, no trace
    device_only = {"peak_mem_gib", "k1_roofline", "k2_roofline",
                   "device_idle_share", "edge_bw_share"}
    assert have == {m for m in want
                    if m.split(".", 1)[0] not in device_only}


def _broken(monkeypatch, name, fault):
    """``repro_torch.algorithms.<program>`` replaced by one whose
    programs carry ``fault``."""
    from repro_torch import algorithms
    program = small_cell(name).mix["program"]
    real = getattr(algorithms, program)

    def factory(*args, **kw):
        prog = real(*args, **kw)
        if fault == "unchanged":
            return dataclasses.replace(
                prog, step=lambda ctx, st, it: dict(st),
                max_iters=min(prog.max_iters, 16))

        def altered(st):
            out = prog.extract(st).clone()
            at = torch.nonzero(torch.isfinite(out))[0]
            out[at] += 1.0
            return out
        return dataclasses.replace(prog, extract=altered)

    monkeypatch.setattr(algorithms, program, factory)


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_fault_in_the_timed_path_is_not_correct(monkeypatch, name, fault):
    """A step that returns its state unchanged, or an answer altered
    where the program produces it, comes out as not correct."""
    _broken(monkeypatch, name, fault)
    result = harness.run_cell(registry.load(), small_cell(name), 77, 0.2,
                              False, "cpu")
    _schema(result, False)
    assert result["correct"] is False
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_added_by_files_and_entries_only(tmp_path):
    """A new configuration, mix, cell and per-layer metric, as later PRs
    add them: new files and new entries in BENCHMARK.json, no edit of a
    file that is there."""
    here = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "gap-urand-s19.json").read_text())
    (here / "configs" / "gap-urand-s8.json").write_text(
        json.dumps({**cfg, "scale": 8}))
    (here / "mixes" / "pr.DD1.json").write_text(json.dumps(
        {**json.loads((here / "mixes" / "pr.TG0.json").read_text()),
         "config": "DD1"}))
    (here / "limits" / "urand8.pr.DD1.json").write_text(
        json.dumps({"pr_l1_err": 1e-4}))
    (here / "metrics" / "runs.window.py").write_text(
        "def read(rec):\n    return len(rec.runs)\n")
    spec["configs"].append({"name": "gap-urand-s8", "source": "a test",
                            "file": "perfbench/configs/gap-urand-s8.json",
                            "reduced": ["scale"], "why": "a test"})
    spec["workloads"].append({"name": "urand8.pr.DD1",
                              "config": "gap-urand-s8", "traffic": "pr.DD1",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] in ("evps.pr", "run_p95_ms.pr"):
            m["workloads"] = m["workloads"] + ["urand8.pr.DD1"]
    spec["per_layer"].append({"name": "runs.window", "unit": "runs",
                              "better": "higher", "source": "host_clock",
                              "layer": "engine", "moves": "evps.pr",
                              "workloads": ["urand8.pr.DD1"]})
    bench = registry.Benchmark(root=tmp_path, spec=spec, here=here)
    cell = bench.cell("urand8.pr.DD1")
    result = harness.run_cell(bench, cell, 5, 0.2, True, "cpu")
    assert result["correct"] is True
    assert result["metrics"]["runs.window"]["value"] == result["attempted"]
    assert "iters_per_run.pr" not in result["metrics"]
    result = harness.run_cell(bench, cell, 5, 0.2, False, "cpu")
    assert set(result["metrics"]) == {"evps.pr", "run_p95_ms.pr",
                                      "setup_s"}


GRID = """# A grid of rows x cols vertices, with edges to the right and
# below: V is not a power of two, and nothing is drawn.
import torch


def n_nodes(cfg):
    return cfg["rows"] * cfg["cols"]


def edges(cfg, gen, device):
    rows, cols = cfg["rows"], cfg["cols"]
    v = torch.arange(rows * cols, device=device).reshape(rows, cols)
    src = torch.cat([v[:, :-1].reshape(-1), v[:-1, :].reshape(-1)])
    dst = torch.cat([v[:, 1:].reshape(-1), v[1:, :].reshape(-1)])
    return src, dst
"""


GRID_LIMITS = {"pr.TG0": {"pr_l1_err": 2.5e-6},
               "sssp.DD0": {"sssp_mismatch": 0}}


@pytest.mark.parametrize("traffic", sorted(GRID_LIMITS))
def test_graph_added_by_files_and_entries_only(tmp_path, traffic):
    """A new kind of graph, as a later PR adds one: a generator file in
    ``graphs/``, a configuration that names it, a limits file and
    entries in BENCHMARK.json; its cell runs correct against the plain
    references on the CPU."""
    from perfbench import generators
    here = tmp_path / "perfbench"
    shutil.copytree(ROOT / "perfbench", here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "graphs" / "grid.py").write_text(GRID)
    cfg = {"generator": "grid", "rows": 20, "cols": 15, "weights": [1, 255],
           "structure_seed": 11}
    (here / "configs" / "grid-20x15.json").write_text(json.dumps(cfg))
    name, limit = f"grid.{traffic}", GRID_LIMITS[traffic]
    (here / "limits" / f"{name}.json").write_text(json.dumps(limit))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "grid-20x15", "source": "a test",
                            "file": "perfbench/configs/grid-20x15.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": name, "config": "grid-20x15",
                              "traffic": traffic, "chips": 1,
                              "why": "a test"})
    program = traffic.split(".", 1)[0]
    for m in spec["end_to_end"]:
        if m["name"] in (f"evps.{program}", f"run_p95_ms.{program}"):
            m["workloads"] = m["workloads"] + [name]
    bench = registry.Benchmark(root=tmp_path, spec=spec, here=here)
    cell = bench.cell(name)
    assert generators.generate(cell.config, 5, 0, "cpu", here=here
                               ).n_nodes == 300
    with pytest.raises(FileNotFoundError, match="grid.py"):
        generators.generate(cell.config, 5, 0, "cpu")
    result = harness.run_cell(bench, cell, 2**31 + 5, 0.2, False, "cpu")
    _schema(result, False)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["checks"]) == set(limit)
    assert set(result["metrics"]) == {f"evps.{program}",
                                      f"run_p95_ms.{program}", "setup_s"}


def test_reader_of_a_split_quantity():
    """``evps.pr`` and ``evps.sssp`` have no file of their own: both are
    read by ``metrics/evps.py``; a name with a file of its own keeps
    it."""
    bench = registry.load()
    assert bench.reader("evps.pr").read is not None
    assert bench.reader("evps.pr").__file__ == \
        bench.reader("evps.sssp").__file__ == bench.reader("evps").__file__
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric.pr")


def test_per_layer_metric_without_workloads_is_refused():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    del spec["per_layer"][0]["workloads"]
    with pytest.raises(KeyError, match="lists no workloads"):
        registry.load(spec=spec).per_layer("kron19.pr.TG0")


@pytest.mark.parametrize("tol", [1e-4, 1e-3])
def test_pagerank_stopped_early_is_not_correct(monkeypatch, tol):
    """PageRank on the timed path stopped a few iterations early, by a
    looser ``tol``, reads above the limit."""
    from repro_torch import algorithms
    real = algorithms.pagerank
    monkeypatch.setattr(algorithms, "pagerank",
                        lambda **kw: real(**{**kw, "tol": tol}))
    result = harness.run_cell(registry.load(), small_cell("kron19.pr.TG0"),
                              78, 0.2, False, "cpu")
    assert result["correct"] is False
    assert result["checks"]["pr_l1_err"]["value"] > \
        result["checks"]["pr_l1_err"]["limit"]
