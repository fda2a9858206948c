"""The plain references against the port on the CPU, and the control
(the reference in bfloat16, in the program's place) failing the
check."""
import numpy as np
import pytest
import torch

from perfbench import control, generators, registry
from perfbench.tests.conftest import small_cell
from repro_torch import algorithms
from repro_torch.core import SystemConfig, run
from repro_torch.graph import Graph


def _port(cell, coo, source):
    mix = cell.mix
    factory = getattr(algorithms, mix["program"])
    kw = {mix["source_arg"]: source} if source is not None else {}
    program = factory(**mix["args"], **kw)
    graph = Graph.from_coo(coo.src, coo.dst, coo.n_nodes, weight=coo.weight)
    res = run(program, graph, SystemConfig.from_name(mix["config"]),
              use_kernels=True, engine="fused", autotune="off",
              device="cpu")
    assert res.converged
    return res.extract(program).numpy()


@pytest.mark.parametrize("name,scale,seed", [
    ("kron19.pr.TG0", 8, 11), ("kron19.pr.TG0", 10, 2**31 + 1),
    ("urand19.sssp.DD0", 8, 12), ("urand19.sssp.DD0", 10, 2**31 + 2)])
def test_port_within_limits(name, scale, seed):
    bench = registry.load()
    cell = small_cell(name, scale)
    coo = generators.generate(cell.config, seed, cell.mix.get("sources", 0),
                              "cpu")
    ref = bench.reference(cell.mix["program"])
    for source in (coo.sources or [None])[:3]:
        expected = ref.solve(coo, cell.mix["args"], source, "cpu",
                             torch.float64)
        got = ref.readings([_port(cell, coo, source)], expected)
        for key, value in got.items():
            assert value <= cell.limits[key], (key, value)


def test_pagerank_reference_is_a_distribution():
    cell = small_cell("kron19.pr.TG0", 9)
    coo = generators.generate(cell.config, 3, 0, "cpu")
    rank = registry.load().reference("pagerank").solve(
        coo, cell.mix["args"], None, "cpu")
    assert abs(rank.sum() - 1.0) < 1e-9 and (rank > 0).all()


def test_sssp_reference_by_hand():
    ref = registry.load().reference("sssp")
    coo = generators.Coo(src=np.array([0, 1, 1, 2, 0, 2, 3, 4]),
                         dst=np.array([1, 0, 2, 1, 2, 0, 4, 3]),
                         weight=np.array([5, 5, 1, 1, 9, 9, 2, 2], np.float32),
                         n_nodes=5, sources=[0])
    dist = ref.solve(coo, {}, 0, "cpu")
    np.testing.assert_array_equal(dist, [0, 5, 6, np.inf, np.inf])
    assert ref.readings([dist.copy()], dist) == {"sssp_mismatch": 0.0}
    off = dist.copy()
    off[2] = 7
    assert ref.readings([off], dist) == {"sssp_mismatch": 1.0}
    assert ref.readings([None], dist) == {"sssp_mismatch": 5.0}


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_control_fails_at_scale_10(name):
    """The control (PageRank in bfloat16; SSSP one round short of its
    fixpoint) reads above the limit that the program meets."""
    bench = registry.load()
    cell = small_cell(name, 10)
    for seed in (21, 2**31 + 21):
        readings, _ = control.control_readings(bench, cell, seed, "cpu")
        assert any(readings[k] > cell.limits[k] for k in readings)


def test_sssp_rounds_short_only_raises_distances():
    ref = registry.load().reference("sssp")
    cell = small_cell("urand19.sssp.DD0", 9)
    coo = generators.generate(cell.config, 3, 8, "cpu")
    exact = ref.solve(coo, {}, coo.sources[0], "cpu")
    stale = [ref.solve(coo, {}, coo.sources[0], "cpu", rounds_short=k)
             for k in (1, 2)]
    assert (stale[0] >= exact).all() and (stale[1] >= stale[0]).all()
    assert 0 < (stale[0] != exact).sum() < (stale[1] != exact).sum()


@pytest.mark.cuda
def test_control_on_card(cuda_device):
    """The control at each cell's own size fails its check."""
    bench = registry.load()
    for spec in bench.spec["workloads"]:
        cell = bench.cell(spec["name"])
        readings, _ = control.control_readings(bench, cell, 31, cuda_device)
        assert any(readings[k] > cell.limits[k] for k in readings), readings
