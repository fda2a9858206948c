"""BFS, SSSP and PageRank through the port's ``run`` against ``repro``'s.

Both packages run on the very same graph arrays (carried across with
``graph_from_arrays``).  BFS and SSSP reduce with MIN, which is exact,
so the port must agree bit for bit: state, iteration count, direction
trace and occupancy trace, on all 18 configs with the plain reductions
and on the kernel configs with the blocked reducers on.  PageRank sums
floats, so its ranks agree to atol=1e-6 and its iteration count to
within one.  The reference runs its host engine, which its own tests
hold bit-identical to its fused engine.
"""
import numpy as np
import pytest

import repro.algorithms as japps
import repro.algorithms.reference as jref
import repro.core as jcore
import repro_torch.algorithms as tapps
import repro_torch.algorithms.reference as tref
import repro_torch.core as tcore
from repro.graph import random_graph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum

CONFIG_NAMES = [c.name for c in jcore.ALL_CONFIGS]
KERNEL_CONFIGS = ["SD1", "TG0", "DG1", "DD1"]


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def rand_graph():
    return random_graph(64, 400, seed=0, weighted=True, block_size=32)


def _run_both(app, graph, cfg, kernels):
    ref = jcore.run(getattr(japps, app)(), graph,
                    jcore.SystemConfig.from_name(cfg), engine="host",
                    use_pallas=kernels)
    port = tcore.run(getattr(tapps, app)(), _port(graph),
                     tcore.SystemConfig.from_name(cfg), device="cpu",
                     use_kernels=kernels)
    assert port.config_name == cfg
    return port, ref


def _assert_bit_identical(port, ref):
    assert port.iterations == ref.iterations
    assert port.converged == ref.converged is True
    assert port.direction_trace == ref.direction_trace
    assert port.occupancy_trace == ref.occupancy_trace
    assert set(port.state) == set(ref.state)
    for key, want in ref.state.items():
        got, want = port.state[key].numpy(), np.asarray(want)
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _assert_pagerank_close(port, ref):
    assert abs(port.iterations - ref.iterations) <= 1
    n = min(port.iterations, ref.iterations)
    assert port.direction_trace[:n] == ref.direction_trace[:n]
    np.testing.assert_allclose(port.state["rank"].numpy(),
                               np.asarray(ref.state["rank"]), atol=1e-6)


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
def test_exact_apps_bit_identical_on_every_config(tiny_graph, app, cfg):
    _assert_bit_identical(*_run_both(app, tiny_graph, cfg, kernels=False))


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
def test_pagerank_close_on_every_config(tiny_graph, cfg):
    _assert_pagerank_close(*_run_both("pagerank", tiny_graph, cfg,
                                      kernels=False))


@pytest.mark.parametrize("cfg", KERNEL_CONFIGS)
@pytest.mark.parametrize("app", ["bfs", "sssp"])
@pytest.mark.parametrize("graph", ["small", "random"])
def test_exact_apps_bit_identical_with_kernels(small_graph, rand_graph,
                                               graph, app, cfg):
    g = small_graph if graph == "small" else rand_graph
    before = (seg_sum.launches, seg_minmax.launches)
    _assert_bit_identical(*_run_both(app, g, cfg, kernels=True))
    # on the CPU the reducers run their plain versions
    assert (seg_sum.launches, seg_minmax.launches) == before


@pytest.mark.parametrize("cfg", KERNEL_CONFIGS)
def test_pagerank_close_with_kernels(small_graph, cfg):
    _assert_pagerank_close(*_run_both("pagerank", small_graph, cfg,
                                      kernels=True))


def test_oracles_match_reference_oracles(small_graph):
    port = _port(small_graph)
    np.testing.assert_array_equal(tref.bfs_np(port, 3),
                                  jref.bfs_np(small_graph, 3))
    np.testing.assert_array_equal(tref.sssp_np(port, 3),
                                  jref.sssp_np(small_graph, 3))
    np.testing.assert_array_equal(tref.pagerank_np(port),
                                  jref.pagerank_np(small_graph))


@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
def test_port_matches_oracles(small_graph, cfg):
    g = _port(small_graph)
    config = tcore.SystemConfig.from_name(cfg)
    res = {app: tcore.run(getattr(tapps, app)(), g, config, device="cpu",
                          use_kernels=True)
           for app in ("bfs", "sssp", "pagerank")}
    np.testing.assert_array_equal(res["bfs"].state["depth"].numpy(),
                                  tref.bfs_np(g))
    np.testing.assert_allclose(res["sssp"].state["dist"].numpy(),
                               tref.sssp_np(g), rtol=1e-5)
    np.testing.assert_allclose(res["pagerank"].state["rank"].numpy(),
                               tref.pagerank_np(g), atol=1e-6)
