"""The port's frontier, executor and plan cache against ``repro``.

Frontier functions get the same numpy masks as the reference and must
return the same ids, counts and directions bit for bit.  The executor
tests pin the host-sync accounting, the knobs that are not ported yet,
and the device-keyed plan cache.
"""
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfront
from repro.graph import random_graph
from repro_torch.algorithms import bfs, pagerank, sssp
from repro_torch.core import (ALL_CONFIGS, PLAN_CACHE, EdgeContext,
                              SystemConfig, run)
from repro_torch.core import frontier as tfront
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def graphs():
    ref = random_graph(64, 400, seed=0, weighted=True, block_size=32)
    return ref, _port(ref)


def _masks(seed, v, density):
    rng = np.random.default_rng(seed)
    return rng.random(v) < density, rng.random(v) < 0.5


@pytest.mark.parametrize("density", [0.0, 0.02, 0.3, 0.9])
@pytest.mark.parametrize("prev_pull", [False, True])
@pytest.mark.parametrize("with_unvisited", [False, True])
def test_choose_direction_matches_reference(graphs, density, prev_pull,
                                            with_unvisited):
    ref, port = graphs
    mask, unvisited = _masks(int(density * 100), ref.n_nodes, density)
    j = jfront.choose_direction(
        jnp.asarray(mask), jnp.asarray(ref.out_degree), ref.n_edges,
        ref.n_nodes, prev_pull,
        unvisited=jnp.asarray(unvisited) if with_unvisited else None)
    t = tfront.choose_direction(
        torch.from_numpy(mask), torch.from_numpy(port.out_degree),
        port.n_edges, port.n_nodes, torch.tensor(prev_pull),
        unvisited=torch.from_numpy(unvisited) if with_unvisited else None)
    assert t.dtype == torch.bool and bool(t) == bool(j)
    assert int(tfront.frontier_edges(torch.from_numpy(mask), torch.from_numpy(
        port.out_degree))) == int(jfront.frontier_edges(
            jnp.asarray(mask), jnp.asarray(ref.out_degree)))


@pytest.mark.parametrize("density", [0.0, 0.1, 0.6])
@pytest.mark.parametrize("capacity", [1, 8, 64])
def test_sparse_frontier_and_edge_gather_match_reference(graphs, density,
                                                         capacity):
    ref, port = graphs
    mask, _ = _masks(7 + capacity, ref.n_nodes, density)
    jf = jfront.dense_to_sparse(jnp.asarray(mask), capacity)
    tf = tfront.dense_to_sparse(torch.from_numpy(mask), capacity)
    assert tf.ids.dtype == torch.int32 and tf.count.dtype == torch.int32
    np.testing.assert_array_equal(tf.ids.numpy(), np.asarray(jf.ids))
    assert int(tf.count) == int(jf.count)
    assert bool(tf.overflowed) == bool(jf.overflowed)
    for cap_e in (4, 40, 400):
        je = jfront.gather_frontier_edges(jf.ids,
                                          jnp.asarray(ref.row_ptr_out), cap_e)
        te = tfront.gather_frontier_edges(
            tf.ids, torch.from_numpy(port.row_ptr_out), cap_e)
        assert te.edge_ids.dtype == torch.int32
        np.testing.assert_array_equal(te.edge_ids.numpy(),
                                      np.asarray(je.edge_ids))
        assert int(te.count) == int(je.count)
        assert bool(te.overflowed) == bool(je.overflowed)


def test_host_syncs_are_counted_per_iteration(graphs):
    _, g = graphs
    static = run(bfs(), g, SystemConfig.from_name("SG0"), device="cpu",
                 engine="host")
    assert static.host_syncs == static.iterations  # the convergence read
    dyn = run(bfs(), g, SystemConfig.from_name("DD1"), device="cpu",
              engine="host")
    pushes = dyn.direction_trace.count("S")
    # convergence + direction every iteration, the gather fit on pushes
    assert dyn.host_syncs == 2 * dyn.iterations + pushes
    assert dyn.sparse_iterations > 0
    pr = run(pagerank(), g, SystemConfig.from_name("DG0"), device="cpu",
             engine="host")
    assert pr.host_syncs == 2 * pr.iterations  # not gatherable
    assert pr.dispatches == pr.iterations and pr.engine == "host"


def test_iteration_limit_reports_not_converged(graphs):
    _, g = graphs
    res = run(sssp(), g, SystemConfig.from_name("TG0"), device="cpu",
              max_iters=2)
    assert res.iterations == 2 and not res.converged
    assert res.outcome == "iter_limit" and res.config_name == "TG0"


def test_knobs_not_ported_yet_raise(graphs, monkeypatch, tmp_path):
    _, g = graphs
    cfg = SystemConfig.from_name("SD1")
    # the fused engine is the default now, and ``key`` is accepted
    res = run(bfs(), g, cfg, device="cpu", engine="fused",
              key=torch.Generator().manual_seed(0))
    assert res.engine == "fused" and res.converged
    assert run(bfs(), g, cfg, device="cpu").engine == "fused"
    with pytest.raises(ValueError, match="engine"):
        run(bfs(), g, cfg, device="cpu", engine="jit")
    # the tuner is ported: every mode runs, with the same result
    import repro_torch.kernels.autotune as at
    monkeypatch.setattr(at, "DEFAULT_CACHE_PATH", str(tmp_path / "c.json"))
    base = run(bfs(), g, cfg, device="cpu", use_kernels=True)
    for mode in ("measure", "heuristic", True):
        tuned = run(bfs(), g, cfg, device="cpu", use_kernels=True,
                    autotune=mode)
        assert tuned.converged and torch.equal(tuned.state["depth"],
                                               base.state["depth"])
    with pytest.raises(ValueError, match="autotune"):
        run(bfs(), g, cfg, device="cpu", autotune="sometimes")
    # the resilience knobs are ported: they run and give the plain result
    from repro_torch.core import RetryPolicy
    plain = run(bfs(), g, cfg, device="cpu")
    for knobs in (dict(checkpoint_every=1), dict(retry=RetryPolicy())):
        res = run(bfs(), g, cfg, device="cpu", **knobs)
        assert res.outcome == "converged" and res.fault is None
        assert res.iterations == plain.iterations
        assert torch.equal(res.state["depth"], plain.state["depth"])
    # specialization is ported: an unknown mode raises, "static" runs
    with pytest.raises(ValueError, match="specialize"):
        run(bfs(), g, cfg, device="cpu", specialize=1)
    res = run(bfs(), g, cfg, device="cpu", specialize="static")
    assert res.converged and res.config_source == "static"
    assert res.config_name == "DD1"  # BFS traverses dynamically


def test_plan_cache_shares_artifacts_and_keys_on_device():
    ref = random_graph(48, 200, seed=2, block_size=16)
    g = _port(ref)
    PLAN_CACHE.clear()
    for cfg in ALL_CONFIGS:
        EdgeContext.create(g, cfg, use_kernels=True, device="cpu")
    kinds = PLAN_CACHE.kinds()
    assert kinds["device"] == 1 and kinds["context"] == 18
    assert kinds["owned_reducer"] == 1 and kinds["pull_reducer"] == 1
    # csr/owned/csc orders for n_chunks 1 and 8
    assert kinds["chunked"] == 6
    a = EdgeContext.create(g, ALL_CONFIGS[0], device="cpu")
    assert EdgeContext.create(g, ALL_CONFIGS[0], device="cpu") is a
    assert EdgeContext.create(g, ALL_CONFIGS[0],
                              device=torch.device("cpu")) is a
    assert a.device == torch.device("cpu")
    assert a._graph_strong is None  # cache-owned: the graph is not pinned
    assert a.graph is g
    del g, a
    gc.collect()
    assert len(PLAN_CACHE) == 0


def test_direction_helpers_follow_the_config(graphs):
    from repro_torch.core import MIN, EdgePhase, UpdateProp
    _, g = graphs
    static = EdgeContext(g, SystemConfig.from_name("TG1"), device="cpu")
    dyn = EdgeContext(g, SystemConfig.from_name("DG1"), device="cpu")
    assert bool(static.dynamic_direction(False))  # the config's pull wins
    assert bool(dyn.dynamic_direction(True))
    assert not bool(dyn.dynamic_direction(False))
    idle = torch.zeros(g.n_nodes, dtype=torch.bool)
    assert bool(static.choose_direction(idle, torch.tensor(False)))
    assert dyn.resolve_direction(None) is UpdateProp.PUSH
    x = torch.arange(g.n_nodes, dtype=torch.float32)
    assert static.true_n_nodes == g.n_nodes and static.vertex_offsets() == 0
    assert static.align_per_graph(x) is x
    assert float(static.per_graph_sum(x)) == float(x.sum())
    assert bool(static.per_graph_any(x > 10))
    assert torch.equal(static.per_vertex(2.0), torch.full((g.n_nodes,), 2.0))
    # an explicit direction overrides the config's; MIN is exact both ways
    phase = EdgePhase(monoid=MIN, vprop=lambda st, src, w: st["d"][src] + w)
    st = {"d": torch.from_numpy(np.random.default_rng(0).uniform(
        0, 5, g.n_nodes).astype(np.float32))}
    assert torch.equal(static.propagate(st, phase, UpdateProp.PUSH),
                       static.propagate(st, phase))
