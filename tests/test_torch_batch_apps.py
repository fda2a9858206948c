"""PR, BC, MIS and CLR through the port's ``run_batch`` against
``repro``'s, on all 18 configs.

The graphs are the reference's, carried across with
``graph_from_arrays``, two of one padding bucket that pack into one
batch.  MIS and CLR are exact once both packages hold the same
priorities, so the port's ``init`` is handed the reference's batched
draws (``fold_in(key(0), i)`` for graph *i*; ``jax.random`` cannot be
reproduced in torch).  PR and BC sum floats: PR's ranks agree to atol
1e-6 and its iteration count to +-1 (as the sequential parity tests
hold it), BC's depths, path counts, iteration counts and traces
exactly and its dependency scores to rtol 1e-5, atol 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest

import repro.algorithms as japps
import repro.core as jcore
from repro.graph import grid_graph, rmat_graph
import repro_torch.algorithms as tapps
import repro_torch.core as tcore
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CONFIG_NAMES = [c.name for c in jcore.ALL_CONFIGS]
FACTORY = {"PR": "pagerank", "BC": "bc", "MIS": "mis", "CLR": "coloring"}


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def graphs():
    ref = [rmat_graph(5, 8, seed=1, weighted=True),
           grid_graph(7, seed=0, weighted=True)]
    return ref, [_port(g) for g in ref]


def _with_priorities(program, ref_program, ref, port):
    """The port program, its ``init`` handed the reference's batched
    priority draw of each graph."""
    base = jax.random.key(0)
    prio = {id(p): np.array(ref_program.init(
        r, jax.random.fold_in(base, i))["priority"])
        for i, (r, p) in enumerate(zip(ref, port))}
    init = program.init
    return dataclasses.replace(
        program, init=lambda g, key=None: init(g, priority=prio[id(g)]))


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("app", ["PR", "BC", "MIS", "CLR"])
def test_apps_match_the_reference_batch(graphs, app, cfg):
    ref, port = graphs
    ref_program = getattr(japps, FACTORY[app])()
    want = jcore.run_batch(ref_program, ref, jcore.SystemConfig.from_name(cfg))
    program = getattr(tapps, FACTORY[app])()
    if app in ("MIS", "CLR"):
        program = _with_priorities(program, ref_program, ref, port)
    got = tcore.run_batch(program, port, tcore.SystemConfig.from_name(cfg),
                          device="cpu")
    for r, w in zip(got, want):
        assert r.engine == "batched" and r.converged and w.converged
        assert set(r.state) == set(w.state)
        if app == "PR":
            assert abs(r.iterations - w.iterations) <= 1
            n = min(r.iterations, w.iterations)
            assert r.direction_trace[:n] == w.direction_trace[:n]
            np.testing.assert_allclose(r.state["rank"].numpy(),
                                       np.asarray(w.state["rank"]),
                                       atol=1e-6)
            continue
        assert r.iterations == w.iterations
        assert r.direction_trace == w.direction_trace
        assert r.occupancy_trace == w.occupancy_trace
        for k, v in w.state.items():
            if app == "BC" and k == "delta":
                np.testing.assert_allclose(r.state[k].numpy(), np.asarray(v),
                                           rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_array_equal(r.state[k].numpy(),
                                              np.asarray(v), err_msg=k)


@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
@pytest.mark.parametrize("app", ["PR", "BC"])
def test_float_apps_with_kernels_close_to_sequential(graphs, app, cfg):
    """The packed graph's blocked reducers (their plain versions here)
    against each graph's sequential run with the same reducers."""
    port = graphs[1]
    program = getattr(tapps, FACTORY[app])()
    config = tcore.SystemConfig.from_name(cfg)
    got = tcore.run_batch(program, port, config, use_kernels=True,
                          device="cpu")
    for g, r in zip(port, got):
        w = tcore.run(program, g, config, use_kernels=True, device="cpu")
        assert abs(r.iterations - w.iterations) <= (1 if app == "PR" else 0)
        key = "rank" if app == "PR" else "delta"
        np.testing.assert_allclose(r.state[key].numpy(),
                                   w.state[key].numpy(), rtol=1e-5,
                                   atol=1e-6)
