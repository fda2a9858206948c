"""CC, MIS, CLR and BC through the port's ``run`` against ``repro``'s.

Both packages run on the very same graph arrays (carried across with
``graph_from_arrays``), as in ``test_torch_apps.py``.  CC reduces with
MIN over int32 labels and is exact; MIS and CLR are exact once both
packages hold the same priorities, so the port's ``init`` is handed
the reference's (``jax.random.permutation`` cannot be reproduced in
torch).  These three must agree bit for bit: state, iteration count,
direction and occupancy traces.  BC sums floats: its depths, path
counts (integral, exact in float32), iteration count and traces must
agree exactly and its dependency scores to rtol=1e-5, atol=1e-6.  The
port runs its default fused engine; the reference runs its host
engine, which its own tests hold bit-identical to its fused engine.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.algorithms.reference as jref
import repro.core as jcore
import repro_torch.algorithms as tapps
import repro_torch.algorithms.reference as tref
import repro_torch.core as tcore
from repro.graph import random_graph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CONFIG_NAMES = [c.name for c in jcore.ALL_CONFIGS]
KERNEL_CONFIGS = ["SD1", "TG0", "DG1", "DD1"]
#: the port's factory name for each registry name
FACTORY = {"CC": "cc", "MIS": "mis", "CLR": "coloring", "BC": "bc"}


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def rand_graph():
    return random_graph(64, 400, seed=0, weighted=True, block_size=32)


def _run_both(app, graph, cfg, kernels):
    ref_program = getattr(japps, FACTORY[app])()
    ref = jcore.run(ref_program, graph, jcore.SystemConfig.from_name(cfg),
                    engine="host", use_pallas=kernels)
    program = getattr(tapps, FACTORY[app])()
    if app in ("MIS", "CLR"):
        # the reference's own draw (its default per-graph key)
        priority = np.array(ref_program.init(graph)["priority"])
        program = dataclasses.replace(
            program, init=functools.partial(program.init, priority=priority))
    port = tcore.run(program, _port(graph), tcore.SystemConfig.from_name(cfg),
                     device="cpu", use_kernels=kernels)
    assert port.config_name == cfg and port.engine == "fused"
    assert port.converged and ref.converged
    return port, ref


def _assert_equal(port, ref, exact_keys):
    assert port.iterations == ref.iterations
    assert port.direction_trace == ref.direction_trace
    assert port.occupancy_trace == ref.occupancy_trace
    assert set(port.state) == set(ref.state)
    for key in exact_keys:
        got, want = port.state[key].numpy(), np.asarray(ref.state[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)


def _assert_app(app, port, ref):
    if app == "BC":
        _assert_equal(port, ref, [k for k in ref.state if k != "delta"])
        np.testing.assert_allclose(port.state["delta"].numpy(),
                                   np.asarray(ref.state["delta"]),
                                   rtol=1e-5, atol=1e-6)
    else:
        _assert_equal(port, ref, list(ref.state))


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("app", ["CC", "MIS", "CLR", "BC"])
def test_apps_match_the_reference_on_every_config(tiny_graph, app, cfg):
    _assert_app(app, *_run_both(app, tiny_graph, cfg, kernels=False))


@pytest.mark.parametrize("cfg", KERNEL_CONFIGS)
@pytest.mark.parametrize("app", ["CC", "MIS", "CLR", "BC"])
def test_apps_match_the_reference_with_kernels(rand_graph, app, cfg):
    _assert_app(app, *_run_both(app, rand_graph, cfg, kernels=True))


@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
def test_apps_satisfy_the_oracles(small_graph, cfg):
    g = _port(small_graph)
    config = tcore.SystemConfig.from_name(cfg)
    res = {app: tcore.run(getattr(tapps, FACTORY[app])(), g, config,
                          device="cpu", use_kernels=True)
           for app in FACTORY}
    np.testing.assert_array_equal(res["CC"].state["label"].numpy(),
                                  tref.cc_np(g))
    member = res["MIS"].state["status"].numpy() == 1
    assert tref.is_maximal_independent_set(g, member)
    assert tref.is_proper_coloring(g, res["CLR"].state["color"].numpy())
    delta = res["BC"].extract(tapps.bc()).numpy()
    np.testing.assert_allclose(delta, tref.bc_np(g), rtol=1e-4, atol=1e-4)


def test_oracles_match_reference_oracles(small_graph):
    port = _port(small_graph)
    np.testing.assert_array_equal(tref.cc_np(port), jref.cc_np(small_graph))
    np.testing.assert_array_equal(tref.bc_np(port, 3),
                                  jref.bc_np(small_graph, 3))
    rng = np.random.default_rng(0)
    for member in (np.zeros(port.n_nodes, bool),
                   rng.random(port.n_nodes) < 0.1,
                   rng.random(port.n_nodes) < 0.5):
        for name in ("is_independent_set", "is_maximal_independent_set"):
            assert getattr(tref, name)(port, member) == \
                getattr(jref, name)(small_graph, member)
    for color in (np.arange(port.n_nodes), np.zeros(port.n_nodes),
                  rng.integers(-1, 8, port.n_nodes)):
        assert tref.is_proper_coloring(port, color) == \
            jref.is_proper_coloring(small_graph, color)


def test_registry_has_the_reference_names():
    assert list(tapps.REGISTRY) == list(japps.REGISTRY)
    for name, factory in tapps.REGISTRY.items():
        program = factory()
        assert program.name == japps.REGISTRY[name]().name == name
        assert program.max_iters == japps.REGISTRY[name]().max_iters


@pytest.mark.parametrize("app", ["MIS", "CLR"])
def test_default_priorities_are_a_seeded_permutation(small_graph, app):
    g = _port(small_graph)
    program = getattr(tapps, FACTORY[app])()
    a = program.init(g)["priority"]
    assert np.array_equal(np.sort(a.numpy()), np.arange(g.n_nodes))
    assert np.array_equal(program.init(g)["priority"].numpy(), a.numpy())
    keyed = program.init(g, torch.Generator().manual_seed(3))["priority"]
    assert not np.array_equal(keyed.numpy(), a.numpy())
    res = tcore.run(program, g, tcore.SystemConfig.from_name("DD1"),
                    key=torch.Generator().manual_seed(3), device="cpu")
    np.testing.assert_array_equal(res.state["priority"].numpy(),
                                  keyed.numpy())
