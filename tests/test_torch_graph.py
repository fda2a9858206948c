"""The port's graph, program model and package rules against ``repro``.

Both packages build graphs from the same numpy seeds; every array of
the port's ``Graph`` must equal the reference's bit for bit.  The
package-rule tests check that ``repro_torch`` imports neither JAX nor
the reference package, and that ``run`` refuses to fall back to the
CPU on its own.
"""
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graph as jgraph
from repro.kernels.segment_reduce import bin_edges_by_block as j_bin
import repro_torch.core as tcore
import repro_torch.graph as tgraph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.kernels.segment_reduce import bin_edges_by_block as t_bin


def _assert_same_graph(port, ref):
    assert (port.n_nodes, port.n_edges, port.block_size) == \
        (ref.n_nodes, ref.n_edges, ref.block_size)
    for name in ARRAY_FIELDS:
        a, b = np.asarray(getattr(port, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


GENERATORS = {
    "regular": ("regular_graph", (96, 4), dict(locality=0.4, seed=1,
                                               weighted=True, block_size=32)),
    "powerlaw": ("powerlaw_graph", (400, 2400),
                 dict(alpha=1.0, seed=3, weighted=True, block_size=64)),
    "powerlaw_sorted": ("powerlaw_graph", (300, 2000),
                        dict(alpha=1.2, max_degree=40, locality=0.21,
                             degree_order="sorted", seed=5)),
    "powerlaw_hubs": ("powerlaw_graph", (300, 1500),
                      dict(alpha=0.7, hub_fraction=0.12, seed=2)),
    "random": ("random_graph", (64, 400), dict(seed=0, weighted=True,
                                               block_size=32)),
    "rmat": ("rmat_graph", (8,), dict(seed=4, weighted=True,
                                      block_size=32)),
}


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_generators_match_reference(gen):
    fn, args, kw = GENERATORS[gen]
    _assert_same_graph(getattr(tgraph, fn)(*args, **kw),
                       getattr(jgraph, fn)(*args, **kw))


@pytest.mark.parametrize("name", ["DCT", "WNG", "AMZ"])
def test_paper_graph_matches_reference(name):
    # both seed with hash(name): equal within one process
    _assert_same_graph(tgraph.paper_graph(name, scale=256),
                       jgraph.paper_graph(name, scale=256))


def test_paper_stats_match_reference():
    assert tgraph.PAPER_STATS == jgraph.PAPER_STATS
    assert tgraph.PAPER_GRAPHS == jgraph.PAPER_GRAPHS


def test_graph_from_arrays_carries_fixtures(tiny_graph, small_graph):
    for ref in (tiny_graph, small_graph):
        port = graph_from_arrays(
            {f: np.asarray(getattr(ref, f)) for f in ARRAY_FIELDS},
            ref.n_nodes, ref.n_edges, ref.block_size)
        _assert_same_graph(port, ref)
        assert tgraph.validate_graph(port) == []


def test_graph_from_arrays_requires_every_array():
    with pytest.raises(KeyError, match="perm_owned"):
        graph_from_arrays({f: np.zeros(1) for f in ARRAY_FIELDS
                           if f != "perm_owned"}, 1, 1, 32)


def test_from_coo_matches_reference():
    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    w = rng.uniform(1, 4, 300).astype(np.float32)
    for sym in (False, True):
        _assert_same_graph(
            tgraph.Graph.from_coo(src, dst, 50, w, block_size=16,
                                  symmetrize=sym),
            jgraph.Graph.from_coo(src, dst, 50, w, block_size=16,
                                  symmetrize=sym))


def test_bin_edges_by_block_matches_reference():
    dst = np.random.default_rng(1).integers(0, 1000, 5000)
    for a, b in zip(t_bin(dst, 1000, 64), j_bin(dst, 1000, 64)):
        np.testing.assert_array_equal(a, b)


def test_validate_graph_matches_reference(small_graph):
    from repro.graph.structure import validate_graph as j_validate
    arrays = {f: np.array(getattr(small_graph, f)) for f in ARRAY_FIELDS}
    arrays["row_ptr_out"][5] = arrays["row_ptr_out"][4] - 1
    arrays["dst_in"][0] = small_graph.n_nodes + 3
    arrays["weight"][2] = np.nan
    port = graph_from_arrays(arrays, small_graph.n_nodes,
                             small_graph.n_edges, small_graph.block_size)
    import dataclasses
    ref = dataclasses.replace(small_graph, **arrays)
    errors = tgraph.validate_graph(port)
    assert errors and errors == j_validate(ref)


def test_device_copy_holds_tensors(tiny_graph):
    port = graph_from_arrays(
        {f: np.asarray(getattr(tiny_graph, f)) for f in ARRAY_FIELDS},
        tiny_graph.n_nodes, tiny_graph.n_edges, tiny_graph.block_size)
    dev = port.to("cpu")
    for name in ARRAY_FIELDS:
        t = getattr(dev, name)
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(t.numpy(), getattr(port, name))
    for a, b in zip(dev.edges_owned(), tiny_graph.edges_owned()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_config_space_matches_reference():
    assert [c.name for c in tcore.ALL_CONFIGS] == \
        [c.name for c in jcore.ALL_CONFIGS]
    assert len(tcore.ALL_CONFIGS) == 18
    assert [c.name for c in tcore.STATIC_CONFIGS] == \
        [c.name for c in jcore.STATIC_CONFIGS]
    for c in jcore.ALL_CONFIGS:
        port = tcore.SystemConfig.from_name(c.name, n_chunks=3)
        assert port.name == c.name and port.n_chunks == 3
        assert (port.prop.value, port.coherence.value,
                port.consistency.value) == \
            (c.prop.value, c.coherence.value, c.consistency.value)


def test_table_iii_matches_reference():
    assert set(tcore.TABLE_III) == set(jcore.TABLE_III)
    for app, props in jcore.TABLE_III.items():
        port = tcore.TABLE_III[app]
        assert (port.traversal.value, port.control.value,
                port.information.value) == \
            (props.traversal.value, props.control.value,
             props.information.value)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_monoid_identity_matches_reference(kind, dtype):
    ref = np.asarray(jcore.Monoid(kind).identity(jnp.dtype(dtype)))
    port = tcore.Monoid(kind).identity(getattr(torch, dtype))
    assert np.asarray(port, dtype=dtype) == ref
    assert np.asarray(port, dtype=dtype).tobytes() == \
        ref.astype(dtype).tobytes()


def test_package_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 45  # every module was imported


def test_run_without_device_needs_cuda(tiny_graph):
    from repro_torch.algorithms import bfs
    port = graph_from_arrays(
        {f: np.asarray(getattr(tiny_graph, f)) for f in ARRAY_FIELDS},
        tiny_graph.n_nodes, tiny_graph.n_edges, tiny_graph.block_size)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: run() would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.run(bfs(), port, tcore.SystemConfig.from_name("SG0"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcore.run(bfs(), port, tcore.SystemConfig.from_name("SG0"),
                  device="cuda")
