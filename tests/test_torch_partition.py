"""The port's graph partitioner against ``repro.graph.partition``.

One reference graph is carried across with ``graph_from_arrays``, so
both packages partition the very same edge orders; every array of both
layouts must be bit-equal (values, dtypes and shapes, the padding to a
multiple of 8 included) for 1, 3 and 8 devices.  The port also takes a
graph whose arrays are tensors.
"""
import dataclasses

import numpy as np
import pytest

from repro.graph import powerlaw_graph, regular_graph
from repro.graph import partition as jpart
from repro_torch.graph import partition as tpart
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

DEVICES = (1, 3, 8)
GRAPHS = {
    "powerlaw": lambda: powerlaw_graph(400, 2400, alpha=1.0, seed=3,
                                       weighted=True, block_size=64),
    "regular": lambda: regular_graph(97, 4, locality=0.4, seed=1,
                                     weighted=True, block_size=32),
}


def _carry(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def graphs(request):
    g = GRAPHS[request.param]()
    return g, _carry(g)


def _assert_equal(port, ref):
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), f.name
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("n_devices", DEVICES)
def test_edge_partition_equals_the_reference(graphs, n_devices):
    jg, tg = graphs
    port = tpart.partition_edges_1d(tg, n_devices)
    _assert_equal(port, jpart.partition_edges_1d(jg, n_devices))
    assert port.edges_per_device % 8 == 0


@pytest.mark.parametrize("n_devices", DEVICES)
def test_vertex_partition_equals_the_reference(graphs, n_devices):
    jg, tg = graphs
    port = tpart.partition_vertices(tg, n_devices)
    _assert_equal(port, jpart.partition_vertices(jg, n_devices))
    assert port.vertex_offsets[-1] == tg.n_nodes


@pytest.mark.parametrize("layout", ["partition_edges_1d",
                                    "partition_vertices"])
def test_a_graph_of_tensors_partitions_the_same(graphs, layout):
    _, tg = graphs
    fn = getattr(tpart, layout)
    _assert_equal(fn(tg.to("cpu"), 3), fn(tg, 3))


def test_every_edge_lands_once(graphs):
    """The padding carries the sentinel target; the real slots hold each
    edge of the graph exactly once."""
    _, tg = graphs
    part = tpart.partition_edges_1d(tg, 3)
    real = part.dst != tg.n_nodes
    assert int(real.sum()) == tg.n_edges
    got = sorted(zip(part.src[real].tolist(), part.dst[real].tolist()))
    assert got == sorted(zip(tg.src.tolist(), tg.dst.tolist()))
