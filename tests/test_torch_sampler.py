"""The port's neighbor sampler against ``repro.graph.sampler``.

Both draw from ``np.random.default_rng(seed)`` in the same order, so for
one graph carried across with ``graph_from_arrays``, the same fanouts
and the same seed, every array of every block must be bit-equal: one
hop, then the multi-hop ``sample`` (two draws in a row from one
sampler), for seeds 0 and 7.  The port also takes a graph whose arrays
are tensors.
"""
import dataclasses

import numpy as np
import pytest

from repro.graph import powerlaw_graph
from repro.graph import sampler as jsamp
from repro_torch.graph import sampler as tsamp
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

SEEDS = (0, 7)
FANOUTS = (5, 3)


@pytest.fixture(scope="module")
def graphs():
    g = powerlaw_graph(400, 2400, alpha=1.0, seed=3, weighted=True,
                       block_size=64)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in ARRAY_FIELDS},
                           g.n_nodes, g.n_edges, g.block_size)
    return g, tg


def _seeds(g, n=32):
    return np.random.default_rng(11).choice(g.n_nodes, n, replace=False)


def _assert_blocks(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.fanout == b.fanout
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f.name
                np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_hop_equals_the_reference(graphs, seed):
    jg, tg = graphs
    seeds = _seeds(tg)
    port = tsamp.NeighborSampler(tg, FANOUTS, seed=seed)
    ref = jsamp.NeighborSampler(jg, FANOUTS, seed=seed)
    _assert_blocks([port.sample_hop(seeds, 4)], [ref.sample_hop(seeds, 4)])


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_hop_draws_equal_the_reference(graphs, seed):
    jg, tg = graphs
    seeds = _seeds(tg)
    port = tsamp.NeighborSampler(tg, FANOUTS, seed=seed)
    ref = jsamp.NeighborSampler(jg, FANOUTS, seed=seed)
    for _ in range(2):  # the generator's state carries across draws
        _assert_blocks(port.sample(seeds), ref.sample(seeds))


@pytest.mark.parametrize("seed", SEEDS)
def test_a_graph_of_tensors_samples_the_same(graphs, seed):
    _, tg = graphs
    seeds = _seeds(tg)
    a = tsamp.NeighborSampler(tg.to("cpu"), FANOUTS, seed=seed)
    b = tsamp.NeighborSampler(tg, FANOUTS, seed=seed)
    _assert_blocks(a.sample(seeds), b.sample(seeds))


def test_sampled_edges_are_in_edges(graphs):
    """Every real sampled edge is an in-edge of its seed; padding holds
    the sentinel id."""
    _, tg = graphs
    seeds = _seeds(tg)
    blk = tsamp.NeighborSampler(tg, FANOUTS, seed=0).sample_hop(seeds, 4)
    edges = set(zip(tg.src_in.tolist(), tg.dst_in.tolist()))
    tgt = blk.seeds[blk.dst_local]
    for s, t, m in zip(blk.src_global, tgt, blk.edge_mask):
        assert (int(s), int(t)) in edges if m else s == tg.n_nodes
