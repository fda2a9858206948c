"""The generators: determinism, the Kronecker quadrant probabilities,
and the symmetrised, loop-free, duplicate-free edge list."""
import numpy as np
import pytest
import torch

from perfbench import generators
from perfbench.tests.conftest import small_cell


def _cfg(name, scale=8):
    return small_cell(name, scale).config


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_same_seed_same_graph(name):
    cfg = _cfg(name)
    a = generators.generate(cfg, 2**31 + 5, 8, "cpu")
    b = generators.generate(cfg, 2**31 + 5, 8, "cpu")
    for f in ("src", "dst", "weight"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.sources == b.sources


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_seeds_relabel_one_structure(name):
    """Another seed gives the same graph under other labels: the same
    degree sequence, weights and source degrees."""
    cfg = _cfg(name)
    a = generators.generate(cfg, 1, 8, "cpu")
    b = generators.generate(cfg, 2, 8, "cpu")
    assert not np.array_equal(a.src, b.src)
    deg = [np.bincount(g.src, minlength=g.n_nodes) for g in (a, b)]
    np.testing.assert_array_equal(np.sort(deg[0]), np.sort(deg[1]))
    np.testing.assert_array_equal(np.sort(a.weight), np.sort(b.weight))
    assert sorted(deg[0][a.sources]) == sorted(deg[1][b.sources])


@pytest.mark.parametrize("name", ["kron19.pr.TG0", "urand19.sssp.DD0"])
def test_symmetric_simple_weighted(name):
    g = generators.generate(_cfg(name), 7, 8, "cpu")
    assert g.n_edges > 0
    assert (g.src != g.dst).all()
    key = g.src * g.n_nodes + g.dst
    assert np.unique(key).shape[0] == key.shape[0]
    back = dict(zip(key.tolist(), g.weight.tolist()))
    for s, d, w in zip(g.src[:500], g.dst[:500], g.weight[:500]):
        assert back[int(d) * g.n_nodes + int(s)] == w
    assert g.weight.min() >= 1 and g.weight.max() <= 255
    assert (g.weight == np.round(g.weight)).all()
    deg = np.bincount(g.src, minlength=g.n_nodes)
    assert len(g.sources) == 8 and len(set(g.sources)) == 8
    assert (deg[g.sources] > 0).all()


def test_kron_quadrant_probabilities():
    """One level: the quadrants (0,0), (0,1), (1,0), (1,1) come with
    probabilities A, B, C and 1 - A - B - C."""
    gen = torch.Generator().manual_seed(3)
    src, dst = generators.kron_edges(1, 1 << 17, 0.57, 0.19, 0.19, gen,
                                     "cpu")
    quad = (src * 2 + dst).numpy()
    freq = np.bincount(quad, minlength=4) / quad.shape[0]
    np.testing.assert_allclose(freq, [0.57, 0.19, 0.19, 0.05], atol=0.003)


def test_kron_bits_are_levels():
    """Every level sets its own bit: at scale s the endpoints fill
    [0, 2**s) and vertex 0 (all bits in quadrant A) is the densest."""
    gen = torch.Generator().manual_seed(4)
    src, dst = generators.kron_edges(6, 64, 0.57, 0.19, 0.19, gen, "cpu")
    assert int(src.max()) < 64 and int(dst.max()) < 64
    deg = torch.bincount(torch.cat([src, dst]), minlength=64)
    assert int(deg.argmax()) == 0


def test_urand_uniform():
    gen = torch.Generator().manual_seed(5)
    src, dst = generators.urand_edges(4, 1 << 12, gen, "cpu")
    freq = torch.bincount(torch.cat([src, dst]), minlength=16).double()
    freq /= freq.sum()
    assert float((freq - 1 / 16).abs().max()) < 0.005


def test_symmetrize_keeps_smallest_duplicate():
    src = torch.tensor([0, 1, 2, 2, 3])
    dst = torch.tensor([1, 0, 2, 3, 2])
    w = torch.tensor([9, 4, 1, 7, 200])
    s, d, ww = generators.symmetrize(src, dst, w, 4)
    got = {(int(a), int(b)): int(c) for a, b, c in zip(s, d, ww)}
    assert got == {(0, 1): 4, (1, 0): 4, (2, 3): 7, (3, 2): 7}
