"""The generators: determinism, the graphs bit for bit as the files
in ``graphs/`` first made them, the Kronecker quadrant probabilities,
the random geometric graph against brute force, and the symmetrised,
loop-free, duplicate-free edge list."""
import hashlib
import json
import math

import numpy as np
import pytest
import torch

from perfbench import generators
from perfbench.graphs import kron, rgg, urand
from perfbench.tests.conftest import ROOT, small_cell


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
    src, dst = kron.kron_edges(1, 1 << 17, 0.57, 0.19, 0.19, gen, "cpu")
    quad = (src * 2 + dst).numpy()
    freq = np.bincount(quad, minlength=4) / quad.shape[0]
    np.testing.assert_allclose(freq, [0.57, 0.19, 0.19, 0.05], atol=0.003)


def test_kron_bits_are_levels():
    """Every level sets its own bit: at scale s the endpoints fill
    [0, 2**s) and vertex 0 (all bits in quadrant A) is the densest."""
    gen = torch.Generator().manual_seed(4)
    src, dst = kron.kron_edges(6, 64, 0.57, 0.19, 0.19, gen, "cpu")
    assert int(src.max()) < 64 and int(dst.max()) < 64
    deg = torch.bincount(torch.cat([src, dst]), minlength=64)
    assert int(deg.argmax()) == 0


def test_urand_uniform():
    gen = torch.Generator().manual_seed(5)
    src, dst = urand.urand_edges(4, 1 << 12, gen, "cpu")
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


#: sha256 over ``src``, ``dst``, ``weight`` and ``sources`` (int64) of
#: ``generate(cfg, seed, 8, "cpu")``, as the generators made them before
#: they moved to ``graphs/``: every benchmark graph stays bit for bit.
DIGESTS = [
    ("gap-kron-s19", 8, 1,
     "b52f3909f76baede03d649ca67d326f5d60d470cbf39fd1e8e5e22e08a18109b"),
    ("gap-kron-s19", 8, 2**31 + 5,
     "c5b5fd9f20cfaf225e7e849f16da78d191e8688e614bd483e10407ad306c353e"),
    ("gap-kron-s19", 12, 1,
     "f558dfca37abe96a095167b5e9959a08c881ffe0426896a1c9353786dfd16f6a"),
    ("gap-kron-s19", 12, 2**31 + 5,
     "7c2f3782dd3abb7ad2bbd60cb5be5db05bd45c728f88cde1e5aeb235e191766b"),
    ("gap-urand-s19", 8, 1,
     "1e0a13dc9a180f123522e140dddb07af906804515c73c557b1d90012b3001735"),
    ("gap-urand-s19", 8, 2**31 + 5,
     "d21ceeaa84c3a0d9f2be0f46352440a5011dfab38359fa9415bd9c45d6a3071f"),
    ("gap-urand-s19", 12, 1,
     "e9d1a071a715a573e47a99f1b4327d931b9db730426e8104358d3ad6f196b9a5"),
    ("gap-urand-s19", 12, 2**31 + 5,
     "313de2f17065c45bece5352f8f07519b5106b003b64fa3101c3d95a8e1b5b459"),
]


def _config(name, **changes):
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    return {**cfg, **changes}


@pytest.mark.parametrize("name,scale,seed,digest", DIGESTS)
def test_graphs_unchanged_bit_for_bit(name, scale, seed, digest):
    g = generators.generate(_config(name, scale=scale), seed, 8, "cpu")
    h = hashlib.sha256()
    for a in (g.src, g.dst, g.weight, np.asarray(g.sources, np.int64)):
        h.update(np.ascontiguousarray(a).tobytes())
    assert h.hexdigest() == digest


def test_missing_generator_file_is_named():
    cfg = {**_config("gap-urand-s19", scale=4), "generator": "no_such"}
    with pytest.raises(FileNotFoundError, match="graphs/no_such.py"):
        generators.generate(cfg, 1, 0, "cpu")


RGG = {"generator": "rgg", "radius_coef": 0.55, "weights": [1, 255],
       "structure_seed": 1}


def _rgg(scale, seed=1, **kw):
    gen = torch.Generator().manual_seed(seed)
    return rgg.edges({**RGG, "scale": scale}, gen, "cpu", **kw)


@pytest.mark.parametrize("max_candidates", [rgg.MAX_CANDIDATES, 1000])
def test_rgg_equals_brute_force(max_candidates):
    """At n = 2**10 the edge set is every pair closer than r, each once
    as (i, j) with i < j, whether the candidates go in one chunk or in
    many."""
    n = 1 << 10
    src, dst = _rgg(10, max_candidates=max_candidates)
    gen = torch.Generator().manual_seed(1)
    pts = torch.rand((n, 2), generator=gen, dtype=torch.float64)
    r = 0.55 * math.sqrt(math.log(n) / n)
    i, j = torch.triu_indices(n, n, offset=1)
    dx = pts[i, 0] - pts[j, 0]
    dy = pts[i, 1] - pts[j, 1]
    close = dx * dx + dy * dy < r * r
    want = sorted(zip(i[close].tolist(), j[close].tolist()))
    got = list(zip(src.tolist(), dst.tolist()))
    assert (src < dst).all() and len(set(got)) == len(got)
    assert sorted(got) == want and len(want) > 2000


def test_rgg_mean_degree():
    """At n = 2**14 the mean degree is within 3 % of (n - 1) times the
    chance that two uniform points of the unit square lie within r:
    pi r**2 less the border's loss, 8 r**3 / 3 - r**4 / 2."""
    n = 1 << 14
    src, _ = _rgg(14, seed=2)
    r = rgg.radius({**RGG, "scale": 14})
    want = (n - 1) * (math.pi * r**2 - 8 * r**3 / 3 + r**4 / 2)
    assert abs(2 * src.shape[0] / n - want) < 0.03 * want


def test_rgg_same_seed_same_graph():
    a, b, c = _rgg(12, seed=3), _rgg(12, seed=3), _rgg(12, seed=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0][:1000], c[0][:1000])


def test_rgg_weights_after_generate():
    """After ``generate()`` both directions of a pair carry one weight,
    and the weights are uniform in [1, 255]: mean 128 +- 2."""
    g = generators.generate({**RGG, "scale": 14}, 2**31 + 5, 8, "cpu")
    assert g.n_nodes == 1 << 14 and (g.src != g.dst).all()
    key = g.src * g.n_nodes + g.dst
    back = dict(zip(key.tolist(), g.weight.tolist()))
    assert len(back) == g.n_edges
    for s, d, w in zip(g.src, g.dst, g.weight):
        assert back[int(d) * g.n_nodes + int(s)] == w
    assert abs(float(g.weight.mean()) - 128) < 2
    assert g.weight.min() >= 1 and g.weight.max() <= 255
