"""The port's taxonomy (Eqs. 1-7) and its datasets module against
``repro``'s.

Both packages profile the very same graphs: the Table II stand-ins,
which ``paper_graph`` builds from the same ``hash(name)`` seed within
this process, and generator graphs carried across with
``graph_from_arrays``.  Every figure is float64 numpy on the host in
both, so the port's must equal the reference's exactly, under the
paper's GPU and under the H100 profile (handed to the reference as an
``HwProfile`` of the same numbers).
"""
import dataclasses
import gzip

import numpy as np
import pytest

import repro.core.taxonomy as jtax
import repro.graph as jgraph
import repro.graph.datasets as jds
import repro_torch.core.taxonomy as ttax
import repro_torch.graph.datasets as tds
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


#: the reference's HwProfile for each of the port's profiles
PROFILES = {"paper_gpu": (ttax.PAPER_GPU, jtax.PAPER_GPU),
            "h100": (ttax.H100,
                     jtax.HwProfile(**dataclasses.asdict(ttax.H100)))}

GENERATED = {
    "powerlaw": lambda: jgraph.powerlaw_graph(
        1500, 9000, alpha=1.2, max_degree=200, locality=0.3, seed=3,
        block_size=64),
    "powerlaw_sorted": lambda: jgraph.powerlaw_graph(
        1200, 6000, alpha=1.2, max_degree=90, locality=0.21,
        degree_order="sorted", seed=5),
    "regular": lambda: jgraph.regular_graph(800, 4, locality=0.5, seed=1),
    "rmat": lambda: jgraph.rmat_graph(10, 8, seed=7, block_size=64),
}


def _graph_pair(kind, name):
    if kind == "paper":
        return (tds.paper_graph(name, scale=64, block_size=64),
                jds.paper_graph(name, scale=64, block_size=64))
    ref = GENERATED[name]()
    return _port(ref), ref


CASES = [("paper", n) for n in jds.PAPER_GRAPHS] + \
    [("generated", n) for n in GENERATED]


@pytest.mark.parametrize("hw", list(PROFILES))
@pytest.mark.parametrize("kind,name", CASES)
def test_equations_equal_the_reference(kind, name, hw):
    port, ref = _graph_pair(kind, name)
    thw, jhw = PROFILES[hw]
    assert ttax.volume_kb(port.n_nodes, port.n_edges, thw) == \
        jtax.volume_kb(ref.n_nodes, ref.n_edges, jhw)
    assert ttax.an_local_remote(port, thw.tb_size) == \
        jtax.an_local_remote(ref, jhw.tb_size)
    assert ttax.reuse(port, thw) == jtax.reuse(ref, jhw)
    assert ttax.imbalance(port, thw) == jtax.imbalance(ref, jhw)
    assert dataclasses.astuple(ttax.profile_graph(port, thw)) == \
        dataclasses.astuple(jtax.profile_graph(ref, jhw))


@pytest.mark.parametrize("kind,name", CASES)
def test_profile_graph_defaults_to_the_papers_gpu(kind, name):
    port, ref = _graph_pair(kind, name)
    assert ttax.profile_graph(port) == ttax.profile_graph(port,
                                                          ttax.PAPER_GPU)
    assert dataclasses.astuple(ttax.profile_graph(port)) == \
        dataclasses.astuple(jtax.profile_graph(ref))


def test_kmeans_equals_the_reference():
    rng = np.random.default_rng(0)
    for values in (rng.integers(0, 300, size=8).astype(np.float64),
                   rng.pareto(1.2, size=8) * 40, np.full(8, 3.0),
                   np.array([0, 0, 0, 0, 0, 0, 0, 500.0])):
        assert ttax._kmeans2(values) == jtax._kmeans2(values)


def test_thresholds_and_classifiers_equal_the_reference():
    assert dataclasses.asdict(ttax.PAPER_GPU) == \
        dataclasses.asdict(jtax.PAPER_GPU)
    for x in (0.0, 0.04, 0.05, 0.15, 0.2, 0.25, 0.4, 0.41, 1.0):
        assert ttax.classify_reuse(x) == jtax.classify_reuse(x)
        assert ttax.classify_imbalance(x) == jtax.classify_imbalance(x)
    for kb in (10.0, 47.9, 48.0, 200.0, 273.0, 274.0, 2000.0):
        for hw in PROFILES:
            thw, jhw = PROFILES[hw]
            assert ttax.classify_volume_kb(kb, thw) == \
                jtax.classify_volume_kb(kb, jhw)


@pytest.mark.parametrize("name", sorted(tds.PAPER_STATS))
def test_table_ii_classes_from_the_published_numbers(name):
    """Volume from the published |V|, |E|; Reuse from the published
    AN_L, AN_R; Imbalance from the published figure; all under the
    paper's GPU."""
    v, e, _, avg, vol, _, imb, vc, rc, ic = tds.PAPER_STATS[name]
    kb = ttax.volume_kb(v, e, ttax.PAPER_GPU)
    assert kb == pytest.approx(vol, rel=5e-3)
    assert ttax.classify_volume_kb(kb, ttax.PAPER_GPU) == vc
    r = ttax.reuse_from_an(*tds.PAPER_AN[name], avg)
    assert ttax.classify_reuse(r, ttax.PAPER_GPU) == rc
    assert ttax.classify_imbalance(imb, ttax.PAPER_GPU) == ic


def test_h100_volume_knees():
    assert ttax.H100.vol_low_kb == 384.0
    assert ttax.H100.vol_high_kb == pytest.approx(387.88, abs=5e-3)
    assert (ttax.H100.n_cores, ttax.H100.tb_size) == (132, 256)


@pytest.mark.parametrize("name", sorted(tds.PAPER_STATS))
def test_every_table_ii_input_is_volume_l_on_the_h100(name):
    v, e = tds.PAPER_STATS[name][:2]
    kb = ttax.volume_kb(v, e, ttax.H100)
    assert kb < 210.82  # AMZ, the largest, is 210.8 KB per SM
    assert ttax.classify_volume_kb(kb, ttax.H100) == "L"


# ---------------------------------------------------------------------------
# the datasets module
# ---------------------------------------------------------------------------
def test_dataset_tables_equal_the_reference():
    assert tds.PAPER_STATS == jds.PAPER_STATS
    assert tds.PAPER_AN == jds.PAPER_AN
    assert tds.PAPER_SOURCES == jds.PAPER_SOURCES
    assert tds.DEGREE_PROFILES == jds.DEGREE_PROFILES
    assert tds.fetch_instructions() == jds.fetch_instructions()
    assert tds.fetch_instructions("AMZ") == jds.fetch_instructions("AMZ")


@pytest.mark.parametrize("kind,name", CASES)
def test_degree_profile_equals_the_reference(kind, name):
    port, ref = _graph_pair(kind, name)
    assert tds.degree_profile(port) == jds.degree_profile(ref)


def _write_inputs(root):
    rng = np.random.default_rng(3)
    src = rng.integers(0, 40, size=120) * 7 + 3  # sparse ids, compacted
    dst = rng.integers(0, 40, size=120) * 7 + 3
    w = rng.uniform(0.5, 2.0, size=120)
    rows = "\n".join(f"{s} {d} {x:.4f}" for s, d, x in zip(src, dst, w))
    (root / "AMZ.txt").write_text("# comment\n" + rows + "\n")
    mtx = "\n".join(f"{s + 1} {d + 1} {x:.4f}"
                    for s, d, x in zip(src % 50, dst % 50, w))
    with gzip.open(root / "RAJ.mtx.gz", "wt") as fh:
        fh.write("%%MatrixMarket matrix coordinate real general\n"
                 f"50 50 {len(src)}\n" + mtx + "\n")


@pytest.mark.parametrize("weighted", [False, True])
def test_local_files_load_as_in_the_reference(tmp_path, monkeypatch,
                                              weighted):
    _write_inputs(tmp_path)
    monkeypatch.setenv("REPRO_DATA_DIR", str(tmp_path))
    for name in ("AMZ", "RAJ"):
        assert tds.real_graph_path(name) == jds.real_graph_path(name)
        port, src = tds.dataset_graph(name, weighted=weighted, block_size=16)
        ref, jsrc = jds.dataset_graph(name, weighted=weighted, block_size=16)
        assert src == jsrc == "real"
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(port, f)),
                                          np.asarray(getattr(ref, f)), f)
    assert tds.real_graph_path("OLS") is None
    g, src = tds.dataset_graph("OLS", scale=256, block_size=64)
    assert src == "synthetic" and g is tds.paper_graph(
        "OLS", scale=256, weighted=False, block_size=64)
    g, src = tds.dataset_graph("AMZ", scale=256, block_size=64,
                               prefer_real=False)
    assert src == "synthetic"


def test_empty_file_is_refused(tmp_path):
    (tmp_path / "x.txt").write_text("# nothing\n")
    with pytest.raises(ValueError, match="no edges"):
        tds.load_real_graph(tmp_path / "x.txt")
