"""The port's plan tuner against ``repro``'s (``tests/test_autotune.py``'s
contracts).

Degree features and signatures are numpy and must equal the
reference's exactly.  The candidates keep the reference's block shapes
(``block_mult``, ``block_div``, ``gather_splits``) in its order, each
at every thread count of the card's axis.  Every candidate may only
trade time: through the plain versions of K1/K2 it reduces min/max and
int32 sums bit for bit like the plain scatter, float32 sums to 1e-6.
Measurement here goes through a patched timer, so that the choice is
deterministic; the real timer is the card's (CUDA events), held in
``tests/test_torch_cuda.py``.
"""
import json

import numpy as np
import pytest
import torch

import repro.kernels.autotune as jat
import repro_torch.kernels.autotune as at
from repro.graph import (powerlaw_graph, random_graph, regular_graph,
                         rmat_graph)
from repro_torch.algorithms import REGISTRY
from repro_torch.core import ALL_CONFIGS, PLAN_CACHE, SystemConfig, run
from repro_torch.core.executor import EdgeContext
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.kernels.segment_reduce import (DEFAULT_PLAN, TilingPlan,
                                                segment_reduce_ref)

CONFIG_NAMES = [c.name for c in ALL_CONFIGS]
GRAPHS = {
    "regular": lambda: regular_graph(300, 4, seed=5, block_size=32),
    "powerlaw": lambda: powerlaw_graph(400, 2400, alpha=1.2, seed=3,
                                       weighted=True, block_size=64),
    "powerlaw_skew": lambda: powerlaw_graph(600, 9000, alpha=2.1, seed=8,
                                            block_size=64),
    "rmat": lambda: rmat_graph(9, 8, seed=4, block_size=32),
    "rmat_256": lambda: rmat_graph(10, 8, seed=7),
}


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module", params=list(GRAPHS))
def pair(request):
    ref = GRAPHS[request.param]()
    return ref, _port(ref)


def _shapes(plans):
    out = []
    for p in plans:
        s = (p.block_mult, p.block_div, p.gather_splits)
        if s not in out:
            out.append(s)
    return out


def test_features_and_signature_equal_the_reference(pair):
    ref, port = pair
    got, want = at.degree_features(port), jat.degree_features(ref)
    assert got == want
    assert at.degree_signature(port) == jat.degree_signature(ref)
    assert at.degree_signature(got) == jat.degree_signature(want)


@pytest.mark.parametrize("max_candidates", [2, 6])
@pytest.mark.parametrize("order", ["owned", "pull", "gathered"])
def test_candidates_keep_the_reference_shapes_and_order(pair, order,
                                                        max_candidates):
    ref, port = pair
    feats = at.degree_features(port)
    got = at.candidate_plans(features=feats, order=order,
                             max_candidates=max_candidates)
    want = jat.candidate_plans(features=jat.degree_features(ref),
                               order=order, max_candidates=max_candidates)
    assert got[0].astuple() == DEFAULT_PLAN.astuple()
    assert _shapes(got) == _shapes(want)
    if order == "gathered":
        assert [p.astuple() for p in got] == [p.astuple() for p in want]
        return
    # the card's thread axis on every block shape, nothing else
    assert len({p.astuple() for p in got}) == len(got)
    for shape in _shapes(got):
        threads = sorted(p.tile_e for p in got
                         if (p.block_mult, p.block_div,
                             p.gather_splits) == shape)
        assert threads == sorted(at.THREADS)


@pytest.mark.parametrize("order", ["owned", "pull", "gathered"])
def test_suggest_plan_keeps_the_reference_shape(pair, order):
    ref, port = pair
    got = at.suggest_plan(at.degree_features(port), order)
    want = jat.suggest_plan(jat.degree_features(ref), order)
    assert (got.block_mult, got.block_div, got.gather_splits) == \
        (want.block_mult, want.block_div, want.gather_splits)
    assert got.tile_e == (DEFAULT_PLAN.tile_e if order == "gathered"
                          else at.HEURISTIC_THREADS)


@pytest.mark.parametrize("order", ["owned", "pull"])
def test_every_candidate_reduces_like_the_oracle(pair, order):
    """K1/K2's plain versions under every candidate plan against one
    plain scatter, bit for bit: min/max of float32 and int32, int32
    sums, and float32 sums of integer values (exact in any order); a
    float32 sum of fractions of one scale to 1e-6."""
    _, g = pair
    rng = np.random.default_rng(1)
    ids = np.asarray(g.dst)[np.asarray(g.perm_owned)] if order == "owned" \
        else np.asarray(g.dst_in)
    ids = torch.from_numpy(ids.astype(np.int64))
    f32 = torch.from_numpy(rng.standard_normal(g.n_edges).astype(np.float32))
    f32_int = torch.from_numpy(rng.integers(-32, 32, g.n_edges)
                               .astype(np.float32))
    f32_small = torch.from_numpy(rng.random(g.n_edges).astype(np.float32)
                                 / np.float32(1024))
    i32 = torch.from_numpy(rng.integers(-50, 50, g.n_edges).astype(np.int32))
    for plan in at.candidate_plans(g, order=order):
        red = at.build_reducer(g, order, plan, device="cpu")
        assert red.plan == plan and red.tile_e == plan.tile_e
        for vals, kinds in ((f32, ("min", "max")),
                            (f32_int, ("sum", "min", "max")),
                            (i32, ("sum", "min", "max"))):
            for kind in kinds:
                got = red.reduce(vals, kind)
                want = segment_reduce_ref(vals, ids, g.n_nodes, kind)
                assert torch.equal(got, want), (plan, kind, vals.dtype)
        torch.testing.assert_close(
            red.reduce(f32_small, "sum"),
            segment_reduce_ref(f32_small, ids, g.n_nodes, "sum"),
            rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
def _fake_timer(monkeypatch, table=None):
    """Patch the timer: each plan's seconds from ``table`` (default: the
    fastest is 256 threads at the largest block shape), and a list of
    the plans timed."""
    timed = []

    def fake(graph, plan, order="owned", **kw):
        timed.append(plan)
        if table is not None:
            return table(plan)
        return (1.0 + abs(plan.tile_e - 256) / 1024
                - 0.01 * plan.block_mult - 0.01 * plan.block_div
                - 0.001 * plan.gather_splits)

    monkeypatch.setattr(at, "measure_plan", fake)
    return timed


def test_tune_picks_the_fastest_and_keeps_the_default_within_margin(
        monkeypatch):
    g = _port(powerlaw_graph(400, 2400, alpha=1.2, seed=3, block_size=64))
    timed = _fake_timer(monkeypatch)
    r = at.tune(g, order="pull", device="cpu")
    assert [p.astuple() for p in timed] == \
        [p.astuple() for p in at.candidate_plans(g, order="pull")]
    best = min(r.measurements, key=lambda ps: ps[1])[0]
    assert r.plan.astuple() == best.astuple() and r.plan.source == "tuned"
    assert r.plan.tile_e == 256 and r.speedup_vs_default > 1.0
    # within 2 % of the default: the default stays
    _fake_timer(monkeypatch, lambda p: 1.0 if p == DEFAULT_PLAN else 0.99)
    r = at.tune(g, order="owned", device="cpu")
    assert r.plan == DEFAULT_PLAN and r.speedup_vs_default == 1.0
    assert r.best_seconds == 0.99 and r.default_seconds == 1.0


def test_tune_skips_plans_the_shared_memory_cannot_hold(monkeypatch):
    g = _port(random_graph(8192, 400, seed=1))
    _fake_timer(monkeypatch)
    cands = at.candidate_plans(g, order="owned")
    assert any(p.block_mult > 1 for p in cands)
    r = at.tune(g, order="owned", d=48, device="cpu")
    assert r.measurements
    assert all(p.block_size(256) * 48 * 4 <= at.SMEM_LIMIT
               for p, _ in r.measurements)


def test_measure_plan_times_the_plain_versions_on_the_cpu():
    g = _port(regular_graph(128, 4, seed=5))
    for order in ("owned", "pull", "gathered"):
        s = at.measure_plan(g, at.candidate_plans(g, order=order)[-1],
                            order=order, repeats=2, device="cpu")
        assert 0.0 < s < 10.0


class TestDiskCache:
    def test_round_trip_and_warm_hit_on_signature(self, tmp_path,
                                                  monkeypatch):
        path = tmp_path / "autotune_cache.json"
        g1 = _port(powerlaw_graph(400, 2400, alpha=1.2, seed=3))
        g2 = _port(powerlaw_graph(400, 2400, alpha=1.2, seed=4))
        assert at.degree_signature(g1) == at.degree_signature(g2)
        timed = _fake_timer(monkeypatch)
        p1 = at.autotune_plan(g1, order="pull", cache_path=path,
                              device="cpu")
        assert p1.source == "tuned" and timed
        entries = at.load_disk_cache(path)
        (key, entry), = entries.items()
        assert key.endswith("|cpu") and entry["device"] == "cpu"
        assert json.loads(path.read_text())["version"] == 1
        n = len(timed)
        p2 = at.autotune_plan(g2, order="pull", cache_path=path,
                              device="cpu")
        assert len(timed) == n  # recalled, not measured
        assert p2.astuple() == p1.astuple() and p2.source == "disk"

    def test_corrupt_file_is_retuned(self, tmp_path, monkeypatch):
        path = tmp_path / "autotune_cache.json"
        path.write_text("{not json")
        assert at.load_disk_cache(path) == {}
        _fake_timer(monkeypatch)
        plan = at.autotune_plan(_port(regular_graph(128, 4, seed=5)),
                                cache_path=path, device="cpu")
        assert isinstance(plan, TilingPlan) and at.load_disk_cache(path)

    def test_stores_merge(self, tmp_path):
        path = tmp_path / "c.json"
        at.store_disk_entry("a", {"tile_e": 128}, path=path)
        at.store_disk_entry("b", {"tile_e": 256}, path=path)
        assert set(at.load_disk_cache(path)) == {"a", "b"}

    def test_none_disables_the_disk(self, tmp_path, monkeypatch):
        monkeypatch.setattr(at, "DEFAULT_CACHE_PATH",
                            str(tmp_path / "autotune_cache.json"))
        _fake_timer(monkeypatch)
        plan = at.autotune_plan(_port(regular_graph(128, 4, seed=6)),
                                cache_path=None, device="cpu")
        assert isinstance(plan, TilingPlan)
        assert not (tmp_path / "autotune_cache.json").exists()

    def test_default_path_is_the_ports_own(self):
        assert at.DEFAULT_CACHE_PATH == "results/torch/autotune_cache.json"
        assert at.DEFAULT_CACHE_PATH != jat.DEFAULT_CACHE_PATH

    def test_unwritable_path_does_not_crash_a_run(self, tmp_path,
                                                  monkeypatch):
        monkeypatch.chdir(tmp_path)
        (tmp_path / "results").write_text("not a directory")
        _fake_timer(monkeypatch)
        g = _port(powerlaw_graph(220, 2200, alpha=1.6, seed=10,
                                 weighted=True))
        r = run(REGISTRY["BFS"](), g, SystemConfig.from_name("TD0"),
                use_kernels=True, autotune="measure", device="cpu")
        assert r.converged and (tmp_path / "results").is_file()

    def test_fresh_checkout_creates_the_cache(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        _fake_timer(monkeypatch)
        g = _port(powerlaw_graph(220, 2200, alpha=1.6, seed=9,
                                 weighted=True))
        r = run(REGISTRY["BFS"](), g, SystemConfig.from_name("TD0"),
                use_kernels=True, autotune=True, device="cpu")
        assert r.converged
        assert at.load_disk_cache(tmp_path / at.DEFAULT_CACHE_PATH)


def test_per_kind_counters(tmp_path, monkeypatch):
    PLAN_CACHE.clear()
    assert PLAN_CACHE.stats()["by_kind"] == {}
    _fake_timer(monkeypatch)
    g = _port(regular_graph(128, 4, seed=7))
    for _ in range(2):
        at.autotune_plan(g, cache_path=tmp_path / "c.json", device="cpu")
    assert PLAN_CACHE.stats()["by_kind"]["tuned_tiling"] == {
        "hits": 1, "misses": 1, "entries": 1}
    assert PLAN_CACHE.kind_stats("never") == {"hits": 0, "misses": 0,
                                              "entries": 0}
    PLAN_CACHE.clear()
    assert PLAN_CACHE.stats()["by_kind"] == {}


# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def knob_graph():
    return _port(powerlaw_graph(260, 2600, alpha=1.6, seed=4, weighted=True))


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("mode", ["heuristic", "measure"])
def test_results_invariant_under_autotune(knob_graph, cfg, mode,
                                          monkeypatch, tmp_path):
    monkeypatch.setattr(at, "DEFAULT_CACHE_PATH", str(tmp_path / "c.json"))
    _fake_timer(monkeypatch)
    program, config = REGISTRY["BFS"](), SystemConfig.from_name(cfg)
    base = run(program, knob_graph, config, use_kernels=True, device="cpu")
    tuned = run(program, knob_graph, config, use_kernels=True,
                autotune=mode, device="cpu")
    assert (tuned.iterations, tuned.direction_trace, tuned.occupancy_trace) \
        == (base.iterations, base.direction_trace, base.occupancy_trace)
    for k, v in base.state.items():
        assert torch.equal(tuned.state[k], v), k


def test_a_tuned_and_an_untuned_run_capture_two_graphs(knob_graph):
    """The fused engine's key holds the resolved plans: a tuned run on
    the graph and program of an untuned one must not replay the graph
    built over the default reducers."""
    cfg = SystemConfig.from_name("TD0")
    program = REGISTRY["BFS"]()
    PLAN_CACHE.clear()
    base = EdgeContext.create(knob_graph, cfg, use_kernels=True,
                              device="cpu")
    heur = EdgeContext.create(knob_graph, cfg, use_kernels=True,
                              autotune="heuristic", device="cpu")
    assert heur is not base
    assert heur is EdgeContext.create(knob_graph, cfg, use_kernels=True,
                                      autotune="heuristic", device="cpu")
    assert heur.plan_signature != base.plan_signature
    r1 = run(program, knob_graph, cfg, use_kernels=True, device="cpu")
    assert PLAN_CACHE.kind_stats("exec_fn")["entries"] == 1
    r2 = run(program, knob_graph, cfg, use_kernels=True,
             autotune="heuristic", device="cpu")
    fns = PLAN_CACHE.kind_stats("exec_fn")
    assert fns["entries"] == 2 and fns["hits"] == 0
    engines = [v[1] for k, v in PLAN_CACHE._store.items()
               if k[1] == "exec_fn"]
    assert {e.ctx.plan_signature for e in engines} == \
        {base.plan_signature, heur.plan_signature}
    assert r1.direction_trace == r2.direction_trace
    assert torch.equal(r1.state["depth"], r2.state["depth"])


def test_bad_mode_raises(knob_graph):
    with pytest.raises(ValueError, match="autotune"):
        run(REGISTRY["BFS"](), knob_graph, SystemConfig.from_name("SG0"),
            autotune="turbo", device="cpu")
    with pytest.raises(ValueError, match="autotune"):
        at.autotune_plan(knob_graph, mode="turbo", device="cpu")
