"""The last public names of ``repro`` the port gained, each against the
reference on the same numpy inputs: ``GraphStats``/``graph_stats``,
``frontier_density``, the process-wide ``STATS`` counter,
``gathered_segment_reduce_ref``, ``ORDERS``, ``Dtypes``, every config
module's ``arch(axes)``, the packages' exports, the batch and resilience
smoke workloads' paths, the serve harness's interleaved windows and
``examples/lm_demo_torch.py``.  Last, an ``ast`` walk over every file
pair of the two packages: the public top-level names the port lacks are
exactly the ones listed below as not to port, each with its reason.
"""
import ast
import dataclasses
import functools
import importlib
import importlib.util
import io
import json
import math
import os
import sys
import threading
import types
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.graph as jgraph
import repro_torch.core as tcore
import repro_torch.graph as tgraph

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"

#: public top-level names of ``repro`` that the port does not carry, by
#: file, each with its reason
NOT_TO_PORT = {
    "core/__init__.py": {"TPU_V5E": "the TPU's profile; the port has H100"},
    "core/taxonomy.py": {"TPU_V5E": "the TPU's profile; the port has H100"},
    "kernels/embedding_bag/__init__.py": {
        "embedding_bag_pallas": "the Pallas kernel; the port has embag"},
    "kernels/embedding_bag/kernel.py": {
        "embedding_bag_pallas": "the Pallas kernel; the port has embag"},
    "kernels/segment_reduce/kernel.py": {
        "seg_sum_pallas": "the Pallas kernel; the port has seg_sum",
        "seg_minmax_pallas": "the Pallas kernel; the port has seg_minmax"},
    "kernels/segment_reduce/ops.py": {
        "plan_tiles": "the TPU's tile plan, imported here by the reference; "
                      "the port's reducer takes its chunk plan",
        "seg_sum_pallas": "the Pallas kernel", "seg_minmax_pallas":
        "the Pallas kernel"},
    "models/layers.py": {
        "blocked_attention_xla": "XLA's blocked attention; the port has "
                                 "blocked_attention"},
    "models/mesh_compat.py": {
        "active_abstract_mesh": "JAX's abstract mesh; the port has "
                                "active_device_mesh"},
    "launch/dryrun.py": {
        n: "the HLO text's regexes and sizes; the port's dry run counts "
           "through RankTrace" for n in (
               "COLLECTIVE_RE", "DOC", "DTYPE_BYTES", "SHAPE_RE",
               "collective_stats", "shape_bytes")},
    "launch/perf.py": {
        n: "the HLO text's computations; the port attributes each "
           "collective through RankTrace (--dump-trace)" for n in (
               "COLL_KINDS", "DTYPE_BYTES", "SHAPE_RE", "shape_bytes",
               "split_computations", "while_bodies")},
}


@pytest.fixture
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- graph_stats -------------------------------------------------------------
GENERATORS = {
    "powerlaw": ("powerlaw_graph", (400, 2400), dict(alpha=1.0, seed=3)),
    "powerlaw_sorted": ("powerlaw_graph", (300, 2000),
                        dict(alpha=1.2, max_degree=40, locality=0.21,
                             degree_order="sorted", seed=5)),
    "regular": ("regular_graph", (96, 4), dict(locality=0.4, seed=1)),
    "random": ("random_graph", (64, 400), dict(seed=0)),
    "rmat": ("rmat_graph", (8,), dict(seed=4)),
    "grid": ("grid_graph", (7,), dict(seed=0)),
}


@pytest.mark.parametrize("gen", list(GENERATORS))
def test_graph_stats_is_the_references(gen):
    fn, args, kw = GENERATORS[gen]
    ref = jgraph.graph_stats(getattr(jgraph, fn)(*args, **kw))
    port_g = getattr(tgraph, fn)(*args, **kw)
    for g in (port_g, port_g.to("cpu")):  # host arrays and tensors
        got = tgraph.graph_stats(g)
        assert got.as_dict == ref.as_dict  # equal, not close
        assert type(got.avg_degree) is float and type(got.max_degree) is int
    assert [f.name for f in dataclasses.fields(tgraph.GraphStats)] == \
        [f.name for f in dataclasses.fields(jgraph.GraphStats)]


# --- frontier_density --------------------------------------------------------
@pytest.mark.parametrize("seed", range(6))
def test_frontier_density_is_the_references_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 3000))
    deg = rng.integers(0, 500, n).astype(np.int32)
    mask = rng.random(n) < rng.random()
    for n_edges in (int(deg.sum()), int(rng.integers(1, 10**7)), 0):
        want = np.asarray(jcore.frontier_density(
            jnp.asarray(mask), jnp.asarray(deg), n_edges))
        got = tcore.frontier_density(torch.from_numpy(mask),
                                     torch.from_numpy(deg), n_edges)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert got.numpy().view(np.uint32) == want.view(np.uint32)


# --- STATS -------------------------------------------------------------------
def _port_graph():
    return tgraph.powerlaw_graph(400, 2400, alpha=1.0, seed=3,
                                 weighted=True, block_size=64)


def test_stats_counts_host_steps_as_the_reference(one_torch_thread):
    """The host engine: one dispatch per iteration in both packages."""
    from repro.algorithms import bfs as jbfs
    from repro_torch.algorithms import bfs
    jg = jgraph.powerlaw_graph(400, 2400, alpha=1.0, seed=3, weighted=True,
                               block_size=64)
    cfg = "DD1"
    jcore.STATS.reset()
    want = jcore.run(jbfs(), jg, jcore.SystemConfig.from_name(cfg),
                     engine="host")
    tcore.STATS.reset()
    got = tcore.run(bfs(), _port_graph(), tcore.SystemConfig.from_name(cfg),
                    engine="host", device="cpu")
    assert got.iterations == want.iterations
    assert tcore.STATS.dispatches == jcore.STATS.dispatches == \
        got.dispatches == got.iterations


@pytest.mark.parametrize("app,cfg", [("BFS", "SD1"), ("PR", "TG0"),
                                     ("SSSP", "DG1")])
def test_stats_counts_fused_replays(app, cfg, one_torch_thread):
    """The fused engine: one dispatch per replay, ``ceil(iterations /
    STEPS_PER_LAUNCH)``, where the reference counts its one
    ``while_loop``; the capture is not counted."""
    from repro_torch.algorithms import REGISTRY
    from repro_torch.core.capture import STEPS_PER_LAUNCH
    g, program = _port_graph(), REGISTRY[app]()
    config = tcore.SystemConfig.from_name(cfg)
    tcore.STATS.reset()
    total = 0
    for _ in range(2):  # the first run captures, the second replays
        before = tcore.STATS.dispatches
        res = tcore.run(program, g, config, device="cpu")
        assert tcore.STATS.dispatches - before == res.dispatches == \
            -(-res.iterations // STEPS_PER_LAUNCH)
        total += res.dispatches
    assert tcore.STATS.dispatches == total
    tcore.STATS.reset()
    assert tcore.STATS.dispatches == 0


def test_stats_counts_a_batch_once_per_replay(one_torch_thread):
    from repro_torch.algorithms import bfs
    from repro_torch.core import run_batch_slice
    from repro_torch.core.batch import BatchedEdgeContext, pack_graphs
    graphs = tgraph.rmat_batch(4, 6, seed=7)
    config = tcore.SystemConfig.from_name("SD1")
    tcore.STATS.reset()
    rs = tcore.run_batch(bfs(), graphs, config, device="cpu")
    launches = {}  # per padding bucket: its batch's replays, shared
    for g, r in zip(graphs, rs):
        assert launches.setdefault(tcore.bucket_key(g), r.dispatches) == \
            r.dispatches
    assert tcore.STATS.dispatches == sum(launches.values()) > 0

    batch = pack_graphs(graphs)
    bctx = BatchedEdgeContext(batch, config, device="cpu")
    program = bfs()
    state = batch.pack_state([{k: torch.as_tensor(v) for k, v in
                               program.init(g).items()} for g in graphs],
                             pad=program.state_pad)
    tcore.STATS.reset()
    sl = run_batch_slice(program, batch, bctx, state, np.zeros(4, np.int32),
                         np.zeros(4, bool), np.full(4, 100, np.int32), 8)
    assert tcore.STATS.dispatches == sl.dispatches > 0


def test_stats_counts_checkpointed_segments(one_torch_thread):
    from repro_torch.algorithms import pagerank
    tcore.STATS.reset()
    res = tcore.run(pagerank(), _port_graph(),
                    tcore.SystemConfig.from_name("TG0"), checkpoint_every=4,
                    device="cpu")
    assert res.resilience["segments"] > 1
    assert tcore.STATS.dispatches == res.dispatches > 0


def test_stats_add_is_safe_across_threads():
    """Gateway lanes run on threads: every increment lands, with more
    threads than cores and a short switch interval."""
    stats = tcore.ExecutorStats()
    n_threads, n = (os.cpu_count() or 4) + 2, 5_000

    def bump():
        for _ in range(n):
            stats.add(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert stats.dispatches == n_threads * n
    assert tcore.STATS.plan_cache() == tcore.PLAN_CACHE.stats()
    assert set(tcore.STATS.plan_cache()) == set(jcore.STATS.plan_cache())


# --- gathered_segment_reduce_ref ---------------------------------------------
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("seed", range(5))
def test_gathered_oracle_is_the_references(seed, kind):
    """The reference's cases (``test_sparse_frontier.py:145``), then int32
    values with ids past the segments, which both drop."""
    from repro.kernels.segment_reduce import \
        gathered_segment_reduce_ref as j_ref
    from repro_torch.kernels.segment_reduce import (
        gathered_segment_reduce, gathered_segment_reduce_ref)
    rng = np.random.default_rng(seed)
    n, segs = 64, 9
    cases = [(rng.integers(-1, segs, n).astype(np.int32),
              rng.normal(size=n).astype(np.float32)),
             (rng.integers(-3, segs + 3, n).astype(np.int32),
              rng.integers(-50, 50, n).astype(np.int32))]
    for ids, vals in cases:
        want = j_ref(vals, ids, segs, kind)
        got = gathered_segment_reduce_ref(vals, ids, segs, kind)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        port = gathered_segment_reduce(torch.from_numpy(vals),
                                       torch.from_numpy(ids), segs, kind)
        np.testing.assert_allclose(port.numpy(), got, rtol=1e-6)


def test_gathered_oracle_keeps_the_int_min_identity():
    from repro_torch.kernels.segment_reduce import gathered_segment_reduce_ref
    out = gathered_segment_reduce_ref(np.asarray([5], np.int32),
                                      np.asarray([-1], np.int32), 3, "min")
    assert out.tolist() == [np.iinfo(np.int32).max] * 3


# --- ORDERS, Dtypes, arch(axes) ----------------------------------------------
def test_orders_and_dtypes_are_the_references():
    from repro.kernels import autotune as jtune
    from repro.models import layers as jlayers
    from repro_torch.benchmarks import autotune as bench
    from repro_torch.kernels import autotune
    from repro_torch.models import layers
    assert autotune.ORDERS == jtune.ORDERS == bench.ORDERS
    got, want = layers.DEFAULT_DTYPES, jlayers.DEFAULT_DTYPES
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert str(getattr(got, f.name)) == \
            f"torch.{jnp.dtype(getattr(want, f.name)).name}"
    assert layers.Dtypes() == got


_PRODUCTION = types.SimpleNamespace(axis_names=("data", "model"),
                                    shape={"data": 16, "model": 16})


@pytest.mark.parametrize("axes", ["none", "production"])
@pytest.mark.parametrize("module", ["starcoder2_7b", "command_r_35b",
                                    "command_r_plus_104b",
                                    "qwen3_moe_235b_a22b", "grok_1_314b",
                                    "pna", "schnet", "meshgraphnet",
                                    "equiformer_v2", "dlrm_mlperf"])
def test_each_config_module_builds_its_arch(module, axes):
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import axes_for_mesh
    ref_mod = importlib.import_module(f"repro.configs.{module}")
    mod = importlib.import_module(f"repro_torch.configs.{module}")
    ax = None if axes == "none" else axes_for_mesh(_PRODUCTION)
    arch = mod.arch(ax)
    want = get_arch(arch.name, ax)
    assert arch.name == ref_mod.arch().name
    for f in ("name", "family", "cfg", "reduced_cfg", "init_params",
              "loss"):
        a, b = getattr(arch, f), getattr(want, f)
        if isinstance(a, functools.partial):  # equal by what they call
            a, b = (a.func, a.args, a.keywords), (b.func, b.args, b.keywords)
        assert a == b, f
    assert sorted(arch.cells) == sorted(want.cells)
    if ax is not None and arch.param_sharding is not None:
        assert arch.param_sharding(ax) == want.param_sharding(ax)


def test_packages_export_the_references_names():
    """``__all__`` of each package holds the reference's, less the names
    not to port."""
    for pkg in ("core", "graph", "configs", "kernels.segment_reduce"):
        ref = importlib.import_module(f"repro.{pkg}")
        port = importlib.import_module(f"repro_torch.{pkg}")
        skip = set(NOT_TO_PORT.get(pkg.replace(".", "/") + "/__init__.py",
                                   {}))
        missing = set(ref.__all__) - skip - set(port.__all__)
        assert not missing, (pkg, missing)
        for name in port.__all__:
            assert getattr(port, name) is not None


def _top_names(path: Path, imports: bool) -> set:
    """The public names a module's top level defines (functions, classes,
    assignments to a name), and with ``imports`` the ones it imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, ast.Tuple) else [t]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_is_ported_or_listed():
    """Each reference module's public top-level names, and each
    ``__init__``'s re-exports, are in its counterpart (defined or
    imported there), or listed above as not to port."""
    left = {}
    for ref in sorted((SRC / "repro").rglob("*.py")):
        rel = ref.relative_to(SRC / "repro").as_posix()
        port = SRC / "repro_torch" / rel
        assert port.exists(), rel
        want = _top_names(ref, imports=rel.endswith("__init__.py"))
        if rel.endswith("__init__.py"):
            want = {n for n in want if n not in ("jax", "numpy")}
        gap = want - _top_names(port, imports=True)
        gap -= set(NOT_TO_PORT.get(rel, {}))
        gap.discard("os")  # an ``os.environ[...] =`` at top level
        if gap:
            left[rel] = sorted(gap)
    assert not left, left
    # and every name listed is still missing, so the list stays true
    for rel, names in NOT_TO_PORT.items():
        port = _top_names(SRC / "repro_torch" / rel, imports=True)
        assert not set(names) & port, (rel, set(names) & port)


# --- the smoke paths and the serve harness's windows -------------------------
def test_a_smoke_record_never_lands_on_the_tracked_file(monkeypatch,
                                                         tmp_path):
    import repro_torch.benchmarks as benchmarks
    from repro_torch.benchmarks import batch, resilience
    monkeypatch.setattr(benchmarks, "SMOKE_DIR", tmp_path / "smoke")
    for mod in (batch, resilience):
        assert benchmarks.smoke_out(mod.OUT, mod.OUT) == \
            tmp_path / "smoke" / mod.OUT.name
        assert benchmarks.smoke_out(tmp_path / "x.json", mod.OUT) == \
            tmp_path / "x.json"
        assert benchmarks.smoke_out(None, mod.OUT) is None
    assert batch.SMOKE_WORKLOAD == dict(scale=5, edge_factor=8, seed=7)
    assert (batch.SMOKE_SIZES, batch.SMOKE_REPEATS) == ((1, 4), 2)
    assert (resilience.SMOKE_SCALE, resilience.SMOKE_REPEATS) == (9, 5)


def _fake_serve(monkeypatch, captures):
    """The serve harness over fake serial and gateway windows: each
    gateway window's rate and captures are drawn in turn; the window
    kinds are appended to the returned list as they run."""
    from repro_torch.benchmarks import serve
    order, draws = [], iter(captures)

    def solo(program, pool, config, repeats, device):
        order.append("solo")
        return [0.002] * len(pool)

    def gateway(kind):
        def window(*args):
            order.append(kind)
            rate, caught = next(draws)
            n = serve.SMOKE_WORKLOAD["requests"]
            return [0.01 * (1 + i % 7) for i in range(n)], rate, dict(
                mean_occupancy=1.0, slices=1, replays=1, roster_rebuilds=0,
                captures=caught)
        return window

    monkeypatch.setattr(serve, "_measure_solo", solo)
    monkeypatch.setattr(serve, "_gateway_closed", gateway("closed"))
    monkeypatch.setattr(serve, "_gateway_open", gateway("open"))
    return serve, order


def test_serve_bench_measures_serial_and_gateway_windows_in_turns(
        monkeypatch):
    """Every gateway window follows its own serial measurement, and each
    mode keeps the best of its pairs."""
    serve, order = _fake_serve(monkeypatch, [(300.0, 0), (100.0, 0),
                                             (500.0, 0), (90.0, 0)])
    rec = serve.run_serve_bench(out_path=None, smoke=True, repeats=2,
                                device="cpu")
    # a first serial measurement fixes the open loop's schedule
    assert ["solo"] + rec["windows"] == order
    assert rec["windows"] == ["solo", "closed", "solo", "open"] * 2
    for mode in ("closed", "open"):
        m = rec["modes"][mode]
        assert len(m["pairs"]) == 2
        assert m["throughput_speedup"] == max(
            p["throughput_speedup"] for p in m["pairs"])
        assert m["p99_gain"] == max(p["p99_gain"] for p in m["pairs"])


def test_serve_bench_reads_every_window_and_records_its_captures(
        monkeypatch):
    """A window that captured a roster's graph counts like any other (a
    cost a real stream pays); each pair records its captures, and no mode
    runs more than ``repeats`` windows."""
    serve, order = _fake_serve(monkeypatch, [(900.0, 1), (800.0, 3),
                                             (100.0, 0), (700.0, 0)])
    rec = serve.run_serve_bench(out_path=None, smoke=True, repeats=2,
                                device="cpu")
    assert rec["windows"] == ["solo", "closed", "solo", "open"] * 2
    c, o = rec["modes"]["closed"], rec["modes"]["open"]
    assert [p["captures"] for p in c["pairs"]] == [1, 0]
    assert [p["captures"] for p in o["pairs"]] == [3, 0]
    assert c["gateway"]["throughput_rps"] == 900.0  # it captured; it counts
    assert o["gateway"]["throughput_rps"] == 800.0
    assert rec["solo_repeats"] == serve.SOLO_REPEATS


# --- examples/lm_demo_torch.py -----------------------------------------------
def _load_script(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lm_demo_torch_trains_and_serves_on_the_cpu(one_torch_thread,
                                                     capsys):
    demo = _load_script("lm_demo_torch", ROOT / "examples" /
                        "lm_demo_torch.py")
    rec = demo.main(["--steps", "3", "--d-model", "64", "--layers", "2",
                     "--seq", "32", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == rec["summary"]
    assert last["steps"] == 3 and last["n_layers"] == 2
    assert math.isfinite(last["loss_first"]) and \
        math.isfinite(last["loss_last"])
    assert len(last["token_ids"]) == demo.GEN + 1
    assert last["k4_launches"] == 0  # the CPU runs K4's plain version


def test_lm_demo_torch_serves_the_reference_s_tokens(monkeypatch,
                                                      one_torch_thread):
    """From the reference's initial weights (its training skipped), the
    serve half decodes the tokens ``examples/lm_demo.py`` decodes: f32
    weights as in ``test_torch_lm_demo.py``, the bf16 cache of both."""
    from repro.models import transformer as JT
    from repro_torch.models.transformer import lm_params_from_jax
    ref = _load_script("lm_demo_ref", ROOT / "examples" / "lm_demo.py")
    demo = _load_script("lm_demo_torch", ROOT / "examples" /
                        "lm_demo_torch.py")
    base = ref.get_arch("starcoder2-7b")
    monkeypatch.setattr(ref, "get_arch", lambda name: types.SimpleNamespace(
        reduced_cfg=dataclasses.replace(base.reduced_cfg,
                                        param_dtype="float32")))
    monkeypatch.setattr(ref, "train_loop", lambda step, params, *a, **k:
                        (params, None, [{"loss": 0.0}]))
    monkeypatch.setattr(sys, "argv", ["lm_demo.py", "--d-model", "64",
                                      "--layers", "2"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        ref.main()
    line = [l for l in buf.getvalue().splitlines()
            if l.startswith("serve: decoded")][-1]
    want = json.loads(line[len("serve: decoded "):line.index("]") + 1])

    cfg = dataclasses.replace(demo.demo_config(64, 2), param_dtype="float32")
    jcfg = dataclasses.replace(base.reduced_cfg, param_dtype="float32",
                               **{f: getattr(cfg, f) for f in (
                                   "n_layers", "d_model", "n_heads",
                                   "n_kv_heads", "d_head", "d_ff", "vocab",
                                   "window")})
    params = lm_params_from_jax(
        jax.tree.map(np.asarray, JT.init_lm(jax.random.key(0), jcfg)), cfg,
        device="cpu")
    got = demo.serve(cfg, params, torch.device("cpu"))
    assert got["token_ids"] == want
