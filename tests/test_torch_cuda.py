"""The port's CUDA kernels on the card (marker ``cuda``).

Every test here needs a CUDA device and ``nvcc``, and skips without
them.  It imports neither JAX nor ``repro``, so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels are held against their plain versions on the same inputs:
K1/K2 min, max and int32 sum bit-equal, the float32 sum to
rtol=atol=1e-5, since the kernel's shared-memory atomics add in an order
that changes from run to run (hubs, split blocks, empty blocks, float
specials, wrapping sums and dirty-scratch checks included); K3 bit-equal at P = 1 and to 1e-5 for
P > 1 and the mean (another order of the sum), and its table-batched call
bit-equal to single-table calls at any P (the same code per bag); K4 to atol 2e-3 in f32
and, in bf16, to one bf16 step of the output (rtol 2**-7) plus atol 1e-2
(online softmax against one pass, p rounded to bf16 at another running
max).
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import REGISTRY, bfs, pagerank, sssp
from repro_torch.core import PLAN_CACHE, SystemConfig, capture, run
from repro_torch.graph import powerlaw_graph
from repro_torch.kernels.embedding_bag import (MAX_TABLES, embag,
                                               embag_tables, embedding_bag_ref,
                                               embedding_bags_ref)
from repro_torch.kernels.embedding_bag.kernel import _library as embag_library
from repro_torch.kernels.flash_attention import (attention, flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.segment_reduce import (BlockedSegmentReducer,
                                                ChunkPlan, seg_minmax,
                                                seg_minmax_plain, seg_sum,
                                                seg_sum_plain)

SWEEP = [(1000, 300, 64, 1), (4096, 512, 128, 8), (777, 100, 32, 5),
         (64, 512, 128, 1), (2048, 64, 64, 16)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _binned(rng, e, v, b):
    raw = rng.integers(0, v, e)
    ids = raw[np.argsort(raw // b, kind="stable")]
    bp = np.zeros((v + b - 1) // b + 1, np.int64)
    np.add.at(bp, raw // b + 1, 1)
    return ids.astype(np.int32), np.cumsum(bp).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("e,v,b,d", SWEEP)
@pytest.mark.parametrize("case", ["sum", "isum", "min", "max", "imin",
                                  "imax"])
def test_kernels_match_plain_on_the_card(cuda_device, e, v, b, d, case):
    rng = np.random.default_rng(e + v + d)
    ids, bp = _binned(rng, e, v, b)
    if case.startswith("i"):
        vals = rng.integers(-10**6, 10**6, (e, d)).astype(np.int32)
    else:
        vals = rng.standard_normal((e, d)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (vals, ids, bp)]
    kw = dict(block_size=b, num_segments=v, tile_e=256)
    if case.endswith("sum"):
        launches = seg_sum.launches
        got = seg_sum(*args, **kw)
        want = seg_sum_plain(*args, **kw)
        assert seg_sum.launches == launches + 1
        torch.cuda.synchronize()
        if case == "isum":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        is_min = case.endswith("min")
        launches = seg_minmax.launches
        got = seg_minmax(*args, is_min=is_min, **kw)
        want = seg_minmax_plain(*args, is_min=is_min, **kw)
        assert seg_minmax.launches == launches + 1
        torch.cuda.synchronize()
        assert torch.equal(got, want)


CASES = ["sum", "isum", "min", "max", "imin", "imax"]


def _bin(raw, v, b, rng, sort):
    """Edges of segment ids ``raw`` binned by block: sorted by id (the CSC
    order) or in random order inside each block (the owned order)."""
    raw = np.asarray(raw)
    key = raw if sort else (raw // b) * len(raw) + rng.permutation(len(raw))
    ids = raw[np.argsort(key, kind="stable")]
    bp = np.zeros((v + b - 1) // b + 1, np.int64)
    np.add.at(bp, raw // b + 1, 1)
    return ids.astype(np.int32), np.cumsum(bp).astype(np.int32)


def _kernel_and_plain(dev, case, vals, ids, bp, b, v, chunks=None):
    """Run the kernel once (counting its launch) and the plain version on
    the same inputs; returns both, synchronised."""
    args = [torch.from_numpy(a).to(dev) for a in (vals, ids, bp)]
    kw = dict(block_size=b, num_segments=v, chunks=chunks)
    if case.endswith("sum"):
        fn, plain = seg_sum, seg_sum_plain
    else:
        fn, plain = seg_minmax, seg_minmax_plain
        kw["is_min"] = case.endswith("min")
    launches = fn.launches
    got = fn(*args, **kw)
    assert fn.launches == launches + 1
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    return got, want


def _values_for(rng, case, e, d):
    if case.startswith("i"):
        return rng.integers(-10**6, 10**6, (e, d)).astype(np.int32)
    if case == "sum":  # positive: rtol bounds any order of addition
        return rng.uniform(1.0, 2.0, (e, d)).astype(np.float32)
    return rng.standard_normal((e, d)).astype(np.float32)


def _assert_match(case, got, want):
    if case == "sum":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True], ids=["owned", "csc"])
@pytest.mark.parametrize("case", CASES)
def test_star_hub_matches_plain_on_the_card(cuda_device, sort, case):
    """A hub with 200,000 in-edges: its block splits into many chunks,
    and in the CSC order every warp sees one long run of its id."""
    rng = np.random.default_rng(len(case) + sort)
    v, b, hub = 5000, 256, 300
    raw = np.concatenate([np.full(200_000, hub), rng.integers(0, v, 30_000)])
    ids, bp = _bin(raw, v, b, rng, sort)
    got, want = _kernel_and_plain(cuda_device, case,
                                  _values_for(rng, case, len(ids), 1),
                                  ids, bp, b, v)
    _assert_match(case, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["one-block", "empty-between-heavy"])
@pytest.mark.parametrize("d", [1, 5, 8, 16])
@pytest.mark.parametrize("case", CASES)
def test_skewed_blocks_match_plain_on_the_card(cuda_device, layout, d, case):
    rng = np.random.default_rng(d * 7 + len(case))
    v, b = 2048, 128
    if layout == "one-block":  # every edge in block 3, the others empty
        raw = rng.integers(3 * b, 4 * b, 60_000)
    else:  # blocks 0, 4, 8, .. heavy; the blocks between them empty
        heavy = rng.integers(0, v // (4 * b), 60_000) * 4 * b
        raw = heavy + rng.integers(0, b, 60_000)
    ids, bp = _bin(raw, v, b, rng, sort=False)
    got, want = _kernel_and_plain(cuda_device, case,
                                  _values_for(rng, case, len(ids), d),
                                  ids, bp, b, v)
    _assert_match(case, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("is_min", [True, False], ids=["min", "max"])
def test_float_order_specials_match_plain_on_the_card(cuda_device, d,
                                                      is_min):
    """-0.0 below +0.0, and a NaN of either sign wins (a NaN row comes
    out 0x7fffffff for max, 0xffffffff for min), bit for bit against the
    plain version's int32 keys."""
    rng = np.random.default_rng(d)
    v, b, e = 700, 64, 50_000
    specials = np.array([0x00000000, 0x80000000, 0x7fc00000, 0xffc00000,
                         0x7f800000, 0xff800000], np.uint32).view(np.float32)
    vals = rng.standard_normal((e, d)).astype(np.float32)
    pick = rng.random((e, d)) < 0.5
    vals[pick] = rng.choice(specials, int(pick.sum()))
    ids, bp = _bin(rng.integers(0, v, e), v, b, rng, sort=True)
    got, want = _kernel_and_plain(cuda_device, "min" if is_min else "max",
                                  vals, ids, bp, b, v)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    has_nan = np.zeros((v, d), bool)
    np.logical_or.at(has_nan, ids, np.isnan(vals))
    np.testing.assert_array_equal(torch.isnan(got).cpu().numpy(), has_nan)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True], ids=["owned", "csc"])
def test_int32_sum_wraps_on_the_card(cuda_device, sort):
    rng = np.random.default_rng(3)
    v, b, e = 300, 64, 100_000
    ids, bp = _bin(rng.integers(0, 20, e), v, b, rng, sort)
    vals = rng.integers(2**30, 2**31 - 1, (e, 2)).astype(np.int32)
    got, want = _kernel_and_plain(cuda_device, "isum", vals, ids, bp, b, v)
    wrapped = np.zeros((v, 2), np.int32)
    np.add.at(wrapped, ids, vals)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), wrapped)


@pytest.mark.cuda
def test_reducers_called_again_and_interleaved_agree(cuda_device):
    """A split block's counter is reset and its partials are rewritten by
    every call: the same reducer twice, and two reducers in turns, give
    the first results again."""
    rng = np.random.default_rng(11)
    reducers, values = [], []
    for v, b, e in ((4000, 256, 150_000), (9000, 128, 90_000)):
        raw = np.where(rng.random(e) < 0.6, 5, rng.integers(0, v, e))
        ids, bp = _bin(raw, v, b, rng, sort=True)
        red = BlockedSegmentReducer(ids, bp, v, b, device=cuda_device)
        assert red.chunks.n_slots > 0
        reducers.append(red)
        values.append(torch.from_numpy(
            rng.integers(-2**31, 2**31, (e, 3)).astype(np.int32)).to(
                cuda_device))
    kinds = ("sum", "min", "max")
    first = [[red.reduce(x, k) for k in kinds]
             for red, x in zip(reducers, values)]
    for _ in range(3):
        for red, x, want in zip(reducers, values, first):
            for k, w in zip(kinds, want):
                assert torch.equal(red.reduce(x, k), w), k
    torch.cuda.synchronize()
    for red in reducers:
        assert not red.chunks.counters.any()


@pytest.mark.cuda
def test_kernels_take_a_plan_of_any_chunk_size(cuda_device):
    rng = np.random.default_rng(4)
    v, b = 3000, 256
    ids, bp = _bin(rng.integers(0, 40, 80_000), v, b, rng, sort=False)
    vals = rng.integers(-10**6, 10**6, (len(ids), 4)).astype(np.int32)
    for chunk_e in (1, 100, 2048, 10**6):
        chunks = ChunkPlan.build(bp, chunk_e, cuda_device)
        for case in ("isum", "imin", "imax"):
            got, want = _kernel_and_plain(cuda_device, case, vals, ids, bp,
                                          b, v, chunks=chunks)
            assert torch.equal(got, want), (chunk_e, case)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
def test_main_path_on_the_card_matches_the_cpu(cuda_device, cfg):
    g = powerlaw_graph(3000, 20000, alpha=1.2, seed=7, weighted=True,
                       block_size=64)
    config = SystemConfig.from_name(cfg)
    for app in (bfs, sssp, pagerank):
        before = seg_sum.launches + seg_minmax.launches
        gpu = run(app(), g, config, use_kernels=True, device=cuda_device)
        assert seg_sum.launches + seg_minmax.launches > before
        cpu = run(app(), g, config, use_kernels=True, device="cpu")
        for key, want in cpu.state.items():
            got = gpu.state[key].cpu()
            if app is pagerank and key == "rank":
                torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
            else:
                assert torch.equal(got, want), (app, key)
        if app is not pagerank:
            assert gpu.iterations == cpu.iterations
            assert gpu.direction_trace == cpu.direction_trace
            assert gpu.occupancy_trace == cpu.occupancy_trace


@pytest.fixture(scope="module")
def engine_graph():
    return powerlaw_graph(3000, 20000, alpha=1.2, seed=7, weighted=True,
                          block_size=64)


def _engines(app, g, cfg, dev):
    """The host and the fused engine on one cell, with the kernels; MIS
    and CLR draw their priorities from the same seeded generator."""
    program = REGISTRY[app]()
    kw = dict(use_kernels=True, device=dev)
    if app in ("MIS", "CLR"):
        key = lambda: torch.Generator().manual_seed(11)  # noqa: E731
        host = run(program, g, SystemConfig.from_name(cfg), engine="host",
                   key=key(), **kw)
        fused = run(program, g, SystemConfig.from_name(cfg), key=key(), **kw)
    else:
        host = run(program, g, SystemConfig.from_name(cfg), engine="host",
                   **kw)
        fused = run(program, g, SystemConfig.from_name(cfg), **kw)
    assert fused.engine == "fused" and fused.converged and host.converged
    k = capture.STEPS_PER_LAUNCH
    assert fused.dispatches == fused.host_syncs == -(-fused.iterations // k)
    return fused, host


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "MIS", "CLR"])
def test_fused_equals_host_on_the_card(cuda_device, engine_graph, app, cfg):
    fused, host = _engines(app, engine_graph, cfg, cuda_device)
    assert fused.iterations == host.iterations
    assert fused.direction_trace == host.direction_trace
    assert fused.occupancy_trace == host.occupancy_trace
    for key, want in host.state.items():
        assert torch.equal(fused.state[key], want), (app, key)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "DD1"])
@pytest.mark.parametrize("app", ["PR", "BC"])
def test_fused_float_apps_agree_with_host_on_the_card(cuda_device,
                                                      engine_graph, app, cfg):
    # K1's float sum adds in a run-dependent order on the card
    fused, host = _engines(app, engine_graph, cfg, cuda_device)
    assert abs(fused.iterations - host.iterations) <= 1
    key = "rank" if app == "PR" else "delta"
    torch.testing.assert_close(fused.state[key], host.state[key],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_fused_replays_make_no_hidden_sync(cuda_device, engine_graph,
                                           monkeypatch):
    """Every launch runs under ``set_sync_debug_mode("error")``; only the
    counted polls between them read the device."""
    launch = capture._Fused.launch

    def strict(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(capture._Fused, "launch", strict)
    program = REGISTRY["BC"]()  # every kind of IF node, nested 4 deep
    run(program, engine_graph, SystemConfig.from_name("DD1"),
        use_kernels=True, device=cuda_device)
    res = run(program, engine_graph, SystemConfig.from_name("DD1"),
              use_kernels=True, device=cuda_device)
    assert res.converged and res.host_syncs == res.dispatches
    torch.cuda.set_sync_debug_mode("error")
    try:  # the mode does catch a read of the device
        with pytest.raises(RuntimeError):
            bool(torch.ones((), device=cuda_device))
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_a_host_read_in_a_step_fails_before_the_capture(cuda_device,
                                                        engine_graph):
    """A step that reads the device on the host could not be captured:
    the warm-up, which makes synchronizing operations raise, stops the
    run first.  Nothing is cached, no stream is left capturing, and the
    next fused run works."""
    import dataclasses
    program = bfs()
    reads = dataclasses.replace(program, step=lambda ctx, st, it: (
        bool(st["active"].any()), program.step(ctx, st, it))[1])
    config = SystemConfig.from_name("DD1")
    PLAN_CACHE.clear()
    with pytest.raises(RuntimeError, match="synchroniz"):
        run(reads, engine_graph, config, use_kernels=True,
            device=cuda_device)
    assert not torch.cuda.is_current_stream_capturing()
    assert PLAN_CACHE.kinds().get("exec_fn", 0) == 0
    res = run(program, engine_graph, config, use_kernels=True,
              device=cuda_device)
    host = run(program, engine_graph, config, use_kernels=True,
               engine="host", device=cuda_device)
    assert res.converged and torch.equal(res.state["depth"],
                                         host.state["depth"])


@pytest.mark.cuda
def test_a_failed_capture_is_discarded_cleanly(cuda_device, engine_graph):
    """An error raised while a step is being recorded (here by the step
    itself, inside the live IF body) ends every open capture and drops
    the graph; the next fused run captures and runs as usual."""
    import dataclasses
    program = bfs()

    def step(ctx, st, it):
        if torch.cuda.is_current_stream_capturing():
            raise ValueError("refused while recording")
        return program.step(ctx, st, it)

    config = SystemConfig.from_name("DD1")
    PLAN_CACHE.clear()
    with pytest.raises(ValueError, match="refused while recording"):
        run(dataclasses.replace(program, step=step), engine_graph, config,
            use_kernels=True, device=cuda_device)
    assert not torch.cuda.is_current_stream_capturing()
    assert PLAN_CACHE.kinds().get("exec_fn", 0) == 0
    res = run(program, engine_graph, config, use_kernels=True,
              device=cuda_device)
    host = run(program, engine_graph, config, use_kernels=True,
               engine="host", device=cuda_device)
    assert res.converged and torch.equal(res.state["depth"],
                                         host.state["depth"])


INVALIDATED = """
import contextlib, dataclasses
from repro_torch.algorithms import bfs
from repro_torch.core import SystemConfig, capture, run
from repro_torch.graph import powerlaw_graph
capture._no_host_reads = lambda device: contextlib.nullcontext()
program = bfs()
reads = dataclasses.replace(program, step=lambda ctx, st, it: (
    bool(st["active"].any()), program.step(ctx, st, it))[1])
try:
    run(reads, powerlaw_graph(300, 1500, seed=1, block_size=64),
        SystemConfig.from_name("SD1"), use_kernels=True)
except RuntimeError as exc:
    print("raised:", exc, flush=True)
"""


@pytest.mark.cuda
def test_an_invalidated_capture_raises_a_clear_error(cuda_device):
    """With the warm-up's guard off, a host read inside the capture
    invalidates it; the run raises an error that says the process cannot
    use the device again, instead of crashing while ending the
    captures.  Run in its own process, which it leaves unusable: that
    process aborts at exit, when PyTorch frees the graph's memory pool
    while its streams are still capturing."""
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", INVALIDATED], cwd=root,
                          env={**__import__("os").environ,
                               "PYTHONPATH": str(root / "src")},
                          capture_output=True, text=True, timeout=300)
    assert "raised: a CUDA graph capture was invalidated" in proc.stdout, \
        proc.stdout + proc.stderr


@pytest.mark.cuda
def test_a_repeat_run_replays_the_cached_graph(cuda_device, engine_graph):
    from torch.profiler import ProfilerActivity, profile
    program = bfs()
    config = SystemConfig.from_name("DD1")
    PLAN_CACHE.clear()  # count this graph's entries only
    first = run(program, engine_graph, config, use_kernels=True,
                device=cuda_device)
    graphs = PLAN_CACHE.kinds()["exec_fn"]
    launches = seg_minmax.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = run(program, engine_graph, config, use_kernels=True,
                    device=cuda_device)
    # no capture and no wrapper call: the cached graph ran K2
    assert PLAN_CACHE.kinds()["exec_fn"] == graphs
    assert seg_minmax.launches == launches
    names = [e.key for e in prof.key_averages()]
    assert any("seg_reduce_kernel" in n for n in names), names
    assert again.iterations == first.iterations
    assert again.direction_trace == first.direction_trace
    for key, want in first.state.items():
        assert torch.equal(again.state[key], want), key


@pytest.mark.cuda
@pytest.mark.parametrize("r,d,b,p,mode", [
    (1000, 32, 16, 4, "sum"), (5000, 128, 33, 1, "sum"),
    (200, 64, 8, 8, "mean"), (50, 8, 3, 2, "sum"), (50, 6, 9, 3, "sum"),
    (100_000, 128, 4096, 1, "sum"), (100_000, 128, 1000, 8, "mean")])
def test_embedding_bag_matches_plain_on_the_card(cuda_device, r, d, b, p,
                                                 mode):
    rng = np.random.default_rng(r + b)
    table = torch.from_numpy(
        rng.standard_normal((r, d)).astype(np.float32)).to(cuda_device)
    idx = rng.integers(0, r, (b, p)).astype(np.int32)
    idx[0, 0] = -1       # wraps to the last row
    idx[-1, -1] = r      # out of range: a NaN row
    idx = torch.from_numpy(idx).to(cuda_device)
    launches = embag.launches
    got = embag(table, idx, mode=mode)
    assert embag.launches == launches + 1
    want = embedding_bag_ref(table, idx, mode=mode)
    torch.cuda.synchronize()
    assert torch.isnan(got[-1]).all() and not torch.isnan(got[:-1]).any()
    if p == 1:
        assert torch.equal(got[:-1], want[:-1])
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   equal_nan=True)


#: (B, P, D, table rows) of the table-batched K3 cases
BAGS_CASES = [(512, 1, 128, (1000, 200, 50, 300, 77, 10)),
              (300, 8, 128, (5000, 3, 40_000)),
              (77, 3, 16, (1000, 200, 50, 300, 77, 10)),
              (64, 40, 32, (100, 7)),
              (33, 2, 6, (50, 9, 12))]


def _bags_inputs(dev, rows, b, p, d, seed):
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.standard_normal((r, d)).astype(np.float32))
              .to(dev) for r in rows]
    idx = np.stack([rng.integers(0, r, (b, p)) for r in rows], axis=1)
    return tables, torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b,p,d,rows", BAGS_CASES)
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("items_per_warp,threads", [(1, 256), (2, 128),
                                                    (4, 256), (4, 128)])
def test_embag_tables_is_single_table_calls_on_the_card(
        cuda_device, b, p, d, rows, mode, items_per_warp, threads):
    tables, idx = _bags_inputs(cuda_device, rows, b, p, d, b + p + d)
    launches = embag.launches
    got = embag_tables(tables, idx, mode=mode,
                       launch=(items_per_warp, threads))
    assert embag.launches == launches + 1
    per_table = torch.stack([embag(t, idx[:, f], mode=mode)
                             for f, t in enumerate(tables)], dim=1)
    want = embedding_bags_ref(tables, idx, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got, per_table)
    if p == 1:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_embag_tables_hold_each_table_to_its_own_rows_on_the_card(
        cuda_device):
    tables, _ = _bags_inputs(cuda_device, (1000, 10, 77), 1, 1, 128, 3)
    idx = torch.tensor([[[500, 1], [5, 2], [3, 4]],
                        [[20, 0], [20, 0], [20, 0]],
                        [[-1, 0], [-1, 0], [-77, 0]],
                        [[999, 0], [-10, 0], [-78, 0]]],
                       dtype=torch.int32, device=cuda_device)
    got = embag_tables(tables, idx)
    want = embedding_bags_ref(tables, idx)
    torch.cuda.synchronize()
    nan = torch.zeros((4, 3), dtype=torch.bool, device=cuda_device)
    nan[1, 1] = nan[3, 2] = True
    assert torch.equal(torch.isnan(got).all(-1), nan)
    assert torch.equal(torch.isnan(got).any(-1), nan)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [128, 16, 6])
def test_embag_tables_write_into_a_slice_of_z_on_the_card(cuda_device, d):
    rows = (1000, 200, 50, 300, 77, 10)
    tables, idx = _bags_inputs(cuda_device, rows, 129, 1, d, d)
    z = torch.full((129, len(rows) + 1, d), 7.0, device=cuda_device)
    got = embag_tables(tables, idx, out=z[:, 1:])
    torch.cuda.synchronize()
    assert got.data_ptr() == z[:, 1:].data_ptr()
    assert (z[:, 0] == 7.0).all()
    assert torch.equal(z[:, 1:], embedding_bags_ref(tables, idx))


@pytest.mark.cuda
def test_embag_tables_on_the_criteo_vocabularies_on_the_card(cuda_device):
    from repro_torch.models.dlrm import CRITEO_1TB_VOCABS
    rows = tuple(min(v, 100_000) for v in CRITEO_1TB_VOCABS)
    tables, idx = _bags_inputs(cuda_device, rows, 2048, 1, 128, 26)
    launches = embag.launches
    got = embag_tables(tables, idx)
    assert embag.launches == launches + 1
    want = embedding_bags_ref(tables, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_embag_tables_takes_the_sources_table_limit(cuda_device):
    assert embag_library().embag_max_tables() == MAX_TABLES
    tables, idx = _bags_inputs(cuda_device, (3,) * MAX_TABLES, 5, 1, 4, 1)
    torch.testing.assert_close(embag_tables(tables, idx),
                               embedding_bags_ref(tables, idx), rtol=0,
                               atol=0)


@pytest.mark.cuda
def test_dlrm_forward_launches_k3_once_on_the_card(cuda_device):
    from repro_torch.configs.dlrm_mlperf import REDUCED, serving_batch
    from repro_torch.models.dlrm import dlrm_forward, init_dlrm
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = init_dlrm(REDUCED, gen, cuda_device)
    batch = serving_batch(REDUCED, "serve_p99", 3, device=cuda_device)
    launches = embag.launches
    got = dlrm_forward(REDUCED, model, batch, device=cuda_device)
    assert embag.launches == launches + 1
    want = dlrm_forward(REDUCED, model, batch, impl="plain",
                        device=cuda_device)
    assert embag.launches == launches + 1
    assert got.shape == (512,) and torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (1, 2, 2, 128, 128, 64, True), (2, 4, 2, 256, 256, 64, True),
    (1, 8, 2, 128, 256, 128, True), (1, 2, 1, 64, 64, 32, False),
    (1, 2, 1, 128, 64, 32, True), (1, 4, 2, 100, 100, 16, True),
    (2, 6, 3, 72, 200, 128, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_on_the_card(cuda_device, b, hq, hkv,
                                                   sq, sk, d, causal, dtype):
    rng = np.random.default_rng(b + sq + sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    launches = flash_attention.launches
    got = attention(q, k, v, causal=causal, device=cuda_device)
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    tol = (dict(rtol=0.0, atol=2e-3) if dtype == torch.float32
           else dict(rtol=2**-7, atol=1e-2))
    torch.testing.assert_close(got.float(), want.float(), **tol)


BF16_TOL = dict(rtol=2**-7, atol=1e-2)


def _bf16_qkv(dev, rng, b, hq, hkv, sq, sk, d):
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, torch.bfloat16)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,causal", [
    (1, 2, 2, 100, 100, True), (2, 6, 2, 72, 200, True),
    (1, 9, 1, 129, 257, True), (2, 3, 1, 129, 257, False),
    (1, 2, 1, 200, 72, True), (1, 4, 4, 300, 129, True),
    (1, 2, 2, 512, 512, True)],
    ids=["100x100", "72x200-b2-g3", "129x257-g9", "129x257-full",
         "200x72-sq>sk", "300x129-sq>sk", "512x512"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_bf16_tensor_core_path(cuda_device, b, hq, hkv, sq,
                                               sk, causal, d):
    """The bf16 kernel (wgmma, TMA) at every head size, ragged Sq and Sk,
    rows that see no key (causal, Sq > Sk), B = 2 and GQA groups 1, 3, 9,
    against the plain version at one bf16 step plus 1e-2."""
    rng = np.random.default_rng(1000 * d + sq + sk)
    q, k, v = _bf16_qkv(cuda_device, rng, b, hq, hkv, sq, sk, d)
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_bf16_stays_inside_its_head(cuda_device, d, causal):
    """Sk = 200 and Sq = 100 are not multiples of the 128-row tiles, so a
    tile of kv head 0 runs past its last key and a tile of a q head past
    its last row.  kv head 1 (and the q heads that read it) hold inf and
    NaN: the q heads of kv head 0 must come out finite and equal to the
    plain version on head 0 alone, as they do only if the loads are
    clipped at the head and zero-filled."""
    rng = np.random.default_rng(d)
    q, k, v = _bf16_qkv(cuda_device, rng, 1, 4, 2, 100, 200, d)
    q[:, 2:], k[:, 1], v[:, 1] = float("nan"), float("inf"), float("nan")
    k[:, 1, ::2] = float("-inf")
    got = flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q[:, :2], k[:, :1], v[:, :1], causal=causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:, :2]).all()
    torch.testing.assert_close(got[:, :2].float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
def test_flash_attention_bf16_refuses_a_misaligned_view(cuda_device):
    """TMA loads from 16-byte aligned addresses only: a contiguous view
    that starts one element into its storage is refused, not launched."""
    rng = np.random.default_rng(0)
    q, k, v = _bf16_qkv(cuda_device, rng, 1, 2, 1, 64, 64, 64)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    shifted = flat[1:].view(q.shape).copy_(q)
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(shifted, k, v)
    assert flash_attention.launches == launches


# ---------------------------------------------------------------------------
# checkpointed runs (core/resilience.py on the segment engine)
def _key(app):
    return torch.Generator().manual_seed(11) if app in ("MIS", "CLR") \
        else None


def _cell(app, g, cfg, dev, **kw):
    return run(REGISTRY[app](), g, SystemConfig.from_name(cfg), key=_key(app),
               use_kernels=True, device=dev, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 32])
@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "MIS", "CLR", "PR"])
def test_checkpointed_fused_equals_plain_fused_on_the_card(
        cuda_device, engine_graph, app, cfg, k):
    plain = _cell(app, engine_graph, cfg, cuda_device)
    res = _cell(app, engine_graph, cfg, cuda_device, checkpoint_every=k)
    assert res.outcome == "converged" and res.fault is None
    assert res.engine == "fused" and res.attempts == 1
    if app == "PR":  # K1's float atomics add in a run-dependent order
        assert abs(res.iterations - plain.iterations) <= 1
        torch.testing.assert_close(res.state["rank"], plain.state["rank"],
                                   rtol=0, atol=1e-6)
        return
    assert res.iterations == plain.iterations
    assert res.direction_trace == plain.direction_trace
    assert res.occupancy_trace == plain.occupancy_trace
    for key, want in plain.state.items():
        assert torch.equal(res.state[key], want), key


@pytest.mark.cuda
def test_one_segment_graph_serves_every_segment_and_attempt(cuda_device,
                                                            engine_graph):
    from repro_torch.core import RetryPolicy
    from repro_torch.testing import NaNFault
    PLAN_CACHE.clear()
    program, config = pagerank(), SystemConfig.from_name("SD1")
    kw = dict(use_kernels=True, device=cuda_device)
    res = run(program, engine_graph, config, checkpoint_every=4,
              retry=RetryPolicy(max_attempts=3),
              fault_injector=NaNFault(at_iteration=8), **kw)
    assert res.converged and res.attempts == 2 and res.engine == "fused"
    assert res.resilience["segments"] > 3
    assert PLAN_CACHE.kinds()["exec_fn"] == 1
    for k in (1, 8):  # other segment lengths replay the same graph
        run(program, engine_graph, config, checkpoint_every=k, **kw)
    assert PLAN_CACHE.kinds()["exec_fn"] == 1
    run(program, engine_graph, config, **kw)  # the plain engine's own
    assert PLAN_CACHE.kinds()["exec_fn"] == 2


@pytest.mark.cuda
def test_one_host_read_per_segment_besides_the_polls(cuda_device,
                                                     engine_graph,
                                                     monkeypatch):
    """Each boundary (sentinels, and the certificate on the last) makes
    exactly one synchronizing call; the rest are the polls."""
    import warnings
    from repro_torch.core import resilience
    boundary, reads = resilience._boundary, []

    def counted(*args, **kwargs):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = boundary(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        reads.append(sum("synchroniz" in str(w.message) for w in caught))
        return out

    _cell("BFS", engine_graph, "DD1", cuda_device, checkpoint_every=2)
    monkeypatch.setattr(resilience, "_boundary", counted)
    res = _cell("BFS", engine_graph, "DD1", cuda_device, checkpoint_every=2)
    segments = res.resilience["segments"]
    assert segments == -(-res.iterations // 2) and reads == [1] * segments
    assert res.host_syncs == res.dispatches + segments


@pytest.mark.cuda
def test_segment_replays_make_no_hidden_sync(cuda_device, engine_graph,
                                             monkeypatch):
    launch = capture._FusedSegment.launch

    def strict(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(capture._FusedSegment, "launch", strict)
    res = _cell("BC", engine_graph, "DD1", cuda_device, checkpoint_every=3)
    assert res.converged and res.fault is None and res.dispatches > 0


@pytest.mark.cuda
def test_kill_and_resume_on_the_card(cuda_device, engine_graph, tmp_path):
    from repro_torch.testing import ProcessKillFault, SimulatedProcessDeath
    kw = dict(checkpoint_every=4)
    clean = _cell("CLR", engine_graph, "SD1", cuda_device, **kw)
    kill_at = clean.iterations - 4
    with pytest.raises(SimulatedProcessDeath):
        _cell("CLR", engine_graph, "SD1", cuda_device,
              checkpoint_dir=str(tmp_path), **kw,
              fault_injector=ProcessKillFault(at_iteration=kill_at,
                                              point="after_segment"))
    resumed = _cell("CLR", engine_graph, "SD1", cuda_device,
                    checkpoint_dir=str(tmp_path), **kw)
    assert resumed.converged and resumed.fault is None
    assert resumed.iterations == clean.iterations
    assert resumed.direction_trace == clean.direction_trace
    assert resumed.resilience["segments"] <= 2
    for key, want in clean.state.items():
        assert torch.equal(resumed.state[key], want), key


# ---------------------------------------------------------------------------
# the tuner's plans and the batched engine
@pytest.fixture(scope="module")
def tune_graph():
    return powerlaw_graph(20000, 160000, alpha=1.2, seed=9, weighted=True)


@pytest.mark.cuda
@pytest.mark.parametrize("threads", [128, 256, 1024])
@pytest.mark.parametrize("order,shape,d", [
    ("owned", (1, 1), 1), ("owned", (1, 1), 8), ("owned", (4, 1), 1),
    ("owned", (4, 1), 8), ("owned", (8, 1), 1), ("pull", (1, 2), 1),
    ("pull", (1, 2), 8), ("pull", (1, 4), 1), ("pull", (1, 4), 8),
    ("pull", (2, 1), 8)])
def test_kernels_under_tuned_plans_match_plain_on_the_card(
        cuda_device, tune_graph, threads, order, shape, d):
    """Thread counts other than 512, coarsened owned blocks (chunks that
    cross a base block) and refined pull blocks (thousands of one-chunk
    blocks) against the plain versions on the same plan, at every width
    whose accumulator fits the shared memory (2,048 vertices: D = 1)."""
    from repro_torch.kernels.autotune import build_reducer
    from repro_torch.kernels.segment_reduce import TilingPlan
    mult, div = shape
    plan = TilingPlan(tile_e=threads, block_mult=mult, block_div=div)
    red = build_reducer(tune_graph, order, plan, device=cuda_device)
    assert red.tile_e == threads
    assert red.block_size == plan.block_size(tune_graph.block_size)
    rng = np.random.default_rng(threads + d)
    e = tune_graph.n_edges
    kw = dict(block_size=red.block_size, num_segments=red.num_segments,
              tile_e=threads, chunks=red.chunks)
    args = (red.segment_ids, red.block_ptr)
    for case in CASES:
        vals = torch.from_numpy(_values_for(rng, case, e, d)).to(cuda_device)
        if case.endswith("sum"):
            got = seg_sum(vals, *args, **kw)
            want = seg_sum_plain(vals, *args, **kw)
        else:
            is_min = case.endswith("min")
            got = seg_minmax(vals, *args, is_min=is_min, **kw)
            want = seg_minmax_plain(vals, *args, is_min=is_min, **kw)
        torch.cuda.synchronize()
        if case == "isum":
            assert torch.equal(got, want)
        else:
            _assert_match(case, got, want)


@pytest.mark.cuda
def test_measure_plan_times_with_cuda_events(cuda_device, tune_graph):
    from repro_torch.kernels import autotune as at
    for order in ("owned", "pull", "gathered"):
        plan = at.candidate_plans(tune_graph, order=order)[-1]
        s = at.measure_plan(tune_graph, plan, order=order, repeats=2,
                            device=cuda_device)
        assert 0.0 < s < 1.0
    plan = at.autotune_plan(tune_graph, order="pull", cache_path=None,
                            device=cuda_device)
    assert plan.tile_e in at.THREADS


@pytest.mark.cuda
def test_a_tuned_and_an_untuned_run_capture_two_graphs_on_the_card(
        cuda_device, engine_graph):
    """The capture key holds the resolved plans: the heuristic run gets
    its own captured graph, over its own reducers, and the same result."""
    program, config = bfs(), SystemConfig.from_name("TD0")
    PLAN_CACHE.clear()
    base = run(program, engine_graph, config, use_kernels=True,
               device=cuda_device)
    assert PLAN_CACHE.kind_stats("exec_fn")["entries"] == 1
    tuned = run(program, engine_graph, config, use_kernels=True,
                autotune="heuristic", device=cuda_device)
    assert PLAN_CACHE.kind_stats("exec_fn")["entries"] == 2
    assert tuned.iterations == base.iterations
    assert tuned.direction_trace == base.direction_trace
    assert torch.equal(tuned.state["depth"], base.state["depth"])


def _batch_graphs():
    from repro_torch.graph import rmat_batch
    return rmat_batch(6, 8, seed=3, weighted=True)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1"])
@pytest.mark.parametrize("app", ["BFS", "CC", "SSSP"])
def test_fused_batch_equals_the_eager_cpu_batch(cuda_device, app, cfg):
    from repro_torch.core import run_batch
    graphs = _batch_graphs()
    program, config = REGISTRY[app](), SystemConfig.from_name(cfg)
    gpu = run_batch(program, graphs, config, use_kernels=True,
                    device=cuda_device)
    cpu = run_batch(program, graphs, config, use_kernels=True, device="cpu")
    k = capture.STEPS_PER_LAUNCH
    longest = max(r.iterations for r in cpu)
    for g, c in zip(gpu, cpu):
        assert g.engine == "batched" and g.converged
        assert g.dispatches == -(-longest // k)
        assert g.iterations == c.iterations
        assert g.direction_trace == c.direction_trace
        assert g.occupancy_trace == c.occupancy_trace
        for key, want in c.state.items():
            assert torch.equal(g.state[key].cpu(), want), (app, key)


@pytest.mark.cuda
def test_batched_replays_make_no_hidden_sync(cuda_device, monkeypatch):
    """Every replay of a batched graph (BC under DD1: its phase select
    and the inner context's IF nodes) runs under
    ``set_sync_debug_mode("error")``."""
    from repro_torch.core import run_batch
    launch = capture._Fused.launch

    def strict(self):
        torch.cuda.set_sync_debug_mode("error")
        try:
            launch(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(capture._Fused, "launch", strict)
    graphs = _batch_graphs()
    program, config = REGISTRY["BC"](), SystemConfig.from_name("DD1")
    run_batch(program, graphs, config, use_kernels=True, device=cuda_device)
    res = run_batch(program, graphs, config, use_kernels=True,
                    device=cuda_device)
    cpu = run_batch(program, graphs, config, use_kernels=True, device="cpu")
    for r, c in zip(res, cpu):
        assert r.converged and r.host_syncs == r.dispatches
        assert r.iterations == c.iterations
        torch.testing.assert_close(r.state["delta"].cpu(), c.state["delta"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_batch_slices_on_the_card_equal_the_cpu(cuda_device):
    from repro_torch.core import (BatchedEdgeContext, pack_graphs,
                                  run_batch_slice)
    graphs = _batch_graphs()[:3]
    program, config = REGISTRY["CLR"](), SystemConfig.from_name("DD1")
    batch = pack_graphs(graphs)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        bctx = BatchedEdgeContext(batch, config, use_kernels=True,
                                  device=dev)
        state = {k: v.to(dev) for k, v in batch.pack_state(
            [program.init(g) for g in graphs], pad=program.state_pad).items()}
        it_b, conv = np.zeros(3, np.int32), np.zeros(3, bool)
        parked = np.array([False, True, False])
        cols = []
        for _ in range(64):
            s = run_batch_slice(program, batch, bctx, state, it_b,
                                parked | conv, np.full(3, 512, np.int32), 4)
            cols.append(s.dir_cols)
            state, it_b, conv = s.state, s.it_b, conv | s.converged_b
            if (conv | parked).all():
                break
        out[dev.type] = (state, it_b, conv, np.concatenate(cols, 1))
    (gs, gi, gc, gd), (cs, ci, cc, cd) = out["cuda"], out["cpu"]
    assert (gi == ci).all() and (gc == cc).all() and (gd == cd).all()
    for key, want in cs.items():
        assert torch.equal(gs[key].cpu(), want), key
