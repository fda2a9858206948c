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
max), with and without the sliding window; the reduced LMs' prefill
with K4 against prefill with its plain version (``blocked_attention``)
to the CPU parity tests' bounds.
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


# ---------------------------------------------------------------------------
# specialization (core/specialize_learned.py) on the card
def _skew_model(path):
    """A model file that sends near-regular graphs to SD1 and skewed
    ones to TG0 (both reduce through K1/K2)."""
    from repro_torch.core import specialize_learned as sl
    tree = {"feature": sl.FEATURES.index("degree_skew"), "threshold": 0.6,
            "left": {"counts": [1, 0]}, "right": {"counts": [0, 1]}}
    return sl.save_model(sl.LearnedSpecializer(
        features=sl.FEATURES, classes=("SD1", "TG0"), tree=tree), path)


@pytest.fixture
def skew_model(tmp_path, monkeypatch):
    from repro_torch.core import specialize_learned as sl
    sl.clear_memo()
    monkeypatch.setattr(sl, "DEFAULT_MODEL_PATH",
                        _skew_model(tmp_path / "model.json"))
    yield
    sl.clear_memo()


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "MIS", "CLR", "PR"])
def test_learned_run_equals_the_resolved_plain_run_on_the_card(
        cuda_device, engine_graph, skew_model, app):
    import warnings
    from repro_torch.core import SpecializeFallbackWarning
    with warnings.catch_warnings():
        warnings.simplefilter("error", SpecializeFallbackWarning)
        res = _cell(app, engine_graph, "DG0", cuda_device,
                    specialize="learned")
    assert (res.config_name, res.config_source) == ("TG0", "learned")
    plain = _cell(app, engine_graph, res.config_name, cuda_device)
    if app == "PR":  # K1's float atomics add in a run-dependent order
        assert abs(res.iterations - plain.iterations) <= 1
        torch.testing.assert_close(res.state["rank"], plain.state["rank"],
                                   rtol=0, atol=1e-6)
        return
    assert res.iterations == plain.iterations
    assert res.direction_trace == plain.direction_trace
    for key, want in plain.state.items():
        assert torch.equal(res.state[key], want), key


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC"])
def test_batch_never_packs_different_resolved_configs_on_the_card(
        cuda_device, skew_model, monkeypatch, app):
    import repro_torch.core.batch as batch_mod
    from repro_torch.core import run_batch
    from repro_torch.graph import regular_graph
    # one padding bucket, (512, 4096, 256); different degree shapes
    gs = [regular_graph(500, 4, seed=1, weighted=True),
          powerlaw_graph(500, 2000, alpha=1.2, max_degree=60, seed=2,
                         weighted=True),
          regular_graph(500, 4, seed=3, weighted=True)]
    packed = []
    real = batch_mod.get_graph_batch

    def spy(members):
        packed.append(tuple(id(m) for m in members))
        return real(members)

    monkeypatch.setattr(batch_mod, "get_graph_batch", spy)
    results = run_batch(REGISTRY[app](), gs, SystemConfig.from_name("DG0"),
                        use_kernels=True, device=cuda_device,
                        specialize="learned")
    assert [r.config_name for r in results] == ["SD1", "TG0", "SD1"]
    assert sorted(packed) == sorted([(id(gs[0]), id(gs[2])), (id(gs[1]),)])
    for g, r in zip(gs, results):
        seq = _cell(app, g, r.config_name, cuda_device)
        assert r.config_source == "learned"
        assert r.iterations == seq.iterations
        for key, want in seq.state.items():
            assert torch.equal(r.state[key], want), key


@pytest.mark.cuda
def test_missing_model_falls_back_to_static_partial_on_the_card(
        cuda_device, engine_graph, tmp_path, monkeypatch):
    from repro_torch.core import SpecializeFallbackWarning
    from repro_torch.core import specialize_learned as sl
    sl.clear_memo()
    monkeypatch.setattr(sl, "DEFAULT_MODEL_PATH",
                        str(tmp_path / "absent.json"))
    with pytest.warns(SpecializeFallbackWarning, match="code=model_missing"):
        res = _cell("SSSP", engine_graph, "DG0", cuda_device,
                    specialize="learned")
    want = sl.static_config_for(REGISTRY["SSSP"]().properties, engine_graph,
                                partial=True)
    assert (res.config_name, res.config_source) == (want.name,
                                                    "static_partial")
    plain = _cell("SSSP", engine_graph, want.name, cuda_device)
    assert torch.equal(res.state["dist"], plain.state["dist"])
    sl.clear_memo()


@pytest.mark.cuda
def test_committed_model_serves_learned_runs_on_the_card(cuda_device,
                                                         engine_graph):
    import warnings
    from repro_torch.core import SpecializeFallbackWarning
    from repro_torch.core import specialize_learned as sl
    sl.clear_memo()
    with warnings.catch_warnings():
        warnings.simplefilter("error", SpecializeFallbackWarning)
        res = _cell("BFS", engine_graph, "TG0", cuda_device,
                    specialize="learned")
    assert res.config_source == "learned"
    assert res.config_name in sl.load_model(sl.DEFAULT_MODEL_PATH).classes
    sl.clear_memo()


# ---------------------------------------------------------------------------
# the streaming gateway (launch/serve.py) on the card
def _gateway_pool(n=8):
    from repro_torch.graph import rmat_batch
    return rmat_batch(n, 8, seed=3, weighted=True)


def _gateway_same(app, got, want):
    """A gateway result (host arrays) against a sequential fused run on
    the card: bit for bit, PR to atol 1e-6 with iterations +-1 (K1's
    float atomics)."""
    assert got.engine == "gateway" and got.converged
    if app == "PR":
        assert abs(got.iterations - want.iterations) <= 1
        torch.testing.assert_close(torch.from_numpy(got.state["rank"]),
                                   want.state["rank"].cpu(), rtol=0,
                                   atol=1e-6)
        return
    assert got.iterations == want.iterations
    assert got.direction_trace == want.direction_trace
    assert got.occupancy_trace == want.occupancy_trace
    for key, v in want.state.items():
        assert np.array_equal(got.state[key], v.cpu().numpy()), key


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["SD1", "TG0"])
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC", "PR"])
def test_gateway_on_the_card_equals_sequential_fused_runs(cuda_device, app,
                                                          cfg):
    from repro_torch.launch.serve import ContinuousScheduler
    from repro_torch.kernels.segment_reduce import seg_minmax, seg_sum
    graphs = _gateway_pool()
    program, config = REGISTRY[app](), SystemConfig.from_name(cfg)
    want = [run(program, g, config, use_kernels=True, device=cuda_device)
            for g in graphs]
    launches = seg_sum.launches + seg_minmax.launches
    sched = ContinuousScheduler(max_batch=4, slice_len=3,
                                device=cuda_device)
    first = [sched.submit(program, g, config, use_kernels=True)
             for g in graphs[:5]]
    sched.poll()                        # a cohort in flight, then joiners
    rest = [sched.submit(program, g, config, use_kernels=True)
            for g in graphs[5:]]
    sched.run_until_idle()
    for t, w in zip(first + rest, want):
        _gateway_same(app, t.result(0), w)
    s = sched.stats
    assert s.quarantined == s.slice_retries == s.sentinel_trips == 0
    assert s.converged == len(graphs) and s.replays >= s.slices
    assert seg_sum.launches + seg_minmax.launches > launches


@pytest.mark.cuda
def test_gateway_clients_on_threads_while_rosters_capture(cuda_device):
    """8 client threads submit to two lanes while the worker captures
    new rosters (and runs the certificates under the sync-debug mode):
    no error, every result equal to its sequential run."""
    import threading
    from repro_torch.launch.serve import GraphGateway
    graphs = _gateway_pool(16)
    cells = [(REGISTRY["BFS"](), SystemConfig.from_name("SD1"), "BFS"),
             (REGISTRY["SSSP"](), SystemConfig.from_name("TG0"), "SSSP")]
    want = {(a, i): run(p, g, c, use_kernels=True, device=cuda_device)
            for p, c, a in cells for i, g in enumerate(graphs)}
    torch.cuda.synchronize()
    results, errors = {}, []
    with GraphGateway(max_batch=4, slice_len=4,
                      device=cuda_device) as gw:
        def client(k):
            try:
                for j in range(4):
                    i = (4 * k + j) % len(graphs)
                    p, c, a = cells[(k + j) % 2]
                    t = gw.submit(p, graphs[i], c, use_kernels=True)
                    results[(k, j)] = (a, i, t.result(timeout=300))
            except Exception as err:  # noqa: BLE001
                errors.append(err)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads)
        snap = gw.stats()
    assert not errors, errors
    assert len(results) == 32 and snap["converged"] == 32
    assert snap["roster_rebuilds"] > 2
    assert snap["quarantined"] == snap["slice_retries"] == 0
    for a, i, res in results.values():
        _gateway_same(a, res, want[(a, i)])


@pytest.mark.cuda
def test_gateway_kill_and_recover_on_the_card(cuda_device, tmp_path):
    from repro_torch.launch.serve import ContinuousScheduler
    from repro_torch.testing import GatewayKillFault, SimulatedProcessDeath
    graphs = _gateway_pool(4)
    cells = [(REGISTRY[a](), SystemConfig.from_name(c))
             for a, c in (("BFS", "SD1"), ("SSSP", "SD1"), ("CC", "TG0"))]

    def stream(**kw):
        sched = ContinuousScheduler(max_batch=2, slice_len=2,
                                    device=cuda_device, **kw)
        return [sched.submit(p, graphs[i % 4], c, use_kernels=True)
                for i, (p, c) in enumerate(cells * 3)], sched

    clean_t, clean = stream()
    clean.run_until_idle()
    tickets, sched = stream(journal_dir=str(tmp_path),
                            fault_injector=GatewayKillFault(after_slices=3))
    with pytest.raises(SimulatedProcessDeath):
        sched.run_until_idle()
    fresh = ContinuousScheduler(max_batch=2, slice_len=2,
                                device=cuda_device)
    recovered = fresh.recover(str(tmp_path))
    assert any(t._restore is not None for t in recovered)
    fresh.run_until_idle()
    by_jid = {t.jid: t.result(0) for t in tickets if t.done()}
    by_jid.update({t.jid: t.result(0) for t in recovered})
    for want_t, t in zip(clean_t, tickets):
        want, got = want_t.result(0), by_jid[t.jid]
        assert got.converged and got.iterations == want.iterations
        assert got.direction_trace == want.direction_trace
        for key, v in want.state.items():
            assert np.array_equal(got.state[key], v), key


@pytest.mark.cuda
def test_autotune_bench_launches_k1_k2_and_keeps_measure_equal_to_off(
        cuda_device, tmp_path, monkeypatch):
    import repro_torch.kernels.autotune as at
    from repro_torch.benchmarks import autotune as bench
    monkeypatch.setattr(at, "DEFAULT_CACHE_PATH",
                        str(tmp_path / "autotune_cache.json"))
    monkeypatch.setattr(bench, "SMOKE_WORKLOADS",
                        {"skew": bench.SMOKE_WORKLOADS["skew"]})
    before = (seg_sum.launches, seg_minmax.launches)
    rec = bench.run_autotune(out_path=None, smoke=True, repeats=2,
                             device=cuda_device)
    assert rec["kernel_launches"] == {
        "seg_sum": seg_sum.launches - before[0],
        "seg_minmax": seg_minmax.launches - before[1]}
    assert min(rec["kernel_launches"].values()) > 0
    assert rec["summary"]["states_equal"] is True
    assert rec["summary"]["plain_equal"] is True
    cells = rec["workloads"]["skew"]["configs"]
    assert len(cells) == 18 and all(c["states_equal"] and c["plain_equal"]
                                    for c in cells.values())
    assert all(c["speedup"] == 1.0 for c in cells.values()
               if not c["plans_differ"])
    assert rec["card"] and rec["device"].startswith("cuda")


@pytest.mark.cuda
def test_partition_and_sampler_accept_a_graph_on_the_card(cuda_device):
    import dataclasses
    from repro_torch.graph import (NeighborSampler, partition_edges_1d,
                                   partition_vertices)
    g = powerlaw_graph(400, 2400, alpha=1.0, seed=3, weighted=True,
                       block_size=64)
    gd = g.to(cuda_device)
    assert gd.src.is_cuda
    for fn in (partition_edges_1d, partition_vertices):
        for n in (1, 3, 8):
            a, b = fn(gd, n), fn(g, n)
            for f in dataclasses.fields(b):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if isinstance(y, np.ndarray):
                    assert isinstance(x, np.ndarray) and x.dtype == y.dtype
                    assert np.array_equal(x, y), f.name
                else:
                    assert x == y
    seeds = np.arange(0, 400, 13)
    for seed in (0, 7):
        got = NeighborSampler(gd, (5, 3), seed=seed).sample(seeds)
        want = NeighborSampler(g, (5, 3), seed=seed).sample(seeds)
        for x, y in zip(got, want):
            assert np.array_equal(x.src_global, y.src_global)
            assert np.array_equal(x.edge_mask, y.edge_mask)
            assert np.array_equal(x.seeds, y.seeds)


# K4 with a sliding window: (B, Hq, Hkv, Sq, Sk, window).  Windows that
# skip many tiles (the first visited tile's stage is not 0), the window
# of one key, one wider than Sk, a suffix Sq < Sk, rows that see no key
# (Sq > Sk), ragged Sq and Sk, GQA groups 1, 3 and 9.
WINDOW_CASES = [(1, 2, 2, 1000, 1000, 200), (2, 6, 2, 300, 700, 128),
                (1, 9, 1, 129, 257, 1), (1, 4, 4, 513, 513, 5000),
                (1, 2, 1, 200, 72, 30), (1, 2, 2, 2048, 2048, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,window", WINDOW_CASES,
                         ids=["1000-w200", "300x700-w128-g3", "129x257-w1-g9",
                              "513-w5000", "200x72-sq>sk-w30", "2048-w300"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_window_matches_plain_on_the_card(
        cuda_device, b, hq, hkv, sq, sk, window, d, dtype):
    """Both kernels with the window against the plain version: f32 to
    atol 2e-3, bf16 to one bf16 step plus 1e-2 (as without a window)."""
    rng = np.random.default_rng(d + sq + window)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device, dtype)
        for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    assert flash_attention.launches == launches + 1
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    tol = (dict(rtol=0.0, atol=2e-3) if dtype == torch.float32
           else BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.cuda
def test_flash_attention_window_is_refused_without_the_causal_mask(
        cuda_device):
    rng = np.random.default_rng(3)
    q, k, v = _bf16_qkv(cuda_device, rng, 1, 2, 1, 64, 64, 64)
    launches = flash_attention.launches
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=16)
    assert flash_attention.launches == launches


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["starcoder2-7b", "command-r-35b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_prefill_launches_k4_once_per_layer(cuda_device, arch, dtype):
    """The reduced LM's prefill on the card: one K4 launch per layer, and
    the logits and caches of prefill with K4 against prefill with its
    plain version (``blocked_attention``), a 48-token prompt past
    starcoder2's reduced window: f32 to 1e-4, bf16 logits to 2e-2 and
    caches to two bf16 steps plus 3e-2 (the CPU tests' bounds)."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.transformer import decode_step, init_lm, prefill
    cfg = dataclasses.replace(get_arch(arch).reduced_cfg, param_dtype=dtype)
    params = init_lm(cfg, torch.Generator(cuda_device).manual_seed(0),
                     cuda_device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 49))
    launches = flash_attention.launches
    got, (gk, gv) = prefill(cfg, params, toks[:, :48], device=cuda_device)
    assert flash_attention.launches == launches + cfg.n_layers
    want, (wk, wv) = prefill(cfg, params, toks[:, :48], impl="plain",
                             device=cuda_device)
    assert flash_attention.launches == launches + cfg.n_layers
    f32 = dtype == "float32"
    torch.testing.assert_close(got, want, rtol=1e-4 if f32 else 0.0,
                               atol=1e-4 if f32 else 2e-2)
    cache_tol = (dict(rtol=1e-5, atol=1e-5) if f32
                 else dict(rtol=2**-6, atol=3e-2))
    torch.testing.assert_close(gk.float(), wk.float(), **cache_tol)
    torch.testing.assert_close(gv.float(), wv.float(), **cache_tol)
    # decode the 49th token against the prefill's cache
    shape = (cfg.n_layers, 2, cfg.n_kv_heads, 64, cfg.d_head)
    kc = torch.zeros(shape, dtype=cfg.dtype, device=cuda_device)
    vc = torch.zeros_like(kc)
    kc[:, :, :, :48], vc[:, :, :, :48] = gk, gv
    lg, _ = decode_step(cfg, params, toks[:, 48:], (kc, vc), 48,
                        device=cuda_device)
    full, _ = prefill(cfg, params, toks, device=cuda_device)
    torch.cuda.synchronize()
    torch.testing.assert_close(lg[:, 0], full, rtol=1e-4 if f32 else 0.0,
                               atol=1e-4 if f32 else 2e-2)


@pytest.mark.cuda
def test_lm_demo_serves_on_the_card(cuda_device, capsys):
    from repro_torch.launch import lm_demo
    rec = lm_demo.main(["--width", "reduced", "--batch", "2", "--prompt-len",
                        "48", "--gen", "4"])
    assert rec["k4_launches"] == 2 and rec["peak_bytes"] > 0
    assert rec["token_ids"].shape == (2, 5)
    assert torch.isfinite(rec["last_logits"]).all()
    assert "GB" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# training (no kernel runs: K3 and K4 have no backward)
# ---------------------------------------------------------------------------
def _train_case(name, dtype):
    import dataclasses
    from repro_torch.configs import dlrm_mlperf, starcoder2_7b
    from repro_torch.configs.base import dlrm_train_step, lm_train_step
    from repro_torch.data.synthetic import dlrm_batch, lm_batch
    from repro_torch.models.dlrm import init_dlrm
    from repro_torch.models.transformer import init_lm
    gen = torch.Generator().manual_seed(0)
    if name == "dlrm":
        cfg = dlrm_mlperf.REDUCED
        return (init_dlrm(cfg, gen, "cpu"),
                lambda d: dlrm_train_step(cfg, device=d),
                lambda s: dlrm_batch(s, 128, cfg.vocab_sizes))
    cfg = dataclasses.replace(starcoder2_7b.REDUCED, param_dtype=dtype)
    return (init_lm(cfg, gen, "cpu"),
            lambda d: lm_train_step(cfg, 4, 48, microbatches=2, device=d),
            lambda s: lm_batch(s, 4, 48, cfg.vocab))


def _train_run(params, make_step, arrays, device, steps=3):
    from repro_torch.train import TrainLoopConfig, train_loop
    return train_loop(make_step(device), params,
                      lambda s: {k: torch.from_numpy(v).to(device)
                                 for k, v in arrays(s).items()},
                      TrainLoopConfig(total_steps=steps))


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("dlrm", "float32"),
                                        ("starcoder2", "float32"),
                                        ("starcoder2", "bfloat16")])
def test_train_steps_on_the_card_equal_the_cpu(cuda_device, name, dtype):
    """3 steps of the reduced DLRM and starcoder2-7b on the card against
    the port's CPU steps from the same parameters, at ``chip_smoke.py``'s
    ``TRAIN_TOL``: f32 losses and grad norms rtol 1e-5, parameters rtol
    1e-5, atol 1e-4 (a third of one AdamW step at lr 3e-4: where a
    gradient is near 0, a last-bit difference of the two devices' sums
    moves its update by up to lr); bf16 losses atol 1e-3, grad norms
    rtol 2e-3, parameters atol 4e-3; the parameters' movement from
    their start within f32 1e-3, bf16 0.1 of its norm, and every leaf
    the CPU moved moved on the card.  No K3 or K4 launch."""
    import copy
    from repro_torch.kernels.embedding_bag import embag
    first, make_step, arrays = _train_case(name, dtype)
    k3, k4 = embag.launches, flash_attention.launches
    card = copy.deepcopy(first).to(cuda_device)
    _, _, got = _train_run(card, make_step, arrays, cuda_device)
    assert (embag.launches, flash_attention.launches) == (k3, k4)
    on_cpu = copy.deepcopy(first)
    _, _, want = _train_run(on_cpu, make_step, arrays, torch.device("cpu"))
    f32 = dtype == "float32"
    for key, tol in (("loss", dict(rtol=1e-5, atol=0.0) if f32
                      else dict(rtol=0.0, atol=1e-3)),
                     ("grad_norm", dict(rtol=1e-5 if f32 else 2e-3,
                                        atol=0.0))):
        np.testing.assert_allclose([r[key] for r in got],
                                   [r[key] for r in want], **tol)
    for (n, a), (_, b) in zip(card.named_parameters(),
                              on_cpu.named_parameters()):
        torch.testing.assert_close(
            a.detach().float().cpu(), b.detach().float(), msg=n,
            **(dict(rtol=1e-5, atol=1e-4) if f32 else dict(rtol=0.0,
                                                           atol=4e-3)))
    diff2 = want2 = 0.0
    for (n, a), (_, b), (_, s0) in zip(card.named_parameters(),
                                       on_cpu.named_parameters(),
                                       first.named_parameters()):
        s0 = s0.detach().double()
        da = a.detach().double().cpu() - s0
        db = b.detach().double() - s0
        assert bool(da.any()) or not bool(db.any()), f"{n} did not move"
        diff2 += float(((da - db) ** 2).sum())
        want2 += float((db ** 2).sum())
    assert want2 > 0 and (diff2 / want2) ** 0.5 <= (1e-3 if f32 else 0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dlrm", "starcoder2"])
def test_train_gradients_reach_every_parameter_on_the_card(cuda_device,
                                                            name):
    from repro_torch.configs.base import trainable, value_and_grad
    from repro_torch.models.dlrm import dlrm_loss
    from repro_torch.models.transformer import train_forward
    from repro_torch.configs import dlrm_mlperf, starcoder2_7b
    params, _, arrays = _train_case(name, "bfloat16")
    params = params.to(cuda_device)
    batch = {k: torch.from_numpy(v).to(cuda_device)
             for k, v in arrays(0).items()}
    if name == "dlrm":
        def loss():
            return dlrm_loss(dlrm_mlperf.REDUCED, params, batch,
                             device=cuda_device)
    else:
        def loss():
            return train_forward(starcoder2_7b.REDUCED, params, batch,
                                 device=cuda_device)
    _, grads = value_and_grad(loss, trainable(params))
    for n, g in grads.items():
        assert torch.isfinite(g.float()).all(), n
        assert bool((g != 0).any()), f"{n}: no gradient"


@pytest.mark.cuda
def test_kernels_raise_under_grad_mode_on_the_card(cuda_device):
    from repro_torch.kernels.embedding_bag import embag
    t = torch.randn(100, 16, device=cuda_device, requires_grad=True)
    idx = torch.zeros((4, 1), dtype=torch.int32, device=cuda_device)
    launches = embag.launches
    with pytest.raises(NotImplementedError):
        embag(t, idx)
    with pytest.raises(NotImplementedError):
        embag_tables([t], idx[:, None])
    q = torch.randn(1, 2, 16, 32, device=cuda_device, requires_grad=True)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q.detach(), q.detach())
    assert embag.launches == launches
    with torch.inference_mode():
        embag(t, idx)
    assert embag.launches == launches + 1


@pytest.mark.cuda
def test_train_launcher_on_the_card(cuda_device, capsys, tmp_path):
    from repro_torch.launch import train
    for arch in ("dlrm-mlperf", "starcoder2-7b"):
        hist = train.main(["--arch", arch, "--steps", "3", "--ckpt",
                           str(tmp_path / arch)])
        assert len(hist) == 3
        assert all(np.isfinite(r["loss"]) for r in hist)
    assert "done: loss" in capsys.readouterr().out


@pytest.mark.cuda
def test_checkpoint_round_trip_of_card_tensors(cuda_device, tmp_path):
    from repro_torch.train import restore_checkpoint, save_checkpoint
    tree = {"h": torch.randn(33, 7, device=cuda_device).bfloat16(),
            "f": torch.randn(5, device=cuda_device),
            "i": torch.arange(4, device=cuda_device, dtype=torch.int32)}
    save_checkpoint(tmp_path, 3, tree)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    restore_checkpoint(tmp_path, like)
    for k in tree:
        assert like[k].device == tree[k].device
        assert torch.equal(like[k].view(torch.int16) if k == "h" else
                           like[k], tree[k].view(torch.int16) if k == "h"
                           else tree[k])


# ---------------------------------------------------------------------------
# the MoE LMs and the GNNs (K4 in the MoE prefill; the GNNs' aggregate is
# the plain scatter, as the reference's)
# ---------------------------------------------------------------------------
MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]


def _moe_pair(name, dtype, device):
    import copy
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.moe import init_moe_lm
    cfg = dataclasses.replace(get_arch(name).reduced_cfg, param_dtype=dtype)
    cpu = init_moe_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, cpu, copy.deepcopy(cpu).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_apply_on_the_card_equals_the_cpu(cuda_device, name, dtype):
    """``moe_apply`` on 256 tokens, card against CPU: f32 routing and
    ``keep`` equal, outputs to 1e-5, the aux loss rtol 1e-6; bf16
    outputs to two bf16 steps plus 2e-2 (the combine's bf16 scatter-add
    rounds in arrival order on the card)."""
    from repro_torch.models.moe import moe_apply
    cfg, cpu, card = _moe_pair(name, dtype, cuda_device)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (256, cfg.d_model)).astype(np.float32)).to(cfg.dtype)
    rc, rg = [], []
    with torch.inference_mode():
        yc, ac = moe_apply(cpu.blocks[0].moe, x, cfg, rc)
        yg, ag = moe_apply(card.blocks[0].moe, x.to(cuda_device), cfg, rg)
    torch.cuda.synchronize()
    f32 = dtype == "float32"
    if f32:
        assert torch.equal(rg[0]["expert_idx"].cpu(), rc[0]["expert_idx"])
        assert torch.equal(rg[0]["keep"].cpu(), rc[0]["keep"])
    torch.testing.assert_close(yg.float().cpu(), yc.float(),
                               **(dict(rtol=0.0, atol=1e-5) if f32
                                  else dict(rtol=2**-6, atol=2e-2)))
    np.testing.assert_allclose(float(ag), float(ac), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_prefill_launches_k4_once_per_layer(cuda_device, name, dtype):
    """The reduced MoE's prefill on the card: one K4 launch per layer;
    its logits against prefill with ``blocked_attention`` on the card
    and against the CPU's (f32 1e-4; bf16 2e-2)."""
    from repro_torch.models.moe import moe_prefill
    cfg, cpu, card = _moe_pair(name, dtype, cuda_device)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 48))
    launches = flash_attention.launches
    got, _ = moe_prefill(cfg, card, toks, device=cuda_device)
    assert flash_attention.launches == launches + cfg.n_layers
    plain, _ = moe_prefill(cfg, card, toks, impl="plain",
                           device=cuda_device)
    want, _ = moe_prefill(cfg, cpu, toks, device="cpu")
    assert flash_attention.launches == launches + cfg.n_layers
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" \
        else dict(rtol=0.0, atol=2e-2)
    torch.testing.assert_close(got, plain, **tol)
    torch.testing.assert_close(got.cpu(), want, **tol)


@pytest.mark.cuda
def test_lm_demo_serves_a_moe_on_the_card(cuda_device, capsys):
    from repro_torch.launch import lm_demo
    rec = lm_demo.main(["--arch", "grok-1-314b", "--width", "reduced",
                        "--batch", "2", "--prompt-len", "48", "--gen", "4"])
    assert rec["k4_launches"] == 2 and rec["peak_bytes"] > 0
    assert 0.0 <= rec["dropped_share"] < 1.0
    assert torch.isfinite(rec["last_logits"]).all()
    assert "dropped at capacity" in capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("config", ["SG0", "SG1", "SGR", "SD0", "SD1",
                                    "SDR"])
def test_gnn_aggregate_on_the_card_equals_the_cpu(cuda_device, config,
                                                  kind):
    """``aggregate`` under the six configs on 20,000 edges into 3,000
    nodes (some empty), D = 8: min and max bit-equal to the CPU's
    (+-inf in the empty segments), sums to 1e-5 (atomics)."""
    from repro_torch.core.config_space import SystemConfig as S
    from repro_torch.models.gnn import aggregate
    rng = np.random.default_rng(3)
    dst = torch.from_numpy(rng.integers(0, 2900, 20000).astype(np.int32))
    v = torch.from_numpy(rng.standard_normal((20000, 8)).astype(np.float32))
    want = aggregate(v, dst, 3000, kind, S.from_name(config))
    got = aggregate(v.to(cuda_device), dst.to(cuda_device), 3000, kind,
                    S.from_name(config)).cpu()
    if kind == "sum":
        torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    else:
        assert torch.equal(got, want)
        assert torch.isinf(got[2900:]).all()


def _gnn_case(name):
    from repro_torch.configs.registry import get_arch
    arch = get_arch(name)
    cfg = arch.reduced_cfg
    rng = np.random.default_rng(0)
    n, e = 64, 256
    b = {"src": rng.integers(0, n, e).astype(np.int32),
         "dst": rng.integers(0, n - 6, e).astype(np.int32)}
    if name in ("schnet", "equiformer-v2"):
        g = cfg.n_graphs
        b.update(species=rng.integers(0, 10, n).astype(np.int32),
                 positions=rng.standard_normal((n, 3)).astype(np.float32),
                 graph_ids=(np.arange(n) % g).astype(np.int32),
                 energy=rng.standard_normal(g).astype(np.float32))
    elif name == "meshgraphnet":
        b.update(node_feat=rng.standard_normal((n, cfg.d_node_in))
                 .astype(np.float32),
                 edge_feat=rng.standard_normal((e, cfg.d_edge_in))
                 .astype(np.float32),
                 target=rng.standard_normal((n, cfg.d_out))
                 .astype(np.float32))
    else:
        deg = np.bincount(b["dst"], minlength=n)
        b.update(node_feat=rng.standard_normal((n, cfg.d_in))
                 .astype(np.float32), in_degree=deg.astype(np.int32),
                 labels=rng.integers(0, cfg.n_classes, n).astype(np.int32))
    params = arch.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return arch, cfg, params, b


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pna", "meshgraphnet", "schnet",
                                  "equiformer-v2"])
def test_gnn_train_step_on_the_card_equals_the_cpu(cuda_device, name):
    """One AdamW step (lr 1e-3) of each reduced GNN on the card against
    the CPU from the same parameters: loss and grad norm rtol 1e-4
    (EquiformerV2's bf16 edge tensors: 1e-2), parameters atol 1e-4
    (EquiformerV2 4e-3, ``chip_smoke.py``'s bf16 ``TRAIN_TOL``: AdamW
    moves a leaf whose gradient is near 0 by up to lr = 1e-3, so a
    rounding difference of such a gradient moves it by that much; seen
    1.7e-3 after 3 steps), the parameters' movement within 1e-2 of its
    norm (EquiformerV2 0.1), and every leaf the CPU moved moved on the
    card (the last
    block's gate of EquiformerV2 gets no gradient: only the invariant
    channel reaches the head)."""
    import copy
    from repro_torch.configs.base import loss_train_step
    from repro_torch.optim import adamw_init
    arch, cfg, first, b = _gnn_case(name)
    eq = name == "equiformer-v2"
    out = []
    for d in (cuda_device, torch.device("cpu")):
        params = copy.deepcopy(first).to(d)
        batch = {k: torch.from_numpy(v).to(d) for k, v in b.items()}
        step = loss_train_step(cfg, arch.loss, device=d)
        params, _, metrics = step(params, adamw_init(params), batch)
        out.append((params, metrics))
    (card, mc), (cpu, mcpu) = out
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mc[key]), float(mcpu[key]),
                                   rtol=1e-2 if eq else 1e-4)
    diff2 = want2 = 0.0
    for (n, a), (_, c), (_, s0) in zip(card.named_parameters(),
                                       cpu.named_parameters(),
                                       first.named_parameters()):
        a, c = a.detach().cpu().double(), c.detach().double()
        s0 = s0.detach().double()
        torch.testing.assert_close(a, c, rtol=0.0,
                                   atol=4e-3 if eq else 1e-4,
                                   msg=lambda m, n=n: f"{n}: {m}")
        assert bool((a - s0).any()) or not bool((c - s0).any()), n
        diff2 += float((((a - s0) - (c - s0)) ** 2).sum())
        want2 += float(((c - s0) ** 2).sum())
    assert (diff2 / want2) ** 0.5 <= (0.1 if eq else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "pna",
                                  "equiformer-v2"])
def test_train_launcher_trains_moe_and_gnn_on_the_card(cuda_device, arch,
                                                       capsys):
    from repro_torch.launch import train
    hist = train.main(["--arch", arch, "--steps", "3", "--seq", "32"])
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
    assert "done: loss" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the sharding pieces on the card: an NCCL group of one rank
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nccl_mesh():
    """An NCCL group of this process alone and its 1 x 1 mesh."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1, device_id=dev)
    yield make_local_mesh()
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_local_mesh_is_one_by_one(nccl_mesh):
    from repro_torch.configs.base import axes_for_mesh
    assert tuple(nccl_mesh.shape) == (1, 1)
    assert nccl_mesh.mesh_dim_names == ("data", "model")
    assert nccl_mesh.device_type == "cuda"
    ax = axes_for_mesh(nccl_mesh)
    assert ax.dp == ("data",) and ax.tp == "model" and ax.dp_size == 1


def _reduced_lm(name, dtype, ax):
    import dataclasses
    from repro_torch.configs.registry import get_arch
    arch = get_arch(name, axes=ax)
    cfg = dataclasses.replace(arch.reduced_cfg, param_dtype=dtype,
                              dp_axes=arch.cfg.dp_axes,
                              tp_axis=arch.cfg.tp_axis,
                              sp_axis=arch.cfg.sp_axis)
    return cfg, dataclasses.replace(cfg, dp_axes=(), tp_axis=None,
                                    sp_axis=None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["starcoder2-7b", "command-r-35b"])
def test_sharded_prefill_is_bit_equal_one_k4_per_layer(nccl_mesh, name,
                                                       dtype):
    """The reduced LM's prefill through DTensor parameters on the 1 x 1
    mesh, K4 inside ``local_map``: one K4 launch per layer, logits and
    cache bit-equal to the unsharded prefill of the same weights."""
    import copy

    from repro_torch.configs.base import (axes_for_mesh, distribute_params,
                                          distribute_tree, lm_param_sharding)
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.mesh_compat import use_mesh
    dev = torch.device("cuda")
    ax = axes_for_mesh(nccl_mesh)
    cfg, plain = _reduced_lm(name, dtype, ax)
    params = T.init_lm(plain, torch.Generator(dev).manual_seed(3), dev)
    sharded = distribute_params(copy.deepcopy(params), nccl_mesh,
                                lm_param_sharding(cfg, ax))
    tokens = torch.from_numpy(
        lm_batch(0, 2, 96, cfg.vocab)["tokens"]).to(dev)
    want, (wk, wv) = T.prefill(plain, params, tokens, device=dev)
    flash_attention.launches = 0
    with use_mesh(nccl_mesh):
        got, (gk, gv) = T.prefill(
            cfg, sharded, distribute_tree({"t": tokens}, nccl_mesh,
                                          {"t": (ax.dp, None)})["t"],
            device=dev)
    assert flash_attention.launches == cfg.n_layers
    assert torch.equal(got.full_tensor(), want)
    assert torch.equal(gk.full_tensor(), wk)
    assert torch.equal(gv.full_tensor(), wv)


@pytest.mark.cuda
def test_compressed_reducer_over_nccl_equals_the_cpu(nccl_mesh):
    """Two rounds of ``CompressedReducer.reduce`` with an NCCL all-reduce
    mean: wire and residual bit-equal to the same rounds on the CPU."""
    from repro_torch.optim.compression import (CompressedReducer,
                                               all_reduce_mean)
    gen = torch.Generator().manual_seed(5)
    grads = {"w": torch.randn((256, 96), generator=gen) * 1e-3,
             "b": torch.randn((96,), generator=gen).to(torch.bfloat16)}
    cr = CompressedReducer(torch.bfloat16)
    card = {k: v.cuda() for k, v in grads.items()}
    st, cst = cr.init_state(card), cr.init_state(grads)
    for _ in range(2):
        out, st = cr.reduce(card, st, all_reduce_mean())
        cout, cst = cr.reduce(grads, cst, lambda w: {k: v / 1 for k, v in
                                                     w.items()})
        for k in grads:
            assert out[k].dtype == torch.float32
            assert torch.equal(out[k].cpu(), cout[k])
            assert torch.equal(st[k].cpu(), cst[k])


@pytest.mark.cuda
def test_checkpoint_restore_with_shardings_on_the_card(nccl_mesh, tmp_path):
    """DTensor parameters and AdamW moments saved whole (rank 0 writes)
    and restored onto a mesh ``ElasticMesh`` builds with ``shardings=``:
    bit-equal."""
    from repro_torch.configs.base import (axes_for_mesh, lm_param_sharding,
                                          opt_sharding_like)
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.fault_tolerance import ElasticMesh
    dev = torch.device("cuda")
    ax = axes_for_mesh(nccl_mesh)
    cfg, plain = _reduced_lm("starcoder2-7b", "bfloat16", ax)
    em = ElasticMesh(model_parallel=1)
    mesh = em.build()
    specs = lm_param_sharding(cfg, ax)
    params = em.reshard(T.init_lm(plain, torch.Generator(dev).manual_seed(4),
                                  dev), mesh, specs)
    opt = adamw_init(params)
    for m in opt["mu"].values():
        m.to_local().uniform_(-1, 1)
    save_checkpoint(tmp_path, 2, (params, opt))
    fresh = T.init_lm(plain, torch.Generator(dev).manual_seed(9), dev)
    fresh_opt = adamw_init(fresh)
    (rp, ro), step, _ = restore_checkpoint(
        tmp_path, (fresh, fresh_opt),
        shardings=(mesh, (specs, opt_sharding_like(specs))))
    assert step == 2
    for (n, a), (_, b) in zip(rp.named_parameters(),
                              params.named_parameters()):
        assert torch.equal(a.full_tensor(), b.full_tensor()), n
    for n in opt["mu"]:
        assert torch.equal(ro["mu"][n].full_tensor(),
                           opt["mu"][n].full_tensor()), n


@pytest.mark.cuda
@pytest.mark.parametrize("app,cfg", [("SSSP", "TG0"), ("PR", "SD0")])
def test_stats_counts_each_engine_with_the_kernels_on_the_card(
        cuda_device, engine_graph, app, cfg):
    """``STATS`` grows by each run's dispatches: the host engine's
    iterations, the fused engine's replays; K2 (SSSP's min over the CSC
    order) or K1 (PR's owned sum) launched; the states those of a plain
    fused run (SSSP exact, PR to atol 1e-6)."""
    from repro_torch.core import STATS
    kernel = seg_sum if app == "PR" else seg_minmax
    launches = kernel.launches
    STATS.reset()
    fused, host = _engines(app, engine_graph, cfg, cuda_device)
    assert STATS.dispatches == host.dispatches + fused.dispatches
    assert host.dispatches == host.iterations
    assert kernel.launches > launches
    plain = run(REGISTRY[app](), engine_graph, SystemConfig.from_name(cfg),
                device=cuda_device)
    for res in (fused, host):
        if app == "PR":
            assert abs(res.iterations - plain.iterations) <= 1
            torch.testing.assert_close(res.state["rank"],
                                       plain.state["rank"], rtol=0,
                                       atol=1e-6)
        else:
            assert res.iterations == plain.iterations
            for key, want in plain.state.items():
                assert torch.equal(res.state[key], want), key


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_gathered_reduce_matches_its_oracle_on_the_card(cuda_device, dtype,
                                                        kind):
    """Ids below 0 and past the segments dropped; exact but for the
    float32 sum, which the card adds in a run-dependent order."""
    from repro_torch.kernels.segment_reduce import (
        gathered_segment_reduce, gathered_segment_reduce_ref)
    rng = np.random.default_rng(5)
    n, segs = 20_000, 1_000
    ids = rng.integers(-3, segs + 3, n).astype(np.int32)
    vals = (rng.standard_normal(n).astype(np.float32) if dtype == "float32"
            else rng.integers(-1000, 1000, n).astype(np.int32))
    got = gathered_segment_reduce(
        torch.from_numpy(vals).to(cuda_device),
        torch.from_numpy(ids).to(cuda_device), segs, kind).cpu().numpy()
    want = gathered_segment_reduce_ref(vals, ids, segs, kind)
    assert got.dtype == want.dtype
    if dtype == "float32" and kind == "sum":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
