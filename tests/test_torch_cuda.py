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
P > 1 and the mean (another order of the sum); K4 to atol 2e-3 in f32
and, in bf16, to one bf16 step of the output (rtol 2**-7) plus atol 1e-2
(online softmax against one pass, p rounded to bf16 at another running
max).
"""
import numpy as np
import pytest
import torch

from repro_torch.algorithms import bfs, pagerank, sssp
from repro_torch.core import SystemConfig, run
from repro_torch.graph import powerlaw_graph
from repro_torch.kernels.embedding_bag import embag, embedding_bag_ref
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
