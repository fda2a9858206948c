"""The port's segment reducers against ``repro``'s.

The same binned edges, made from numpy seeds, go through the reference
(its Pallas kernels in interpret mode, as its own tests run them) and
through the port's plain path on the CPU, which reduces chunk by chunk
through the CUDA kernels' chunk plan.  min/max and int32 results must
be bit-equal; float32 sums agree to atol=1e-5 (rtol=1e-5 where the
terms are positive), because the tiled one-hot matmul of the reference
and the port's scatter add the same terms in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.segment_reduce import BlockedSegmentReducer as JReducer
from repro.kernels.segment_reduce import gathered_segment_reduce as j_gather
from repro.kernels.segment_reduce.kernel import plan_tiles as j_plan_tiles
from repro.kernels.segment_reduce.kernel import (seg_minmax_pallas,
                                                 seg_sum_pallas)
from repro_torch.core.config_space import Consistency
from repro_torch.core.consistency import scheduled_reduce
from repro_torch.core.vertex_program import Monoid
from repro_torch.graph import powerlaw_graph
from repro_torch.kernels.autotune import build_reducer
from repro_torch.kernels.segment_reduce import (BlockedSegmentReducer,
                                                ChunkPlan, TilingPlan,
                                                gathered_segment_reduce,
                                                plan_chunks, plan_tiles,
                                                seg_minmax, seg_minmax_plain,
                                                seg_sum, seg_sum_plain,
                                                segment_reduce_ref)

SWEEP = [(1000, 300, 64, 1), (4096, 512, 128, 8), (777, 100, 32, 5),
         (64, 512, 128, 1), (2048, 64, 64, 16)]


def _binned(rng, e, v, b):
    raw = rng.integers(0, v, e)
    order = np.argsort(raw // b, kind="stable")
    ids = raw[order]
    bp = np.zeros((v + b - 1) // b + 1, np.int64)
    np.add.at(bp, raw // b + 1, 1)
    return ids, np.cumsum(bp)


def _values(rng, e, d, dtype):
    if dtype == "int32":
        vals = rng.integers(-10**6, 10**6, (e, d)).astype(np.int32)
    else:
        vals = rng.standard_normal((e, d)).astype(np.float32)
    return vals if d > 1 else vals[:, 0]


@pytest.mark.parametrize("e,v,b,d", SWEEP)
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_blocked_reducer_matches_reference(e, v, b, d, kind):
    rng = np.random.default_rng(e + v)
    ids, bp = _binned(rng, e, v, b)
    vals = _values(rng, e, d, "float32")
    ref = np.asarray(JReducer(ids, bp, v, b, tile_e=256).reduce(
        jnp.asarray(vals), kind))
    red = BlockedSegmentReducer(ids, bp, v, b, tile_e=256, device="cpu")
    got = red.reduce(torch.from_numpy(vals), kind).numpy()
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if kind == "sum":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)
    assert red.n_tiles == JReducer(ids, bp, v, b, tile_e=256).n_tiles


@pytest.mark.parametrize("e,v,b,d", SWEEP[:3])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_blocked_reducer_int32_exact(e, v, b, d, kind):
    rng = np.random.default_rng(e * 7 + v)
    ids, bp = _binned(rng, e, v, b)
    vals = _values(rng, e, d, "int32")
    ref = np.asarray(JReducer(ids, bp, v, b).reduce(jnp.asarray(vals), kind))
    got = BlockedSegmentReducer(ids, bp, v, b, device="cpu").reduce(
        torch.from_numpy(vals), kind).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_masked_matches_reference(kind):
    rng = np.random.default_rng(42)
    e, v, b = 800, 256, 64
    ids, bp = _binned(rng, e, v, b)
    vals = rng.standard_normal(e).astype(np.float32)
    mask = rng.random(e) < 0.6
    ref = np.asarray(JReducer(ids, bp, v, b).masked(
        jnp.asarray(vals), jnp.asarray(mask), kind))
    got = BlockedSegmentReducer(ids, bp, v, b, device="cpu").masked(
        torch.from_numpy(vals), torch.from_numpy(mask), kind).numpy()
    if kind == "sum":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_reducer_identity_matches_reference(kind, dtype):
    ref = np.asarray(JReducer.identity(kind, jnp.dtype(dtype)))
    port = BlockedSegmentReducer.identity(kind, getattr(torch, dtype))
    assert np.asarray(port, dtype).tobytes() == ref.tobytes()


@pytest.mark.parametrize("tile_e", [1, 7, 64, 512])
def test_plan_tiles_matches_reference(tile_e):
    _, bp = _binned(np.random.default_rng(tile_e), 900, 300, 32)
    bp[3] = bp[2]  # an empty block keeps one all-padding tile
    bp[3:] = np.maximum.accumulate(bp[3:])
    for a, b in zip(plan_tiles(bp, tile_e), j_plan_tiles(bp, tile_e)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_gathered_reduce_matches_reference(splits, kind, dtype):
    rng = np.random.default_rng(splits * 13 + len(kind))
    cap, v = 300, 90
    ids = rng.integers(-1, v, cap).astype(np.int32)
    vals = _values(rng, cap, 1, dtype)
    plan = TilingPlan(gather_splits=splits)
    from repro.kernels.segment_reduce import TilingPlan as JPlan
    ref = np.asarray(j_gather(jnp.asarray(vals), jnp.asarray(ids), v, kind,
                              plan=JPlan(gather_splits=splits)))
    got = gathered_segment_reduce(torch.from_numpy(vals),
                                  torch.from_numpy(ids), v, kind,
                                  plan=plan).numpy()
    if kind == "sum" and dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("d", [1, 4])
def test_gathered_reduce_on_the_cpu_never_loads_the_kernels(monkeypatch,
                                                            splits, kind, d):
    """A CPU tensor takes the plain scatter, which equals the numpy
    oracle (``[S]`` and ``[S, D]``), and never opens the CUDA library."""
    from repro_torch.kernels.segment_reduce import (
        gathered_segment_reduce_ref, kernel)

    def no_library():
        raise AssertionError("the CPU path opened the CUDA library")

    monkeypatch.setattr(kernel, "_library", no_library)
    monkeypatch.setattr(gathered_segment_reduce, "launches", 0)
    rng = np.random.default_rng(31 + splits + d)
    cap, v = 300, 90
    ids = rng.integers(-2, v + 2, cap).astype(np.int32)
    vals = rng.integers(-1000, 1000, (cap, d)).astype(np.int32)
    vals = vals if d > 1 else vals[:, 0]
    got = gathered_segment_reduce(torch.from_numpy(vals),
                                  torch.from_numpy(ids), v, kind,
                                  plan=TilingPlan(gather_splits=splits))
    np.testing.assert_array_equal(
        got.numpy(), gathered_segment_reduce_ref(vals, ids, v, kind))
    assert gathered_segment_reduce.launches == 0


@pytest.mark.parametrize("kind", ["min", "max"])
def test_gathered_identity_keys_decode_to_infinities(kind):
    """The card's float min/max fills ``out`` with the key of +-inf:
    K2's order-preserving map, which the kernel decodes in place."""
    from repro_torch.kernels.segment_reduce import kernel, sparse
    key = torch.tensor(sparse._IDENT_KEY[kind], dtype=torch.int32)
    assert kernel._flip(key).view(torch.float32).item() == (
        float("inf") if kind == "min" else float("-inf"))
    # every finite float's key lies on the right side of the identity's
    keys = kernel._key(torch.tensor([-3e38, -0.0, 0.0, 3e38]), kind)
    assert bool(((keys < key) if kind == "min" else (keys > key)).all())


def test_segment_reduce_ref_drops_out_of_range_ids():
    vals = torch.tensor([1.0, 2.0, 4.0, 8.0])
    ids = torch.tensor([0, -1, 3, 1])
    np.testing.assert_array_equal(
        segment_reduce_ref(vals, ids, 3, "sum").numpy(), [1.0, 8.0, 0.0])
    np.testing.assert_array_equal(
        segment_reduce_ref(vals, ids, 3, "min").numpy(), [1.0, 8.0, np.inf])


@pytest.mark.parametrize("consistency", list(Consistency))
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
def test_scheduled_reduce_combines_chunks(consistency, kind):
    rng = np.random.default_rng(3)
    parts = torch.from_numpy(rng.integers(0, 100, (4, 10)).astype(np.int32))
    n = 1 if consistency is Consistency.DRF0 else 4
    got = scheduled_reduce(lambda i: parts[i], n, consistency, Monoid(kind))
    want = {"sum": parts[:n].sum(0), "min": parts[:n].amin(0),
            "max": parts[:n].amax(0)}[kind]
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_wrappers_reject_what_the_kernels_do_not_take():
    ids, bp = _binned(np.random.default_rng(0), 100, 64, 32)
    ids_t = torch.from_numpy(ids.astype(np.int32))
    bp_t = torch.from_numpy(bp.astype(np.int32))
    kw = dict(block_size=32, num_segments=64)
    ints = torch.ones(100, 1, dtype=torch.int32)  # K1 sums int32 exactly
    assert torch.equal(seg_sum(ints, ids_t, bp_t, **kw),
                       seg_sum_plain(ints, ids_t, bp_t, **kw))
    with pytest.raises(TypeError, match="values"):
        seg_sum(torch.ones(100, 1, dtype=torch.int64), ids_t, bp_t, **kw)
    with pytest.raises(TypeError):
        seg_minmax(torch.ones(100, 1, dtype=torch.float64), ids_t, bp_t,
                   is_min=True, **kw)
    with pytest.raises(ValueError, match="shared memory"):
        seg_sum(torch.ones(100, 400), ids_t, bp_t, **kw)
    with pytest.raises(ValueError, match="block_ptr"):
        seg_sum(torch.ones(100, 1), ids_t, bp_t[:-1], **kw)
    with pytest.raises(ValueError, match="tile_e"):
        seg_sum(torch.ones(100, 1), ids_t, bp_t, tile_e=48, **kw)
    with pytest.raises(TypeError, match="segment_ids"):
        seg_sum(torch.ones(100, 1), ids_t.long(), bp_t, **kw)
    with pytest.raises(ValueError, match="chunk plan reads"):
        seg_sum(torch.ones(100, 1), ids_t, bp_t, **kw,
                chunks=ChunkPlan.build(np.array([0, 60, 101])))
    with pytest.raises(ValueError, match="chunk plan covers"):
        seg_minmax(torch.ones(100, 1), ids_t, bp_t, is_min=True, **kw,
                   chunks=ChunkPlan.build(np.array([0, 100])))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    rng = np.random.default_rng(5)
    ids, bp = _binned(rng, 500, 200, 64)
    vals = torch.from_numpy(rng.standard_normal((500, 2)).astype(np.float32))
    args = (vals, torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(bp.astype(np.int32)))
    kw = dict(block_size=64, num_segments=200)
    before = (seg_sum.launches, seg_minmax.launches)
    assert torch.equal(seg_sum(*args, **kw), seg_sum_plain(*args, **kw))
    assert torch.equal(seg_minmax(*args, is_min=False, **kw),
                       seg_minmax_plain(*args, is_min=False, **kw))
    assert (seg_sum.launches, seg_minmax.launches) == before
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="no kernel"):
        seg_sum(*meta, **kw)


def test_int32_sum_matches_numpy_add_at():
    rng = np.random.default_rng(11)
    e, v, b = 3000, 700, 128
    ids, bp = _binned(rng, e, v, b)
    vals = rng.integers(-2**20, 2**20, (e, 3)).astype(np.int32)
    got = seg_sum(torch.from_numpy(vals), torch.from_numpy(ids.astype(np.int32)),
                  torch.from_numpy(bp.astype(np.int32)), block_size=b,
                  num_segments=v, tile_e=256)
    want = np.zeros((v, 3), np.int32)
    np.add.at(want, ids, vals)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_reducers_without_device_need_cuda():
    from repro_torch.graph import powerlaw_graph
    from repro_torch.kernels.autotune import build_reducer
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the reducers would use it")
    ids, bp = _binned(np.random.default_rng(1), 100, 64, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockedSegmentReducer(ids, bp, 64, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockedSegmentReducer.from_plan(ids, bp, 64, 32)
    g = powerlaw_graph(200, 800, alpha=1.2, seed=3, block_size=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_reducer(g, "pull")
    assert build_reducer(g, "owned", device="cpu").segment_ids.device.type \
        == "cpu"


# ---------------------------------------------------------------------------
# the chunk plan of the CUDA kernels, and the plain path that follows it
# ---------------------------------------------------------------------------
def _check_chunk_plan(block_ptr, chunk_e):
    """Every property the kernels rely on, for one plan."""
    block_ptr = np.asarray(block_ptr, np.int64)
    block, start, end, index, slot = plan_chunks(block_ptr, chunk_e)
    n_blocks = block_ptr.shape[0] - 1
    for a in (block, start, end, index, slot):
        assert a.dtype == np.int32 and a.shape == block.shape
    # every block has chunks, in block order, each inside its block
    np.testing.assert_array_equal(np.unique(block), np.arange(n_blocks))
    assert np.all(np.diff(block) >= 0)
    assert np.all(start >= block_ptr[block])
    assert np.all(end <= block_ptr[block + 1])
    assert np.all(end - start <= chunk_e) and np.all(end >= start)
    # every edge exactly once: the chunks tile the edge range in order
    if block.size:
        assert start[0] == block_ptr[0] and end[-1] == block_ptr[-1]
        np.testing.assert_array_equal(start[1:], end[:-1])
    # an empty block keeps one (empty) chunk; a full chunk is never empty
    per_block = np.bincount(block, minlength=n_blocks)
    empty = np.diff(block_ptr) == 0
    assert np.all(per_block[empty] == 1)
    assert np.all((end > start) | empty[block])
    # index counts a block's chunks from 0; slots are dense, unique and
    # consecutive within a split block, -1 for a block of one chunk
    first = np.cumsum(per_block) - per_block
    np.testing.assert_array_equal(index, np.arange(block.size)
                                  - first[block])
    split = per_block[block] > 1
    assert np.all(slot[~split] == -1)
    np.testing.assert_array_equal(slot[split], np.arange(split.sum()))
    assert np.all(np.diff(block_ptr)[per_block > 1] > chunk_e)
    return block, start, end, index, slot


@given(st.integers(0, 2**31 - 1), st.integers(0, 40), st.integers(1, 300),
       st.integers(0, 3000))
@settings(max_examples=40, deadline=None)
def test_plan_chunks_properties(seed, n_blocks, chunk_e, heavy):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 60, n_blocks)
    counts[rng.random(n_blocks) < 0.3] = 0          # empty blocks
    if n_blocks:
        counts[rng.integers(0, n_blocks)] = heavy    # one hub block
    _check_chunk_plan(np.concatenate([[0], np.cumsum(counts)]), chunk_e)


@pytest.mark.parametrize("block_ptr", [
    [0], [0, 0], [0, 0, 0, 0],                       # no edges at all
    [0, 1000], [0, 0, 1000, 1000],                   # one block holds all
    [0, 500, 500, 500, 900, 900, 1300],              # empty between heavy
], ids=["no-blocks", "one-empty", "all-empty", "one-block", "one-of-three",
        "empty-between-heavy"])
@pytest.mark.parametrize("chunk_e", [1, 7, 256, 5000])
def test_plan_chunks_edge_cases(block_ptr, chunk_e):
    block, start, end, _, slot = _check_chunk_plan(block_ptr, chunk_e)
    counts = np.diff(block_ptr)
    if chunk_e == 1:  # one chunk per edge; every block of 2+ edges splits
        assert (slot >= 0).sum() == counts[counts > 1].sum()
    if chunk_e > block_ptr[-1]:  # larger than E: one chunk per block
        assert block.size == len(block_ptr) - 1 and np.all(slot == -1)
    assert ChunkPlan.build(np.asarray(block_ptr), chunk_e).n_chunks \
        == block.size


def test_plan_chunks_rejects_what_the_kernels_cannot_index():
    with pytest.raises(ValueError, match="chunk_e"):
        plan_chunks(np.array([0, 10]), 0)
    with pytest.raises(ValueError, match="int32"):
        plan_chunks(np.array([0, 2**31]), 4096)


#: A degree-sorted power-law graph: its hubs share block 0, which the
#: chunk plan below splits into several chunks
SKEWED = dict(n=1500, n_edges=9000, alpha=1.1, max_degree=400,
              degree_order="sorted", seed=5, weighted=True, block_size=64)
SKEWED_CHUNK_E = 256
SKEWED_TILE_E = 128


def _pallas_blocked(vals, ids, bp, bs, v, kind):
    """The reference's Pallas kernels in interpret mode over its tiling
    plan of the same binned edges (as its BlockedSegmentReducer runs
    them)."""
    gather, tbid, tfirst = j_plan_tiles(bp, SKEWED_TILE_E)
    pad = gather < 0
    safe = np.where(pad, 0, gather)
    lids = np.where(pad, -1, ids[safe] - tbid[:, None] * bs).astype(np.int32)
    tiled = vals[safe]
    n_out = -(-v // bs)
    args = (jnp.asarray(tiled), jnp.asarray(lids), jnp.asarray(tbid),
            jnp.asarray(tfirst))
    if kind == "sum":
        out = seg_sum_pallas(*args, block_size=bs, num_out_blocks=n_out,
                             interpret=True)
    else:
        out = seg_minmax_pallas(*args, block_size=bs, num_out_blocks=n_out,
                                is_min=kind == "min", interpret=True)
    return np.asarray(out)[:v]


@pytest.mark.parametrize("order", ["owned", "pull"])
@pytest.mark.parametrize("kind", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype,d", [("float32", 1), ("float32", 3),
                                     ("int32", 1), ("int32", 3)])
def test_chunked_plain_matches_pallas_on_a_skewed_graph(order, kind, dtype,
                                                        d):
    red = build_reducer(powerlaw_graph(**SKEWED), order, device="cpu")
    ids, bp = red.segment_ids.numpy(), red.block_ptr.numpy()
    chunks = ChunkPlan.build(bp, SKEWED_CHUNK_E)
    block = chunks.table[0].numpy()
    assert (block == 0).sum() >= 4, "block 0 must split into chunks"
    rng = np.random.default_rng(len(order) * 10 + d)
    if kind == "sum" and dtype == "float32":
        # positive terms: the relative tolerance then bounds the error of
        # any order of addition (terms that cancel would not)
        vals = rng.uniform(1.0, 2.0, (ids.shape[0], d)).astype(np.float32)
    else:
        vals = _values(rng, ids.shape[0], d, dtype).reshape(ids.shape[0], d)
    kw = dict(block_size=red.block_size, num_segments=red.num_segments,
              chunks=chunks)
    args = (torch.from_numpy(vals), red.segment_ids, red.block_ptr)
    if kind == "sum":
        got = seg_sum_plain(*args, **kw).numpy()
    else:
        got = seg_minmax_plain(*args, is_min=kind == "min", **kw).numpy()
    want = _pallas_blocked(vals, ids, bp, red.block_size, red.num_segments,
                           kind)
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "sum" and dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("chunk_e", [1, 3, 64, 10**6])
def test_chunked_plain_does_not_depend_on_the_chunk_size(chunk_e):
    rng = np.random.default_rng(chunk_e)
    ids, bp = _binned(rng, 1200, 500, 64)
    ids_t = torch.from_numpy(ids.astype(np.int32))
    bp_t = torch.from_numpy(bp.astype(np.int32))
    vals = torch.from_numpy(rng.integers(-2**31, 2**31, (1200, 2))
                            .astype(np.int32))
    kw = dict(block_size=64, num_segments=500)
    chunks = ChunkPlan.build(bp, chunk_e)
    for kind in ("sum", "min", "max"):
        want = segment_reduce_ref(vals, ids_t, 500, kind)
        if kind == "sum":
            got = seg_sum(vals, ids_t, bp_t, chunks=chunks, **kw)
        else:
            got = seg_minmax(vals, ids_t, bp_t, is_min=kind == "min",
                             chunks=chunks, **kw)
        assert torch.equal(got, want), kind


def test_plain_minmax_orders_floats_as_the_kernels_do():
    """-0.0 below +0.0 through the kernels' int32 keys; a NaN of either
    sign wins both min and max; empty rows keep +-inf."""
    nan = float("nan")
    vals = torch.tensor([[0.0], [-0.0], [nan], [float("inf")],
                         [float("-inf")], [1.0], [-nan], [-0.0]])
    ids = torch.tensor([0, 0, 1, 1, 2, 2, 3, 4], dtype=torch.int32)
    bp = torch.tensor([0, 4, 7, 8], dtype=torch.int32)
    kw = dict(block_size=2, num_segments=6)
    lo = seg_minmax(vals, ids, bp, is_min=True, **kw)[:, 0]
    hi = seg_minmax(vals, ids, bp, is_min=False, **kw)[:, 0]
    assert torch.signbit(lo[0]) and not torch.signbit(hi[0])
    assert torch.isnan(lo[1]) and torch.isnan(hi[1])
    assert lo[2] == float("-inf") and hi[2] == 1.0
    # a row reached only by a NaN with its sign bit set
    assert torch.signbit(vals[6, 0])
    assert torch.isnan(lo[3]) and torch.isnan(hi[3])
    assert torch.signbit(lo[4]) and torch.signbit(hi[4])
    assert lo[5] == float("inf") and hi[5] == float("-inf")


def test_reducer_keeps_its_chunk_plan_on_its_device():
    ids, bp = _binned(np.random.default_rng(9), 5000, 300, 32)
    red = BlockedSegmentReducer(ids, bp, 300, 32, device="cpu")
    block, start, end, index, slot = plan_chunks(bp)
    np.testing.assert_array_equal(red.chunks.table.numpy(),
                                  np.stack([block, start, end, index, slot]))
    assert red.chunks.counters.shape == (len(bp) - 1,)
    assert not red.chunks.counters.any()


@pytest.mark.parametrize("kind", ["min", "max"])
def test_float_minmax_matches_the_reference_nan_rows_included(kind):
    """The reference's min/max propagate a NaN, and so do the port's
    kernels and its plain path: a NaN of either sign takes the extreme
    int32 key of the reduction.  Every row with a NaN is NaN in both;
    signed zeros and every other row agree bit for bit."""
    rng = np.random.default_rng(17)
    e, v, b = 3000, 200, 64
    ids, bp = _binned(rng, e, v, b)
    specials = np.array([0x00000000, 0x80000000, 0x7fc00000, 0xffc00000,
                         0x7f800000, 0xff800000], np.uint32).view(np.float32)
    vals = rng.standard_normal(e).astype(np.float32)
    pick = rng.random(e) < 0.02
    vals[pick] = rng.choice(specials, int(pick.sum()))
    ref = np.asarray(JReducer(ids, bp, v, b).reduce(jnp.asarray(vals), kind))
    got = BlockedSegmentReducer(ids, bp, v, b, device="cpu").reduce(
        torch.from_numpy(vals), kind).numpy()
    nan_rows = np.zeros(v, bool)
    nan_rows[ids[np.isnan(vals)]] = True
    assert nan_rows.any() and not nan_rows.all()
    assert np.isnan(ref[nan_rows]).all() and np.isnan(got[nan_rows]).all()
    assert not np.isnan(ref[~nan_rows]).any()
    np.testing.assert_array_equal(got[~nan_rows].view(np.int32),
                                  ref[~nan_rows].view(np.int32))
