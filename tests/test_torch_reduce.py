"""The port's segment reducers against ``repro``'s.

The same binned edges, made from numpy seeds, go through the reference
(its Pallas kernels in interpret mode, as its own tests run them) and
through the port's plain path on the CPU.  min/max and int32 results
must be bit-equal; float32 sums agree to atol=1e-5, because the tiled
one-hot matmul of the reference and the port's scatter add the same
terms in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segment_reduce import BlockedSegmentReducer as JReducer
from repro.kernels.segment_reduce import gathered_segment_reduce as j_gather
from repro.kernels.segment_reduce.kernel import plan_tiles as j_plan_tiles
from repro_torch.core.config_space import Consistency
from repro_torch.core.consistency import scheduled_reduce
from repro_torch.core.vertex_program import Monoid
from repro_torch.kernels.segment_reduce import (BlockedSegmentReducer,
                                                TilingPlan,
                                                gathered_segment_reduce,
                                                plan_tiles, seg_minmax,
                                                seg_minmax_plain, seg_sum,
                                                seg_sum_plain,
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
