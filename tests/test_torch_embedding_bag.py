"""The port's embedding bag (K3) against ``repro``'s.

The same numpy-seeded tables and indices go through the reference's
Pallas kernel (interpret mode, as its own tests run it) and its oracle,
and through the port's wrapper on the CPU, which runs the plain
version.  A bag of one row is a copy, so P = 1 must be bit-equal; for
P > 1 and for the mean, the sum's order differs (atol = rtol = 1e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.embedding_bag import embedding_bag_ref as j_ref
from repro_torch.kernels.embedding_bag import (embag, embedding_bag,
                                               embedding_bag_ref)

CASES = [(1000, 32, 16, 4, "sum"), (5000, 128, 33, 1, "sum"),
         (200, 64, 8, 8, "mean"), (50, 8, 3, 2, "sum"),
         (4096, 128, 64, 1, "sum")]


def _inputs(r, d, b, p, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((r, d)).astype(np.float32)
    idx = rng.integers(0, r, (b, p)).astype(np.int32)
    return table, idx


def _check(got, want, pool):
    if pool == 1:
        assert got.tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("r,d,b,p,mode", CASES)
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_matches_the_pallas_kernel_and_oracle(r, d, b, p, mode, impl):
    table, idx = _inputs(r, d, b, p, r + b)
    pallas = np.asarray(embedding_bag_pallas(jnp.asarray(table),
                                             jnp.asarray(idx), mode=mode))
    oracle = np.asarray(j_ref(jnp.asarray(table), jnp.asarray(idx),
                              mode=mode))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        mode=mode, impl=impl).numpy()
    assert got.shape == (b, d) and got.dtype == np.float32
    _check(got, pallas, p)
    _check(got, oracle, p)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_out_of_range_indices_follow_take(mode):
    r, d = 40, 8
    table, _ = _inputs(r, d, 1, 1, 3)
    idx = np.array([[-1, 3], [-40, 0], [40, 1], [-41, 2], [7, 10**6]],
                   np.int32)
    want = np.asarray(j_ref(jnp.asarray(table), jnp.asarray(idx), mode=mode))
    got = embag(torch.from_numpy(table), torch.from_numpy(idx),
                mode=mode).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2:]).all() and not np.isnan(got[:2]).any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # a wrapped index reads the row it names from the end
    np.testing.assert_array_equal(
        embedding_bag_ref(torch.from_numpy(table),
                          torch.tensor([[-1]], dtype=torch.int32)).numpy(),
        table[-1:])


def test_a_strided_column_of_a_batch_pools_like_its_copy():
    table, _ = _inputs(300, 16, 1, 1, 5)
    sparse = np.random.default_rng(6).integers(0, 300, (9, 4, 3)).astype(
        np.int32)
    t, s = torch.from_numpy(table), torch.from_numpy(sparse)
    for f in range(4):
        assert torch.equal(embag(t, s[:, f, :]),
                           embag(t, s[:, f, :].contiguous()))


def test_wrapper_takes_the_plain_version_only_on_the_cpu():
    table, idx = _inputs(100, 16, 7, 3, 8)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    before = embag.launches
    assert torch.equal(embag(t, i, mode="mean"),
                       embedding_bag_ref(t, i, mode="mean"))
    assert embag.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        embag(t.to("meta"), i.to("meta"))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = torch.ones(10, 4)
    i = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(TypeError, match="indices"):
        embag(t, i.long())
    with pytest.raises(TypeError, match="table"):
        embag(t.double(), i)
    with pytest.raises(ValueError, match="mode"):
        embag(t, i, mode="max")
    with pytest.raises(ValueError, match="at least one"):
        embag(t, i[:, :0])
    with pytest.raises(ValueError, match="contiguous"):
        embag(torch.ones(4, 10).t(), i)
    with pytest.raises(ValueError, match="impl"):
        embedding_bag(t, i, impl="pallas")
