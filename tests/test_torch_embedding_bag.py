"""The port's embedding bag (K3) against ``repro``'s.

The same numpy-seeded tables and indices go through the reference's
Pallas kernel (interpret mode, as its own tests run it) and its oracle,
and through the port's wrapper on the CPU, which runs the plain
version.  A bag of one row is a copy, so P = 1 must be bit-equal; for
P > 1 and for the mean, the sum's order differs (atol = rtol = 1e-5).
The table-batched call (``embedding_bags`` / ``embag_tables``) is held
against the reference's kernel applied table by table and stacked.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import embedding_bag_pallas
from repro.kernels.embedding_bag import embedding_bag_ref as j_ref
from repro_torch.kernels.embedding_bag import (MAX_TABLES, embag,
                                               embag_tables, embedding_bag,
                                               embedding_bag_ref,
                                               embedding_bags,
                                               embedding_bags_ref)

#: the table rows of the REDUCED DLRM configuration
REDUCED_ROWS = (1000, 200, 50, 300, 77, 10)
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


def _tables(rows, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((r, d)).astype(np.float32) for r in rows]


def _sparse(rows, b, p, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, r, (b, p)) for r in rows],
                    axis=1).astype(np.int32)


def _torch(tables):
    return [torch.from_numpy(t) for t in tables]


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_embedding_bags_match_the_pallas_kernel_per_table(p, mode, impl):
    tables = _tables(REDUCED_ROWS, 16, p)
    idx = _sparse(REDUCED_ROWS, 24, p, p + 10)
    want = np.stack([
        np.asarray(embedding_bag_pallas(jnp.asarray(t), jnp.asarray(idx[:, f]),
                                        mode=mode))
        for f, t in enumerate(tables)], axis=1)
    got = embedding_bags(_torch(tables), torch.from_numpy(idx), mode=mode,
                         impl=impl).numpy()
    assert got.shape == (24, len(REDUCED_ROWS), 16)
    assert got.dtype == np.float32
    _check(got, want, p)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_hold_each_table_to_its_own_rows(mode):
    rows = (1000, 10, 77)
    tables = _tables(rows, 8, 4)
    idx = np.array([[[500, 1], [5, 2], [3, 4]],
                    [[20, 0], [20, 0], [20, 0]],       # >= 10 in table 1
                    [[-1, 0], [-1, 0], [-77, 0]],      # wraps in each table
                    [[999, 0], [-10, 0], [-78, 0]]],   # < -77 in table 2
                   np.int32)
    want = np.stack([
        np.asarray(j_ref(jnp.asarray(t), jnp.asarray(idx[:, f]), mode=mode))
        for f, t in enumerate(tables)], axis=1)
    got = embag_tables(_torch(tables), torch.from_numpy(idx),
                       mode=mode).numpy()
    nan = np.zeros((4, 3), bool)
    nan[1, 1] = nan[3, 2] = True
    np.testing.assert_array_equal(np.isnan(got).all(-1), nan)
    np.testing.assert_array_equal(np.isnan(got).any(-1), nan)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # a wrapped index reads the row it names from the end of its own table
    np.testing.assert_array_equal(
        embag_tables(_torch(tables), torch.from_numpy(idx[2:3, :, :1]))
        .numpy()[0], np.stack([t[-1] for t in tables[:2]] + [tables[2][0]]))


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_embedding_bags_write_into_a_slice_of_z(impl):
    tables = _torch(_tables(REDUCED_ROWS, 16, 6))
    idx = torch.from_numpy(_sparse(REDUCED_ROWS, 9, 2, 7))
    z = torch.full((9, len(REDUCED_ROWS) + 1, 16), 7.0)
    z[:, 0] = torch.arange(16.0)
    first = z[:, 0].clone()
    got = embedding_bags(tables, idx, impl=impl, out=z[:, 1:])
    assert got.data_ptr() == z[:, 1:].data_ptr()
    assert torch.equal(z[:, 0], first)
    assert torch.equal(z[:, 1:], embedding_bags(tables, idx, impl=impl))
    assert torch.equal(z[:, 1:], embedding_bags_ref(tables, idx))


def test_embag_tables_is_the_single_table_embag_per_table():
    tables = _torch(_tables(REDUCED_ROWS, 16, 8))
    idx = torch.from_numpy(_sparse(REDUCED_ROWS, 11, 4, 9))
    want = torch.stack([embag(t, idx[:, f], mode="mean")
                        for f, t in enumerate(tables)], dim=1)
    before = embag.launches
    assert torch.equal(embag_tables(tables, idx, mode="mean"), want)
    assert embag.launches == before  # the CPU runs the plain version


def test_embag_tables_rejects_what_the_kernel_does_not_take():
    t = [torch.ones(10, 4), torch.ones(5, 4)]
    i = torch.zeros(3, 2, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="widths"):
        embag_tables([t[0], torch.ones(5, 8)], i)
    with pytest.raises(TypeError, match="float32"):
        embag_tables([t[0], t[1].double()], i)
    with pytest.raises(ValueError, match="tables on"):
        embag_tables([t[0], t[1].to("meta")], i)
    with pytest.raises(ValueError, match="indices name 3 tables"):
        embag_tables(t, torch.zeros(3, 3, 1, dtype=torch.int32))
    many = [torch.ones(2, 4)] * (MAX_TABLES + 1)
    with pytest.raises(ValueError, match=f"1 to {MAX_TABLES} tables"):
        embag_tables(many, torch.zeros(3, MAX_TABLES + 1, 1,
                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        embag_tables(t, i, out=torch.empty(3, 2, 5))
    with pytest.raises(ValueError, match="out must be"):
        embag_tables(t, i, out=torch.empty(3, 2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="out must be"):
        embag_tables(t, i, out=torch.empty(3, 4, 2).transpose(1, 2))
    with pytest.raises(ValueError, match="at least one"):
        embag_tables(t, i[:, :, :0])
    with pytest.raises(TypeError, match="indices"):
        embag_tables(t, i.long())
    with pytest.raises(ValueError, match="indices are on"):
        embag_tables(t, i.to("meta"))
    with pytest.raises(ValueError, match="contiguous"):
        embag_tables([t[0], torch.ones(4, 5).t()], i)
    with pytest.raises(ValueError, match="contiguous"):
        embag_tables(t, torch.zeros(3, 2, 2, dtype=torch.int32)
                     .transpose(0, 2).contiguous().transpose(0, 2))
    with pytest.raises(ValueError, match="mode"):
        embag_tables(t, i, mode="max")
    with pytest.raises(ValueError, match="impl"):
        embedding_bags(t, i, impl="pallas")
    with pytest.raises(ValueError, match="no kernel"):
        embag_tables([x.to("meta") for x in t], i.to("meta"))


def test_embag_tables_checks_a_table_again_when_its_data_changes():
    t = [torch.nn.Parameter(torch.ones(10, 4), requires_grad=False),
         torch.nn.Parameter(torch.ones(5, 4), requires_grad=False)]
    i = torch.zeros(3, 2, 1, dtype=torch.int32)
    assert embag_tables(t, i).shape == (3, 2, 4)
    t[1].data = torch.ones(5, 8)
    with pytest.raises(ValueError, match="widths"):
        embag_tables(t, i)
    t[0].data = torch.full((6, 8), 2.0)
    assert torch.equal(embag_tables(t, i)[:, 0], torch.full((3, 8), 2.0))
