"""The port's batched frontier helpers and ``rmat_batch`` against
``repro``'s.

``choose_direction_batch`` must give, row by row, the scalar rule on
each graph alone and the reference's batched rule, bit for bit;
``sparse_to_dense`` the reference's mask; ``rmat_batch`` the
reference's graphs, array for array.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.frontier as jfront
import repro.graph as jgraph
import repro_torch.core.frontier as tfront
import repro_torch.graph as tgraph
from repro_torch.graph.structure import ARRAY_FIELDS


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("with_unvisited", [False, True])
def test_choose_direction_batch_rows_match_scalar_and_reference(
        seed, with_unvisited):
    rng = np.random.default_rng(seed)
    b, n_q = 5, 64
    n_b = rng.integers(8, n_q + 1, b).astype(np.int32)
    cols = np.arange(n_q)[None, :] < n_b[:, None]
    deg = np.where(cols, rng.integers(0, 40, (b, n_q)), 0).astype(np.int32)
    m_b = deg.sum(1).astype(np.int32)
    mask = cols & (rng.random((b, n_q)) < rng.random((b, 1)))
    unvisited = cols & (rng.random((b, n_q)) < 0.6) if with_unvisited \
        else None
    prev = rng.random(b) < 0.5
    t = torch.from_numpy
    got = tfront.choose_direction_batch(
        t(mask), t(deg), t(m_b), t(n_b), t(prev),
        unvisited=None if unvisited is None else t(unvisited)).numpy()
    want = np.asarray(jfront.choose_direction_batch(
        jnp.asarray(mask), jnp.asarray(deg), jnp.asarray(m_b),
        jnp.asarray(n_b), jnp.asarray(prev),
        unvisited=None if unvisited is None else jnp.asarray(unvisited)))
    np.testing.assert_array_equal(got, want)
    for i in range(b):
        n = int(n_b[i])
        row = tfront.choose_direction(
            t(mask[i, :n]), t(deg[i, :n]), int(m_b[i]), n,
            torch.tensor(bool(prev[i])),
            unvisited=None if unvisited is None else t(unvisited[i, :n]))
        assert bool(row) == bool(got[i]), i


def test_sparse_to_dense_matches_the_reference():
    rng = np.random.default_rng(3)
    for n in (1, 17, 300):
        cap = max(1, n // 2)
        ids = np.full(cap, -1, np.int32)
        k = int(rng.integers(0, cap + 1))
        ids[:k] = np.sort(rng.choice(n, size=k, replace=False))
        got = tfront.sparse_to_dense(torch.from_numpy(ids), n).numpy()
        want = np.asarray(jfront.sparse_to_dense(jnp.asarray(ids), n))
        np.testing.assert_array_equal(got, want)
        front = tfront.dense_to_sparse(torch.from_numpy(got), cap)
        np.testing.assert_array_equal(
            tfront.sparse_to_dense(front.ids, n).numpy(), got)


@pytest.mark.parametrize("kw", [dict(count=3, scale=5, seed=7),
                                dict(count=4, scale=4, seed=1,
                                     scale_spread=2, weighted=True,
                                     block_size=32)])
def test_rmat_batch_matches_the_reference(kw):
    got, want = tgraph.rmat_batch(**kw), jgraph.rmat_batch(**kw)
    assert len(got) == len(want) == kw["count"]
    for p, r in zip(got, want):
        assert (p.n_nodes, p.n_edges, p.block_size) == \
            (r.n_nodes, r.n_edges, r.block_size)
        for name in ARRAY_FIELDS:
            a, b = np.asarray(getattr(p, name)), np.asarray(getattr(r, name))
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
