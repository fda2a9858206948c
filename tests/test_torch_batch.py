"""The port's batched execution against ``repro``'s (``tests/test_batch.py``'s
contracts).

Packing is numpy on the host and must give the reference's packed
arrays exactly.  ``run_batch`` on the CPU (the fused engine's guarded
steps run eagerly) must equal the reference's ``run_batch`` on the same
graphs, carried across with ``graph_from_arrays``: bit for bit for BFS,
SSSP and CC on all 18 configs (states, iteration counts and traces;
``tests/test_torch_batch_apps.py`` holds PR, BC, MIS and CLR), and each
graph's own sequential ``run`` too.  ``run_batch_slice`` resumed across
slices, with graphs joining at different iterations and a parked slot,
must equal the sequential runs.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.algorithms as japps
import repro.core as jcore
import repro.core.batch as jbatch
from repro.graph import grid_graph, random_graph, regular_graph, rmat_graph
import repro_torch.algorithms as tapps
import repro_torch.core as tcore
import repro_torch.core.batch as tbatch
from repro_torch.core import capture
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CONFIG_NAMES = [c.name for c in jcore.ALL_CONFIGS]
FACTORY = {"BFS": "bfs", "SSSP": "sssp", "CC": "cc", "PR": "pagerank",
           "BC": "bc", "MIS": "mis", "CLR": "coloring"}


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


def _mixed_ref():
    """Two graphs of different (n, m) in one padding bucket."""
    graphs = [rmat_graph(5, 8, seed=1, weighted=True),
              grid_graph(7, seed=0, weighted=True)]
    assert jbatch.bucket_key(graphs[0]) == jbatch.bucket_key(graphs[1])
    return graphs


@pytest.fixture(scope="module")
def mixed():
    ref = _mixed_ref()
    return ref, [_port(g) for g in ref]


def _same_result(port, want, exact=True, **tol):
    """A port result against a reference (or sequential port) result:
    iterations, convergence, traces and every state key."""
    assert port.iterations == want.iterations
    assert port.converged == want.converged
    assert port.direction_trace == want.direction_trace
    if exact:
        assert port.occupancy_trace == want.occupancy_trace
    for k, v in want.state.items():
        got = port.state[k].cpu().numpy()
        v = np.asarray(v)
        if exact:
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, err_msg=k, **tol)


# ---------------------------------------------------------------------------
class TestBuckets:
    @given(st.integers(1, 1 << 20), st.integers(1, 1 << 22))
    @settings(max_examples=50, deadline=None)
    def test_shape_matches_the_reference(self, n, m):
        n_q, m_q = tbatch.bucket_shape(n, m)
        assert (n_q, m_q) == jbatch.bucket_shape(n, m)
        assert n_q >= n and m_q >= m
        assert n_q & (n_q - 1) == 0 and m_q & (m_q - 1) == 0
        if m_q > m:
            assert n_q > n

    @given(st.integers(4, 1 << 12), st.integers(4, 1 << 14))
    @settings(max_examples=50, deadline=None)
    def test_key_stable_within_a_quantum(self, n, m):
        n_q, m_q = tbatch.bucket_shape(n, m)
        n2 = max(n_q // 2 + 1, min(n_q - 1, n + 1))
        m2 = max(m_q // 2 + 1, min(m_q - 1, m + 1))
        if (tbatch.bucket_shape(n2, 1)[0] == n_q
                and tbatch.bucket_shape(1, m2)[1] == m_q):
            assert tbatch.bucket_shape(n2, m2) == (n_q, m_q)
        assert tbatch.bucket_shape(n_q + 1, m)[0] == 2 * n_q

    def test_key_deterministic_and_equal_to_the_reference(self):
        a, b, c = (regular_graph(100, 4, seed=1), regular_graph(100, 4, seed=2),
                   regular_graph(1000, 4, seed=1))
        keys = [tbatch.bucket_key(_port(g)) for g in (a, b, c)]
        assert keys[0] == keys[1] != keys[2]
        assert keys == [jbatch.bucket_key(g) for g in (a, b, c)]


class TestPacking:
    @pytest.mark.parametrize("seed", [0, 7, 41])
    def test_packed_arrays_equal_the_reference(self, seed):
        rng = np.random.default_rng(seed)
        ref = [random_graph(int(rng.integers(20, 90)),
                            int(rng.integers(60, 400)), seed=seed + i,
                            weighted=True, block_size=32) for i in range(3)]
        want = jbatch.pack_graphs(ref)
        got = tbatch.pack_graphs([_port(g) for g in ref])
        assert (got.n_q, got.m_q) == (want.n_q, want.m_q)
        np.testing.assert_array_equal(got.n_nodes_b, want.n_nodes_b)
        np.testing.assert_array_equal(got.n_edges_b, want.n_edges_b)
        p, q = got.packed, want.packed
        assert (p.n_nodes, p.n_edges, p.block_size) == \
            (q.n_nodes, q.n_edges, q.block_size)
        for name in ARRAY_FIELDS:
            a, b = np.asarray(getattr(p, name)), np.asarray(getattr(q, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        # padding edges are self-loops on padding vertices only
        for i, g in enumerate(ref):
            vo, eo = i * got.n_q, i * got.m_q
            pad_src = p.src[eo + g.n_edges:eo + got.m_q]
            np.testing.assert_array_equal(
                pad_src, p.dst[eo + g.n_edges:eo + got.m_q])
            assert ((pad_src >= vo + g.n_nodes)
                    & (pad_src < vo + got.n_q)).all()

    def _states(self, graphs, rng):
        return [{"x": torch.from_numpy(rng.standard_normal(g.n_nodes)
                                       .astype(np.float32)),
                 "flag": torch.tensor(bool(i % 2)),
                 "m": torch.from_numpy(rng.integers(
                     -5, 9, (g.n_nodes, 3)).astype(np.int32))}
                for i, g in enumerate(graphs)]

    def test_state_round_trip_device_and_host(self, mixed):
        ref, graphs = mixed
        batch = tbatch.pack_graphs(graphs)
        states = self._states(graphs, np.random.default_rng(0))
        packed = batch.pack_state(states, pad={"x": 1.5})
        assert packed["x"].shape == (batch.n_total,)
        assert packed["flag"].shape == (batch.size,)
        assert packed["m"].shape == (batch.n_total, 3)
        host = batch.pack_state_host(
            [{k: v.numpy() for k, v in s.items()} for s in states],
            pad={"x": 1.5})
        want = jbatch.pack_graphs(ref).pack_state(
            [{k: jnp.asarray(v.numpy()) for k, v in s.items()}
             for s in states], pad={"x": 1.5})
        for k in packed:
            np.testing.assert_array_equal(packed[k].numpy(), host[k])
            np.testing.assert_array_equal(host[k], np.asarray(want[k]))
        for orig, dev, hst in zip(states, batch.unpack_state(packed),
                                  batch.unpack_state_host(host)):
            for k in orig:
                assert torch.equal(orig[k], dev[k]), k
                np.testing.assert_array_equal(orig[k].numpy(), hst[k])

    def test_rejects_mixed_block_sizes(self):
        with pytest.raises(ValueError, match="block_size"):
            tbatch.pack_graphs([_port(regular_graph(50, 4, seed=0,
                                                    block_size=32)),
                                _port(regular_graph(50, 4, seed=1,
                                                    block_size=64))])

    def test_rejects_bad_state_shapes(self, mixed):
        batch = tbatch.pack_graphs(mixed[1])
        bad = [{"x": torch.zeros(7)} for _ in mixed[1]]
        with pytest.raises(ValueError, match="per-vertex"):
            batch.pack_state(bad)
        with pytest.raises(ValueError, match="per-vertex"):
            batch.pack_state_host([{"x": np.zeros(7)} for _ in mixed[1]])
        with pytest.raises(ValueError, match="states"):
            batch.pack_state(bad[:1])

    def test_pack_entry_lives_as_long_as_its_first_graph(self):
        """The "batch_pack" entry is anchored on the first member, which
        the batch holds weakly; the other members are held strongly, so
        their ids stay taken while the entry lives."""
        import gc
        import weakref
        graphs = [_port(rmat_graph(5, 8, seed=s)) for s in (71, 72, 73)]
        batch = tbatch.get_graph_batch(tuple(graphs))
        assert batch._anchor() is graphs[0]
        assert batch._pinned == tuple(graphs[1:])
        entries = tcore.PLAN_CACHE.kind_stats("batch_pack")["entries"]
        anchor, rest = weakref.ref(graphs[0]), weakref.ref(graphs[1])
        del batch, graphs
        gc.collect()
        assert anchor() is None
        # the cache prunes a dead anchor's entries at its next call,
        # which releases the members it pinned
        assert tcore.PLAN_CACHE.kind_stats("batch_pack")["entries"] == \
            entries - 1
        gc.collect()
        assert rest() is None

    def test_pack_is_cached_per_tuple(self, mixed):
        graphs = mixed[1]
        b1 = tbatch.get_graph_batch(tuple(graphs))
        assert tbatch.get_graph_batch(tuple(graphs)) is b1
        assert tbatch.get_graph_batch(tuple(reversed(graphs))) is not b1


# ---------------------------------------------------------------------------
_REF_CACHE = {}


def _ref_batch(app, cfg, ref_graphs, **kw):
    key = (app, cfg, tuple(id(g) for g in ref_graphs),
           tuple(sorted(kw.items())))
    if key not in _REF_CACHE:
        _REF_CACHE[key] = jcore.run_batch(
            getattr(japps, FACTORY[app])(), ref_graphs,
            jcore.SystemConfig.from_name(cfg), **kw)
    return _REF_CACHE[key]


@pytest.mark.parametrize("cfg", CONFIG_NAMES)
@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC"])
def test_exact_apps_match_the_reference_batch(mixed, app, cfg):
    ref, graphs = mixed
    program = getattr(tapps, FACTORY[app])()
    config = tcore.SystemConfig.from_name(cfg)
    got = tcore.run_batch(program, graphs, config, device="cpu")
    for g, r, w in zip(graphs, got, _ref_batch(app, cfg, ref)):
        assert r.engine == "batched" and r.config_name == cfg
        _same_result(r, w)
        _same_result(r, tcore.run(program, g, config, device="cpu"))


@pytest.mark.parametrize("cfg", ["SD1", "TG0", "DD1", "DG1"])
def test_kernel_reducers_on_the_packed_graph(mixed, cfg):
    """The blocked reducers built over the packed graph (K1/K2's plain
    versions on the CPU) give the same results."""
    ref, graphs = mixed
    config = tcore.SystemConfig.from_name(cfg)
    for app in ("BFS", "CC"):
        program = getattr(tapps, FACTORY[app])()
        got = tcore.run_batch(program, graphs, config, use_kernels=True,
                              device="cpu")
        for r, w in zip(got, _ref_batch(app, cfg, ref)):
            _same_result(r, w)


def test_iteration_counts_differ_per_graph():
    ref = [grid_graph(7, seed=0), rmat_graph(5, 8, seed=3)]
    graphs = [_port(g) for g in ref]
    assert tbatch.bucket_key(graphs[0]) == tbatch.bucket_key(graphs[1])
    program, config = tapps.bfs(), tcore.SystemConfig.from_name("DG0")
    got = tcore.run_batch(program, graphs, config, device="cpu")
    assert got[0].iterations != got[1].iterations
    for g, r in zip(graphs, got):
        _same_result(r, tcore.run(program, g, config, device="cpu"))


@pytest.mark.parametrize("cfg", ["DG1", "SG0"])
def test_batch_composition_invariance(cfg):
    g1 = _port(rmat_graph(5, 8, seed=11))
    g2 = _port(grid_graph(7, seed=12))
    g3 = _port(regular_graph(40, 5, seed=13))  # another bucket
    assert tbatch.bucket_key(g1) == tbatch.bucket_key(g2) \
        != tbatch.bucket_key(g3)
    program, config = tapps.bfs(), tcore.SystemConfig.from_name(cfg)
    solo = tcore.run_batch(program, [g1], config, device="cpu")[0]
    duo = tcore.run_batch(program, [g1, g2], config, device="cpu")[0]
    trio = tcore.run_batch(program, [g1, g3, g2], config, device="cpu")[0]
    _same_result(duo, solo)
    _same_result(trio, solo)


def test_multiple_buckets_and_max_batch():
    graphs = [_port(rmat_graph(s, 8, seed=seed))
              for s, seed in ((5, 21), (8, 22), (5, 23), (5, 24))]
    program, config = tapps.bfs(), tcore.SystemConfig.from_name("DGR")
    got = tcore.run_batch(program, graphs, config, max_batch=2, device="cpu")
    for g, r in zip(graphs, got):
        _same_result(r, tcore.run(program, g, config, device="cpu"))
    with pytest.raises(ValueError, match="max_batch"):
        tcore.run_batch(program, graphs, config, max_batch=0, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        tcore.run_batch(program, graphs, config, keys=[None], device="cpu")


def test_launches_per_batch():
    """One launch per STEPS_PER_LAUNCH iterations of the longest graph,
    one poll each."""
    graphs = [_port(g) for g in (grid_graph(7, seed=0),
                                 rmat_graph(5, 8, seed=3))]
    got = tcore.run_batch(tapps.bfs(), graphs,
                          tcore.SystemConfig.from_name("SG0"), device="cpu")
    longest = max(r.iterations for r in got)
    assert longest > capture.STEPS_PER_LAUNCH
    for r in got:
        assert r.dispatches == math.ceil(longest / capture.STEPS_PER_LAUNCH)
        assert r.host_syncs == r.dispatches


def test_repeat_traffic_hits_the_plan_cache():
    graphs = [_port(g) for g in (rmat_graph(5, 8, seed=41),
                                 rmat_graph(5, 8, seed=42))]
    program, config = tapps.bfs(), tcore.SystemConfig.from_name("DG0")
    tcore.run_batch(program, graphs, config, device="cpu")
    pack = tcore.PLAN_CACHE.kind_stats("batch_pack")
    ctx = tcore.PLAN_CACHE.kind_stats("batch_context")
    fns = tcore.PLAN_CACHE.kind_stats("exec_fn")
    tcore.run_batch(program, graphs, config, device="cpu")
    assert tcore.PLAN_CACHE.kind_stats("batch_pack") == dict(
        pack, hits=pack["hits"] + 1)
    assert tcore.PLAN_CACHE.kind_stats("batch_context") == dict(
        ctx, hits=ctx["hits"] + 1)
    assert tcore.PLAN_CACHE.kind_stats("exec_fn") == dict(
        fns, hits=fns["hits"] + 1)


def test_sparse_capacity_zero_disables_the_gather_batch_wide(mixed):
    ref, graphs = mixed
    program, config = tapps.bfs(), tcore.SystemConfig.from_name("DG1")
    got = tcore.run_batch(program, graphs, config, sparse_edge_capacity=0,
                          device="cpu")
    for g, r, w in zip(graphs, got, _ref_batch("BFS", "DG1", ref,
                                               sparse_edge_capacity=0)):
        _same_result(r, w)
        _same_result(r, tcore.run(program, g, config, sparse_edge_capacity=0,
                                  device="cpu"))
        assert all(o == -1.0 for o in r.occupancy_trace)


def test_default_keys_follow_each_graphs_own_generator(mixed):
    """Without ``keys`` a randomized program draws from each graph's own
    default generator, so the batch equals each sequential run; the
    reference folds the batch index into one key instead."""
    graphs = mixed[1]
    for factory in (tapps.mis, tapps.coloring):
        program = factory()
        config = tcore.SystemConfig.from_name("DD1")
        got = tcore.run_batch(program, graphs, config, device="cpu")
        for g, r in zip(graphs, got):
            _same_result(r, tcore.run(program, g, config, device="cpu"))
        keys = [torch.Generator().manual_seed(5 + i)
                for i in range(len(graphs))]
        got = tcore.run_batch(program, graphs, config, keys=keys,
                              device="cpu")
        for i, (g, r) in enumerate(zip(graphs, got)):
            _same_result(r, tcore.run(
                program, g, config, device="cpu",
                key=torch.Generator().manual_seed(5 + i)))


def test_a_converged_that_reduces_to_a_scalar_is_refused(mixed):
    import dataclasses
    program = dataclasses.replace(
        tapps.bfs(), converged=lambda prev, cur: ~cur["active"].any())
    with pytest.raises(ValueError, match="last axis"):
        tcore.run_batch(program, mixed[1],
                        tcore.SystemConfig.from_name("SG0"), device="cpu")


# ---------------------------------------------------------------------------
def _slice_roster(program, config, graphs, joins, parked, slice_len,
                  limits=None):
    """Drive a roster through ``run_batch_slice``: graph i joins at
    iteration ``joins[i]`` (its state advanced sequentially first), the
    slots in ``parked`` stay parked.  Returns per-graph (state, it,
    converged, trace) after the slices, with the trace prefix of the
    sequential part prepended."""
    batch = tbatch.pack_graphs(graphs)
    bctx = tbatch.BatchedEdgeContext(batch, config, device="cpu")
    states, prefixes = [], []
    for g, j in zip(graphs, joins):
        init = {k: torch.as_tensor(t) for k, t in program.init(g).items()}
        if j:
            r = tcore.run(program, g, config, max_iters=j, engine="host",
                          device="cpu")
            assert r.iterations == j and not r.converged
            init = r.state
        states.append(init)
        prefixes.append(r.direction_trace if j else "")
    state = batch.pack_state(states, pad=program.state_pad)
    it_b = np.asarray(joins, np.int32)
    done_b = np.asarray([i in parked for i in range(len(graphs))])
    limit_b = np.asarray(limits or [program.max_iters] * len(graphs),
                         np.int32)
    conv = np.zeros(len(graphs), bool)
    traces = list(prefixes)
    slices = 0
    while True:
        out = tbatch.run_batch_slice(program, batch, bctx, state, it_b,
                                     done_b | conv, limit_b, slice_len)
        slices += 1
        assert out.dispatches <= math.ceil(slice_len /
                                           capture.STEPS_PER_LAUNCH)
        for i in range(len(graphs)):
            traces[i] += "".join("T" if d else "S"
                                 for d in out.dir_cols[i, :out.advanced[i]])
        assert (out.advanced[list(parked)] == 0).all()
        state, it_b, conv = out.state, out.it_b, conv | out.converged_b
        if (done_b | conv | (it_b >= limit_b)).all():
            break
    per = batch.unpack_state(state)
    return [(per[i], int(it_b[i]), bool(conv[i]), traces[i])
            for i in range(len(graphs))], slices


@pytest.mark.parametrize("slice_len", [1, 4, 9])
@pytest.mark.parametrize("app,cfg", [("BFS", "DG1"), ("CC", "DD1"),
                                     ("CLR", "SD1"), ("CLR", "DG0")])
def test_slices_equal_sequential_runs(app, cfg, slice_len):
    """Graphs that join at different iterations and a parked slot:
    resumed slices give each graph its sequential result; CC's
    alternation and CLR's round-numbered colours see each graph's own
    counter."""
    ref = [rmat_graph(5, 8, seed=1, weighted=True),
           grid_graph(7, seed=0, weighted=True),
           rmat_graph(5, 8, seed=2, weighted=True)]
    graphs = [_port(g) for g in ref]
    program = getattr(tapps, FACTORY[app])()
    config = tcore.SystemConfig.from_name(cfg)
    joins, parked = [0, 2, 1], {2}
    got, slices = _slice_roster(program, config, graphs, joins, parked,
                                slice_len)
    assert slices >= 1
    for i, g in enumerate(graphs):
        state, it, conv, trace = got[i]
        if i in parked:
            assert it == joins[i] and not conv
            continue
        want = tcore.run(program, g, config, engine="host", device="cpu")
        assert (it, conv, trace) == (want.iterations, True,
                                     want.direction_trace)
        for k, v in want.state.items():
            assert torch.equal(state[k], v), (i, k)


def test_slice_stops_each_graph_at_its_own_limit():
    graphs = [_port(grid_graph(7, seed=0)), _port(rmat_graph(5, 8, seed=3))]
    program, config = tapps.bfs(), tcore.SystemConfig.from_name("SG0")
    got, _ = _slice_roster(program, config, graphs, [0, 0], set(), 4,
                           limits=[5, 64])
    want = tcore.run(program, graphs[0], config, max_iters=5, device="cpu")
    state, it, conv, trace = got[0]
    assert (it, conv, trace) == (5, False, want.direction_trace)
    assert torch.equal(state["depth"], want.state["depth"])
    assert got[1][2]
