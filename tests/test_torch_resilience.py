"""The port's resilience layer against ``repro.core.resilience``.

Both packages run on the very same R-MAT scale-6 graph (carried across
with ``graph_from_arrays``), as ``tests/test_resilience.py`` does for
the reference alone.  The port must:

1. give a checkpointed run equal to its plain run for every
   ``checkpoint_every`` in {1, 3, 8, 32} under both engines, on every
   third config, and equal to the reference's checkpointed run: bit for
   bit for BFS, SSSP, CC, and for MIS and CLR given the reference's
   priorities; PageRank to atol 1e-6 and iterations +-1;
2. end every seeded fault (mode x engine x {BFS, PR, MIS}) with the
   reference's outcome, attempt count, fault history (kind, sentinels,
   segment, attempt, engine; not the error's text) and final state;
3. build the reference's sentinel battery (names, order, verdicts) and
   certificates, and give ``check_state_host`` the reference's answer;
4. keep the reference's checkpoint ring.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.core.resilience as jres
import repro.testing.faults as jfaults
import repro_torch.algorithms as tapps
import repro_torch.core as tcore
import repro_torch.core.resilience as tres
import repro_torch.testing.faults as tfaults
from repro.graph import rmat_graph
from repro_torch.core.vertex_program import FRONTIER_DIR_KEY, FRONTIER_OCC_KEY
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CONFIGS = [c.name for c in jcore.ALL_CONFIGS][::3]
INTERVALS = (1, 3, 8, 32)
EXACT_APPS = ["BFS", "SSSP", "CC", "MIS", "CLR"]
FAULT_APPS = ["BFS", "PR", "MIS"]
ENGINES = ["fused", "host"]
RETRY = dict(max_attempts=6)
#: per-iteration frontier bookkeeping, not part of an answer: it
#: differs legitimately when recovery replays or changes engine
_FRONTIER_KEYS = {FRONTIER_DIR_KEY, FRONTIER_OCC_KEY}


@pytest.fixture(scope="module")
def ref_graph():
    return rmat_graph(scale=6, edge_factor=8, seed=3, weighted=True)


@pytest.fixture(scope="module")
def graph(ref_graph):
    return graph_from_arrays({f: np.asarray(getattr(ref_graph, f))
                              for f in ARRAY_FIELDS},
                             ref_graph.n_nodes, ref_graph.n_edges,
                             ref_graph.block_size)


@functools.lru_cache(maxsize=None)
def _ref_program(app):
    # one object per app, so the reference compiles each cell once
    return japps.REGISTRY[app]()


def _port_program(app, ref_graph):
    """The port's program; MIS and CLR take the reference's priorities
    (``jax.random`` cannot be reproduced in torch)."""
    program = tapps.REGISTRY[app]()
    if app in ("MIS", "CLR"):
        priority = np.array(_ref_program(app).init(ref_graph)["priority"])
        program = dataclasses.replace(
            program, init=functools.partial(program.init, priority=priority))
    return program


def _assert_same(port, want, exact: bool, frontier: bool = True):
    """``port`` (a port result) against ``want`` (either package's)."""
    if exact:
        assert port.iterations == want.iterations
        if frontier:
            assert port.direction_trace == want.direction_trace
            assert port.occupancy_trace == want.occupancy_trace
    else:
        assert abs(port.iterations - want.iterations) <= 1
    assert set(port.state) == set(want.state)
    for k, v in want.state.items():
        if not frontier and k in _FRONTIER_KEYS:
            continue
        got = port.state[k].cpu().numpy()
        v = v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        assert got.dtype == v.dtype, k
        if exact or v.dtype.kind != "f":
            np.testing.assert_array_equal(got, v, err_msg=k)
        else:
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("app", EXACT_APPS + ["PR"])
def test_checkpointed_runs_equal_plain_and_reference(graph, ref_graph, app,
                                                     cfg):
    program = _port_program(app, ref_graph)
    config = tcore.SystemConfig.from_name(cfg)
    for engine in ENGINES:
        plain = tcore.run(program, graph, config, engine=engine,
                          device="cpu")
        for k in INTERVALS:
            res = tcore.run(program, graph, config, engine=engine,
                            checkpoint_every=k, device="cpu")
            assert res.outcome == "converged" and res.fault is None
            assert res.engine == engine and res.attempts == 1
            # the same engine on the CPU: bit for bit, PR included
            _assert_same(res, plain, exact=True)
            assert res.resilience["segments"] == -(-res.iterations // k)
    ref = jcore.run(_ref_program(app), ref_graph,
                    jcore.SystemConfig.from_name(cfg), checkpoint_every=3)
    assert ref.outcome == "converged"
    _assert_same(res, ref, exact=app != "PR")


def test_iter_limit_outcome_is_structured(graph):
    program = tapps.REGISTRY["PR"]()
    config = tcore.SystemConfig.from_name("DG1")
    res = tcore.run(program, graph, config, checkpoint_every=2, max_iters=3,
                    device="cpu")
    assert not res.converged and res.outcome == "iter_limit"
    plain = tcore.run(program, graph, config, max_iters=3, device="cpu")
    assert plain.outcome == "iter_limit"
    _assert_same(res, plain, exact=True)


def _history(res):
    return [{k: h.get(k) for k in ("kind", "sentinels", "segment",
                                   "attempt", "engine")}
            for h in (res.fault or {}).get("history", [])]


def _both(app, graph, ref_graph, make, retry, engine="fused", k=2):
    """The same seeded fault through both packages (DG1)."""
    ref = jcore.run(_ref_program(app), ref_graph,
                    jcore.SystemConfig.from_name("DG1"), engine=engine,
                    checkpoint_every=k, fault_injector=make(jfaults),
                    retry=None if retry is None else jres.RetryPolicy(**retry))
    port = tcore.run(_port_program(app, ref_graph), graph,
                     tcore.SystemConfig.from_name("DG1"), engine=engine,
                     checkpoint_every=k, fault_injector=make(tfaults),
                     retry=None if retry is None else tres.RetryPolicy(**retry),
                     device="cpu")
    assert (port.outcome, port.attempts, port.engine, port.converged) == \
        (ref.outcome, ref.attempts, ref.engine, ref.converged)
    assert _history(port) == _history(ref)
    if port.fault is not None:
        assert port.fault["recovered"] == ref.fault["recovered"]
    _assert_same(port, ref, exact=app != "PR")
    return port


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("app", FAULT_APPS)
@pytest.mark.parametrize("mode", sorted(tfaults.FAULT_MODES))
def test_fault_matrix_matches_the_reference(graph, ref_graph, mode, app,
                                            engine):
    res = _both(app, graph, ref_graph, lambda m: m.make_fault(mode), RETRY,
                engine)
    # never a wrong answer that claims convergence
    assert res.outcome == "converged"


SCENARIOS = {
    # a runner that always fails: faulted after every attempt
    "persistent_exception": ("BFS", lambda m: m.RunnerExceptionFault(
        at_iteration=0, times=None), dict(max_attempts=3)),
    # no retry: the first trip is final
    "nan_without_retry": ("PR", lambda m: m.NaNFault(at_iteration=2), None),
    # a dropped update on the done-boundary: only the certificate sees it
    "stale_at_convergence": ("BFS", lambda m: m.StaleUpdateFault(
        at_iteration=3, fraction=0.5), RETRY),
    "compile_fault": ("BFS", lambda m: m.CompileFault(engine="fused"),
                      RETRY),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fault_scenarios_match_the_reference(graph, ref_graph, name):
    app, make, retry = SCENARIOS[name]
    res = _both(app, graph, ref_graph, make, retry)
    if name == "persistent_exception":
        assert res.outcome == "faulted" and res.iterations == 0
        assert len(res.fault["history"]) == 3
        assert res.fault["final"]["kind"] == "exception"
    elif name == "nan_without_retry":
        assert res.outcome == "faulted"
        assert "nan" in res.fault["final"]["sentinels"]
    elif name == "stale_at_convergence":
        assert res.converged and res.fault["recovered"]
        assert any("certificate" in (h.get("sentinels") or ())
                   for h in res.fault["history"])
    else:
        assert res.converged and res.engine == "host"


def test_a_process_death_passes_every_retry_net(graph):
    with pytest.raises(tfaults.SimulatedProcessDeath):
        tcore.run(tapps.REGISTRY["BFS"](), graph,
                  tcore.SystemConfig.from_name("DG1"), checkpoint_every=1,
                  retry=tres.RetryPolicy(max_attempts=6), device="cpu",
                  fault_injector=tfaults.ProcessKillFault(at_iteration=1))


@pytest.mark.parametrize("app", sorted(tapps.REGISTRY))
def test_sentinels_and_certificates_match_the_reference(graph, ref_graph,
                                                        app):
    """The battery's names and order, its flags on a clean and on a
    bit-flipped converged state, and the certificate's verdicts."""
    port_program, ref_program = _port_program(app, ref_graph), \
        _ref_program(app)
    port_fns = tres.build_sentinels(port_program)
    ref_fns = jres.build_sentinels(ref_program)
    assert [n for n, _ in port_fns] == [n for n, _ in ref_fns]
    assert port_fns[0][0] == "nan"
    res = tcore.run(port_program, graph, tcore.SystemConfig.from_name("SG0"),
                    device="cpu")
    init = {k: torch.as_tensor(v).numpy()
            for k, v in port_program.init(graph).items()}
    final = {k: v.numpy() for k, v in res.state.items()}
    flipped = tfaults.BitFlipFault(seed=5).perturb(1, final, init)
    stale = tfaults.StaleUpdateFault(seed=5).perturb(1, final, init)
    limit = res.iterations
    clean = np.full(limit + 1, -1.0, np.float32)
    bad_occ = clean.copy()
    bad_occ[limit - 1] = np.nan   # inside the window [0, limit)
    ctx = tcore.EdgeContext.create(graph, tcore.SystemConfig.from_name("SG0"),
                                   device="cpu")
    jctx = jcore.EdgeContext.create(ref_graph,
                                    jcore.SystemConfig.from_name("SG0"))
    for prev, cur, occ in ((init, final, clean), (init, flipped, clean),
                           (final, flipped, bad_occ), (final, final, bad_occ)):
        got = tres._sentinel_flags(
            port_fns, {k: torch.from_numpy(v) for k, v in prev.items()},
            {k: torch.from_numpy(v) for k, v in cur.items()},
            torch.from_numpy(occ), 0, limit, limit + 1, True)
        want = jres._sentinel_flags(
            ref_fns, {k: jnp.asarray(v) for k, v in prev.items()},
            {k: jnp.asarray(v) for k, v in cur.items()}, jnp.asarray(occ),
            0, limit, limit + 1, True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for st in (final, flipped, stale):
        verdict = tres.check_certificate(port_program, ctx, st)
        assert verdict == jres.check_certificate(ref_program, jctx, st)
    assert tres.check_certificate(port_program, ctx, final) is \
        (None if ref_program.certificate is None else True)


@pytest.mark.parametrize("app,prev,cur", [
    ("SSSP", [0.0, 2.0, np.inf], [0.0, 1.5, np.inf]),
    ("SSSP", [0.0, 2.0, np.inf], [0.0, np.nan, np.inf]),
    ("SSSP", [0.0, 2.0, np.inf], [0.0, 3.0, np.inf]),
    ("SSSP", [0.0, 2.0, np.inf], [np.nan, 3.0, np.inf]),
    ("CC", [0, 0, 2], [0, 0, 1]),
    ("CC", [0, 0, 1], [0, 1, 1]),
    ("BFS", [0, -1, 1], [0, 7, 1]),
])
def test_check_state_host_matches_the_reference(app, prev, cur):
    key = {"SSSP": "dist", "CC": "label", "BFS": "depth"}[app]
    dtype = np.float32 if app == "SSSP" else np.int32
    p = {key: np.asarray(prev, dtype)}
    c = {key: np.asarray(cur, dtype)}
    got = tres.check_state_host(tapps.REGISTRY[app](), p, c)
    assert got == jres.check_state_host(japps.REGISTRY[app](), p, c)


def test_sentinels_are_validated():
    bad = dataclasses.replace(tapps.REGISTRY["CC"](),
                              monotone={"label": "sideways"})
    with pytest.raises(ValueError, match="sideways"):
        tres.build_sentinels(bad)


class TestCheckpointRing:
    def _cp(self, it):
        return tres.Checkpoint(it=it, done=False, state={"x": np.arange(3)},
                               dir_buf=None, occ_buf=None)

    def test_capacity_validation(self):
        for bad in (0, -3):
            with pytest.raises(ValueError, match=f"capacity.*{bad}"):
                tres.CheckpointRing(bad)

    def test_pinned_first_survives_wraparound(self):
        ring = tres.CheckpointRing(capacity=3)
        for it in range(10):
            ring.push(self._cp(it))
        assert len(ring) == 3
        assert ring.latest().it == 9
        assert ring.rollback(1).it == 8
        assert ring.rollback(50).it == 0

    def test_capacity_one_is_cold_restart(self):
        ring = tres.CheckpointRing(capacity=1)
        for it in range(5):
            ring.push(self._cp(it))
        assert len(ring) == 1 and ring.latest().it == 0

    def test_empty_ring_raises(self):
        with pytest.raises(IndexError):
            tres.CheckpointRing().latest()


def test_validation_errors(graph):
    program = tapps.REGISTRY["BFS"]()
    config = tcore.SystemConfig.from_name("DG1")
    with pytest.raises(ValueError, match="checkpoint_every"):
        tcore.run(program, graph, config, checkpoint_every=-1, device="cpu")
    with pytest.raises(ValueError, match="max_attempts"):
        tcore.run(program, graph, config, checkpoint_every=2, device="cpu",
                  retry=tres.RetryPolicy(max_attempts=0))
    with pytest.raises(ValueError, match="engine"):
        tcore.run(program, graph, config, checkpoint_every=2, device="cpu",
                  engine="jit")


def test_degradation_chain_is_the_references():
    for cfg in ("SD1", "DG1"):
        for autotune in ("off", "measure"):
            for cap in (None, 0):
                knobs = {"engine": "fused", "autotune": autotune,
                         "sparse_edge_capacity": cap}
                got = tres._degradation_chain(
                    {**knobs, "use_kernels": True},
                    tcore.SystemConfig.from_name(cfg))
                want = jres._degradation_chain(
                    {**knobs, "use_pallas": True},
                    jcore.SystemConfig.from_name(cfg))
                strip = [{k: v for k, v in r.items()
                          if k not in ("use_kernels", "use_pallas")}
                         for r in got]
                assert strip == [{k: v for k, v in r.items()
                                  if k != "use_pallas"} for r in want]
