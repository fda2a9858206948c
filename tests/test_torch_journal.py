"""The port's write-ahead journal against ``repro.launch.journal``
(``tests/test_journal.py``'s contracts), on the CPU.

Record and replay round trips, torn lines, graph persistence and
replay idempotence (recovering one journal twice gives the same tickets,
restore states and counters; replay appends nothing).  The on-disk
format is the reference's, so a journal moves between the packages: a
reference gateway killed by its ``GatewayKillFault`` leaves a journal
the port recovers, with results bit-identical to the reference's
uninterrupted gateway, and the other way round (BFS, SSSP and CC, no
key).  The port's generator keys are journaled by their state and come
back as the same draws.
"""
import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.launch.journal as jjournal
import repro.launch.serve as jserve
import repro.testing.faults as jfaults
from repro.graph import rmat_batch as j_rmat_batch
from repro_torch.algorithms import REGISTRY
from repro_torch.core import SystemConfig, run
from repro_torch.core.durability import _deserialize_key, _serialize_key
from repro_torch.graph import rmat_batch, rmat_graph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays
from repro_torch.launch import serve
from repro_torch.launch.journal import (JOURNAL_FILE, WriteAheadJournal,
                                        graph_fingerprint)
from repro_torch.launch.serve import ContinuousScheduler
from repro_torch.testing.faults import (GatewayKillFault,
                                        SimulatedProcessDeath)

CPU = "cpu"


def _graph(seed=5):
    return rmat_graph(scale=6, edge_factor=8, seed=seed, weighted=True)


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _states_equal(a, b):
    return set(a) == set(b) and all(
        _host(a[k]).dtype == _host(b[k]).dtype
        and np.array_equal(_host(a[k]), _host(b[k])) for k in a)


def _sched(**kw):
    return ContinuousScheduler(max_batch=2, slice_len=2, device=CPU, **kw)


def _killed_journal(tmp_path, n=4, after_slices=2):
    """A journal left behind by a gateway killed mid-stream."""
    program = REGISTRY["BFS"]()
    config = SystemConfig.from_name("DG1")
    pool = rmat_batch(2, 6, seed=9)
    sched = _sched(journal_dir=str(tmp_path),
                   fault_injector=GatewayKillFault(after_slices=after_slices))
    tickets = [sched.submit(program, pool[i % 2], config) for i in range(n)]
    with pytest.raises(SimulatedProcessDeath):
        sched.run_until_idle()
    return tickets


class TestJournalRecords:
    def test_submit_commit_retire_round_trip(self, tmp_path):
        j = WriteAheadJournal(tmp_path)
        jid = j.record_submit(REGISTRY["SSSP"](), _graph(),
                              SystemConfig.from_name("TG0"), key=None,
                              max_iters=50, deadline_s=2.5,
                              knobs={"use_pallas": False})
        j.record_admit(jid)
        state = {"dist": np.arange(4, dtype=np.float32)}
        j.record_commit(jid, 3, state, 2, "ST", [0.5, 0.25])
        tickets, report = j.replay()
        assert report["torn"] == 0 and report["orphan"] == 0
        rec = tickets[jid]
        assert rec["submit"]["program"] == "SSSP"
        assert rec["submit"]["config"] == "TG0"
        assert rec["submit"]["deadline_s"] == 2.5
        assert rec["admitted"] and rec["retired"] is None
        assert rec["commits"][0]["it"] == 3
        assert rec["commits"][0]["trace"] == "ST"
        cp, faults = j.store_for(jid).load_latest()
        assert faults == [] and cp.it == 3
        assert np.array_equal(cp.state["dist"], state["dist"])
        j.record_retire(jid, "converged")
        assert j.unfinished() == {}
        assert not (tmp_path / "tickets" / jid).exists()

    def test_jids_survive_reopen(self, tmp_path):
        program, config = REGISTRY["BFS"](), SystemConfig.from_name("DG1")
        first = WriteAheadJournal(tmp_path).record_submit(
            program, _graph(), config, key=None, max_iters=None,
            deadline_s=None, knobs={})
        second = WriteAheadJournal(tmp_path).record_submit(
            program, _graph(), config, key=None, max_iters=None,
            deadline_s=None, knobs={})
        assert first != second

    def test_torn_final_line_skipped_not_fatal(self, tmp_path):
        j = WriteAheadJournal(tmp_path)
        jid = j.record_submit(REGISTRY["BFS"](), _graph(),
                              SystemConfig.from_name("DG1"), key=None,
                              max_iters=None, deadline_s=None, knobs={})
        with open(tmp_path / JOURNAL_FILE, "a") as f:
            f.write('deadbeef {"type": "retire", "jid"')
        tickets, report = j.replay()
        assert report["torn"] == 1
        assert tickets[jid]["retired"] is None

    def test_orphan_records_counted(self, tmp_path):
        j = WriteAheadJournal(tmp_path)
        j.record_admit("jid-99999999")
        _, report = j.replay()
        assert report["orphan"] == 1

    def test_records_are_the_reference_s_bytes(self, tmp_path):
        """The same submit, admit, commit and retire through both
        journals: identical journal lines, the same graph file name and
        checkpoints each package loads."""
        gj = jjournal.WriteAheadJournal(tmp_path / "ref")
        gt = WriteAheadJournal(tmp_path / "port")
        ref_graph = j_rmat_batch(1, 6, seed=9)[0]
        for j, prog, cfg, g in (
                (gj, japps.REGISTRY["BFS"](),
                 jcore.SystemConfig.from_name("DG1"), ref_graph),
                (gt, REGISTRY["BFS"](), SystemConfig.from_name("DG1"),
                 rmat_batch(1, 6, seed=9)[0])):
            jid = j.record_submit(prog, g, cfg, key=None, max_iters=7,
                                  deadline_s=None,
                                  knobs={"use_pallas": True,
                                         "sparse_edge_capacity": None,
                                         "autotune": "off",
                                         "config_source": "caller"})
            j.record_admit(jid)
            j.record_commit(jid, 2, {"dist": np.arange(3, dtype=np.int32)},
                            1, "SS", None)
        assert (tmp_path / "ref" / JOURNAL_FILE).read_bytes() == \
            (tmp_path / "port" / JOURNAL_FILE).read_bytes()
        assert sorted(p.name for p in (tmp_path / "ref" / "graphs")
                      .iterdir()) == sorted(
            p.name for p in (tmp_path / "port" / "graphs").iterdir())
        cp_port, _ = gt.store_for("jid-00000000").load_latest()
        cp_ref, _ = WriteAheadJournal(tmp_path / "ref").store_for(
            "jid-00000000").load_latest()
        assert _states_equal(cp_port.state, cp_ref.state)


class TestGraphPersistence:
    def test_round_trip_bit_identical(self, tmp_path):
        j = WriteAheadJournal(tmp_path)
        g = _graph()
        fp = j.persist_graph(g)
        g2 = WriteAheadJournal(tmp_path).load_graph(fp)
        for name in ARRAY_FIELDS:
            a, b = np.asarray(getattr(g, name)), np.asarray(
                getattr(g2, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (g2.n_nodes, g2.n_edges, g2.block_size) \
            == (g.n_nodes, g.n_edges, g.block_size)
        assert graph_fingerprint(g2) == fp

    def test_identical_graphs_share_one_copy(self, tmp_path):
        j = WriteAheadJournal(tmp_path)
        fp1 = j.persist_graph(_graph(seed=5))
        fp2 = j.persist_graph(_graph(seed=5))
        fp3 = j.persist_graph(_graph(seed=6))
        assert fp1 == fp2 and fp1 != fp3
        assert len(list((tmp_path / "graphs").iterdir())) == 2

    def test_loaded_graph_cached_per_fingerprint(self, tmp_path):
        fp = WriteAheadJournal(tmp_path).persist_graph(_graph())
        j2 = WriteAheadJournal(tmp_path)
        assert j2.load_graph(fp) is j2.load_graph(fp)

    def test_each_package_loads_the_other_s_graph_file(self, tmp_path):
        ref_graph = j_rmat_batch(1, 6, seed=9)[0]
        fp = jjournal.WriteAheadJournal(tmp_path / "a").persist_graph(
            ref_graph)
        port = WriteAheadJournal(tmp_path / "a").load_graph(fp)
        assert graph_fingerprint(port) == fp
        fp2 = WriteAheadJournal(tmp_path / "b").persist_graph(port)
        back = jjournal.WriteAheadJournal(tmp_path / "b").load_graph(fp2)
        assert fp2 == fp and jjournal.graph_fingerprint(back) == fp


class TestKeys:
    def test_generator_key_round_trips_its_state(self):
        key = torch.Generator().manual_seed(11)
        rec = _serialize_key(key)
        want = torch.randperm(50, generator=key)
        again = _deserialize_key(rec)
        assert torch.equal(torch.randperm(50, generator=again), want)
        assert _deserialize_key(None) is None
        with pytest.raises(ValueError, match="JAX"):
            _deserialize_key({"dtype": "uint32", "data": [0, 1]})

    @pytest.mark.parametrize("after", [0, 1])
    @pytest.mark.parametrize("app", ["MIS", "CLR"])
    def test_keyed_ticket_recovers_to_the_same_draws(self, tmp_path, app,
                                                     after):
        """Killed before its first slice, the ticket draws again from the
        journaled generator state; after one, it resumes from the
        checkpoint: the same result either way."""
        program, config = REGISTRY[app](), SystemConfig.from_name("SD1")
        g = _graph(seed=7)
        want = run(program, g, config, key=torch.Generator().manual_seed(3),
                   device=CPU)
        sched = ContinuousScheduler(
            max_batch=2, slice_len=1, device=CPU, journal_dir=str(tmp_path),
            fault_injector=GatewayKillFault(after_slices=after))
        sched.submit(program, g, config,
                     key=torch.Generator().manual_seed(3))
        with pytest.raises(SimulatedProcessDeath):
            sched.run_until_idle()
        fresh = _sched()
        (t,) = fresh.recover(str(tmp_path))
        assert (t._restore is None) == (after == 0)
        fresh.run_until_idle()
        res = t.result(0)
        assert res.iterations == want.iterations
        assert _states_equal(res.state, want.state)


class TestReplayIdempotence:
    def test_recover_twice_yields_same_ticket_set(self, tmp_path):
        _killed_journal(tmp_path)
        size_after_kill = (tmp_path / JOURNAL_FILE).stat().st_size
        worlds = []
        for _ in range(2):
            sched = _sched()
            recovered = sched.recover(str(tmp_path))
            worlds.append({
                "jids": [t.jid for t in recovered],
                "restores": {t.jid: (t._restore[1] if t._restore else 0)
                             for t in recovered},
                "states": {t.jid: (t._restore[0] if t._restore else None)
                           for t in recovered},
                "recovered": sched.stats.recovered_tickets,
                "submitted": sched.stats.submitted,
            })
        a, b = worlds
        assert a["jids"] == b["jids"] and len(a["jids"]) > 0
        assert a["restores"] == b["restores"]
        assert a["recovered"] == b["recovered"]
        assert a["submitted"] == b["submitted"]
        for jid in a["states"]:
            sa, sb = a["states"][jid], b["states"][jid]
            assert (sa is None) == (sb is None)
            if sa is not None:
                assert _states_equal(sa, sb)
        assert (tmp_path / JOURNAL_FILE).stat().st_size == size_after_kill

    def test_recover_then_drain_then_recover_is_empty(self, tmp_path):
        _killed_journal(tmp_path)
        sched = _sched(journal_dir=str(tmp_path))
        recovered = sched.recover(str(tmp_path))
        assert recovered
        sched.run_until_idle()
        assert all(t.done() for t in recovered)
        assert _sched().recover(str(tmp_path)) == []

    def test_recover_skips_tickets_already_live(self, tmp_path):
        _killed_journal(tmp_path)
        program, config = REGISTRY["BFS"](), SystemConfig.from_name("DG1")
        sched = _sched(journal_dir=str(tmp_path))
        live = sched.submit(program, _graph(seed=7), config)
        assert live.jid is not None
        recovered = sched.recover(str(tmp_path))
        assert recovered
        assert live.jid not in {t.jid for t in recovered}
        assert sched.recover(str(tmp_path)) == []
        jids = [t.jid for lane in sched._lanes.values()
                for t in [*lane.queue, *lane.tickets]
                if t is not None and t.jid is not None]
        assert len(jids) == len(set(jids))
        sched.run_until_idle()
        assert live.done() and all(t.done() for t in recovered)
        assert _sched().recover(str(tmp_path)) == []

    def test_recovered_results_bit_identical_to_uninterrupted(
            self, tmp_path):
        program, config = REGISTRY["BFS"](), SystemConfig.from_name("DG1")
        pool = rmat_batch(2, 6, seed=9)
        ref = _sched()
        ref_tickets = [ref.submit(program, pool[i % 2], config)
                       for i in range(4)]
        ref.run_until_idle()
        killed = _killed_journal(tmp_path)
        fresh = _sched()
        recovered = fresh.recover(str(tmp_path))
        fresh.run_until_idle()
        by_jid = {t.jid: t for t in killed if t.done()}
        by_jid.update({t.jid: t for t in recovered})
        for rt, kt in zip(ref_tickets, sorted(by_jid)):
            res = by_jid[kt].result(0)
            assert _states_equal(rt.result(0).state, res.state)
            assert res.iterations == rt.result(0).iterations
            assert res.direction_trace == rt.result(0).direction_trace


# ---------------------------------------------------------------------------
# journals across the packages

APPS = ("BFS", "SSSP", "CC")


def _mixed_stream(mod, graphs, journal_dir=None, kill=None):
    """BFS, SSSP and CC over two graphs (three lanes), with a journal and
    a kill when asked; returns (tickets, scheduler)."""
    registry = japps.REGISTRY if mod is jserve else REGISTRY
    config = (jcore.SystemConfig if mod is jserve else SystemConfig) \
        .from_name("DG1")
    kw = {} if mod is jserve else {"device": CPU}
    sched = mod.ContinuousScheduler(max_batch=2, slice_len=2,
                                    journal_dir=journal_dir,
                                    fault_injector=kill, **kw)
    programs = [registry[a]() for a in APPS]
    tickets = [sched.submit(programs[i % 3], graphs[i % 2], config)
               for i in range(6)]
    return tickets, sched


def _ref_graphs():
    return j_rmat_batch(2, 6, seed=9, weighted=True)


def _port_graphs():
    return [graph_from_arrays({f: np.asarray(getattr(g, f))
                               for f in ARRAY_FIELDS},
                              g.n_nodes, g.n_edges, g.block_size)
            for g in _ref_graphs()]


@pytest.mark.parametrize("killed,recovering", [("ref", "port"),
                                               ("port", "ref")])
def test_a_journal_moves_between_the_packages(tmp_path, killed,
                                              recovering):
    """A gateway of one package killed after two slices; the other
    package recovers its journal, and every result equals the killing
    package's uninterrupted gateway, bit for bit."""
    mods = {"ref": jserve, "port": serve}
    kills = {"ref": jfaults.GatewayKillFault, "port": GatewayKillFault}
    deaths = {"ref": jfaults.SimulatedProcessDeath,
              "port": SimulatedProcessDeath}
    graphs = {"ref": _ref_graphs, "port": _port_graphs}
    clean_t, clean = _mixed_stream(mods[killed], graphs[killed]())
    clean.run_until_idle()
    tickets, sched = _mixed_stream(mods[killed], graphs[killed](),
                                   journal_dir=str(tmp_path),
                                   kill=kills[killed](after_slices=2))
    with pytest.raises(deaths[killed]):
        sched.run_until_idle()
    fresh = mods[recovering].ContinuousScheduler(
        max_batch=2, slice_len=2,
        **({"device": CPU} if recovering == "port" else {}))
    recovered = fresh.recover(str(tmp_path))
    assert recovered and any(t._restore is not None for t in recovered)
    fresh.run_until_idle()
    by_jid = {t.jid: t.result(0) for t in tickets if t.done()}
    by_jid.update({t.jid: t.result(0) for t in recovered})
    assert len(by_jid) == len(clean_t)
    for want_t, t in zip(clean_t, tickets):
        want, got = want_t.result(0), by_jid[t.jid]
        assert got.converged and got.iterations == want.iterations
        assert got.direction_trace == want.direction_trace
        assert got.dispatches == want.dispatches
        assert _states_equal(got.state, want.state)
