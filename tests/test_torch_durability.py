"""The port's on-disk checkpoint store against ``repro.core.durability``.

The store keeps the reference's format byte for byte, so each package
must read the other's files (arrays and meta equal), report every
corruption with the reference's structured code, and give the
reference's graph fingerprint.  Through ``run(..., checkpoint_dir=)`` a
killed run must resume bit-identical to an uninterrupted one, replaying
only the lost segment, and never resume from a directory of another
graph or another generator seed.  A run killed under either package
resumes under the other.
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.core.durability as jdur
import repro.core.resilience as jres
import repro.testing.faults as jfaults
import repro_torch.algorithms as tapps
import repro_torch.core as tcore
import repro_torch.core.durability as tdur
import repro_torch.core.resilience as tres
import repro_torch.testing.faults as tfaults
from repro.graph import rmat_graph
from repro.launch.journal import graph_fingerprint as ref_fingerprint
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

CFG = "DG1"
K = 4


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


@pytest.fixture(scope="module")
def ref_graph():
    return rmat_graph(scale=6, edge_factor=8, seed=11, weighted=True)


@pytest.fixture(scope="module")
def graph(ref_graph):
    return _port(ref_graph)


def _cp(module, it, v=0.0, done=False, traced=False):
    return module.Checkpoint(
        it=it, done=done,
        state={"dist": np.full(8, v, np.float32),
               "frontier": np.zeros(8, bool),
               "pull": np.asarray(True)},
        dir_buf=np.arange(6) % 2 == 0 if traced else None,
        occ_buf=np.linspace(-1, 1, 6).astype(np.float32) if traced else None)


def _states_equal(a, b):
    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    return set(a) == set(b) and all(
        host(a[k]).dtype == host(b[k]).dtype
        and np.array_equal(host(a[k]), host(b[k])) for k in a)


def _run(program, g, **kw):
    return tcore.run(program, g, tcore.SystemConfig.from_name(CFG),
                     checkpoint_every=K, device="cpu", **kw)


# ---------------------------------------------------------------------------
# the format


FINGERPRINT = {"program": "SSSP", "config": CFG, "n_nodes": 8, "k": 4,
               "key": None}


@pytest.mark.parametrize("writer,reader", [(jdur, tdur), (tdur, jdur)])
@pytest.mark.parametrize("traced", [False, True])
def test_files_are_read_across_the_packages(tmp_path, writer, reader, traced):
    wres = jres if writer is jdur else tres
    written = _cp(wres, 3, 1.5, done=True, traced=traced)
    path = writer.CheckpointStore(tmp_path, fingerprint=FINGERPRINT).save(
        written)
    assert path.read_bytes()[:8] == tdur.CHECKPOINT_MAGIC == \
        jdur.CHECKPOINT_MAGIC
    store = reader.CheckpointStore(tmp_path, fingerprint=FINGERPRINT)
    cp = store.load(path)
    assert (cp.it, cp.done) == (3, True)
    assert _states_equal(cp.state, written.state)
    for buf in ("dir_buf", "occ_buf"):
        want = getattr(written, buf)
        got = getattr(cp, buf)
        assert (got is None) == (want is None)
        if want is not None:
            assert got.dtype == want.dtype and np.array_equal(got, want)
    # the same header and the same meta, read back by either package
    raw = path.read_bytes()
    assert raw[:tdur._HEADER.size] == jdur._HEADER.pack(
        *jdur._HEADER.unpack_from(raw))
    meta = [m._decode_payload(raw[tdur._HEADER.size:])[1]
            for m in (tdur, jdur)]
    assert meta == [FINGERPRINT, FINGERPRINT]


def test_encoded_payloads_hold_the_same_entries():
    import io
    entries = []
    for m, mres in ((tdur, tres), (jdur, jres)):
        payload = m._encode_payload(_cp(mres, 2, 0.5, traced=True),
                                    FINGERPRINT)
        with np.load(io.BytesIO(payload)) as z:
            entries.append({k: z[k].copy() for k in z.files})
    assert entries[0].keys() == entries[1].keys()
    for k, v in entries[0].items():
        assert v.dtype == entries[1][k].dtype and np.array_equal(
            v, entries[1][k]), k


def test_graph_fingerprint_is_the_references(ref_graph, graph):
    want = ref_fingerprint(ref_graph)
    assert tdur.graph_fingerprint(graph) == want
    # tensors on a device are hashed from host copies
    assert tdur.graph_fingerprint(graph.to("cpu")) == want
    other = dataclasses.replace(graph, weight=graph.weight * 2)
    assert tdur.graph_fingerprint(other) != want


def test_generator_key_serializes_its_state():
    a = torch.Generator().manual_seed(1)
    rec = tdur._serialize_key(a)
    assert rec == tdur._serialize_key(torch.Generator().manual_seed(1))
    assert rec != tdur._serialize_key(torch.Generator().manual_seed(2))
    assert tdur._serialize_key(None) is None
    with pytest.raises(TypeError, match="Generator"):
        tdur._serialize_key(np.asarray([0, 1], np.uint32))


class TestStore:
    def test_save_load_round_trip(self, tmp_path):
        store = tdur.CheckpointStore(tmp_path)
        store.save(_cp(tres, 3, 1.5))
        cp, faults = store.load_latest()
        assert faults == [] and cp.it == 3 and not cp.done
        assert np.array_equal(cp.state["dist"], np.full(8, 1.5, np.float32))
        assert cp.state["frontier"].dtype == np.bool_

    def test_generations_ordered_and_pruned(self, tmp_path):
        store = tdur.CheckpointStore(tmp_path, keep=3)
        for it in range(6):
            store.save(_cp(tres, it, float(it)))
        cps, faults = store.load_all()
        its = [c.it for c in cps]
        assert not faults and its == sorted(its)
        assert its[0] == 0 and its[-1] == 5
        assert len(store.generations()) == 3

    def test_keep_below_one_rejected(self, tmp_path):
        with pytest.raises(ValueError, match="keep"):
            tdur.CheckpointStore(tmp_path, keep=0)

    def test_keep_one_still_resumes_from_newest(self, tmp_path):
        store = tdur.CheckpointStore(tmp_path, keep=1)
        for it in range(5):
            store.save(_cp(tres, it, float(it)))
        cp, faults = store.load_latest()
        assert faults == [] and cp.it == 4
        assert [c.it for c in store.load_all()[0]] == [0, 4]

    def test_atomic_no_tmp_left_behind(self, tmp_path):
        tdur.CheckpointStore(tmp_path).save(_cp(tres, 1))
        assert not [p for p in Path(tmp_path).iterdir()
                    if p.name.startswith(".tmp-")]

    def test_clear_removes_every_generation(self, tmp_path):
        store = tdur.CheckpointStore(tmp_path)
        store.save(_cp(tres, 1))
        (Path(tmp_path) / ".tmp-ckpt-00000009.rck").write_bytes(b"x")
        store.clear()
        assert len(store) == 0 and not list(Path(tmp_path).iterdir())


def _corrupt(path, how):
    raw = bytearray(path.read_bytes())
    if how == "truncate":
        path.write_bytes(bytes(raw[: len(raw) // 2]))
    elif how == "bitflip":
        raw[-1] ^= 0x40
        path.write_bytes(bytes(raw))
    elif how == "magic":
        raw[0] ^= 0xFF
        path.write_bytes(bytes(raw))
    elif how == "version":
        raw[8] = 7
        path.write_bytes(bytes(raw))
    elif how == "short":
        path.write_bytes(b"xy")
    elif how == "payload":
        # an intact header over a payload that is not an npz archive
        body = b"not an npz archive"
        import hashlib
        path.write_bytes(tdur._HEADER.pack(
            tdur.CHECKPOINT_MAGIC, tdur.CHECKPOINT_VERSION, len(body),
            hashlib.sha256(body).digest()) + body)


@pytest.mark.parametrize("how,reason", [
    ("truncate", "truncated"), ("bitflip", "checksum_mismatch"),
    ("magic", "bad_magic"), ("version", "unknown_version"),
    ("short", "short_header"), ("payload", "undecodable")])
def test_each_corruption_gives_the_references_code(tmp_path, how, reason):
    tdur.CheckpointStore(tmp_path).save(_cp(tres, 1))
    gen = tdur.CheckpointStore(tmp_path).generations()[0]
    _corrupt(gen, how)
    records = []
    for m in (tdur, jdur):
        cp, faults = m.CheckpointStore(tmp_path).load_latest()
        assert cp is None and len(faults) == 1
        records.append({k: v for k, v in faults[0].items() if k != "error"})
    assert records[0] == records[1]
    assert records[0]["kind"] == "corrupt_checkpoint"
    assert records[0]["reason"] == reason
    with pytest.raises(tres.ExecutionFault) as err:
        tdur.CheckpointStore(tmp_path).load(gen)
    assert err.value.code == "corrupt_checkpoint"


def test_corrupt_newest_falls_back_and_all_corrupt_is_cold(tmp_path):
    store = tdur.CheckpointStore(tmp_path)
    for it in (1, 2, 3):
        store.save(_cp(tres, it, float(it)))
    _corrupt(store.generations()[0], "bitflip")
    cps, faults = store.load_all()
    assert [f["kind"] for f in faults] == ["corrupt_checkpoint"]
    assert cps[-1].it == 2
    for gen in store.generations():
        _corrupt(gen, "truncate")
    cps, faults = store.load_all()
    assert cps == [] and len(faults) == 3


def test_fingerprint_mismatch_rejected(tmp_path):
    tdur.CheckpointStore(tmp_path, fingerprint={"jid": "a"}).save(
        _cp(tres, 1))
    cp, faults = tdur.CheckpointStore(
        tmp_path, fingerprint={"jid": "b"}).load_latest()
    assert cp is None and faults[0]["kind"] == "checkpoint_mismatch"


# ---------------------------------------------------------------------------
# durable runs


@pytest.mark.parametrize("app,point", [("PR", "after_segment"),
                                       ("SSSP", "after_segment"),
                                       ("CLR", "segment_start")])
@pytest.mark.parametrize("engine", ["fused", "host"])
def test_resume_after_kill_is_bit_identical(tmp_path, graph, app, point,
                                            engine):
    program = tapps.REGISTRY[app]()
    clean = _run(program, graph, engine=engine)
    kill_at = max(K, clean.iterations - K)
    with pytest.raises(tfaults.SimulatedProcessDeath):
        _run(program, graph, engine=engine, checkpoint_dir=str(tmp_path),
             fault_injector=tfaults.ProcessKillFault(at_iteration=kill_at,
                                                     point=point))
    cp, faults = tdur.CheckpointStore(str(tmp_path)).load_latest()
    assert faults == []
    # the killed segment never reached the disk: at most one segment
    # of work is lost, none when the kill came before a segment
    lost = kill_at - cp.it
    assert 0 < lost <= K if point == "after_segment" else lost <= 0
    resumed = _run(tapps.REGISTRY[app](), graph, engine=engine,
                   checkpoint_dir=str(tmp_path))
    assert resumed.converged and resumed.fault is None
    assert resumed.iterations == clean.iterations
    assert resumed.direction_trace == clean.direction_trace
    assert resumed.occupancy_trace == clean.occupancy_trace
    assert _states_equal(clean.state, resumed.state)
    # only the iterations after the resume point ran again
    assert resumed.resilience["segments"] == \
        -(-(clean.iterations - cp.it) // K)


def test_rerun_of_finished_run_converges_from_disk(tmp_path, graph):
    program = tapps.REGISTRY["BFS"]()
    first = _run(program, graph, checkpoint_dir=str(tmp_path))
    again = _run(program, graph, checkpoint_dir=str(tmp_path))
    assert again.converged and again.resilience["segments"] == 0
    assert _states_equal(first.state, again.state)


def test_corrupt_newest_generation_still_recovers(tmp_path, graph):
    program = tapps.REGISTRY["PR"]()
    clean = _run(program, graph)
    with pytest.raises(tfaults.SimulatedProcessDeath):
        _run(program, graph, checkpoint_dir=str(tmp_path),
             fault_injector=tfaults.ProcessKillFault(
                 at_iteration=max(K, clean.iterations - K)))
    _corrupt(tdur.CheckpointStore(str(tmp_path)).generations()[0], "bitflip")
    resumed = _run(program, graph, checkpoint_dir=str(tmp_path))
    assert resumed.converged and _states_equal(clean.state, resumed.state)
    hist = (resumed.fault or {}).get("history", [])
    assert any(h.get("kind") == "corrupt_checkpoint" for h in hist)


def test_same_shape_different_graph_never_resumes(tmp_path, graph):
    program = tapps.REGISTRY["SSSP"]()
    clean_a = _run(program, graph)
    with pytest.raises(tfaults.SimulatedProcessDeath):
        _run(program, graph, checkpoint_dir=str(tmp_path),
             fault_injector=tfaults.ProcessKillFault(
                 at_iteration=max(K, clean_a.iterations - K),
                 point="after_segment"))
    g2 = dataclasses.replace(graph, weight=graph.weight * 2.0,
                             weight_in=graph.weight_in * 2.0)
    clean_b = _run(program, g2)
    resumed = _run(program, g2, checkpoint_dir=str(tmp_path))
    assert resumed.converged and _states_equal(clean_b.state, resumed.state)
    hist = (resumed.fault or {}).get("history", [])
    assert any(h.get("kind") == "checkpoint_mismatch" for h in hist)


@pytest.mark.parametrize("engine", ["fused", "host"])
def test_another_generator_seed_never_resumes(tmp_path, graph, engine):
    program = tapps.REGISTRY["MIS"]()

    def key(seed):
        return torch.Generator().manual_seed(seed)

    def go(seed, **kw):
        return tcore.run(program, graph, tcore.SystemConfig.from_name(CFG),
                         key=key(seed), checkpoint_every=1, engine=engine,
                         device="cpu", **kw)

    clean1, clean2 = go(0), go(1)
    assert clean1.iterations >= 2
    assert not torch.equal(clean1.state["priority"], clean2.state["priority"])
    with pytest.raises(tfaults.SimulatedProcessDeath):
        go(0, checkpoint_dir=str(tmp_path),
           fault_injector=tfaults.ProcessKillFault(at_iteration=1,
                                                   point="after_segment"))
    resumed = go(1, checkpoint_dir=str(tmp_path))
    assert resumed.converged and _states_equal(clean2.state, resumed.state)
    hist = (resumed.fault or {}).get("history", [])
    assert any(h.get("kind") == "checkpoint_mismatch" for h in hist)
    # the killed seed still ends on its own answer from that directory
    assert _states_equal(clean1.state,
                         go(0, checkpoint_dir=str(tmp_path)).state)


@pytest.mark.parametrize("killed_by", ["reference", "port"])
def test_a_run_killed_in_one_package_resumes_in_the_other(
        tmp_path, ref_graph, graph, killed_by):
    """Same program, config, graph content, limit and K, no key: the
    fingerprints agree, so either package resumes the other's run."""
    jconfig = jcore.SystemConfig.from_name(CFG)
    clean = _run(tapps.REGISTRY["SSSP"](), graph)
    kill_at = max(K, clean.iterations - K)
    if killed_by == "reference":
        with pytest.raises(jfaults.SimulatedProcessDeath):
            jcore.run(japps.REGISTRY["SSSP"](), ref_graph, jconfig,
                      checkpoint_every=K, checkpoint_dir=str(tmp_path),
                      fault_injector=jfaults.ProcessKillFault(
                          at_iteration=kill_at, point="after_segment"))
        resumed = _run(tapps.REGISTRY["SSSP"](), graph,
                       checkpoint_dir=str(tmp_path))
    else:
        with pytest.raises(tfaults.SimulatedProcessDeath):
            _run(tapps.REGISTRY["SSSP"](), graph,
                 checkpoint_dir=str(tmp_path),
                 fault_injector=tfaults.ProcessKillFault(
                     at_iteration=kill_at, point="after_segment"))
        resumed = jcore.run(japps.REGISTRY["SSSP"](), ref_graph, jconfig,
                            checkpoint_every=K, checkpoint_dir=str(tmp_path))
    assert resumed.fault is None and resumed.converged
    assert resumed.iterations == clean.iterations
    assert resumed.direction_trace == clean.direction_trace
    assert _states_equal(clean.state, resumed.state)
