"""The port's learned specializer and the ``specialize=`` knob against
``repro``'s.

The cases of ``tests/test_specialize.py``, run against the port: the
model file (round trip, wrong version, corrupt payloads, a missing
file), the chain learned -> static partial -> caller with its
structured warnings, "off", an unknown mode, ``n_chunks`` inheritance,
the plan-cache hit, the signature memo, a cached fallback, ``run`` and
``run_batch`` stamping, and ``project_config``.  Then the differential
cases: ``fit_matrix`` on the reference's baseline matrix gives the
reference's tree, classes and predictions; the reference's model file
loads in the port and predicts what the reference predicts, and a file
the port saves loads in the reference; ``resolve_config`` and ``run``
with ``specialize=`` give the reference's config name and source and,
under that config, the reference's state.  Last, the committed
artifacts of the card's matrix (``results/torch/``) hold the gate.
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.algorithms as japps
import repro.core as jcore
import repro.core.specialize_learned as jsl
import repro.graph as jgraph
from repro_torch.algorithms import REGISTRY
from repro_torch.core import PLAN_CACHE, SystemConfig, run, run_batch
from repro_torch.core import specialize_learned as sl
from repro_torch.graph import powerlaw_graph, regular_graph, rmat_graph
from repro_torch.graph.structure import ARRAY_FIELDS, graph_from_arrays

ROOT = Path(__file__).resolve().parent.parent
#: the reference's training set and the model fitted on it
MATRIX = ROOT / "results" / "baselines" / "BENCH_matrix.json"
REF_MODEL = ROOT / "results" / "specialize_model.json"
#: the port's artifacts, from the card's matrix
PORT_MATRIX = ROOT / "results" / "torch" / "BENCH_matrix.json"
PORT_ARTIFACT = ROOT / "results" / "torch" / "BENCH_specialize.json"
PORT_MODEL = ROOT / "results" / "torch" / "specialize_model.json"
CFG = SystemConfig.from_name("TG0")


@pytest.fixture(autouse=True)
def _fresh_memo():
    sl.clear_memo()
    jsl.clear_memo()
    yield
    sl.clear_memo()
    jsl.clear_memo()


def _fit():
    return sl.fit_matrix(json.loads(MATRIX.read_text()))


def _rows():
    return sl.training_table(json.loads(MATRIX.read_text()))


def _port(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in ARRAY_FIELDS},
                             g.n_nodes, g.n_edges, g.block_size)


# ---------------------------------------------------------------------------
# the model file
# ---------------------------------------------------------------------------
def test_default_model_path_is_the_ports():
    assert sl.DEFAULT_MODEL_PATH == "results/torch/specialize_model.json"
    assert (sl.MODEL_FORMAT, sl.MODEL_VERSION, sl.FEATURES,
            sl.TRACE_FEATURES) == (jsl.MODEL_FORMAT, jsl.MODEL_VERSION,
                                   jsl.FEATURES, jsl.TRACE_FEATURES)


def test_roundtrip(tmp_path):
    model = _fit()
    loaded = sl.load_model(sl.save_model(model, tmp_path / "m.json"))
    assert loaded.features == model.features
    assert loaded.classes == model.classes
    for r in _rows():
        assert loaded.predict_name(r.features) == \
            model.predict_name(r.features)


def test_wrong_version_rejected(tmp_path):
    data = _fit().to_json()
    data["version"] = sl.MODEL_VERSION + 1
    p = tmp_path / "m.json"
    p.write_text(json.dumps(data))
    with pytest.raises(sl.ModelFileError) as ei:
        sl.load_model(p)
    assert ei.value.code == "model_version"


@pytest.mark.parametrize("payload", [
    '{"format": tru', '{"format": "nope"}', "[]",
    json.dumps({"format": "repro-specialize-model", "version": 1,
                "features": [], "classes": ["ZZZ"], "tree": {}})])
def test_corrupt_payloads_rejected(tmp_path, payload):
    p = tmp_path / "m.json"
    p.write_text(payload)
    with pytest.raises(sl.ModelFileError) as ei:
        sl.load_model(p)
    assert ei.value.code == "model_corrupt"


def test_missing_file_is_oserror(tmp_path):
    with pytest.raises(OSError):
        sl.load_model(tmp_path / "absent.json")


# ---------------------------------------------------------------------------
# the fallback chain
# ---------------------------------------------------------------------------
def _resolve(model_path, graph=None, mode="learned", app="BFS"):
    g = graph if graph is not None else rmat_graph(5, 8, seed=11)
    return sl.resolve_config(REGISTRY[app](), g, CFG, mode,
                             model_path=model_path)


def test_missing_model_falls_back_to_partial(tmp_path):
    with pytest.warns(sl.SpecializeFallbackWarning,
                      match="code=model_missing"):
        config, source = _resolve(tmp_path / "absent.json")
    assert source == "static_partial"
    assert isinstance(config, SystemConfig) and config.name == "DD1"


def test_corrupt_model_falls_back_to_partial(tmp_path):
    p = tmp_path / "m.json"
    p.write_text("{not json")
    with pytest.warns(sl.SpecializeFallbackWarning,
                      match="code=model_corrupt"):
        _, source = _resolve(p)
    assert source == "static_partial"


def test_wrong_version_falls_back_to_partial(tmp_path):
    data = _fit().to_json()
    data["version"] = 999
    p = tmp_path / "m.json"
    p.write_text(json.dumps(data))
    with pytest.warns(sl.SpecializeFallbackWarning,
                      match="code=model_version"):
        _, source = _resolve(p)
    assert source == "static_partial"


def test_no_properties_keeps_caller_config():
    class Anon:
        name = "not-a-registered-app"
    with pytest.warns(sl.SpecializeFallbackWarning,
                      match="code=no_properties"):
        config, source = sl.resolve_config(
            Anon(), rmat_graph(5, 8, seed=12), CFG, "learned",
            model_path=REF_MODEL)
    assert (config, source) == (CFG, "caller")


def test_off_is_untouched_and_silent():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for mode in (None, False, "off"):
            assert sl.resolve_config(REGISTRY["BFS"](),
                                     rmat_graph(5, 8, seed=13), CFG,
                                     mode) == (CFG, "caller")


@pytest.mark.parametrize("mode", ["bogus", 1, "Learned"])
def test_unknown_mode_raises(mode):
    with pytest.raises(ValueError, match="specialize"):
        sl.resolve_config(REGISTRY["BFS"](), rmat_graph(5, 8, seed=14),
                          CFG, mode)
    with pytest.raises(ValueError, match="specialize"):
        run(REGISTRY["BFS"](), rmat_graph(5, 8, seed=14), CFG,
            device="cpu", specialize=mode)


def test_learned_uses_the_model():
    config, source = _resolve(REF_MODEL)
    assert source == "learned"
    assert config.name in sl.load_model(REF_MODEL).classes


def test_predicted_config_inherits_caller_chunks():
    caller = SystemConfig.from_name("TG0", n_chunks=4)
    for mode in ("learned", "static"):
        config, _ = sl.resolve_config(REGISTRY["PR"](),
                                      rmat_graph(5, 8, seed=15), caller,
                                      mode, model_path=REF_MODEL)
        assert config.n_chunks == 4


# ---------------------------------------------------------------------------
# caching
# ---------------------------------------------------------------------------
def test_plan_cache_hit_on_repeat_same_graph():
    g = rmat_graph(6, 8, seed=21)
    before = PLAN_CACHE.kind_stats("specialized_config")["hits"]
    first = _resolve(REF_MODEL, g)
    second = _resolve(REF_MODEL, g)
    assert first == second
    assert PLAN_CACHE.kind_stats("specialized_config")["hits"] >= before + 1


def test_signature_memo_hit_on_fresh_same_shape_graph():
    _resolve(REF_MODEL, rmat_graph(6, 8, seed=22))
    assert sl.memo_stats()["misses"] >= 1
    hits = sl.memo_stats()["hits"]
    _resolve(REF_MODEL, rmat_graph(6, 8, seed=22))
    assert sl.memo_stats()["hits"] == hits + 1


def test_fallback_decision_is_cached_too(tmp_path):
    g = rmat_graph(6, 8, seed=23)
    absent = tmp_path / "absent.json"
    with pytest.warns(sl.SpecializeFallbackWarning):
        _resolve(absent, g)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, source = _resolve(absent, g)
    assert source == "static_partial"


# ---------------------------------------------------------------------------
# run and run_batch
# ---------------------------------------------------------------------------
@pytest.fixture
def ref_model_default(monkeypatch):
    """Both packages' default model path pointed at the reference's
    model file."""
    monkeypatch.setattr(sl, "DEFAULT_MODEL_PATH", str(REF_MODEL))
    monkeypatch.setattr(jsl, "DEFAULT_MODEL_PATH", str(REF_MODEL))


def test_run_stamps_source_and_matches_off(ref_model_default):
    g = rmat_graph(6, 8, seed=0)
    prog = REGISTRY["BFS"]()
    off = run(prog, g, CFG, device="cpu", specialize="off")
    assert (off.config_name, off.config_source) == ("TG0", "caller")
    res = run(prog, g, CFG, device="cpu", specialize="learned")
    assert res.config_source == "learned" and res.config_name is not None
    direct = run(prog, g, SystemConfig.from_name(res.config_name),
                 device="cpu")
    assert res.iterations == direct.iterations
    assert torch.equal(res.state["depth"], direct.state["depth"])


def test_run_static_uses_full_tree():
    res = run(REGISTRY["BFS"](), rmat_graph(6, 8, seed=0), CFG,
              device="cpu", specialize="static")
    assert (res.config_source, res.config_name) == ("static", "DD1")


def test_resilient_run_stamps_source_too():
    res = run(REGISTRY["BFS"](), rmat_graph(6, 8, seed=0), CFG,
              device="cpu", specialize="static", checkpoint_every=2)
    assert (res.config_source, res.config_name) == ("static", "DD1")
    assert res.outcome == "converged"


def test_run_batch_stamps_per_graph(ref_model_default):
    gs = [rmat_graph(5, 8, seed=1), regular_graph(100, 3, seed=0)]
    results = run_batch(REGISTRY["BFS"](), gs, CFG, device="cpu",
                        specialize="learned")
    assert len(results) == 2
    for r in results:
        assert r.config_source == "learned" and r.config_name is not None


def _skew_model(path):
    """A model that puts near-regular graphs on SD1 and skewed ones on
    TG0."""
    tree = {"feature": sl.FEATURES.index("degree_skew"), "threshold": 0.6,
            "left": {"counts": [1, 0]}, "right": {"counts": [0, 1]}}
    return sl.save_model(sl.LearnedSpecializer(
        features=sl.FEATURES, classes=("SD1", "TG0"), tree=tree), path)


def test_run_batch_never_packs_different_resolved_configs(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(sl, "DEFAULT_MODEL_PATH",
                        _skew_model(tmp_path / "m.json"))
    # one padding bucket, (512, 4096, 256); different degree shapes
    gs = [regular_graph(500, 4, seed=1),
          powerlaw_graph(500, 2000, alpha=1.2, max_degree=60, seed=2),
          regular_graph(500, 4, seed=3)]
    prog = REGISTRY["SSSP"]()
    packed = []
    import repro_torch.core.batch as batch_mod
    real = batch_mod.get_graph_batch

    def spy(members):
        packed.append(tuple(id(m) for m in members))
        return real(members)

    monkeypatch.setattr(batch_mod, "get_graph_batch", spy)
    results = run_batch(prog, gs, CFG, device="cpu", specialize="learned")
    assert [r.config_name for r in results] == ["SD1", "TG0", "SD1"]
    assert sorted(packed) == sorted([(id(gs[0]), id(gs[2])), (id(gs[1]),)])
    for g, r in zip(gs, results):
        seq = run(prog, g, SystemConfig.from_name(r.config_name),
                  device="cpu")
        assert r.config_source == "learned"
        assert r.iterations == seq.iterations
        assert torch.equal(r.state["dist"], seq.state["dist"])


# ---------------------------------------------------------------------------
# project_config
# ---------------------------------------------------------------------------
def test_project_config():
    assert sl.project_config("TG0", ["TG0", "SG1"]) == "TG0"
    assert sl.project_config("SDR", ["TG0", "SG1", "SD1"]) == "SD1"
    assert sl.project_config("SDR", ["TG0", "SG1"]) == "SG1"
    assert sl.project_config("SG1", ["TG0", "DD1"]) == "DD1"
    for name in ("TDR", "SGR", "DG0", "TG1"):
        for avail in (["TG0", "SG1", "DD1"], ["SD1", "TG1", "DGR"]):
            assert sl.project_config(name, avail) == \
                jsl.project_config(name, avail)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("trace", [False, True])
def test_fit_matrix_gives_the_reference_tree(trace):
    matrix = json.loads(MATRIX.read_text())
    port = sl.fit_matrix(matrix, trace_features=trace)
    ref = jsl.fit_matrix(matrix, trace_features=trace)
    assert port.to_json() == ref.to_json()
    assert port.classes == ref.classes
    for r, jr in zip(sl.training_table(matrix), jsl.training_table(matrix)):
        assert (r.workload, r.label, r.features, r.trace, r.seconds) == \
            (jr.workload, jr.label, jr.features, jr.trace, jr.seconds)
        feats = {**r.features, **r.trace}
        assert port.predict_name(feats) == ref.predict_name(feats)


def test_model_files_move_between_the_packages(tmp_path):
    port = sl.load_model(REF_MODEL)
    ref = jsl.load_model(REF_MODEL)
    assert port.to_json() == ref.to_json()
    saved = sl.save_model(_fit(), tmp_path / "port.json")
    back = jsl.load_model(saved)
    jsl_saved = jsl.save_model(jsl.fit_matrix(json.loads(
        MATRIX.read_text())), tmp_path / "ref.json")
    assert Path(saved).read_text() == Path(jsl_saved).read_text()
    for r in _rows():
        assert back.predict_name(r.features) == \
            port.predict_name(r.features)


GRAPHS = {
    "rmat": lambda: jgraph.rmat_graph(7, 8, seed=3, block_size=32),
    "powerlaw": lambda: jgraph.powerlaw_graph(300, 1500, alpha=1.2,
                                              max_degree=40, seed=2,
                                              block_size=32),
    "regular": lambda: jgraph.regular_graph(200, 3, locality=0.6, seed=1,
                                            block_size=32),
}


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_features_and_static_choice_equal_the_reference(gname):
    ref = GRAPHS[gname]()
    port = _port(ref)
    for app in REGISTRY:
        props, jprops = REGISTRY[app]().properties, jcore.TABLE_III[app]
        assert sl.features_from_graph(props, port) == \
            jsl.features_from_graph(jprops, ref)
        for partial in (False, True):
            assert sl.static_config_for(props, port, partial).name == \
                jsl.static_config_for(jprops, ref, partial).name


@pytest.mark.parametrize("gname", list(GRAPHS))
@pytest.mark.parametrize("mode", ["static", "learned"])
def test_resolve_config_equals_the_reference(gname, mode):
    ref = GRAPHS[gname]()
    port = _port(ref)
    for app in REGISTRY:
        cfg, src = sl.resolve_config(REGISTRY[app](), port, CFG, mode,
                                     model_path=REF_MODEL)
        jcfg, jsrc = jsl.resolve_config(japps.REGISTRY[app](), ref,
                                        jcore.SystemConfig.from_name("TG0"),
                                        mode, model_path=REF_MODEL)
        assert (cfg.name, src) == (jcfg.name, jsrc), app


@pytest.mark.parametrize("mode", ["off", "static", "learned"])
@pytest.mark.parametrize("app,key", [("BFS", "depth"), ("SSSP", "dist"),
                                     ("CC", "label"), ("PR", "rank")])
def test_run_with_specialize_equals_the_reference(app, key, mode,
                                                  ref_model_default):
    ref_graph = GRAPHS["powerlaw"]()
    port = run(REGISTRY[app](), _port(ref_graph), CFG, device="cpu",
               specialize=mode)
    ref = jcore.run(japps.REGISTRY[app](), ref_graph,
                    jcore.SystemConfig.from_name("TG0"), specialize=mode)
    assert (port.config_name, port.config_source) == \
        (ref.config_name, ref.config_source)
    got, want = port.state[key].numpy(), np.asarray(ref.state[key])
    if app == "PR":
        assert abs(port.iterations - ref.iterations) <= 1
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        assert port.iterations == ref.iterations
        assert port.direction_trace == ref.direction_trace
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the committed artifacts of the card's matrix
# ---------------------------------------------------------------------------
def test_committed_artifact_holds_the_gate():
    art = json.loads(PORT_ARTIFACT.read_text())
    assert art["gate"] == {"accuracy_ge_partial": True,
                           "e2e_ge_best_always": True}
    acc = art["accuracy"]
    assert acc["learned_tol"] >= acc["static_partial_tol"]
    assert art["e2e"]["speedup_vs_best_always"] >= 1.0
    matrix = json.loads(PORT_MATRIX.read_text())
    assert art["card"] == matrix["card"] and "H100" in matrix["card"]
    assert matrix["pythonhashseed"] == "0"
    wl = matrix["workload"]
    assert (wl["scale"], wl["use_kernels"], wl["autotune"],
            len(wl["configs"])) == (1, True, "measure", 18)
    assert len(matrix["cells"]) == 42


def test_committed_model_matches_committed_matrix():
    matrix = json.loads(PORT_MATRIX.read_text())
    fresh = sl.fit_matrix(matrix)
    committed = sl.load_model(PORT_MODEL)
    assert committed.to_json() == fresh.to_json()
    assert committed.meta["trained_on"]["card"] == matrix["card"]
    assert jsl.load_model(PORT_MODEL).classes == committed.classes
