"""The port's perf gate (``repro_torch.benchmarks.compare``) against the
reference's ``benchmarks/compare.py``.

Every case of ``tests/test_compare.py`` runs over both modules, on the
reference's own artifact builders.  The port's ``extract_metrics`` and
``fingerprint`` must equal the reference's on every file of
``results/baselines/``.  The one rule that differs, the tolerance rule
for PR and BC identity, has its own tests.  Last, the committed
``results/torch/BENCH_*.json`` must pass against
``results/torch/baselines/``.
"""
import copy
import json
from pathlib import Path

import pytest

import benchmarks.compare as jcmp
import repro_torch.benchmarks.compare as tcmp
from test_compare import (_autotune_artifact, _batch_artifact,
                          _chaos_artifact, _dispatch_artifact,
                          _matrix_artifact, _resilience_artifact,
                          _specialize_artifact)

ROOT = Path(__file__).resolve().parent.parent
REF_BASELINES = ROOT / "results" / "baselines"


@pytest.fixture(params=["reference", "port"])
def m(request):
    return jcmp if request.param == "reference" else tcmp


def _write(d, m, kind, artifact):
    d.mkdir(parents=True, exist_ok=True)
    (d / m.ARTIFACTS[kind]).write_text(json.dumps(artifact))


# ---------------------------------------------------------------------------
# the reference's cases, over both modules
# ---------------------------------------------------------------------------
def test_extract_metric_names(m):
    assert m.extract_metrics("dispatch", _dispatch_artifact())[
        "dispatch/SG0/fused_speedup"] == 1.5
    assert m.extract_metrics("batch", _batch_artifact())[
        "batch/DG1/B16/speedup"] == 2.0
    assert m.extract_metrics("autotune", _autotune_artifact())[
        "autotune/rmat/TD0/speedup"] == 1.3
    got = m.extract_metrics("matrix", _matrix_artifact())
    assert got["matrix/DCT/PR/specialization_gain"] == 1.4
    assert got["matrix/RAJ/CC/specialization_gain"] == 1.4
    with pytest.raises(ValueError):
        m.extract_metrics("nope", {})


def test_identical_passes(m):
    base = _dispatch_artifact()
    rep = m.compare_artifact("dispatch", base, copy.deepcopy(base))
    assert rep["status"] == "ok"
    assert rep["geomean_ratio"] == pytest.approx(1.0)


def test_injected_2x_regression_fails(m):
    rep = m.compare_artifact("batch", _batch_artifact(speedup=2.0),
                             _batch_artifact(speedup=1.0))
    assert rep["status"] == "regression"
    assert rep["geomean_ratio"] == pytest.approx(2.0 ** 0.5)
    assert rep["worst"][0][1] == pytest.approx(2.0)


def test_single_cell_noise_is_absorbed_by_geomean(m):
    base = _dispatch_artifact(speedup=1.5)
    cur = copy.deepcopy(base)
    cur["configs"]["SG0"]["fused_speedup"] = 1.2
    assert m.compare_artifact("dispatch", base, cur)["status"] == "ok"


def test_uniform_regression_beyond_threshold_fails(m):
    assert m.compare_artifact(
        "dispatch", _dispatch_artifact(speedup=1.5),
        _dispatch_artifact(speedup=1.5 / 1.3))["status"] == "regression"


def test_improvement_passes(m):
    rep = m.compare_artifact("dispatch", _dispatch_artifact(speedup=1.5),
                             _dispatch_artifact(speedup=3.0))
    assert rep["status"] == "ok"
    assert rep["geomean_ratio"] < 1.0


def test_changed_workload_is_incompatible(m):
    cur = _batch_artifact()
    cur["workload"]["scale"] = 7
    assert m.compare_artifact("batch", _batch_artifact(),
                              cur)["status"] == "incompatible"
    cur = _autotune_artifact()
    cur["smoke"] = False
    assert m.compare_artifact("autotune", _autotune_artifact(),
                              cur)["status"] == "incompatible"


def test_resilience_caps_and_bit_identity(m):
    base = _resilience_artifact(efficiency=0.98, recovery=1.4)
    cur = _resilience_artifact(efficiency=0.93, recovery=1.2)
    rep = m.compare_artifact("resilience", base, cur)
    assert rep["status"] == "ok"
    assert rep["geomean_ratio"] == pytest.approx(1.0)
    got = m.extract_metrics("resilience", base)
    assert got["resilience/TG0/efficiency"] == pytest.approx(0.90)
    assert got["resilience/recovery/speedup"] == pytest.approx(1.1)
    assert m.compare_artifact("resilience", base, _resilience_artifact(
        identical=False))["status"] == "regression"
    moved = _resilience_artifact()
    moved["checkpoint_every"] = 8
    assert m.compare_artifact("resilience", base,
                              moved)["status"] == "incompatible"


def test_chaos_invariants_read_one_when_healthy(m):
    assert m.extract_metrics("chaos", _chaos_artifact()) == {
        "chaos/core/identical": 1.0,
        "chaos/core/lost_work_contained": 1.0,
        "chaos/gateway/BFS/identical": 1.0,
        "chaos/gateway/SSSP/identical": 1.0,
        "chaos/gateway/lost_work_contained": 1.0,
        "chaos/overload/contained": 1.0,
    }
    base = _chaos_artifact()
    rep = m.compare_artifact("chaos", base, copy.deepcopy(base))
    assert rep["status"] == "ok"
    assert rep["geomean_ratio"] == pytest.approx(1.0)


def test_chaos_lost_identity_blows_the_gate(m):
    for broken in (_chaos_artifact(identical=False),
                   _chaos_artifact(lost_work=1.0),
                   _chaos_artifact(contained=False)):
        rep = m.compare_artifact("chaos", _chaos_artifact(), broken)
        assert rep["status"] == "regression"
        assert rep["worst"][0][1] == pytest.approx(1e6)


def test_specialize_invariants_and_caps(m):
    got = m.extract_metrics("specialize", _specialize_artifact())
    assert got["specialize/accuracy_ge_partial"] == 1.0
    assert got["specialize/e2e_ge_best_always"] == 1.0
    assert got["specialize/accuracy_learned_tol"] == pytest.approx(0.83)
    assert got["specialize/speedup_vs_best_always"] == m.SPECIALIZE_CAP
    base = _specialize_artifact()
    rep = m.compare_artifact("specialize", base, copy.deepcopy(base))
    assert rep["status"] == "ok"
    assert rep["geomean_ratio"] == pytest.approx(1.0)


def test_specialize_broken_acceptance_blows_the_gate(m):
    for broken in (_specialize_artifact(partial_ok=False),
                   _specialize_artifact(e2e_ok=False)):
        rep = m.compare_artifact("specialize", _specialize_artifact(),
                                 broken)
        assert rep["status"] == "regression"
        assert rep["worst"][0][1] == pytest.approx(1e6)
    rep = m.compare_artifact("specialize", _specialize_artifact(),
                             _specialize_artifact(acc=0.5))
    assert rep["ratios"]["specialize/accuracy_learned_tol"] \
        == pytest.approx(0.83 / 0.5)


def test_specialize_training_matrix_pins_fingerprint(m):
    moved = _specialize_artifact()
    moved["workload"]["matrix"]["scale"] = 512
    assert m.compare_artifact("specialize", _specialize_artifact(),
                              moved)["status"] == "incompatible"


def test_chaos_smoke_flag_pins_fingerprint(m):
    full = _chaos_artifact()
    full["smoke"] = False
    assert m.compare_artifact("chaos", _chaos_artifact(),
                              full)["status"] == "incompatible"


def test_matrix_gain_regression_and_input_source_pinning(m):
    base = _matrix_artifact(gain=1.4)
    assert m.compare_artifact("matrix", base,
                              copy.deepcopy(base))["status"] == "ok"
    assert m.compare_artifact("matrix", base, _matrix_artifact(
        gain=1.0))["status"] == "regression"
    assert m.compare_artifact("matrix", base, _matrix_artifact(
        source="real"))["status"] == "incompatible"


def test_end_to_end_pass_and_injected_fail(m, tmp_path):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(base, m, "dispatch", _dispatch_artifact(1.5))
    _write(cur, m, "dispatch", _dispatch_artifact(1.45))
    assert m.compare_dirs(base, cur, ["dispatch"]) == 0
    _write(cur, m, "dispatch", _dispatch_artifact(0.75))
    assert m.compare_dirs(base, cur, ["dispatch"]) == 1


def test_failure_message_names_artifact_metric_and_values(m, tmp_path,
                                                          capsys):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(base, m, "dispatch", _dispatch_artifact(1.5))
    _write(cur, m, "dispatch", _dispatch_artifact(0.75))
    assert m.compare_dirs(base, cur, ["dispatch"]) == 1
    out = capsys.readouterr().out
    assert "worst [dispatch]: dispatch/SG0/fused_speedup" in out
    assert "measured 0.75 vs baseline 1.5" in out
    assert "+100.0% regression" in out


def test_missing_baseline_fails_unless_allowed(m, tmp_path):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(cur, m, "batch", _batch_artifact())
    assert m.compare_dirs(base, cur, ["batch"]) == 2
    assert m.compare_dirs(base, cur, ["batch"], allow_missing=True) == 0


def test_missing_current_fails_unless_allowed(m, tmp_path):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(base, m, "batch", _batch_artifact())
    cur.mkdir()
    assert m.compare_dirs(base, cur, ["batch"]) == 2
    assert m.compare_dirs(base, cur, ["batch"], allow_missing=True) == 0


def test_incompatible_baseline_exits_2(m, tmp_path):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(base, m, "autotune", _autotune_artifact())
    changed = _autotune_artifact()
    changed["workloads"]["rmat"]["params"] = {"scale": 9}
    _write(cur, m, "autotune", changed)
    assert m.compare_dirs(base, cur, ["autotune"]) == 2


def test_corrupt_baseline_exits_2_with_refresh_hint(m, tmp_path, capsys):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(cur, m, "dispatch", _dispatch_artifact())
    base.mkdir()
    (base / m.ARTIFACTS["dispatch"]).write_text('{"workload": tru')
    assert m.compare_dirs(base, cur, ["dispatch"]) == 2
    out = capsys.readouterr().out
    assert "UNREADABLE baseline" in out
    assert str(base / m.ARTIFACTS["dispatch"]) in out
    assert "--update-baselines" in out


def test_corrupt_current_exits_2(m, tmp_path, capsys):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(base, m, "dispatch", _dispatch_artifact())
    cur.mkdir()
    (cur / m.ARTIFACTS["dispatch"]).write_text("")
    assert m.compare_dirs(base, cur, ["dispatch"]) == 2
    assert "UNREADABLE current" in capsys.readouterr().out


def test_update_baselines_copies(m, tmp_path):
    base, cur = tmp_path / "baselines", tmp_path / "results"
    _write(cur, m, "dispatch", _dispatch_artifact())
    m.update_baselines(base, cur, ["dispatch", "batch"])
    assert (base / m.ARTIFACTS["dispatch"]).exists()
    assert not (base / m.ARTIFACTS["batch"]).exists()
    assert m.compare_dirs(base, cur, ["dispatch"]) == 0


# ---------------------------------------------------------------------------
# the port's median baselines and trip-rate report
# ---------------------------------------------------------------------------
def _runs(tmp_path, speedups):
    dirs = []
    for i, sp in enumerate(speedups):
        d = tmp_path / f"run{i}"
        _write(d, tcmp, "dispatch", _dispatch_artifact(sp))
        dirs.append(d)
    return dirs


def test_update_baselines_takes_per_metric_medians(tmp_path, capsys):
    dirs = _runs(tmp_path, (1.5, 1.0, 2.0))
    art = json.loads((dirs[0] / "BENCH_dispatch.json").read_text())
    art["configs"]["SG0"]["fused_speedup"] = 3.0  # one metric moves alone
    (dirs[0] / "BENCH_dispatch.json").write_text(json.dumps(art))
    base = tmp_path / "baselines"
    tcmp.update_baselines(base, dirs, ["dispatch"])
    assert "median of 3" in capsys.readouterr().out
    got = json.loads((base / "BENCH_dispatch.json").read_text())
    assert got["gate_median_of"] == 3
    assert got["gate_metrics"] == {"dispatch/DDR/fused_speedup": 1.5,
                                   "dispatch/DG1/fused_speedup": 1.5,
                                   "dispatch/SG0/fused_speedup": 2.0,
                                   "dispatch/TG0/fused_speedup": 1.5}
    # the gate reads the medians, not the copied first run
    rep = tcmp.compare_artifact("dispatch", got, _dispatch_artifact(1.5))
    assert rep["ratios"]["dispatch/SG0/fused_speedup"] == \
        pytest.approx(2.0 / 1.5)
    assert tcmp.compare_dirs(base, dirs[1], ["dispatch"]) == 1  # 1.0 vs 1.5
    assert tcmp.compare_dirs(base, dirs[2], ["dispatch"]) == 0


def test_median_baseline_refuses_runs_of_different_workloads():
    other = _dispatch_artifact()
    other["workload"]["scale"] = 11
    with pytest.raises(ValueError):
        tcmp.median_baseline("dispatch", [_dispatch_artifact(), other])


def test_trip_rates_count_leave_one_out_and_pairs(tmp_path):
    dirs = _runs(tmp_path, (1.5, 1.5, 1.0))
    rep = tcmp.trip_rates(dirs, ["dispatch"])["dispatch"]
    loo, pairs = rep["leave_one_out"], rep["pairs"]
    assert (loo["n"], pairs["n"]) == (3, 6)
    # only the slow run trips, against the median of the two others;
    # as a one-run baseline it trips nothing (the others are faster)
    assert loo["trips"] == 1 and pairs["trips"] == 2
    assert loo["geomean_regressions"][2] == pytest.approx(0.5)
    assert loo["geomean_regressions"][0] == pytest.approx(1.25 / 1.5 - 1)


def test_main_trip_rate_and_median_update(tmp_path, capsys):
    dirs = [str(d) for d in _runs(tmp_path, (1.5, 1.4, 1.6))]
    assert tcmp.main(["--artifacts", "dispatch", "--trip-rate"]
                     + dirs) == 0
    out = capsys.readouterr().out
    assert "trip-rate dispatch leave_one_out: 0/3" in out
    assert "trip-rate dispatch pairs: 0/6" in out
    base = tmp_path / "baselines"
    argv = ["--artifacts", "dispatch", "--baseline-dir", str(base)]
    for d in dirs:
        argv += ["--current-dir", d]
    assert tcmp.main(argv + ["--update-baselines"]) == 0
    assert json.loads((base / "BENCH_dispatch.json").read_text())[
        "gate_metrics"]["dispatch/SG0/fused_speedup"] == 1.5
    with pytest.raises(SystemExit):  # the gate reads one run
        tcmp.main(argv)
    with pytest.raises(SystemExit):
        tcmp.main(["--trip-rate"] + dirs[:2])


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------
def test_constants_are_the_references():
    assert tcmp.ARTIFACTS == jcmp.ARTIFACTS
    assert tcmp.DEFAULT_THRESHOLD == jcmp.DEFAULT_THRESHOLD == 0.20
    for cap in ("SERVE_CAPS", "RESILIENCE_EFFICIENCY_CAP",
                "RESILIENCE_RECOVERY_CAP", "SPECIALIZE_CAP"):
        assert getattr(tcmp, cap) == getattr(jcmp, cap), cap


@pytest.mark.parametrize("kind", sorted(jcmp.ARTIFACTS))
def test_metrics_equal_the_reference_on_its_baselines(kind):
    data = json.loads((REF_BASELINES / jcmp.ARTIFACTS[kind]).read_text())
    assert tcmp.extract_metrics(kind, data) == jcmp.extract_metrics(kind,
                                                                    data)
    assert tcmp.fingerprint(kind, data) == jcmp.fingerprint(kind, data)


def test_defaults_read_the_ports_artifacts():
    assert tcmp.RESULTS == ROOT / "results" / "torch"
    assert tcmp.BASELINES == ROOT / "results" / "torch" / "baselines"


# ---------------------------------------------------------------------------
# the tolerance rule
# ---------------------------------------------------------------------------
def _resilience(app, bit_identical, within_tolerance):
    art = _resilience_artifact(identical=bit_identical)
    art["workload"]["app"] = app
    for cell in art["configs"].values():
        cell["within_tolerance"] = within_tolerance
    return art


@pytest.mark.parametrize("app", ["PR", "BC"])
def test_float_sum_identity_reads_within_tolerance(app):
    art = _resilience(app, bit_identical=False, within_tolerance=True)
    got = tcmp.extract_metrics("resilience", art)
    assert got["resilience/TG0/identical"] == 1.0
    assert jcmp.extract_metrics("resilience", art)[
        "resilience/TG0/identical"] == 1e-6
    assert tcmp.compare_artifact("resilience", art, copy.deepcopy(
        art))["geomean_ratio"] == pytest.approx(1.0)
    broken = _resilience(app, bit_identical=False, within_tolerance=False)
    rep = tcmp.compare_artifact("resilience", art, broken)
    assert rep["status"] == "regression"
    assert rep["worst"][0][1] == pytest.approx(1e6)


@pytest.mark.parametrize("app", ["BFS", "SSSP", "CC"])
def test_exact_apps_keep_bit_identity(app):
    art = _resilience(app, bit_identical=False, within_tolerance=True)
    assert tcmp.extract_metrics("resilience", art)[
        "resilience/TG0/identical"] == 1e-6
    healthy = _resilience(app, bit_identical=True, within_tolerance=True)
    assert tcmp.compare_artifact("resilience", healthy,
                                 art)["status"] == "regression"


@pytest.mark.parametrize("core_app,agrees,want", [
    ("PR", True, 1.0), ("PR", False, 1e-6), ("BC", True, 1.0),
    ("BFS", True, 1e-6)])
def test_chaos_core_identity_reads_agrees_for_float_sums(core_app, agrees,
                                                         want):
    art = _chaos_artifact(identical=False)
    art["workload"]["core_app"] = core_app
    art["core"]["agrees"] = agrees
    got = tcmp.extract_metrics("chaos", art)
    assert got["chaos/core/identical"] == want
    assert got["chaos/gateway/BFS/identical"] == 1e-6  # exact apps
    assert jcmp.extract_metrics("chaos", art)["chaos/core/identical"] \
        == 1e-6


# ---------------------------------------------------------------------------
# the committed artifacts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(tcmp.ARTIFACTS))
def test_committed_artifacts_pass_against_the_committed_baselines(kind):
    assert (tcmp.BASELINES / tcmp.ARTIFACTS[kind]).exists()
    assert tcmp.compare_dirs(tcmp.BASELINES, tcmp.RESULTS, [kind]) == 0


def test_committed_baselines_are_from_the_card():
    for kind, fname in tcmp.ARTIFACTS.items():
        data = json.loads((tcmp.BASELINES / fname).read_text())
        assert "H100" in data["card"], kind
