"""The port's matrix and specialize harnesses against the reference's.

``run_matrix(smoke=True)`` on a subset (2 inputs x 3 apps, the smoke
configs TG0 / SG1 / DD1) must give the reference's ``inputs`` records
and, cell for cell, the same iterations, ``converged``, direction traces
and ``n_sparse``; times are the host's and are not compared.  Both
packages build the stand-ins from the same ``hash(name)`` seed within
this process.  MIS and CLR draw other priorities than the reference
(``jax.random`` cannot be reproduced in torch), so their record is held
to its structure only.  ``run_specialize`` on the reference's baseline
matrix must give the reference's accuracies, e2e figures, gate and
per-workload choices, and write the same model file.
"""
import json
from pathlib import Path

import pytest

import benchmarks.matrix as jmatrix
import benchmarks.specialize as jspec
from repro_torch.benchmarks import matrix as tmatrix
from repro_torch.benchmarks import specialize as tspec

ROOT = Path(__file__).resolve().parent.parent
BASELINE = ROOT / "results" / "baselines" / "BENCH_matrix.json"
GRAPHS = ["DCT", "RAJ"]
APPS = ["BFS", "SSSP", "PR"]


@pytest.fixture(scope="module")
def ref_matrix(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "m.json"
    return jmatrix.run_matrix(out_path=str(out), smoke=True, apps=APPS,
                              graphs=GRAPHS, repeats=1)


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "kernels"])
def port_matrix(request):
    return tmatrix.run_matrix(out_path=None, smoke=True, apps=APPS,
                              graphs=GRAPHS, repeats=1, device="cpu",
                              use_kernels=request.param)


def test_constants_are_the_references():
    for name in ("REF_CONFIG", "SMOKE_CONFIGS", "FULL_SCALE", "SMOKE_SCALE",
                 "FULL_BLOCK", "SMOKE_BLOCK", "REPEATS", "SMOKE_REPEATS"):
        assert getattr(tmatrix, name) == getattr(jmatrix, name), name
    assert tspec.DEFAULT_TOL == jspec.DEFAULT_TOL


def test_inputs_records_equal_the_reference(port_matrix, ref_matrix):
    assert port_matrix["inputs"] == ref_matrix["inputs"]
    assert port_matrix["smoke"] is True
    wl, jwl = port_matrix["workload"], ref_matrix["workload"]
    assert {k: wl[k] for k in jwl} == jwl
    assert wl["use_kernels"] in (False, True)
    assert port_matrix["card"] == "cpu"


def test_cells_equal_the_reference(port_matrix, ref_matrix):
    assert sorted(port_matrix["cells"]) == sorted(ref_matrix["cells"])
    for wl, cell in port_matrix["cells"].items():
        ref = ref_matrix["cells"][wl]["configs"]
        assert sorted(cell["configs"]) == sorted(ref)
        for cname, got in cell["configs"].items():
            want = ref[cname]
            what = f"{wl} {cname}"
            if wl.endswith("/PR"):  # float sums: iterations to +-1
                assert abs(got["iterations"] - want["iterations"]) <= 1, \
                    what
            else:
                assert got["iterations"] == want["iterations"], what
            assert got["converged"] == want["converged"], what
            assert set(got) == set(want), what
            if "directions" in want and not wl.endswith("/PR"):
                assert got["directions"] == want["directions"], what
                assert got["n_sparse"] == want["n_sparse"], what
        assert cell["best"] in cell["configs"]
        assert cell["specialization_gain"] >= 1.0


def test_summary_is_consistent(port_matrix):
    s = port_matrix["summary"]
    cells = port_matrix["cells"]
    assert s["n_workloads"] == len(cells) == len(GRAPHS) * len(APPS)
    assert sum(s["best_config_histogram"].values()) == len(cells)
    assert s["n_distinct_best"] == len(s["best_config_histogram"])
    assert s["geomean_specialization_gain"] >= 1.0


def test_randomized_apps_keep_the_record_structure():
    got = tmatrix.run_matrix(out_path=None, smoke=True, apps=["MIS", "CLR"],
                             graphs=["RAJ"], repeats=1, device="cpu")
    for app in ("MIS", "CLR"):
        cell = got["cells"][f"RAJ/{app}"]
        assert set(cell) == {"configs", "best", "specialization_gain"}
        assert sorted(cell["configs"]) == sorted(tmatrix.SMOKE_CONFIGS)
        for cname, c in cell["configs"].items():
            assert c["converged"] and c["iterations"] > 0
            assert ("directions" in c) == cname.startswith("D")
            if "directions" in c:
                assert len(c["directions"]) == c["iterations"]
                assert 0 <= c["n_sparse"] <= c["iterations"]


def test_specialize_harness_equals_the_reference(tmp_path):
    ref = jspec.run_specialize(out_path=str(tmp_path / "ref.json"),
                               matrix_path=str(BASELINE),
                               model_out=str(tmp_path / "ref_model.json"),
                               smoke=True)
    port = tspec.run_specialize(out_path=tmp_path / "port.json",
                                matrix_path=BASELINE,
                                model_out=tmp_path / "port_model.json",
                                smoke=True)
    for key in ("accuracy", "e2e", "gate", "per_workload", "smoke"):
        assert port[key] == ref[key], key
    assert {k: v for k, v in port["model"].items() if k != "path"} == \
        {k: v for k, v in ref["model"].items() if k != "path"}
    assert port["workload"] == ref["workload"]
    assert (tmp_path / "port_model.json").read_text() == \
        (tmp_path / "ref_model.json").read_text()
    assert json.loads((tmp_path / "port.json").read_text())["gate"] == \
        ref["gate"]


def test_specialize_harness_refuses_a_missing_or_mismatched_matrix(
        tmp_path):
    with pytest.raises(SystemExit, match="no matrix"):
        tspec.run_specialize(out_path=None,
                             matrix_path=tmp_path / "absent.json")
    with pytest.raises(SystemExit, match="smoke"):
        tspec.run_specialize(out_path=None, matrix_path=BASELINE,
                             smoke=False)
