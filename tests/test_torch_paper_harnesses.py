"""The port's paper harnesses (Table II, Fig. 5, Table V, Fig. 6)
against the reference's ``benchmarks/``.

Both packages run in this one process, so ``paper_graph``'s
``hash(name)`` seeds agree and both build the same stand-ins.
Tolerances:

- Table II: section (a), from the published statistics, is equal; (b),
  measured on the recreations, is equal in its classes and sizes and to
  1e-6 in its floats.
- Fig. 5 at ``scale=16`` on DCT and RAJ (the reference's own
  ``run_fig5``, as ``tests/test_frontier.py`` calls it; one repeat, since
  times are the host's and are not compared): every workload has the
  same configs and a ``best`` among them; BFS, SSSP, CC and BC have equal
  iterations, direction traces and sparse residency (``n_sparse``,
  ``n_dense``, ``mean_sparse_occupancy``); PR's iterations agree to +-1
  (float sums); MIS and CLR draw other priorities than the reference
  (``jax.random`` cannot be reproduced in torch), so their record is
  held to its structure.
- Table V and Fig. 6: both packages read one ``fig5.json`` and give
  equal records; Table V's (a) is 36/36.
"""
import json

import pytest

import benchmarks.fig5 as jfig5
import benchmarks.fig6 as jfig6
import benchmarks.table2 as jtable2
import benchmarks.table5 as jtable5
from repro_torch.benchmarks import fig5 as tfig5
from repro_torch.benchmarks import fig6 as tfig6
from repro_torch.benchmarks import table2 as ttable2
from repro_torch.benchmarks import table5 as ttable5

SCALE = 16
GRAPHS = ["DCT", "RAJ"]
EXACT_APPS = ("BFS", "SSSP", "CC", "BC")
TRACE_KEYS = ("iterations", "directions", "n_push", "n_pull", "n_sparse",
              "n_dense", "mean_sparse_occupancy")


@pytest.fixture(scope="module")
def fig5_pair(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("ref")
    port_dir = tmp_path_factory.mktemp("port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfig5, "REPEATS", 1)
        mp.setattr(tfig5, "REPEATS", 1)
        ref = jfig5.run_fig5(out_dir=str(ref_dir), scale=SCALE,
                             graphs=GRAPHS)
        port = tfig5.run_fig5(out_dir=port_dir, scale=SCALE, graphs=GRAPHS,
                              device="cpu")
    return ref, port, ref_dir / "fig5.json", port_dir / "fig5.json"


def test_constants_are_the_references():
    for name in ("STATIC_SHOWN", "DYNAMIC_SHOWN", "TRAVERSAL_APPS",
                 "SCALE", "REPEATS"):
        assert getattr(tfig5, name) == getattr(jfig5, name), name
    for app in ("BFS", "SSSP", "PR", "CC", "BC", "MIS", "CLR"):
        assert tfig5._configs_for(app) == jfig5._configs_for(app)
    assert ttable5.TABLE_V == jtable5.TABLE_V


def test_table2_equals_the_reference(tmp_path):
    ref = jtable2.run_table2(out_dir=str(tmp_path / "ref"))
    port = ttable2.run_table2(out_dir=tmp_path / "port", device="cpu")
    assert port["card"] == "cpu" and port["hw"] == "paper_gpu"
    assert json.loads((tmp_path / "port" / "table2.json").read_text()) \
        == port
    assert len(port["rows"]) == len(ref) == 6
    for p, r in zip(port["rows"], ref):
        assert p["graph"] == r["graph"]
        # (a) exactly, the published classes among them
        assert p["published"] == r["published"]
        assert p["computed_from_published"] == r["computed_from_published"]
        got, want = p["measured_on_recreation"], r["measured_on_recreation"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, float):
                assert got[k] == pytest.approx(v, rel=0, abs=1e-6), k
            else:
                assert got[k] == v, k
    # the published volume classes are reproduced exactly
    assert all(r["computed_from_published"]["vol_class"]
               == r["published"]["vol_class"] for r in port["rows"])


def test_fig5_record_structure(fig5_pair):
    ref, port, _, port_path = fig5_pair
    cells = port["cells"]
    assert set(cells) == set(ref)
    assert port["workload"]["scale"] == SCALE
    assert port["workload"]["use_kernels"] is False
    assert json.loads(port_path.read_text()) == port
    for key, want in ref.items():
        got = cells[key]
        assert list(got["configs"]) == list(want["configs"]), key
        assert got["best"] in got["configs"]
        assert min(got["configs"], key=lambda c:
                   got["configs"][c]["seconds"]) == got["best"]
        for cname, w in want["configs"].items():
            g = got["configs"][cname]
            assert set(g) - set(w) == {"converged"}, (key, cname)
            assert set(w) <= set(g), (key, cname)
            assert g["converged"] is True
            if cname.startswith("D"):
                assert g["directions"], (key, cname)


@pytest.mark.parametrize("app", EXACT_APPS + ("PR",))
def test_fig5_traces_equal_the_reference(fig5_pair, app):
    ref, port, _, _ = fig5_pair
    for gname in GRAPHS:
        key = f"{gname}/{app}"
        for cname, w in ref[key]["configs"].items():
            g = port["cells"][key]["configs"][cname]
            if app == "PR":
                assert abs(g["iterations"] - w["iterations"]) <= 1, cname
                assert set(g.get("directions", "")) <= {"T", "S"}
                continue
            for k in TRACE_KEYS:
                assert g.get(k) == w.get(k), (key, cname, k)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_table5_equals_the_reference_on_one_fig5(fig5_pair, tmp_path,
                                                 which):
    ref, port, ref_path, port_path = fig5_pair
    (tmp_path / "port").mkdir()
    if which == "reference":  # the reference's cells in the port's record
        want_path = ref_path
        path = tmp_path / "port" / "fig5.json"
        path.write_text(json.dumps({"card": None, "cells": ref}))
    else:  # the port's cells in the reference's format
        want_path = tmp_path / "fig5.json"
        want_path.write_text(json.dumps(port["cells"]))
        path = port_path
    want = jtable5.run_table5(out_dir=str(tmp_path / "ref"),
                              fig5_path=str(want_path), scale=SCALE)
    got = ttable5.run_table5(out_dir=tmp_path / "port", fig5_path=path,
                             scale=SCALE, device="cpu")
    assert got["paper_faithful"]["match_table_v"] == "36/36"
    assert {k: got[k] for k in want} == want
    assert got["card"] == "cpu" and got["scale"] == SCALE


@pytest.mark.parametrize("which", ["reference", "port"])
def test_fig6_equals_the_reference_on_one_fig5(fig5_pair, tmp_path, which):
    ref, port, ref_path, port_path = fig5_pair
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    if which == "reference":  # the reference's cells in the port's record
        want_path = ref_path
        path = tmp_path / "port" / "fig5.json"
        path.write_text(json.dumps({"card": None, "cells": ref}))
    else:
        want_path = tmp_path / "fig5.json"
        want_path.write_text(json.dumps(port["cells"]))
        path = port_path  # the port's own record
    want = jfig6.run_fig6(out_dir=str(tmp_path / "ref"),
                          fig5_path=str(want_path))
    got = tfig6.run_fig6(out_dir=tmp_path / "port", fig5_path=path)
    assert {k: got[k] for k in want} == want
    assert got["card"] == (None if which == "reference" else "cpu")
    assert json.loads((tmp_path / "port" / "fig6.json").read_text()) == got


def test_run_entry_point_prints_the_references_rows(tmp_path, capsys):
    from repro_torch.benchmarks import run as trun
    trun.main(["--device", "cpu", "--scale", "64", "--out-dir",
               str(tmp_path)])
    rows = capsys.readouterr().out.strip().splitlines()
    names = [r.split(",")[0] for r in rows if "," in r]
    assert names[0] == "name"
    assert [n for n in names if n in ("table2_profile", "fig5_sweep",
                                      "table5_model", "fig6_flexibility")] \
        == ["table2_profile", "fig5_sweep", "table5_model",
            "fig6_flexibility"]
    # the reference's roofline row, last, from the committed dry run
    assert names[-1] == "roofline"
    roof = rows[-1].split(",")
    assert int(roof[1]) == 40 and "worst_fraction=" in roof[2], rows[-1]
    assert (tmp_path / "roofline.json").exists()
    assert any("paper_faithful=36/36" in r for r in rows)
    assert any("vol_class_match=6/6" in r for r in rows)
    for name in ("table2", "fig5", "table5", "fig6"):
        assert (tmp_path / f"{name}.json").exists(), name


@pytest.mark.parametrize("flag", ["--batch-smoke", "--resilience-smoke"])
def test_run_refuses_smoke_runs_the_port_has_not(flag):
    from repro_torch.benchmarks import run as trun
    with pytest.raises(SystemExit):
        trun.main([flag, "--device", "cpu"])
