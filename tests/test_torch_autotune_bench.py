"""The port's autotune benchmark against ``benchmarks/autotune.py``.

Both run their smoke workloads (one repeat; times are the host's and are
not compared) with their disk caches under a temporary directory.  The
port must sweep the same workloads (generator, parameters, sizes, degree
features and signature), run the same 18 cells with the same BFS
iterations, reuse the default's time wherever the tuned context resolves
the default's plans (speedup exactly 1.0, as the reference does), and
keep every ``measure`` state equal to its ``off`` state and both equal
to the plain version's (``use_kernels=False``) bit for bit.
"""
import json

import pytest

import benchmarks.autotune as jbench
import repro.kernels.autotune as jat
import repro_torch.kernels.autotune as tat
from repro_torch.benchmarks import autotune as tbench


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("autotune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jat, "DEFAULT_CACHE_PATH", str(d / "ref_cache.json"))
        mp.setattr(tat, "DEFAULT_CACHE_PATH", str(d / "port_cache.json"))
        ref = jbench.run_autotune(out_path=str(d / "ref.json"), smoke=True,
                                  repeats=1)
        port = tbench.run_autotune(out_path=d / "port.json", smoke=True,
                                   repeats=1, device="cpu")
    return ref, port, d


def _names(workloads):
    return {n: (gen.__name__, params) for n, (gen, params)
            in workloads.items()}


def test_constants_are_the_references():
    assert _names(tbench.PINNED_WORKLOADS) == _names(jbench.PINNED_WORKLOADS)
    assert _names(tbench.SMOKE_WORKLOADS) == _names(jbench.SMOKE_WORKLOADS)
    assert (tbench.APP, tbench.REPEATS) == (jbench.APP, jbench.REPEATS)
    assert tbench.ORDERS == jat.ORDERS


def test_same_workloads_and_cells(pair):
    ref, port, d = pair
    assert json.loads((d / "port.json").read_text()) == port
    assert (port["app"], port["smoke"], port["repeats"]) == \
        (ref["app"], ref["smoke"], ref["repeats"])
    assert port["card"] == "cpu" and port["use_kernels"] is True
    assert set(port["kernel_launches"]) == {"seg_sum", "seg_minmax"}
    assert list(port["workloads"]) == list(ref["workloads"])
    for name, want in ref["workloads"].items():
        got = port["workloads"][name]
        for k in ("generator", "params", "n_nodes", "n_edges",
                  "degree_signature", "features"):
            assert got[k] == want[k], (name, k)
        assert list(got["tuning"]) == list(want["tuning"])
        assert list(got["configs"]) == list(want["configs"])
        for cfg, w in want["configs"].items():
            g = got["configs"][cfg]
            assert g["default"]["iterations"] == w["default"]["iterations"]
            assert g["tuned"]["iterations"] == w["tuned"]["iterations"]
        assert got["summary"]["n_configs"] == want["summary"]["n_configs"]


def test_tuning_records_the_sweep_and_its_recall(pair):
    _, port, _ = pair
    for w in port["workloads"].values():
        for order, t in w["tuning"].items():
            assert t["candidates"], order
            assert t["resolved_plan"] == t["plan"], order
            assert t["resolved_source"] == "disk", order


def test_reused_cells_have_speedup_exactly_one(pair):
    ref, port, _ = pair
    for name, w in port["workloads"].items():
        for cfg, cell in w["configs"].items():
            if cfg[:2] == "SG":  # no blocked reducer in either package
                assert not cell["plans_differ"]
                assert not ref["workloads"][name]["configs"][cfg][
                    "plans_differ"]
            if not cell["plans_differ"]:
                assert cell["speedup"] == 1.0, (name, cfg)
                assert cell["tuned"] == cell["default"]
        s = w["summary"]
        assert s["tuned_cells"] == sum(c["plans_differ"]
                                       for c in w["configs"].values())


def test_measure_states_equal_off_states(pair):
    _, port, _ = pair
    assert port["summary"]["states_equal"] is True
    assert all(c["states_equal"] for w in port["workloads"].values()
               for c in w["configs"].values())


def test_off_and_measure_states_equal_the_plain_version(pair):
    _, port, _ = pair
    assert port["summary"]["plain_equal"] is True
    assert all(c["plain_equal"] for w in port["workloads"].values()
               for c in w["configs"].values())
