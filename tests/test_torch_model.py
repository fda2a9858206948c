"""The port's Fig. 4 trees (``core/model.py``) against ``repro``'s.

Every one of the 27 (Volume, Reuse, Imbalance) class triples meets
every Table III row; the full and the partial tree must name the
reference's config in each case.  Table V comes out 36/36 from the
published classes, and the partial tree keeps the reference's pinned
table.
"""
import itertools

import pytest

import repro.core as jcore
import repro_torch.core as tcore
from repro_torch.graph.datasets import PAPER_STATS

TRIPLES = list(itertools.product("LMH", repeat=3))

TABLE_V = {
    "AMZ": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR",
                CC="DD1"),
    "DCT": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR",
                CC="DD1"),
    "EML": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR",
                CC="DD1"),
    "OLS": dict(PR="SDR", SSSP="SDR", MIS="TG0", CLR="TG0", BC="SDR",
                CC="DD1"),
    "RAJ": dict(PR="SDR", SSSP="SDR", MIS="SDR", CLR="SDR", BC="SDR",
                CC="DD1"),
    "WNG": dict(PR="SGR", SSSP="SGR", MIS="SGR", CLR="SGR", BC="SGR",
                CC="DD1"),
}


def _profiles(classes):
    return (tcore.GraphProfile.from_classes(*classes),
            jcore.GraphProfile.from_classes(*classes))


@pytest.mark.parametrize("app", sorted(tcore.TABLE_III))
@pytest.mark.parametrize("classes", TRIPLES, ids="".join)
def test_trees_equal_the_reference(classes, app):
    tprof, jprof = _profiles(classes)
    tprops, jprops = tcore.TABLE_III[app], jcore.TABLE_III[app]
    assert tcore.specialize(tprops, tprof).name == \
        jcore.specialize(jprops, jprof).name
    assert tcore.specialize_partial(tprops, tprof).name == \
        jcore.specialize_partial(jprops, jprof).name


@pytest.mark.parametrize("gname", sorted(TABLE_V))
def test_table_v_from_the_published_classes(gname):
    prof = tcore.GraphProfile.from_classes(*PAPER_STATS[gname][7:10])
    for app, want in TABLE_V[gname].items():
        assert tcore.specialize(tcore.TABLE_III[app], prof).name == want


def test_table_v_36_of_36():
    hits = sum(
        tcore.specialize(
            tcore.TABLE_III[app],
            tcore.GraphProfile.from_classes(*PAPER_STATS[g][7:10])).name
        == TABLE_V[g][app]
        for g in TABLE_V for app in TABLE_V[g])
    assert hits == 36


def test_partial_tree_flips_mis_raj_to_pull_and_never_relaxes():
    raj = tcore.GraphProfile.from_classes(*PAPER_STATS["RAJ"][7:10])
    assert tcore.specialize(tcore.TABLE_III["MIS"], raj).name == "SDR"
    assert tcore.specialize_partial(tcore.TABLE_III["MIS"], raj).name == \
        "TG0"
    for classes in TRIPLES:
        prof = tcore.GraphProfile.from_classes(*classes)
        for props in tcore.TABLE_III.values():
            assert tcore.specialize_partial(props, prof).name[2] != "R"


def test_trees_return_configs_of_the_port():
    prof = tcore.GraphProfile.from_classes("H", "M", "L")
    for props in tcore.TABLE_III.values():
        cfg = tcore.specialize(props, prof)
        assert isinstance(cfg, tcore.SystemConfig)
        assert tcore.SystemConfig.from_name(cfg.name) == cfg
