"""The port's README knob tables (``src/repro_torch/doctables.py``).

Both directions of freshness, as ``tests/test_docs.py`` holds the
reference's: every documented knob exists in the target's signature and
every signature knob has a row; the README's blocks equal the rendered
tables byte for byte, for both packages at once; and the port's markers
never match the reference's sections, so that neither module rewrites
the other's tables.
"""
from pathlib import Path

import pytest

from repro import doctables as jdoc
from repro_torch import doctables as tdoc

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def readme_text():
    return (ROOT / "README.md").read_text()


@pytest.mark.parametrize("section", sorted(tdoc.SECTIONS))
def test_documented_knobs_match_signature(section):
    doc = tdoc.doc_knobs(section)
    sig = tdoc.signature_knobs(section)
    assert doc == sig, (
        f"knob table {section!r} drifted: undocumented={sorted(sig - doc)} "
        f"stale_rows={sorted(doc - sig)} — edit "
        "src/repro_torch/doctables.py and run `python -m "
        "repro_torch.doctables --write`")


def test_ports_own_knobs_are_documented():
    assert {"use_kernels", "device", "checkpoint_dir"} <= \
        tdoc.doc_knobs("torch-run")
    assert "device" in tdoc.doc_knobs("torch-gateway")
    assert "use_pallas" not in tdoc.doc_knobs("torch-submit")


def test_readme_blocks_of_both_packages_are_fresh(readme_text):
    assert tdoc.check_text(readme_text) == []
    assert jdoc.check_text(readme_text) == []


def test_stale_block_is_detected(readme_text):
    stale = readme_text.replace("| `use_kernels=` |", "| `use_kernles=` |")
    assert any("out of date" in p for p in tdoc.check_text(stale))
    assert jdoc.check_text(stale) == []  # not the reference's table


def test_missing_markers_raise_on_inject():
    with pytest.raises(ValueError, match="markers"):
        tdoc.inject("no markers here\n")


def test_inject_is_idempotent_and_leaves_the_references_blocks(readme_text):
    assert tdoc.inject(readme_text) == readme_text
    assert jdoc.inject(tdoc.inject(readme_text)) == readme_text


def test_markers_name_the_port_and_never_the_reference_sections():
    for section in tdoc.SECTIONS:
        begin = tdoc.marker(section, "begin")
        assert "repro_torch.doctables" in begin
        for ref_section in jdoc.SECTIONS:
            assert begin != jdoc.marker(ref_section, "begin")
            assert not jdoc._block_re(ref_section).search(
                tdoc._block(section))


def test_check_and_write_entry_point(tmp_path, readme_text):
    path = tmp_path / "README.md"
    path.write_text(readme_text.replace("| `device=` |", "| `devcie=` |"))
    assert tdoc.main(["--readme", str(path), "--check"]) == 1
    assert tdoc.main(["--readme", str(path), "--write"]) == 0
    assert tdoc.main(["--readme", str(path), "--check"]) == 0
    assert path.read_text() == readme_text
