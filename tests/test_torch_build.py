"""The build helper of the port's CUDA sources (``kernels/_build.py``).

A library is named by a hash of its source, of every local header the
source includes (followed recursively) and of the compiler flags, so a
library built from other code or other flags is never loaded.  Nothing
here needs ``nvcc``: only the names are computed.
"""
import pytest

from repro_torch.core.capture import SOURCE as GRAPH_IF
from repro_torch.kernels import _build
from repro_torch.kernels._build import build_key
from repro_torch.kernels.embedding_bag import SOURCE as EMBAG
from repro_torch.kernels.flash_attention import SOURCE as FLASH
from repro_torch.kernels.segment_reduce import SOURCE as SEGMENT


@pytest.fixture
def sources(tmp_path):
    (tmp_path / "main.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\nint f() { return 1; }\n')
    (tmp_path / "a.cuh").write_text('  #  include "sub/b.cuh"\n')
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.cuh").write_text("// b\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["main.cu", "a.cuh", "sub/b.cuh"])
def test_build_key_follows_the_source_and_its_headers(sources, edit):
    before = build_key(sources / "main.cu")
    path = sources / edit
    path.write_text(path.read_text() + "// edited\n")
    assert build_key(sources / "main.cu") != before


def test_build_key_ignores_files_the_source_does_not_include(sources):
    before = build_key(sources / "main.cu")
    (sources / "unrelated.cuh").write_text("// edited\n")
    (sources / "sub" / "new.cuh").write_text("// new\n")
    assert build_key(sources / "main.cu") == before


def test_build_key_follows_the_compiler_flags(sources, monkeypatch):
    before = build_key(sources / "main.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert build_key(sources / "main.cu") != before


def test_build_key_refuses_a_missing_header(sources):
    (sources / "a.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="a.cuh"):
        build_key(sources / "main.cu")


@pytest.mark.parametrize("source,headers", [
    (SEGMENT, []), (EMBAG, []), (FLASH, ["flash_attention_sm90.cuh"]),
    (GRAPH_IF, [])])
def test_kernel_sources_are_keyed_on_their_headers(source, headers):
    files = _build._local_files(source)
    assert files[0] == source.resolve()
    assert [f.name for f in files[1:]] == headers
    assert len(build_key(source)) == 16
