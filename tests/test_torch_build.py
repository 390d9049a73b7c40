"""The port's kernel builder (ops/_build.py) on the CPU: a library's path
is named by a hash of its source, every csrc header it includes and the
flags, so an edited source or header is rebuilt."""

import shutil

import pytest

from libdeflate_rsx_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    d = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, d)
    monkeypatch.setattr(_build, "CSRC", str(d))
    return d


@pytest.mark.parametrize("name", ["inflate_v2", "inflate_static"])
def test_an_edited_header_changes_the_library_path(csrc, name):
    before = _build.library_path(name)
    assert before == _build.library_path(name)
    header = csrc / "stream_decode.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name) != before


def test_headers_are_found_through_headers(csrc):
    (csrc / "inner.cuh").write_text("// inner\n")
    header = csrc / "stream_decode.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert [p.rsplit("/", 1)[1] for p in _build._sources("inflate_v2")] == \
        ["inflate_v2.cu", "stream_decode.cuh", "inner.cuh"]
    before = _build.library_path("inflate_v2")
    (csrc / "inner.cuh").write_text("// inner, edited\n")
    assert _build.library_path("inflate_v2") != before


def test_an_unincluded_header_leaves_the_path(csrc):
    before = _build.library_path("inflate_tokens")
    header = csrc / "stream_decode.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path("inflate_tokens") == before
    src = csrc / "inflate_tokens.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("inflate_tokens") != before
