"""The kernel library's cache key (``_build.library_path``) covers every
file nvcc reads: an edit to a source or to a header it includes
(``csrc/*.cuh``) gives a new ``.torch_kernels/<hash>/``, so a stale library
is never loaded. The key is pure Python: no nvcc is needed here."""

import pytest

from simple_tip_tpu_torch import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A temporary ``csrc`` with one source and one header it includes."""
    (tmp_path / "kernel.cu").write_text('#include "helpers.cuh"\n')
    (tmp_path / "helpers.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "_CSRC", str(tmp_path))
    return tmp_path


@pytest.mark.parametrize("edited", ["kernel.cu", "helpers.cuh"])
def test_library_path_changes_with_every_file_nvcc_reads(csrc, edited):
    before = _build.library_path()
    assert _build.library_path() == before  # the key is stable
    (csrc / edited).write_text((csrc / edited).read_text() + "// edited\n")
    assert _build.library_path() != before


def test_the_repository_headers_are_hashed():
    assert any(path.endswith(".cuh") for path in _build._headers())
