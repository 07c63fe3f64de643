"""The kernel library's cache key (``_build.library_path``) covers every
file nvcc reads: an edit to a source or to a header it includes
(``csrc/*.cuh``) gives a new ``.torch_kernels/<hash>/``, so a stale library
is never loaded. The key is pure Python: no nvcc is needed here.

Two processes that find no library (two card workers of the run scheduler
on a fresh checkout) each build it in their own temporary directory and
rename it into place: both succeed and end with the same file. Here a
stand-in ``nvcc`` script on ``PATH`` writes its inputs' bytes, slowly, so
that the two builds usually overlap."""

import multiprocessing as mp
import os
import stat

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


FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: '-c SRC -o OBJ' copies SRC; '-shared -o OUT OBJS' joins OBJS
sleep 0.3
out=""; prev=""; inputs=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"
  else case "$a" in *.cu|*.o) inputs="$inputs $a";; esac
  fi
  prev="$a"
done
cat $inputs > "$out"
"""


def _build_in(csrc, root, queue):
    _build._CSRC, _build.BUILD_ROOT = csrc, root
    try:
        path = _build.build()
        with open(path, "rb") as f:
            queue.put((path, f.read()))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        queue.put(("error", repr(e)))


def test_two_cold_builds_at_once_both_end_with_the_library(csrc, tmp_path, monkeypatch):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    root = str(tmp_path / "kernels")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_build_in, args=(str(csrc), root, queue)) for _ in range(2)]
    for p in procs:
        p.start()
    results = [queue.get(timeout=120) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    monkeypatch.setattr(_build, "BUILD_ROOT", root)
    want = _build.library_path()
    assert [r[0] for r in results] == [want, want], results
    assert results[0][1] == results[1][1] == b'#include "helpers.cuh"\n'
    folder = os.path.dirname(want)
    assert sorted(os.listdir(folder)) == ["build.log", "libtip_kernels.so"]
