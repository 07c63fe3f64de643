"""The port's atomic writer and orphan sweep against the JAX package's
``utils/artifacts_io.py``, on the CPU: the sweep removes exactly what the
JAX one removes from the same directory (and returns the same count);
a write leaves no tmp behind and, when it fails, leaves the destination as
it was; the time records of ``test_prio`` go through it.
"""

import os
import pickle
import shutil

import pytest

from simple_tip_tpu.utils import artifacts_io as jax_io
from simple_tip_tpu_torch.engine import eval_prioritization
from simple_tip_tpu_torch.utils import artifacts_io
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

OLD = 1_000_000.0  # an mtime far in the past


def _litter(folder):
    """Files of every shape beside the writers' ``<base>.<pid>.tmp``, old and
    new, and a subdirectory with an old orphan inside."""
    folder.mkdir()
    names = {
        "a.pkl.123.tmp": OLD, "b.9.tmp": OLD, "fresh.pkl.77.tmp": None, "c.tmp": OLD,
        "d.pkl.12a.tmp": OLD, ".tmp-xyz": OLD, "e.1.tmp.bak": OLD, "f.pkl": OLD,
        "cov_stats_0123.pkl.4242.tmp": OLD,
    }
    for name, mtime in names.items():
        (folder / name).write_bytes(b"x")
        if mtime is not None:
            os.utime(folder / name, (mtime, mtime))
    (folder / "sub").mkdir()
    (folder / "sub" / "g.pkl.5.tmp").write_bytes(b"x")
    os.utime(folder / "sub" / "g.pkl.5.tmp", (OLD, OLD))


@pytest.mark.parametrize("age", [None, "60", "junk", 0.0])
def test_sweep_removes_what_the_jax_sweep_removes(tmp_path, monkeypatch, age):
    if isinstance(age, str):
        monkeypatch.setenv("TIP_TMP_SWEEP_AGE_S", age)
        age = None
    else:
        monkeypatch.delenv("TIP_TMP_SWEEP_AGE_S", raising=False)
    _litter(tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port", copy_function=shutil.copy2)
    want = jax_io.sweep_orphan_tmp(str(tmp_path / "jax"), age)
    got = artifacts_io.sweep_orphan_tmp(str(tmp_path / "port"), age)
    assert got == want > 0
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert os.listdir(tmp_path / "port" / "sub") == ["g.pkl.5.tmp"]


def test_sweep_of_a_missing_directory_is_zero(tmp_path):
    assert artifacts_io.sweep_orphan_tmp(str(tmp_path / "none")) == 0


def test_atomic_write_leaves_no_tmp(tmp_path):
    path = tmp_path / "entry.pkl"
    artifacts_io.atomic_write_bytes(str(path), b"one")
    artifacts_io.atomic_write_bytes(str(path), b"two")
    assert path.read_bytes() == b"two" and os.listdir(tmp_path) == ["entry.pkl"]


def test_a_failed_write_keeps_the_old_file(tmp_path, monkeypatch):
    path = tmp_path / "entry.pkl"
    path.write_bytes(b"old")
    seen = []

    def failing(src, dst):
        seen.append(src)
        raise OSError("disk gone")

    monkeypatch.setattr(os, "replace", failing)
    with pytest.raises(OSError, match="disk gone"):
        artifacts_io.atomic_write_bytes(str(path), b"new")
    assert seen == [f"{path}.{os.getpid()}.tmp"]
    assert path.read_bytes() == b"old" and os.listdir(tmp_path) == ["entry.pkl"]


def test_time_records_are_written_atomically(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    written = []
    write = artifacts_io.atomic_write_bytes

    def recording(path, data):
        written.append(path)
        write(path, data)

    monkeypatch.setattr(eval_prioritization, "atomic_write_bytes", recording)
    eval_prioritization._persist_times("mnist", "ood", 3, "dsa", [1.0, 2.0, 3.0, 4.0])
    path = tmp_path / "times" / "mnist_ood_3_dsa"
    assert written == [str(path)] and os.listdir(tmp_path / "times") == ["mnist_ood_3_dsa"]
    assert pickle.loads(path.read_bytes()) == [1.0, 2.0, 3.0, 4.0]
