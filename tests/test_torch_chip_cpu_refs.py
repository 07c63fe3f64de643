"""The CPU sides of ``chip_smoke.py``'s card-against-CPU checks that run in
child processes (``CpuReference``, ``--cpu-ref``): phase 8's four small SA
variants (``compare_sa_small`` / ``SaSmall``) and phase 10's selections
(``start_al_selections_cpu`` / ``compare_al_selections``).

On the CPU, with seeded weights and a few hundred seeded rows: the child's
output equals the same computation in this process on the child's thread
count (``CPU_REF_THREADS``), byte for byte (but for the selections of
pc-mdsa and pc-mmdsa on fewer rows than features, which are noise in any
two processes); ``finish()`` passes on it and ``compare_al_selections``
gates a CPU side equal to its own; a breached gate and a failed child
raise; no child is left running.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch import bridge
from simple_tip_tpu_torch.bridge import params_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture()
def child_threads():
    """This process on the children's thread count while a test computes
    its side, so that CPU reductions sum in the same order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(chip_smoke.CPU_REF_THREADS)
    yield
    torch.set_num_threads(threads)


def _data(seed: int = 3):
    rng = np.random.default_rng(seed)
    x_tr = rng.random((300, 28, 28), dtype=np.float32)[..., None]
    x_nom = rng.random((120, 28, 28), dtype=np.float32)[..., None]
    x_ood = rng.random((120, 28, 28), dtype=np.float32)[..., None]
    return ((x_tr, rng.integers(0, 10, 300)), (x_nom, rng.integers(0, 10, 120)),
            (x_ood, rng.integers(0, 10, 120)))


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


def test_sa_small_child_equals_the_in_process_side(tmp_path, monkeypatch, child_threads):
    monkeypatch.setitem(chip_smoke.PATHS["mnist"], "sa", [6])
    params = params_from_jax(bridge.glorot_params(2, "mnist"))
    pending = chip_smoke.compare_sa_small("mnist", params, _data(), torch.device("cpu"),
                                          str(tmp_path))
    cpu, _ = pending.cpu.result()
    for name in chip_smoke.NEW_SA:
        assert _same(cpu[name][:3], pending.card[name][:3]), name
        assert _same(cpu[name][5], pending.card[name][5]), name
    report = pending.finish()
    assert pending.cpu.proc.poll() == 0 and pending.cpu.proc in chip_smoke.CHILDREN
    assert all(report[name]["max_rel_err"] == 0 for name in chip_smoke.NEW_SA)
    assert "mlsa_full_width" in report


def test_sa_small_raises_on_a_breach_and_on_a_failed_child(tmp_path, monkeypatch):
    monkeypatch.setitem(chip_smoke.PATHS["mnist"], "sa", [6])
    monkeypatch.setattr(chip_smoke, "SA_CHECK", {"mnist": (300, 60, None)})
    params = params_from_jax(bridge.glorot_params(2, "mnist"))
    pending = chip_smoke.compare_sa_small("mnist", params, _data(), torch.device("cpu"),
                                          str(tmp_path))
    monkeypatch.setattr(chip_smoke, "SA_RTOL", -1.0)
    with pytest.raises(AssertionError, match="mnist SA card vs CPU: .*rtol"):
        pending.finish()
    broken = chip_smoke.CpuReference(str(tmp_path / "broken"), "no-such-kind")
    with pytest.raises(AssertionError, match="CPU reference no-such-kind exited 1"):
        broken.result()


class _Finished:
    """A ``CpuReference`` whose output is already known."""

    def __init__(self, out):
        self.out = out

    def result(self):
        return self.out, 0.0


def test_al_selections_child_equals_the_in_process_side(tmp_path, monkeypatch, child_threads):
    """The child builds the same selections (pc-mdsa and pc-mmdsa on 300 rows
    of 1,600 features invert rounding noise in any two processes, so their
    values are only counted), and ``compare_al_selections`` gates a CPU side
    equal to its own with nothing moved."""
    monkeypatch.setattr(chip_smoke, "AL_CHECK", (300, 120, 10))
    tree = bridge.glorot_params(4, "mnist")
    data = _data(5)
    cpu_side = chip_smoke.start_al_selections_cpu(tree, data, str(tmp_path))
    n_train, _, k = chip_smoke.AL_CHECK
    with chip_smoke.caches_off():
        want = chip_smoke.al_selections(params_from_jax(tree), chip_smoke.al_check_datasets(data),
                                        data[0][0][:n_train], k, torch.device("cpu"))
    got, _ = cpu_side.result()
    noisy = ("pc-mdsa", "pc-mmdsa")
    assert got[0].keys() == want[0].keys() and got[3].keys() == want[3].keys()
    for key in want[0]:
        if key[0].replace("-cam", "") not in noisy:
            assert _same(got[0][key], want[0][key]), key
    assert _same(got[1], want[1]) and _same(got[2], want[2])
    for key in want[3]:
        if key[0] not in noisy:
            np.testing.assert_allclose(got[3][key], want[3][key], rtol=1e-5, err_msg=str(key))
    assert got[4] > 0
    report = chip_smoke.compare_al_selections(params_from_jax(tree), data, torch.device("cpu"),
                                              _Finished(want))
    assert report["moved"] == {}
