"""The full-width pc-mlsa read of ``chip_smoke.py`` (phase 8) with its CPU
side in a child process (``CpuReference``, ``--cpu-ref``).

On the CPU, with a narrow tap (MNIST's tap 6) and seeded weights: the
child's fit on the saved traces gives the in-process fit's components and
``reg_covar`` rungs and scores within 1e-5 of them (other thread counts
sum in other orders), the APFD of both SC-CAM orders equal, and no child
is left running; the read raises when the APFD gate is breached, and when
the child fails (here: a thread count torch refuses).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu_torch import bridge
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.models import MnistConvNet
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _read(tmp_path):
    rng = np.random.default_rng(3)
    params = params_from_jax(bridge.glorot_params(2, "mnist"))
    cpu = torch.device("cpu")
    model = BaseModel(MnistConvNet(), params, [6], include_last_layer=True, batch_size=256,
                      device=cpu)
    x_tr = rng.random((300, 28, 28), dtype=np.float32)[..., None]
    x_nom = rng.random((120, 28, 28), dtype=np.float32)[..., None]
    y_nom = rng.integers(0, 10, 120)
    train = model.get_activations(x_tr)
    train_ats = torch.cat([t.reshape(t.shape[0], -1) for t in train[:-1]], dim=1).cpu()
    train_pred = train[-1].argmax(1).cpu().numpy()
    return chip_smoke.MlsaFullWidth("mnist", model, train_ats, train_pred, x_nom, y_nom, cpu,
                                    str(tmp_path))


def test_child_fit_matches_the_in_process_fit(tmp_path):
    read = _read(tmp_path)
    report = read.finish()
    assert read.proc.poll() == 0 and read.proc in chip_smoke.CHILDREN
    assert report["components_reg_covar"]["card"] == report["components_reg_covar"]["cpu"]
    assert report["max_rel_err"] <= 1e-5 and report["apfd_card"] == report["apfd_cpu"]
    assert report["rows"][0] > 0 and report["features"] > 0


def test_read_raises_on_a_breach_and_on_a_failed_child(tmp_path, monkeypatch):
    (tmp_path / "gap").mkdir()
    read = _read(tmp_path / "gap")
    monkeypatch.setattr(chip_smoke, "MLSA_APFD_GAP", -1.0)
    with pytest.raises(AssertionError, match="pc-mlsa at full width: APFD"):
        read.finish()
    (tmp_path / "bad").mkdir()
    monkeypatch.setattr(chip_smoke, "MLSA_CPU_THREADS", 0)
    broken = _read(tmp_path / "bad")
    with pytest.raises(AssertionError,
                       match="pc-mlsa CPU fit, mnist: CPU reference mlsa_full_width exited 1"):
        broken.finish()
