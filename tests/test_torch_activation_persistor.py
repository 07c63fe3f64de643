"""The ``at_collection`` dump of the port against the JAX package's
``activation_persistor.persist`` on one mini model, on the CPU: the same
files (every tap of ``all_layers`` and the labels, in badges of 100, the
last one ragged), the same dtypes and shapes, values within 1e-5."""

import os

import numpy as np
import pytest

from simple_tip_tpu.engine import activation_persistor as jax_persistor
from simple_tip_tpu.models import MnistConvNet as FlaxMnistConvNet
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.casestudies.base import CaseStudy
from simple_tip_tpu_torch.casestudies.mini import MINI_CASE_STUDIES
from simple_tip_tpu_torch.engine import activation_persistor
from simple_tip_tpu_torch.models import MnistConvNet
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(os.path.join(root, "activations")):
        for name in names:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = np.load(path)
    return out


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' dumps of mini-mnist's model 4 on 130 / 40 / 80 rows."""
    (x_train, y_train), (x_test, y_test), (ood_x, ood_y) = MINI_CASE_STUDIES["mini-mnist"].loader()
    sets = dict(train_set=(x_train[:130], y_train[:130]), test_nominal=(x_test[:40], y_test[:40]),
                test_corrupted=(ood_x[:80], ood_y[:80]))
    params = flax_params(4)
    tmp = tmp_path_factory.mktemp("activations")
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "jax"))
        jax_persistor.persist(FlaxMnistConvNet(), params, "mini-mnist", 4, **sets)
        monkeypatch.setenv("TIP_ASSETS", str(tmp / "torch"))
        activation_persistor.persist(MnistConvNet(), params_from_jax(params), "mini-mnist", 4,
                                     device="cpu", **sets)
    return _files(str(tmp / "torch")), _files(str(tmp / "jax"))


def test_the_dump_has_the_jax_files(dumps):
    got, want = dumps
    assert sorted(got) == sorted(want)
    # 7 taps + labels, badges 2 / 1 / 1
    assert len(got) == 8 * (2 + 1 + 1)
    assert "activations/mini-mnist/model_4/train/layer_6/badge_1.npy" in got
    assert got["activations/mini-mnist/model_4/train/labels/badge_1.npy"].shape == (30,)


def test_the_dump_holds_the_jax_values(dumps):
    got, want = dumps
    for name, b in want.items():
        a = got[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name.split(os.sep)[-2] == "labels":
            assert a.tobytes() == b.tobytes(), name
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


def test_collect_activations_dumps_every_run(tmp_path, monkeypatch):
    monkeypatch.setenv("TIP_ASSETS", str(tmp_path))
    cs = CaseStudy(MINI_CASE_STUDIES["mini-mnist"])
    cs.save_params(1, flax_params(1))
    cs.collect_activations([1], device="cpu")
    folder = tmp_path / "activations" / "mini-mnist" / "model_1"
    # 600 / 300 / 600 rows of mini-mnist in badges of 100
    for ds, badges in (("train", 6), ("test_nominal", 3), ("test_nominal_and_corrupted", 6)):
        for sub in [f"layer_{i}" for i in range(7)] + ["labels"]:
            assert len(os.listdir(folder / ds / sub)) == badges, (ds, sub)
    probs = np.load(folder / "test_nominal" / "layer_6" / "badge_2.npy")
    assert probs.shape == (100, 10) and np.allclose(probs.sum(axis=1), 1, atol=1e-5)
