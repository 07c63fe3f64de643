"""Port parity for the uncertainty quantifiers and the prediction phase.

The four point quantifiers agree with the JAX package's ``ops/uncertainty``
on the same probabilities to atol 1e-6. MC-dropout VR draws its masks from
torch's generator, not jax's, so it is held by its range, by its
distribution over seeds and by the ``[setup, pred, quant, cam]`` record.
"""

import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import uncertainty as jax_uncertainty
from simple_tip_tpu_torch.bridge import params_from_jax
from simple_tip_tpu_torch.engine.model_handler import DROPOUT_SAMPLE_SIZE, BaseModel
from simple_tip_tpu_torch.models import MnistConvNet
from simple_tip_tpu_torch.ops import uncertainty
from test_torch_model import flax_params
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _probs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, size=(64, 10)).astype(np.float32)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    probs[0] = 0.0  # exact zeros: 0 log 0 := 0
    probs[0, 3] = 1.0
    probs[1] = 0.1  # a ten-way tie
    return probs.astype(np.float32)


@pytest.mark.parametrize("name", sorted(uncertainty.POINT_PRED_QUANTIFIERS))
def test_point_quantifiers_match_jax(name):
    probs = _probs(0)
    want_pred, want = jax_uncertainty.POINT_PRED_QUANTIFIERS[name](probs)
    got_pred, got = uncertainty.POINT_PRED_QUANTIFIERS[name](torch.from_numpy(probs))
    np.testing.assert_array_equal(got_pred.numpy(), want_pred)
    assert got.numpy().dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_variation_ratio_matches_jax_on_the_same_samples():
    rng = np.random.default_rng(1)
    sampled = rng.dirichlet(np.ones(10), size=(50, 32)).astype(np.float32)
    want_pred, want_vr = jax_uncertainty.variation_ratio(sampled)
    got_pred, got_vr = uncertainty.variation_ratio(torch.from_numpy(sampled))
    np.testing.assert_array_equal(got_pred.numpy(), want_pred)
    np.testing.assert_allclose(got_vr.numpy(), want_vr, atol=1e-12)


def _data(n: int):
    x = np.random.default_rng(4).uniform(0, 1, size=(n, 28, 28, 1)).astype(np.float32)
    return x


def test_vr_range_distribution_and_time_records():
    model = BaseModel(MnistConvNet(), params_from_jax(flax_params(0)), device="cpu")
    x = _data(24)
    pred, unc, times = model.get_pred_and_uncertainty(x, seed=0)
    assert set(unc) == {"softmax", "pcs", "softmax_entropy", "deep_gini", "VR"}
    assert pred.dtype == np.int64 and pred.shape == (24,)
    for name, record in times.items():
        assert len(record) == 4 and record[0] == 0 and record[3] == 0, name
    vr = unc["VR"]
    assert vr.dtype == np.float64 and vr.shape == (24,)
    # VR = 1 - majority/200 with 10 classes lies in [0, 0.9]
    assert vr.min() >= 0 and vr.max() <= 0.9
    assert np.allclose(vr * DROPOUT_SAMPLE_SIZE, np.round(vr * DROPOUT_SAMPLE_SIZE))
    # same seed, same VR; other seeds: a different draw, a similar distribution
    np.testing.assert_array_equal(model.get_pred_and_uncertainty(x, seed=0)[1]["VR"], vr)
    others = [model.get_pred_and_uncertainty(x, seed=s)[1]["VR"] for s in (1, 2, 3)]
    assert any(not np.array_equal(o, vr) for o in others)
    means = np.array([vr.mean()] + [o.mean() for o in others])
    assert means.max() - means.min() < 0.05
    # every sample's spread over seeds is within the binomial noise of 200 votes
    assert np.abs(np.stack(others) - vr).max() < 0.15
