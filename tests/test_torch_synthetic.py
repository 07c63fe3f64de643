"""The port's copy of the synthetic stand-in generators draws the same
arrays from the same seeds as the JAX package's, at its default hardness."""

import numpy as np
import pytest

from simple_tip_tpu.data import synthetic as jax_synthetic
from simple_tip_tpu_torch.data import synthetic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _default_hardness(monkeypatch):
    monkeypatch.delenv("TIP_SYNTH_HARDNESS", raising=False)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(32, 32, 3), (28, 28, 1)])
def test_images_and_their_corruption_match(shape):
    got = synthetic.image_classification(3, 120, 40, shape)
    want = jax_synthetic.image_classification(3, 120, 40, shape)
    _assert_same([*got[0], *got[1]], [*want[0], *want[1]])
    _assert_same([synthetic.corrupt_images(got[1][0], 4)],
                 [jax_synthetic.corrupt_images(want[1][0], 4)])


def test_tokens_and_their_corruption_match():
    got = synthetic.token_classification(5, 150, 60)
    want = jax_synthetic.token_classification(5, 150, 60)
    _assert_same([*got[0], *got[1]], [*want[0], *want[1]])
    _assert_same([synthetic.corrupt_tokens(got[1][0], 6)],
                 [jax_synthetic.corrupt_tokens(want[1][0], 6)])
