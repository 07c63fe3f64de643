"""Port parity for CAM, bit for bit: the device greedy phase and the host CAM
against the JAX package's ``device_cam_greedy`` and ``cam_order``, ties
included (duplicate rows and equal gains: the lowest index wins)."""

import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import prioritizers as jax_prio
from simple_tip_tpu_torch.ops import prioritizers
from simple_tip_tpu_torch.ops.coverage import packbits
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _profiles(seed: int, n: int = 40, w: int = 70):
    rng = np.random.default_rng(seed)
    prof = rng.random((n, w)) < 0.08
    prof[5] = prof[2]  # duplicate rows: equal gains at every step
    prof[11] = prof[2]
    prof[7] = False  # a row that never adds coverage
    scores = rng.integers(0, 4, size=n).astype(np.int32)  # score ties in the tail
    return scores, prof


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_greedy_matches_jax(seed):
    _, prof = _profiles(seed)
    words = prioritizers.pack_profiles(torch.from_numpy(prof))
    jax_words = jax_prio.pack_profiles(prof)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), jax_words)
    picked_j, count = jax_prio.device_cam_greedy(jax_words, prof.shape[0])
    want = np.asarray(picked_j)[: int(count)]
    for check_every in (1, 4, 32):
        got = prioritizers.device_cam_greedy(words, check_every=check_every).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_full_orders_match_jax_host_cam(seed):
    scores, prof = _profiles(seed)
    want = jax_prio.cam_order(scores, prof)
    np.testing.assert_array_equal(prioritizers.cam_order(scores, prof), want)
    np.testing.assert_array_equal(
        prioritizers.cam_order_device(scores, prioritizers.pack_profiles(torch.from_numpy(prof))),
        want,
    )
    # the engine's path: numpy packbits layout reinterpreted as int32 words
    words = prioritizers.words_from_packbits(packbits(torch.from_numpy(prof)))
    np.testing.assert_array_equal(prioritizers.cam_order_device(scores, words), want)
    assert list(prioritizers.cam(scores, prof)) == want.tolist()


def test_popcount_of_every_bit_pattern_class():
    values = np.array([0, 1, -1, 2**31 - 1, -(2**31), 0x55555555, -0x55555556, 12345], np.int64)
    words = torch.from_numpy(values.astype(np.int32))
    want = [bin(int(v) & 0xFFFFFFFF).count("1") for v in values]
    assert prioritizers.popcount32(words).tolist() == want


def test_score_tail_survives_minus_inf():
    scores = np.array([0.5, -np.inf, 2.0, -np.inf], np.float64)
    order = prioritizers._with_score_tail(scores, np.array([2]))
    np.testing.assert_array_equal(order, jax_prio._with_score_tail(scores, np.array([2])))
    assert sorted(order.tolist()) == [0, 1, 2, 3]
