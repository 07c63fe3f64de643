"""Port parity for neuron coverage, bit for bit.

The 12 configured metrics get identical taps and identical train-set
statistics in both packages; scores (values and dtype) and MSB-first packed
profiles are bit-equal, TKNC's ties included. The device statistics fold
matches the JAX fold to 1e-6 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import coverage as jax_coverage
from simple_tip_tpu.ops.stats import DeviceAggregateStatisticsCollector as JaxStats
from simple_tip_tpu_torch.ops import coverage
from simple_tip_tpu_torch.ops.stats import DeviceAggregateStatisticsCollector
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(6, 6, 4), (3, 3, 4), (2, 2, 8)]


def _taps(n: int, seed: int):
    """Relu-like taps: many exact zeros, values on a coarse grid (ties)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in SHAPES:
        a = np.round(rng.normal(0, 1, size=(n,) + shape) * 4) / 4
        out.append(np.maximum(a, 0).astype(np.float32))
    return out


def _stats(seed: int = 0):
    """(jax stats, port stats) of the same train taps, folded in 3 badges."""
    train = _taps(60, seed)
    jax_stats, port_stats = JaxStats(), DeviceAggregateStatisticsCollector()
    for start in range(0, 60, 25):
        jax_stats.track([jnp.asarray(a[start : start + 25]) for a in train])
        port_stats.track([torch.from_numpy(a[start : start + 25]) for a in train])
    return jax_stats.get(), port_stats.get()


def _configs(mins, maxs, std, lib):
    out = {}
    for s in (0, 0.5, 1):
        out[f"NBC_{s}"] = lib.NBC(mins=mins, maxs=maxs, stds=std, scaler=s)
    for s in (0, 0.5, 1):
        out[f"SNAC_{s}"] = lib.SNAC(maxs=maxs, stds=std, scaler=s)
    out["NAC_0"] = lib.NAC(cov_threshold=0.0)
    out["NAC_0.75"] = lib.NAC(cov_threshold=0.75)
    for k in (1, 2, 3):
        out[f"TKNC_{k}"] = lib.TKNC(top_neurons=k)
    out["KMNC_2"] = lib.KMNC(mins, maxs, sections=2)
    return out


def test_stats_fold_matches_jax():
    (jmin, jmax, jstd), (pmin, pmax, pstd) = _stats()
    for a, b, c, d, e, f in zip(jmin, jmax, jstd, pmin, pmax, pstd):
        np.testing.assert_array_equal(d.numpy(), a)
        np.testing.assert_array_equal(e.numpy(), b)
        assert f.shape == c.shape
        np.testing.assert_allclose(f.numpy(), c, rtol=1e-6, atol=1e-7)


def test_twelve_metrics_bit_equal_scores_and_packed_profiles():
    (jmin, jmax, jstd), _ = _stats()
    # identical statistics on both sides: the port gets the JAX numbers
    pmin, pmax, pstd = ([torch.tensor(np.asarray(a)) for a in s] for s in (jmin, jmax, jstd))
    jax_fn, _ = jax_coverage.make_fused_profile_fn(_configs(jmin, jmax, jstd, jax_coverage))
    port_fn = coverage.make_fused_profile_fn(_configs(pmin, pmax, pstd, coverage))
    test = _taps(40, 1)
    want = jax_fn([jnp.asarray(a) for a in test])
    got = port_fn([torch.from_numpy(a) for a in test])
    assert sorted(got) == sorted(want) and len(got) == 12
    for mid, (s, p) in got.items():
        ws, wp = (np.asarray(v) for v in want[mid])
        assert s.numpy().dtype == ws.dtype, mid
        np.testing.assert_array_equal(s.numpy(), ws, err_msg=mid)
        assert p.numpy().dtype == np.uint8
        np.testing.assert_array_equal(p.numpy(), wp, err_msg=mid)


def test_tknc_ties_go_to_the_higher_index():
    layer = np.array([[1.0, 3.0, 3.0, 0.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2):
        _, got = coverage.TKNC(k)([torch.from_numpy(layer)])
        _, want = jax_coverage.TKNC(k)([jnp.asarray(layer)])
        _, host = jax_coverage.TKNC(k)([layer])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), host)
    assert got[0].tolist() == [False, False, True, False, True]
    assert got[1].tolist() == [False, False, False, True, True]


@pytest.mark.parametrize("width,dtype", [(100, np.int16), (40000, np.int32)])
def test_sum_score_dtype_rule(width, dtype):
    prof = torch.zeros(3, width, dtype=torch.bool)
    prof[0, :7] = True
    s = coverage.sum_score(prof)
    want = jax_coverage.sum_score(prof.numpy())
    assert s.numpy().dtype == dtype == want.dtype
    np.testing.assert_array_equal(s.numpy(), want)


@pytest.mark.parametrize("width", [1, 8, 13, 64])
def test_packbits_is_numpy_layout(width):
    bits = np.random.default_rng(width).random((5, width)) < 0.5
    np.testing.assert_array_equal(
        coverage.packbits(torch.from_numpy(bits)).numpy(), np.packbits(bits, axis=1)
    )
