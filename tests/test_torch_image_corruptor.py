"""The port's image corruptor (``simple_tip_tpu_torch/data/image_corruptor.py``)
against the JAX package's, on the CPU.

Every kind at every severity on 4 images of 28x28x1 and 32x32x3 (random
pixels with a bright square, so that edges and warps have structure):

- a deterministic kind: the port's ``corrupt_images`` against the JAX
  package's ``corrupt_images``, within atol 1e-5; canny's binary edges by
  counted flips (at most 0.5% of the pixels);
- a random kind: the port's ``apply`` fed the draws that the JAX factory
  makes from ``fold_in(PRNGKey(seed), i)`` and its key splits (Poisson
  counts as the uniform at the middle of their CDF step), against the JAX
  factory on the same image and key, within atol 1e-5.

The port's own draws: its Threefry-2x32 equal to JAX's cipher, subset
independence bit-equal, a new seed changing the output, shape, range and
determinism, severity monotone (as ``tests/test_image_corruptor.py``), and
the moments of the uniform, normal and Poisson draws within stated bounds.
``corrupted_test_set``'s allocation, severities, labels and permutation are
the JAX package's numpy draws, and the two kind registries are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng

from simple_tip_tpu.data import image_corruptor as jax_ic
from simple_tip_tpu_torch.data import image_corruptor as ic
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [(28, 28, 1), (32, 32, 3)]
KINDS = sorted(ic.CORRUPTIONS)
SEED = 3
ATOL = 1e-5
CANNY_FLIP_SHARE = 0.005
SHOT_LAMBDA = (60.0, 25.0, 12.0, 5.0, 3.0)


def _images(shape, n=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n,) + shape).astype(np.float32)
    x[:, 8:16, 8:16] = 0.95
    return x


def _jax_draws(kind, severity, img, key):
    """The random values the JAX factory of ``kind`` draws from ``key``."""
    r = jax.random
    h, w, _ = img.shape
    if kind in ("gaussian_noise", "speckle_noise"):
        return {"z": r.normal(key, img.shape)}
    if kind == "shot_noise":
        return {"counts": r.poisson(key, img * SHOT_LAMBDA[severity - 1])}
    if kind == "impulse_noise":
        return {"r": r.uniform(key, img.shape)}
    if kind == "glass_blur":
        delta = (1, 1, 1, 2, 2)[severity - 1]
        ky, kx = r.split(key)
        return {"dy": r.randint(ky, (h, w), -delta, delta + 1),
                "dx": r.randint(kx, (h, w), -delta, delta + 1)}
    if kind == "motion_blur":
        return {"theta": r.uniform(key, (), minval=0.0, maxval=np.pi)}
    if kind in ("fog", "frost", "spatter"):
        return {"field": r.uniform(key, (h, w, 1))}
    if kind == "snow":
        k1, k2 = r.split(key)
        return {"flakes": r.uniform(k1, (h, w, 1)),
                "theta": r.uniform(k2, (), minval=0.0, maxval=np.pi)}
    if kind == "elastic_transform":
        ky, kx = r.split(key)
        return {"field_y": r.uniform(ky, (h, w, 1)), "field_x": r.uniform(kx, (h, w, 1))}
    if kind in ("rotate", "shear"):
        return {"sign": r.bernoulli(key)}
    if kind == "translate":
        return {"theta": r.uniform(key, (), maxval=2 * np.pi)}
    if kind == "stripe":
        band = min((2, 3, 4, 5, 6)[severity - 1], max(1, h // 4))
        return {"top": r.randint(key, (), h // 4, max(h // 4 + 1, 3 * h // 4 - band))}
    if kind == "dotted_line":
        out = {}
        for i in range((1, 1, 2, 2, 3)[severity - 1]):
            ka, kb = r.split(r.fold_in(key, i))
            out[f"theta_{i}"] = r.uniform(ka, (), maxval=np.pi)
            out[f"offset_{i}"] = r.uniform(kb, (), minval=-h / 4.0, maxval=h / 4.0)
        return out
    if kind == "zigzag":
        return {"phase": r.uniform(key, (), maxval=2.0)}
    raise AssertionError(kind)


def _uniform_for_counts(counts, rate):
    """The uniform at the middle of each count's CDF step, so that the
    port's inversion returns exactly JAX's Poisson counts."""
    pmf = np.exp(-rate)
    cdf = pmf.copy()
    lo = np.zeros_like(cdf)
    hi = np.where(counts == 0, cdf, np.nan)
    for j in range(1, 200):
        pmf = pmf * rate / j
        lo = np.where(counts == j, cdf, lo)
        cdf = cdf + pmf
        hi = np.where(counts == j, cdf, hi)
    return (lo + hi) / 2


def _port_draws(kind, severity, x, jd):
    out = {}
    for name, v in jd.items():
        v = np.array(v)  # a writable copy of the JAX array
        if name == "counts":
            rate = (x * np.float32(SHOT_LAMBDA[severity - 1])).astype(np.float64)
            out["u"] = torch.from_numpy(_uniform_for_counts(v, rate))
        elif v.dtype == bool:
            out[name] = torch.from_numpy(v)
        elif v.dtype.kind in "iu":
            out[name] = torch.from_numpy(v.astype(np.int64))
        else:
            out[name] = torch.from_numpy(v.astype(np.float32))
    return out


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("severity", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("kind", KINDS)
def test_kind_matches_jax(kind, severity, shape):
    x = _images(shape)
    if not ic.draw_plan(kind, severity, shape):
        want = jax_ic.corrupt_images(x, kind, severity=severity, seed=SEED)
        got = ic.corrupt_images(x, kind, severity=severity, seed=SEED, device="cpu")
    else:
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(SEED), i))(
            jnp.arange(len(x)))
        xj = jnp.asarray(x)
        want = np.asarray(jax.vmap(jax_ic.CORRUPTIONS[kind](severity))(xj, keys))
        jd = jax.vmap(lambda img, k: _jax_draws(kind, severity, img, k))(xj, keys)
        draws = _port_draws(kind, severity, x, jd)
        assert set(draws) == {name for name, *_ in ic.draw_plan(kind, severity, shape)}
        got = ic.apply(kind, severity, torch.from_numpy(x), draws).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if kind == "canny_edges":
        assert set(np.unique(got)) <= {0.0, 1.0}
        assert (got != want).mean() <= CANNY_FLIP_SHARE
    else:
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_shot_noise_counts_are_jax_counts():
    """The port's Poisson inversion gives back JAX's counts from the
    uniforms that ``_uniform_for_counts`` picks (the premise above)."""
    x = _images((28, 28, 1))
    for severity in (1, 5):
        rate = x * np.float32(SHOT_LAMBDA[severity - 1])
        counts = np.asarray(jax.random.poisson(jax.random.PRNGKey(0), rate))
        u = torch.from_numpy(_uniform_for_counts(counts, rate.astype(np.float64)))
        got = ic.apply("shot_noise", severity, torch.from_numpy(x), {"u": u}).numpy()
        want = np.clip(counts.astype(np.float32) / SHOT_LAMBDA[severity - 1], 0, 1)
        np.testing.assert_array_equal(got, want)


def test_threefry_is_jax_cipher():
    rng = np.random.default_rng(1)
    x0, x1 = rng.integers(0, 2 ** 32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    for k0, k1 in ((0, 0), (42, 0), (0xDEADBEEF, 0x12345678)):
        want = prng.threefry2x32_p.bind(jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0),
                                        jnp.asarray(x1))
        got = ic.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                              torch.from_numpy(x1.astype(np.int64)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("kind", KINDS)
def test_shape_range_determinism_and_subset(kind):
    x = _images((32, 32, 3), n=6)
    full = ic.corrupt_images(x, kind, severity=3, seed=7, device="cpu")
    again = ic.corrupt_images(x, kind, severity=3, seed=7, device="cpu", chunk=4)
    assert full.shape == x.shape and full.dtype == np.float32
    assert full.min() >= 0.0 and full.max() <= 1.0
    np.testing.assert_array_equal(full, again)
    sub = ic.corrupt_images(x[[4, 1]], kind, severity=3, seed=7, global_indices=[4, 1],
                            device="cpu")
    np.testing.assert_array_equal(sub, full[[4, 1]])
    assert np.abs(full - x).mean() > 1e-4, f"{kind} left the images untouched"
    if ic.draw_plan(kind, 3, x.shape[1:]):
        other = ic.corrupt_images(x, kind, severity=3, seed=8, device="cpu")
        assert np.abs(other - full).max() > 1e-4, f"{kind} ignores the seed"


@pytest.mark.parametrize(
    "kind", ["gaussian_noise", "impulse_noise", "brightness", "contrast", "rotate"]
)
def test_severity_monotone(kind):
    x = _images((16, 16, 1), n=16)
    d = [np.abs(ic.corrupt_images(x, kind, severity=s, seed=1, device="cpu") - x).mean()
         for s in (1, 3, 5)]
    assert d[0] < d[1] < d[2], d


def test_draw_moments():
    """The draws' distributions over 200 images x 28x28: uniform mean 1/2
    and variance 1/12 within 1%, normal mean 0 within 0.01 and variance 1
    within 1%, Poisson(lambda) mean and variance within 2% of lambda, a
    Bernoulli(1/2) share within 0.1, integers spanning their range."""
    idx = np.arange(200)
    shape = (28, 28, 1)
    u = ic.draw("impulse_noise", 1, 0, idx, shape, "cpu")["r"].numpy().astype(np.float64)
    assert abs(u.mean() - 0.5) < 0.005 and abs(u.var() - 1 / 12) < 1 / 1200
    assert u.min() >= 0 and u.max() < 1
    z = ic.draw("gaussian_noise", 1, 0, idx, shape, "cpu")["z"].numpy().astype(np.float64)
    assert abs(z.mean()) < 0.01 and abs(z.var() - 1) < 0.01
    u64 = ic.draw("shot_noise", 1, 0, idx, shape, "cpu")["u"]
    assert u64.dtype == torch.float64
    for lam in (3.0, 60.0):
        k = ic.poisson_counts(u64, torch.full(u64.shape, lam)).numpy()
        assert abs(k.mean() - lam) < 0.02 * lam and abs(k.var() - lam) < 0.02 * lam
    sign = ic.draw("rotate", 1, 0, np.arange(2000), shape, "cpu")["sign"].numpy()
    assert abs(sign.mean() - 0.5) < 0.1
    dy = ic.draw("glass_blur", 5, 0, idx, shape, "cpu")["dy"].numpy()
    assert set(np.unique(dy)) == {-2, -1, 0, 1, 2}


@pytest.mark.parametrize("kinds", [ic.MNIST_C_KINDS, ic.CIFAR10_C_KINDS,
                                   ("gaussian_noise", "brightness", "stripe")])
def test_corrupted_test_set_draws_are_jax_draws(kinds, monkeypatch):
    """Allocation, severity groups, labels and permutation equal the JAX
    package's: both packages' corruption calls are replaced by one that
    records (kind, severity, source indices) and tags each image with its
    source index, and the two tagged sets are equal."""
    x = _images((28, 28, 1), n=40)
    y = np.arange(40) % 10
    calls = {"jax": [], "port": []}

    def jax_fake(x_, kind, severity=3, seed=0, global_indices=None):
        calls["jax"].append((kind, int(severity), list(global_indices)))
        return np.zeros_like(x_) + np.asarray(global_indices).reshape(-1, 1, 1, 1) / 100.0

    def port_fake(x_, kind, severity, seed, global_indices):
        calls["port"].append((kind, int(severity), global_indices.tolist()))
        return torch.zeros_like(x_) + global_indices.view(-1, 1, 1, 1).to(x_) / 100.0

    monkeypatch.setattr(jax_ic, "corrupt_images", jax_fake)
    monkeypatch.setattr(ic, "corrupt", port_fake)
    want_x, want_y = jax_ic.corrupted_test_set(x, y, kinds, total=30, seed=5)
    got_x, got_y = ic.corrupted_test_set(x, y, kinds, total=30, seed=5, device="cpu")
    assert calls["port"] == calls["jax"]
    np.testing.assert_array_equal(got_y, want_y)
    np.testing.assert_array_equal(got_x, want_x)


def test_corrupted_test_set_corrupts_each_row():
    """Each row of a real run is its source image corrupted as
    ``corrupt_images`` does at the same global index."""
    x = _images((28, 28, 1), n=12)
    y = np.arange(12)
    got_x, got_y = ic.corrupted_test_set(x, y, ("brightness", "stripe"), total=8, seed=2,
                                         device="cpu")
    rng = np.random.default_rng(2)
    parts = []
    for kind, idx in zip(("brightness", "stripe"), ic._allocate(rng, 12, 8, 2)):
        sevs = rng.integers(1, 6, size=len(idx))
        parts += [ic.corrupt_images(x[[i]], kind, int(s), seed=2, global_indices=[i],
                                    device="cpu")[0] for i, s in zip(idx, sevs)]
    perm = rng.permutation(8)
    np.testing.assert_array_equal(got_x, np.stack(parts)[perm])
    np.testing.assert_array_equal(got_y, got_y.astype(np.int64))


def test_kind_registries_equal_jax():
    assert ic.MNIST_C_KINDS == jax_ic.MNIST_C_KINDS
    assert ic.CIFAR10_C_KINDS == jax_ic.CIFAR10_C_KINDS
    assert sorted(ic.CORRUPTIONS) == sorted(jax_ic.CORRUPTIONS)
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(ic._allocate(rng_a, 100, 1000, 15), jax_ic._allocate(rng_b, 100, 1000, 15)):
        np.testing.assert_array_equal(a, b)


def test_bad_kind_and_severity_raise():
    x = _images((16, 16, 1), n=1)
    with pytest.raises(ValueError):
        ic.corrupt_images(x, "no_such_kind", device="cpu")
    with pytest.raises(ValueError):
        ic.corrupt_images(x, "fog", severity=6, device="cpu")
