"""Port parity for kernel B2 (DSA's masked nearest neighbour) and for DSA.

On the CPU the port's DSA runs the kernel's plain version; it is held
against the JAX package's ``DSA`` on its XLA path (``use_pallas=False``)
and against ``PallasDSABackend.score(..., interpret=True)`` with CHUNK and
TILE shrunk so that several tiles accumulate, at rtol 1e-4, including
classes that the 30% training subsample misses (DSA = inf there on both
sides). The CUDA kernel is held against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import dsa_pallas
from simple_tip_tpu.ops.surprise import DSA as JaxDSA
from simple_tip_tpu_torch.ops import dsa_cuda
from simple_tip_tpu_torch.ops.surprise import DSA, subsample_indices


def _data(seed: int = 0):
    rng = np.random.RandomState(seed)
    acts = rng.random((384, 32)).astype(np.float32)
    labels = rng.randint(0, 4, size=384)
    kept = subsample_indices(0.3, 384, 0)
    missed = np.setdiff1d(np.arange(384), kept)[:2]
    labels[missed] = 4  # a class that the 30% subsample misses
    test = rng.random((200, 32)).astype(np.float32)
    tlabels = rng.randint(0, 5, size=200)
    return acts, labels, test, tlabels


@pytest.mark.parametrize("subsampling", [1.0, 0.3])
def test_plain_dsa_matches_jax_xla_path(subsampling):
    acts, labels, test, tlabels = _data()
    ref = JaxDSA(acts, labels, subsampling=subsampling)
    ref.use_pallas = False
    want = ref(test, tlabels)
    got = DSA(torch.from_numpy(acts), labels, subsampling=subsampling)(
        torch.from_numpy(test), tlabels
    )
    assert got.dtype == np.float64 == want.dtype
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if subsampling < 1:
        kept = labels[subsample_indices(subsampling, len(labels), 0)]
        assert 4 not in kept and np.isinf(got[tlabels == 4]).all()


def test_plain_dsa_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(dsa_pallas, "CHUNK", 128)
    monkeypatch.setattr(dsa_pallas, "TILE", 128)
    acts, labels, test, tlabels = _data(1)
    ref = JaxDSA(acts, labels, subsampling=0.3)
    backend = dsa_pallas.PallasDSABackend(ref.train_activations, ref.train_predictions)
    want = backend.score(test, tlabels, interpret=True)
    port = DSA(torch.from_numpy(acts), labels, subsampling=0.3)
    np.testing.assert_array_equal(port.rows.numpy(), ref.train_activations - port.mean.numpy())
    got = port(torch.from_numpy(test), tlabels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_plain_nearest_ties_and_masked_rows():
    train = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [5.0, 5.0]])
    train_sq = (train * train).sum(1)
    train_labels = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    x = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    labels = torch.tensor([0, 7], dtype=torch.int32)
    d2, idx = dsa_cuda.masked_nearest(x, labels, train, train_sq, train_labels, True)
    assert idx.dtype == torch.int32
    assert idx.tolist() == [0, 0]  # tie between rows 0 and 2 -> 0; all masked -> 0
    assert d2[0].item() == 0.0 and torch.isinf(d2[1])
    d2, idx = dsa_cuda.masked_nearest(x, labels, train, train_sq, train_labels, False)
    assert idx.tolist() == [3, 0]



def test_centred_searches_stay_accurate_far_from_the_origin():
    """Traces with a large common offset: the port centres them before the
    float32 d^2 expansion, so DSA agrees with a float64 DSA to rtol 1e-5
    (the uncentred expansion cancels to ~1e-2 here)."""
    rng = np.random.default_rng(3)
    offset = rng.uniform(5, 10, size=20)
    acts = (offset + rng.normal(0, 0.05, size=(300, 20))).astype(np.float32)
    labels = rng.integers(0, 3, size=300)
    test = (offset + rng.normal(0, 0.05, size=(80, 20))).astype(np.float32)
    tlabels = rng.integers(0, 3, size=80)
    got = DSA(torch.from_numpy(acts), labels, badge_size=16)(torch.from_numpy(test), tlabels)
    train, x = acts.astype(np.float64), test.astype(np.float64)
    d2 = ((x[:, None] - train[None]) ** 2).sum(-1)
    same = tlabels[:, None] == labels[None]
    nearest = np.where(same, d2, np.inf).argmin(1)
    a = np.sqrt(np.where(same, d2, np.inf).min(1))
    d2b = ((train[nearest][:, None] - train[None]) ** 2).sum(-1)
    b = np.sqrt(np.where(~same, d2b, np.inf).min(1))
    np.testing.assert_allclose(got, a / b, rtol=1e-5, atol=0)


def test_distances_are_exact_where_the_classes_lie_far_apart():
    """Classes far apart relative to their spread, as in a trained model's
    traces: centring leaves |x|^2 / d^2 near 500, where the float32
    expansion alone is off the float64 DSA by ~1e-4. The port recomputes
    the chosen rows' distances as |x - t|, so DSA agrees with a float64
    DSA to rtol 1e-5 wherever the nearest row is not a near tie (best and
    second best more than 1e-4 apart); at a near tie either row is
    nearest within float32 rounding."""
    rng = np.random.default_rng(5)
    centres = rng.normal(0, 3, size=(4, 64))
    labels = rng.integers(0, 4, size=400)
    acts = (centres[labels] + rng.normal(0, 0.1, size=(400, 64))).astype(np.float32)
    tlabels = rng.integers(0, 4, size=200)
    test = (centres[tlabels] + rng.normal(0, 0.1, size=(200, 64))).astype(np.float32)
    got = DSA(torch.from_numpy(acts), labels)(torch.from_numpy(test), tlabels)
    train, x = acts.astype(np.float64), test.astype(np.float64)
    same = tlabels[:, None] == labels[None]
    d = np.sqrt(np.where(same, ((x[:, None] - train[None]) ** 2).sum(-1), np.inf))
    nearest = d.argmin(1)
    a = d.min(1)
    db = np.sqrt(((train[nearest][:, None] - train[None]) ** 2).sum(-1))
    b = np.where(~same, db, np.inf).min(1)
    ranked = np.sort(d, axis=1)
    clear = (ranked[:, 1] - ranked[:, 0]) > 1e-4 * ranked[:, 0]
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[clear], (a / b)[clear], rtol=1e-5, atol=0)
