"""Port parity for kernel B4, the flash-attention forward.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX package's Pallas kernel in interpret mode
(``flash_attention(..., interpret=True)``) at the shapes that the JAX
package's own flash tests use, rtol 1e-5 and atol 1e-6 (both sum the same
float32 terms, in other orders), and its log-sum-exp against a float64
numpy log-sum-exp. The CUDA kernel is held against the plain version on
the card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops.flash_attention import flash_attention as pallas_flash_attention
from simple_tip_tpu_torch.ops import flash_attention as fa

SHAPES = [
    ((2, 128, 4, 16), 128),  # exact block multiple
    ((1, 100, 2, 32), 100),  # the IMDB sequence length and heads
    ((2, 300, 2, 8), 300),  # several key tiles with a ragged last one
    ((1, 17, 1, 4), 17),  # shorter than one tile
    ((1, 40, 2, 8), 200),  # keys longer than queries (cross-attention)
]


def _qkv(shape, t_kv: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    b, t, h, dh = shape
    q = rng.normal(size=(b, t, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t_kv, h, dh)).astype(np.float32)
    v = rng.normal(size=(b, t_kv, h, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=lambda s: str(s))
def test_plain_matches_pallas_interpret(shape, t_kv):
    q, k, v = _qkv(shape, t_kv)
    before = fa.LAUNCHES
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    assert fa.LAUNCHES == before, "a CPU tensor must not launch the kernel"
    want = pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True)
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=lambda s: str(s))
def test_lse_matches_numpy_logsumexp(shape, t_kv):
    q, k, v = _qkv(shape, t_kv, seed=1)
    _, lse = fa.flash_attention_fwd(*map(torch.from_numpy, (q, k, v)))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s /= np.sqrt(shape[-1])
    peak = s.max(axis=-1, keepdims=True)
    want = (peak + np.log(np.exp(s - peak).sum(axis=-1, keepdims=True)))[..., 0]
    assert tuple(lse.shape) == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)


def test_tile_size_does_not_change_the_function(monkeypatch):
    q, k, v = map(torch.from_numpy, _qkv((2, 33, 2, 8), 150, seed=2))
    out64, lse64 = fa.flash_attention_plain(q, k, v)
    monkeypatch.setattr(fa, "BLOCK_KV", 16)
    out16, lse16 = fa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out16, out64, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse16, lse64, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 4, 2, 4), torch.zeros(1, 4, 2, 4))
    with pytest.raises(ValueError):
        fa.flash_attention(q, torch.zeros(1, 0, 2, 8), torch.zeros(1, 0, 2, 8))
