"""Port parity for kernel B4, the flash-attention forward.

On the CPU the wrapper runs the kernel's plain PyTorch version; it is held
against the JAX package's Pallas kernel in interpret mode
(``flash_attention(..., interpret=True)``) at the shapes that the JAX
package's own flash tests use, rtol 1e-5 and atol 1e-6 (both sum the same
float32 terms, in other orders), and its log-sum-exp against a float64
numpy log-sum-exp. The kernel's 3xTF32 products are emulated here in
torch (each f32 operand split into TF32 high and low parts, three products)
to show that they stay inside the card checks' 1e-5 bounds before any card
time is spent. The CUDA kernel is held against the plain version on the
card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops.flash_attention import flash_attention as pallas_flash_attention
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

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


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits): by clearing the low 13
    mantissa bits, or to nearest with ties away from zero (``cvt.rna``)."""
    bits = x.view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000  # half of the dropped bits' weight, carried by magnitude
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor, rounding: str) -> torch.Tensor:
    """a @ b as hi.hi + hi.lo + lo.hi with TF32 parts and f32 sums."""
    a_hi, b_hi = _tf32(a, rounding), _tf32(b, rounding)
    a_lo, b_lo = _tf32(a - a_hi, rounding), _tf32(b - b_hi, rounding)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _flash_3xtf32(q, k, v, rounding: str):
    """The plain version's steps with both products in 3xTF32."""
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    scale = fa._scale(dh)
    qf, kf, vf = fa._fold(q), fa._pad_keys(fa._fold(k)), fa._pad_keys(fa._fold(v))
    m = torch.full((b * h, t_q), fa.NEG_INF)
    l = torch.zeros(b * h, t_q)
    acc = torch.zeros(b * h, t_q, dh)
    for j0 in range(0, kf.shape[1], fa.BLOCK_KV):
        s = _mm_3xtf32(qf, kf[:, j0 : j0 + fa.BLOCK_KV].transpose(1, 2), rounding) * scale
        col = j0 + torch.arange(fa.BLOCK_KV)
        s = torch.where(col < t_kv, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, :, None])
        l = l * alpha + p.sum(dim=2)
        acc = acc * alpha[:, :, None] + _mm_3xtf32(p, vf[:, j0 : j0 + fa.BLOCK_KV], rounding)
        m = m_new
    return fa._unfold(acc / l[:, :, None], b, h), (m + torch.log(l)).reshape(b, h, t_q)


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("shape,t_kv", [((4, 100, 2, 32), 100), ((2, 300, 2, 8), 300),
                                        ((1, 70, 1, 128), 129)], ids=str)
def test_3xtf32_products_stay_inside_the_card_checks(shape, t_kv, rounding):
    """At IMDB's [4, 100, 2, 32] (and the card tests' ragged and widest
    shapes) the 3xTF32 products keep out and lse within the card checks'
    |got - want| <= 1e-5 + 1e-5 |want| of the plain version; one TF32
    product does not."""
    q, k, v = map(torch.from_numpy, _qkv(shape, t_kv, seed=4))
    want_out, want_lse = fa.flash_attention_plain(q, k, v)
    out, lse = _flash_3xtf32(q, k, v, rounding)
    for got, want in ((out, want_out), (lse, want_lse)):
        assert float(((got - want).abs() - 1e-5 * want.abs()).max()) <= 1e-5
    single = fa._unfold(_tf32(fa._fold(q), rounding) @ _tf32(fa._fold(k), rounding).transpose(1, 2),
                        shape[0], shape[2])
    exact = fa._unfold(fa._fold(q) @ fa._fold(k).transpose(1, 2), shape[0], shape[2])
    assert float((single - exact).abs().max()) > 1e-4  # why one TF32 product is not enough
