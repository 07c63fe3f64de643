"""The tensor-core arithmetic of kernels B5 and B6 (the flash-attention
backward), emulated in plain torch on the CPU.

The kernels in ``csrc/flash_attention_bwd.cu`` compute every product in
3xTF32 on the tensor cores: each float32 operand split into TF32 high and
low parts, three products (lo.hi + hi.lo + hi.hi), each 8-deep k-step
summed from zero and added to the running float32 sum. B5 owns 16-query
tiles and streams keys in 8-key n-tiles; B6 owns 16-key tiles, computes
the scores transposed (``k q^T``, ``v dO^T``) and streams queries. Both pad
the own side to 16 rows and the streamed side to 8 (T=100: 112 x 104
pairs) and the head dim to the kernel's padded width, with zeros. The
emulation repeats those steps, with TF32 rounding by truncation and to
nearest, and holds dq, dk and dv to ``chip_smoke.py``'s card check
(``_bwd_close``: atol min(1e-5, 1e-4 max |want|) + rtol 1e-4) against the
plain versions, and to the JAX package's Pallas backward in interpret mode
at the port's plain-vs-Pallas bound (rtol 1e-4, atol 1e-5); one TF32
product without the low parts fails the card check. The kernels are held
against the plain versions on the card in ``test_torch_kernels_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu.ops.flash_attention import flash_attention as pallas_flash_attention
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [((4, 100, 2, 32), 100), ((2, 300, 2, 8), 300), ((1, 70, 1, 128), 129)]
LOG2E = 1.4426950408889634


def _tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits): by clearing the low 13
    mantissa bits, or to nearest with ties away from zero (``cvt.rna``)."""
    bits = x.view(torch.int32)
    if rounding == "nearest":
        bits = bits + 0x1000  # half of the dropped bits' weight, carried by magnitude
    return (bits & ~0x1FFF).view(torch.float32)


def _mm_tc(a: torch.Tensor, b: torch.Tensor, rounding: str, parts: int = 3) -> torch.Tensor:
    """``a @ b`` as the kernels compute it: per 8-deep k-step, lo.hi + hi.lo
    + hi.hi of the TF32 parts (``parts=1``: hi.hi alone) summed from zero,
    then added to the float32 sum. The k extent is a multiple of 8."""
    a_hi, b_hi = _tf32(a, rounding), _tf32(b, rounding)
    a_lo, b_lo = _tf32(a - a_hi, rounding), _tf32(b - b_hi, rounding)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        part = a_hi[..., ks] @ b_hi[..., ks, :]
        if parts == 3:
            part = a_lo[..., ks] @ b_hi[..., ks, :] + a_hi[..., ks] @ b_lo[..., ks, :] + part
        acc = acc + part
    return acc


def _padded(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Folded ``[G, T, dh]`` zero-padded to ``[G, rows, cols]``."""
    return torch.nn.functional.pad(x, (0, cols - x.shape[2], 0, rows - x.shape[1]))


def _widths(t_own: int, t_streamed: int, dh: int):
    """(own rows, streamed rows, head dim) as the kernels pad them: 16-row
    m-tiles, 8-row n-tiles, dh to 8, 16, 32, 64 or 128."""
    return -(-t_own // 16) * 16, -(-t_streamed // 8) * 8, max(8, 1 << math.ceil(math.log2(dh)))


def _p(s, lse2, scale: float, valid):
    """exp2(s * scale * log2 e - lse * log2 e), one rounding as the kernel's
    fmaf, 0 where ``valid`` is False."""
    scale2 = float(torch.tensor(scale) * torch.tensor(LOG2E))  # a float32 product, as in C
    exponent = (s.double() * scale2 - lse2.double()).float()
    return torch.where(valid, torch.exp2(exponent), torch.zeros(()))


def emulate_dq(q, k, v, dout, lse, dvec, rounding: str, parts: int = 3):
    """B5 on the tensor cores: scores in the accumulator layout with
    queries as rows, ds built there, dq = scale * ds k over 8-key k-steps."""
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    own, streamed, dhp = _widths(t_q, t_kv, dh)
    scale = fa._scale(dh)
    qf, dof = (_padded(fa._fold(x), own, dhp) for x in (q, dout))
    kf, vf = (_padded(fa._fold(x), streamed, dhp) for x in (k, v))
    lse2 = _padded(lse.reshape(b * h, t_q, 1) * torch.tensor(LOG2E, dtype=torch.float32), own, 1)
    dd = _padded(dvec.reshape(b * h, t_q, 1), own, 1)
    s = _mm_tc(qf, kf.transpose(1, 2), rounding, parts)
    dp = _mm_tc(dof, vf.transpose(1, 2), rounding, parts)
    valid = (torch.arange(own)[:, None] < t_q) & (torch.arange(streamed)[None, :] < t_kv)
    ds = _p(s, lse2, scale, valid) * (dp - dd)
    dq = _mm_tc(ds, kf, rounding, parts) * scale
    return fa._unfold(dq[:, :t_q, :dh], b, h), s.shape[1:]


def emulate_dkv(q, k, v, dout, lse, dvec, rounding: str, parts: int = 3):
    """B6 on the tensor cores: the scores transposed (k q^T, v dO^T), so
    p^T and ds^T have keys as rows and lse and D are read per column; then
    dv = p^T dO and dk = scale * ds^T q over 8-query k-steps."""
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    own, streamed, dhp = _widths(t_kv, t_q, dh)
    scale = fa._scale(dh)
    kf, vf = (_padded(fa._fold(x), own, dhp) for x in (k, v))
    qf, dof = (_padded(fa._fold(x), streamed, dhp) for x in (q, dout))
    lse2 = _padded(lse.reshape(b * h, 1, t_q) * torch.tensor(LOG2E, dtype=torch.float32), 1,
                   streamed)
    dd = _padded(dvec.reshape(b * h, 1, t_q), 1, streamed)
    s_t = _mm_tc(kf, qf.transpose(1, 2), rounding, parts)
    dp_t = _mm_tc(vf, dof.transpose(1, 2), rounding, parts)
    p_t = _p(s_t, lse2, scale, (torch.arange(streamed) < t_q)[None, :])
    dv = _mm_tc(p_t, dof, rounding, parts)
    dk = _mm_tc(p_t * (dp_t - dd), qf, rounding, parts) * scale
    return (fa._unfold(dk[:, :t_kv, :dh], b, h), fa._unfold(dv[:, :t_kv, :dh], b, h),
            s_t.shape[1:])


def _case(shape, t_kv: int, seed: int):
    """Seeded q, k, v, dO and the forward's lse and D (plain versions)."""
    rng = np.random.default_rng(seed)
    b, t, h, dh = shape
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((b, t, h, dh), (b, t_kv, h, dh), (b, t_kv, h, dh), (b, t, h, dh))]
    q, k, v, dout = map(torch.from_numpy, arrays)
    out, lse = fa.flash_attention_plain(q, k, v)
    return arrays, (q, k, v, dout, lse, fa.attention_delta(out, dout))


def test_tiles_fit_the_imdb_sequence():
    """At T=100 both kernels compute 112 own rows against 104 streamed rows
    a sequence-head, not the 128 x 128 of 64-row tiles."""
    _, args = _case((1, 100, 2, 32), 100, seed=0)
    _, b5_pairs = emulate_dq(*args, "nearest")
    *_, b6_pairs = emulate_dkv(*args, "nearest")
    assert tuple(b5_pairs) == tuple(b6_pairs) == (112, 104)


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_emulated_kernels_stay_inside_the_card_checks(shape, t_kv, rounding):
    """dq, dk and dv of the emulated 3xTF32 kernels pass the card check
    against the plain versions, at IMDB's [4, 100, 2, 32], a ragged
    [2, 300, 2, 8] and the widest head dim with Tkv = 129."""
    _, args = _case(shape, t_kv, seed=5)
    dq, _ = emulate_dq(*args, rounding)
    dk, dv, _ = emulate_dkv(*args, rounding)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
    chip_smoke._bwd_close(dq, fa.flash_bwd_dq_plain(*args), "emulated dq")
    chip_smoke._bwd_close(dk, want_dk, "emulated dk")
    chip_smoke._bwd_close(dv, want_dv, "emulated dv")


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_emulated_kernels_match_pallas_interpret(shape, t_kv):
    """The emulated kernels against ``jax.vjp`` of the Pallas flash
    attention in interpret mode (its custom VJP runs the Pallas backward)."""
    arrays, args = _case(shape, t_kv, seed=6)
    dq, _ = emulate_dq(*args, "nearest")
    dk, dv, _ = emulate_dkv(*args, "nearest")

    def pallas(q, k, v):
        return pallas_flash_attention(q, k, v, interpret=True)

    _, vjp = jax.vjp(pallas, *(jnp.asarray(x) for x in arrays[:3]))
    want = vjp(jnp.asarray(arrays[3]))
    for got, w in zip((dq, dk, dv), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_one_tf32_product_fails_the_card_checks(shape, t_kv):
    """Without the low parts (one TF32 product, 10 mantissa bits) the
    gradients miss the card check: why the kernels take three products."""
    _, args = _case(shape, t_kv, seed=5)
    dq, _ = emulate_dq(*args, "nearest", parts=1)
    with pytest.raises(AssertionError, match="flash backward"):
        chip_smoke._bwd_close(dq, fa.flash_bwd_dq_plain(*args), "one-product dq")
    dk, _, _ = emulate_dkv(*args, "nearest", parts=1)
    with pytest.raises(AssertionError, match="flash backward"):
        chip_smoke._bwd_close(dk, fa.flash_bwd_dkv_plain(*args)[0], "one-product dk")
