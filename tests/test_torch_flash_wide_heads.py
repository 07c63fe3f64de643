"""Flash attention above head_dim 128: kernels B4, B5 and B6 at wide heads.

The JAX package's flash attention takes any head_dim and tiles only T. On
the CPU the port's wrappers run their plain versions, which take any
head_dim too; they are held here against the Pallas kernels in interpret
mode at dh 160 and 256 and at a ragged Tq 37 / Tkv 53: the forward at the
tolerances of ``test_torch_flash_attention.py`` (rtol 1e-5, atol 1e-6), the
plain backward and ``FlashAttention``'s gradients at those of
``test_torch_flash_backward.py`` (rtol 1e-4 / atol 1e-5 against
``jax.vjp`` of the Pallas kernel; rtol 2e-4 / atol 2e-5 for the
Function).

On the card, dh > 128 takes the kernels' wide-head variants
(``csrc/flash_attention_wide.cu``): a block owns 64 rows and one 128-wide
slice of the output columns, the score products contract over the whole
head dim in 32-column chunks from shared memory, and the second product
runs on the slice's columns; keys stream in blocks of 64 (B4, B5) and
queries in blocks of 32 (B6). That arithmetic is emulated here in torch:
every product in 3xTF32 (TF32 high and low parts by truncation or to
nearest, each 8-deep k-step summed from zero and added to the running
float32 sum in the kernel's order), the head dim padded to a multiple of
32 with zeros. The emulation stays inside ``chip_smoke.py``'s card checks
against the plain versions (``_attention_close``: atol 1e-5 + rtol 1e-5;
``_bwd_close``: atol min(1e-5, 1e-4 max |want|) + rtol 1e-4); one TF32
product without the low parts does not. The kernels are held against the
plain versions on the card in ``test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from simple_tip_tpu.ops.flash_attention import flash_attention as pallas_flash_attention
from simple_tip_tpu_torch.ops import flash_attention as fa
from test_torch_flash_backward_tc import _tf32
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPES = [((1, 40, 2, 160), 40), ((1, 40, 2, 256), 40), ((1, 37, 2, 160), 53)]
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
ROWS, CHUNK, SLICE, STREAM_Q = 64, 32, 128, 32  # the wide kernels' tiles


def _inputs(shape, t_kv: int, seed: int):
    rng = np.random.default_rng(seed)
    b, t, h, dh = shape
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, t, h, dh), (b, t_kv, h, dh), (b, t_kv, h, dh), (b, t, h, dh))]


def _pallas(q, k, v):
    return pallas_flash_attention(q, k, v, interpret=True)


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_plain_forward_matches_pallas_interpret(shape, t_kv):
    q, k, v, _ = _inputs(shape, t_kv, seed=0)
    before = fa.LAUNCHES
    got = fa.flash_attention(*map(torch.from_numpy, (q, k, v))).detach().numpy()
    assert fa.LAUNCHES == before, "a CPU tensor must not launch the kernel"
    want = _pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert got.shape == shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_plain_backward_and_function_gradients_match_pallas_interpret(shape, t_kv):
    q, k, v, dout = _inputs(shape, t_kv, seed=1)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
    _, vjp = jax.vjp(_pallas, *(jnp.asarray(x) for x in (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    out, lse = fa.flash_attention_fwd(tq, tk, tv)
    dvec = fa.attention_delta(out, tdo)
    plain = (fa.flash_bwd_dq(tq, tk, tv, tdo, lse, dvec),
             *fa.flash_bwd_dkv(tq, tk, tv, tdo, lse, dvec))
    for got, w in zip(plain, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-5)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    grads = torch.autograd.grad(fa.flash_attention(*leaves), leaves, tdo)
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), w, rtol=2e-4, atol=2e-5)


def _mm_tc(a, b, rounding: str, parts: int, acc=None):
    """``acc + a @ b`` as the kernels compute it: per 8-deep k-step, lo.hi +
    hi.lo + hi.hi of the TF32 parts (``parts=1``: hi.hi alone) summed from
    zero, then added to the float32 sum. The k extent is a multiple of 8."""
    a_hi, b_hi = _tf32(a, rounding), _tf32(b, rounding)
    a_lo, b_lo = _tf32(a - a_hi, rounding), _tf32(b - b_hi, rounding)
    if acc is None:
        acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        part = a_hi[..., ks] @ b_hi[..., ks, :]
        if parts == 3:
            part = a_lo[..., ks] @ b_hi[..., ks, :] + a_hi[..., ks] @ b_lo[..., ks, :] + part
        acc = acc + part
    return acc


def _fold(x, rows: int, cols: int):
    """``[B, T, H, dh]`` folded to ``[B*H, rows, cols]``, zero-padded."""
    f = fa._fold(x)
    return torch.nn.functional.pad(f, (0, cols - f.shape[2], 0, rows - f.shape[1]))


def _exp2_fma(s, scale2: float, sub):
    """exp2(s * scale2 - sub) with one rounding, as the kernels' fmaf."""
    return torch.exp2((s.double() * scale2 - sub.double()).float())


def _widths(dh: int):
    """(score columns, stored columns): dh padded to whole 32-column score
    chunks, and to whole 128-column output slices where that is wider."""
    dhp = -(-dh // CHUNK) * CHUNK
    return dhp, max(dhp, -(-dh // SLICE) * SLICE)


def emulate_fwd(q, k, v, rounding: str, parts: int = 3):
    """B4's wide-head variant: key blocks of 64, scores over the padded head
    dim, a streaming softmax in base 2, o += p v per key block."""
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    dhp, cols = _widths(dh)
    scale2 = float(torch.tensor(fa._scale(dh)) * torch.tensor(LOG2E))
    t_pad = -(-t_kv // ROWS) * ROWS
    qf = _fold(q, t_q, dhp)
    kf, vf = _fold(k, t_pad, dhp), _fold(v, t_pad, cols)
    m = torch.full((b * h, t_q, 1), -1e30)
    l = torch.zeros(b * h, t_q, 1)
    o = torch.zeros(b * h, t_q, cols)
    for k0 in range(0, t_kv, ROWS):
        keys = slice(k0, k0 + ROWS)
        s = _mm_tc(qf, kf[:, keys].transpose(1, 2), rounding, parts)
        valid = (k0 + torch.arange(ROWS)) < t_kv
        s = torch.where(valid, s * scale2, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(dim=2, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=2, keepdim=True)
        o = _mm_tc(p, vf[:, keys], rounding, parts, acc=o * alpha)
        m = m_new
    out = fa._unfold((o / l)[:, :, :dh], b, h)
    return out, (m * LN2 + torch.log(l)).reshape(b, h, t_q)


def emulate_bwd(q, k, v, dout, lse, dvec, rounding: str, parts: int = 3):
    """B5's and B6's wide-head variants: B5 streams keys in blocks of 64
    (scores and dP over the padded head dim, ds, dq += ds k); B6 streams
    queries in blocks of 32 (s^T and dP^T, dv += p^T dO, dk += ds^T q)."""
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    dhp, cols = _widths(dh)
    scale = fa._scale(dh)
    scale2 = float(torch.tensor(scale) * torch.tensor(LOG2E))
    tk_pad, tq_pad = -(-t_kv // ROWS) * ROWS, -(-t_q // STREAM_Q) * STREAM_Q
    qf, dof = _fold(q, tq_pad, cols), _fold(dout, tq_pad, cols)
    kf, vf = _fold(k, tk_pad, cols), _fold(v, tk_pad, cols)
    lse2 = torch.nn.functional.pad(lse.reshape(b * h, t_q) * torch.tensor(LOG2E), (0, tq_pad - t_q))
    dd = torch.nn.functional.pad(dvec.reshape(b * h, t_q), (0, tq_pad - t_q))
    # B5: own rows are queries.
    dq = torch.zeros(b * h, tq_pad, cols)
    for k0 in range(0, t_kv, ROWS):
        keys = slice(k0, k0 + ROWS)
        s = _mm_tc(qf[..., :dhp], kf[:, keys, :dhp].transpose(1, 2), rounding, parts)
        dp = _mm_tc(dof[..., :dhp], vf[:, keys, :dhp].transpose(1, 2), rounding, parts)
        valid = ((k0 + torch.arange(ROWS)) < t_kv)[None, :] & (torch.arange(tq_pad) < t_q)[:, None]
        p = torch.where(valid, _exp2_fma(s, scale2, lse2[:, :, None]), torch.zeros(()))
        dq = _mm_tc(p * (dp - dd[:, :, None]), kf[:, keys], rounding, parts, acc=dq)
    # B6: own rows are keys.
    dk = torch.zeros(b * h, tk_pad, cols)
    dv = torch.zeros(b * h, tk_pad, cols)
    for q0 in range(0, t_q, STREAM_Q):
        qs = slice(q0, q0 + STREAM_Q)
        s_t = _mm_tc(kf[..., :dhp], qf[:, qs, :dhp].transpose(1, 2), rounding, parts)
        dp_t = _mm_tc(vf[..., :dhp], dof[:, qs, :dhp].transpose(1, 2), rounding, parts)
        valid = (q0 + torch.arange(STREAM_Q)) < t_q
        p_t = torch.where(valid, _exp2_fma(s_t, scale2, lse2[:, None, qs]), torch.zeros(()))
        dv = _mm_tc(p_t, dof[:, qs], rounding, parts, acc=dv)
        dk = _mm_tc(p_t * (dp_t - dd[:, None, qs]), qf[:, qs], rounding, parts, acc=dk)
    return (fa._unfold(dq[:, :t_q, :dh] * scale, b, h),
            fa._unfold(dk[:, :t_kv, :dh] * scale, b, h), fa._unfold(dv[:, :t_kv, :dh], b, h))


def _case(shape, t_kv: int, seed: int):
    q, k, v, dout = map(torch.from_numpy, _inputs(shape, t_kv, seed))
    out, lse = fa.flash_attention_plain(q, k, v)
    return (q, k, v), (q, k, v, dout, lse, fa.attention_delta(out, dout)), (out, lse)


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("shape,t_kv", SHAPES, ids=str)
def test_emulated_wide_kernels_stay_inside_the_card_checks(shape, t_kv, rounding):
    """out, lse, dq, dk and dv of the emulated wide-head variants pass the
    card checks against the plain versions."""
    qkv, args, (want_out, want_lse) = _case(shape, t_kv, seed=2)
    out, lse = emulate_fwd(*qkv, rounding)
    chip_smoke._attention_close(out, want_out, "emulated wide out")
    chip_smoke._attention_close(lse, want_lse, "emulated wide lse")
    dq, dk, dv = emulate_bwd(*args, rounding)
    want_dk, want_dv = fa.flash_bwd_dkv_plain(*args)
    chip_smoke._bwd_close(dq, fa.flash_bwd_dq_plain(*args), "emulated wide dq")
    chip_smoke._bwd_close(dk, want_dk, "emulated wide dk")
    chip_smoke._bwd_close(dv, want_dv, "emulated wide dv")


def test_emulated_wide_kernels_match_pallas_interpret():
    """The emulated wide-head variants against the Pallas kernels in
    interpret mode at dh 256, at the port's plain-vs-Pallas bounds."""
    shape, t_kv = SHAPES[1]
    arrays = _inputs(shape, t_kv, seed=3)
    qkv, args, _ = _case(shape, t_kv, seed=3)
    out, _ = emulate_fwd(*qkv, "nearest")
    jq, jk, jv, jdo = map(jnp.asarray, arrays)
    np.testing.assert_allclose(out.numpy(), np.asarray(_pallas(jq, jk, jv)), rtol=1e-5, atol=1e-6)
    _, vjp = jax.vjp(_pallas, jq, jk, jv)
    for got, w in zip(emulate_bwd(*args, "nearest"), vjp(jdo)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_one_tf32_product_fails_the_card_checks_at_wide_heads():
    """Without the low parts the wide-head gradients miss the card check:
    why the variants keep three products."""
    _, args, _ = _case(*SHAPES[1], seed=2)
    dq, dk, _ = emulate_bwd(*args, "nearest", parts=1)
    with pytest.raises(AssertionError, match="flash backward"):
        chip_smoke._bwd_close(dq, fa.flash_bwd_dq_plain(*args), "one-product dq")
    with pytest.raises(AssertionError, match="flash backward"):
        chip_smoke._bwd_close(dk, fa.flash_bwd_dkv_plain(*args)[0], "one-product dk")
