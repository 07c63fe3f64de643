"""Flash attention: the CUDA kernels B4-B6, their plain PyTorch versions,
their counters, and the differentiable entry point.

Replaces the Pallas TPU kernels of ``simple_tip_tpu/ops/flash_attention.py``:

- B4 ``_flash_kernel`` (via ``_flash_fwd_call``): exact attention
  ``softmax(q k^T / sqrt(dh)) v`` with a streaming softmax over tiles of
  keys, writing the output and the log-sum-exp of every query row;
- B5 ``_flash_bwd_dq_kernel`` and B6 ``_flash_bwd_dkv_kernel`` (via
  ``_flash_bwd_call``): the backward over that log-sum-exp, recomputing
  ``p = exp(s * scale - lse)`` and ``ds = p * (dO v^T - D)`` with
  ``D = rowsum(dO * out)``; B5 gives ``dq = scale * ds k``, B6
  ``dv = p^T dO`` and ``dk = scale * ds^T q``.

Layout is the JAX function's: q ``[B, Tq, H, dh]``, k and v
``[B, Tkv, H, dh]``, out and the gradients like their inputs; the
log-sum-exp and ``D`` are ``[B, H, Tq]``. float32 throughout; any ``dh``,
``Tq`` and ``Tkv >= 1``. All three kernels multiply on the tensor cores
in 3xTF32 (float32-accurate; helpers in ``csrc/tf32_mma.cuh``), one warp
per 16 rows, in persistent blocks that load the next item while this one
computes; at the IMDB shapes (T=100, H=2, dh=32) all three are bound by
bytes. The forward (``csrc/flash_attention_fwd.cu``) walks (sequence-head,
128 queries) items. The backward (``csrc/flash_attention_bwd.cu``) walks
(sequence-head, 128 own rows) items: B5 owns queries and streams keys,
building ds in the accumulator layout of its score tiles and feeding it to
``ds k`` from registers; B6 owns keys, computes the scores transposed
(``k q^T``, ``v dO^T``) and feeds ``p^T`` and ``ds^T`` to ``p^T dO`` and
``ds^T q`` the same way. No atomics: results are the same on every run.
All read [B,T,H,dh] in place and mask ragged tiles; see the sources for
the designs. The TPU kernels' 128-lane padding of T is gone. Above
head_dim 128 a row's head dim no longer fits a warp's registers, and
each kernel takes its wide-head variant (``csrc/flash_attention_wide.cu``):
blocks own 64 rows and one 128-wide slice of the output columns, contracting
the scores over the whole head dim in chunks from shared memory.

``flash_attention(q, k, v)`` is the entry point the models call: it goes
through ``FlashAttention``, a ``torch.autograd.Function`` whose forward is
B4 and whose backward is B5 and B6 on the card, and their plain versions on
the CPU (autograd never traces the plain forward loop). Each wrapper
(``flash_attention_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``) launches its
kernel for CUDA tensors (or raises) and runs its plain version for CPU
tensors. ``LAUNCHES`` (B4), ``BWD_DQ_LAUNCHES`` (B5) and
``BWD_DKV_LAUNCHES`` (B6) count kernel launches and nothing else.
"""

import functools
import math
from typing import Tuple

import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
NEG_INF = -1e30  # large-finite, as in the TPU kernel: -inf breaks the first rescale
BLOCK_KV = 64  # key rows per tile of the plain versions (the kernels tile their own way)
BLOCK_Q = 64  # query rows per tile of B6's plain version


@functools.lru_cache(maxsize=None)
def _scale(dh: int) -> float:
    """1/sqrt(dh) rounded to float32, as the TPU kernel's ``np.float32``."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError("flash attention takes q [B,Tq,H,dh] and k, v [B,Tkv,H,dh]")
    if ks[1] == 0:
        raise ValueError("flash attention needs at least one key")
    if ks[0] != qs[0] or ks[2] != qs[2] or ks[3] != qs[3]:
        raise ValueError(f"q {tuple(qs)} and k {tuple(ks)} disagree")


def _fold(x: torch.Tensor) -> torch.Tensor:
    """``[B, T, H, dh]`` -> ``[B*H, T, dh]``."""
    b, t, h, dh = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, dh)


def _unfold(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``[B*H, T, dh]`` -> ``[B, T, H, dh]``."""
    return x.reshape(b, h, x.shape[1], x.shape[2]).permute(0, 2, 1, 3)


def _pad_keys(x: torch.Tensor) -> torch.Tensor:
    """Folded keys or values padded with zero rows to a multiple of BLOCK_KV."""
    pad = (-x.shape[1]) % BLOCK_KV
    return torch.cat([x, x.new_zeros(x.shape[0], pad, x.shape[2])], dim=1) if pad else x


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, in the Pallas kernel's steps.

    Heads are folded to ``[B*H, T, dh]``; keys are padded to a multiple of
    ``BLOCK_KV`` and walked tile by tile with a running max ``m``,
    normaliser ``l`` and float32 accumulator; keys at or beyond ``Tkv`` are
    masked to -1e30. Returns ``(out [B,Tq,H,dh], lse [B,H,Tq])``.
    """
    _check_shapes(q, k, v)
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    scale = _scale(dh)
    block_kv = BLOCK_KV
    qf, kf, vf = _fold(q), _pad_keys(_fold(k)), _pad_keys(_fold(v))
    m = torch.full((b * h, t_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b * h, t_q, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b * h, t_q, dh, dtype=torch.float32, device=q.device)
    for j0 in range(0, kf.shape[1], block_kv):
        s = (qf @ kf[:, j0 : j0 + block_kv].transpose(1, 2)) * scale
        col = j0 + torch.arange(block_kv, device=q.device)
        s = torch.where(col < t_kv, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, :, None])
        l = l * alpha + p.sum(dim=2)
        acc = acc * alpha[:, :, None] + p @ vf[:, j0 : j0 + block_kv]
        m = m_new
    lse = m + torch.log(l)
    return _unfold(acc / l[:, :, None], b, h), lse.reshape(b, h, t_q)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    # Lean on purpose: at a training step the kernel takes ~10 us, so each
    # microsecond of host work here shows in the step's time.
    global LAUNCHES
    _check_shapes(q, k, v)
    index = q.get_device()
    if not (k.get_device() == index == v.get_device() and q.dtype is k.dtype is v.dtype
            is torch.float32 and q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("flash attention takes contiguous float32 tensors on one card")
    b, t_q, h, dh = q.shape
    out = torch.empty_like(q)
    lse = q.new_empty((b, h, t_q))
    if b * h * t_q == 0:
        return out, lse
    err = _build.launch(
        index, _build.library().tip_flash_attention_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, t_q, k.shape[1], h, dh, _scale(dh),
    )
    _build.check(err, "tip_flash_attention_fwd")
    LAUNCHES += 1
    return out, lse


def _on(x: torch.Tensor, kernel, plain, *args):
    """``kernel(*args)`` where ``x`` is a CUDA tensor, ``plain(*args)`` where
    it is a CPU one."""
    if x.is_cuda:
        return kernel(*args)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return plain(*args)


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,Tq,H,dh], lse [B,H,Tq])`` of exact attention (B4).

    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version.
    """
    return _on(q, _launch, flash_attention_plain, q, k, v)


def _p_ds(qf, kf, vf, dof, lse, dvec, j0: int, t_kv: int, scale: float):
    """The shared recompute for queries ``qf`` against the padded keys
    ``kf``/``vf`` (first key index ``j0``): ``p = exp(s * scale - lse)``
    with keys at or past ``t_kv`` masked to -1e30, and
    ``ds = p * (dO v^T - D)``."""
    s = (qf @ kf.transpose(1, 2)) * scale
    col = j0 + torch.arange(kf.shape[1], device=qf.device)
    s = torch.where(col < t_kv, s, NEG_INF)
    p = torch.exp(s - lse[:, :, None])
    dp = dof @ vf.transpose(1, 2)
    return p, p * (dp - dvec[:, :, None])


def flash_bwd_dq_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    dvec: torch.Tensor,
) -> torch.Tensor:
    """B5 in plain PyTorch, in the Pallas kernel's steps: per tile of
    ``BLOCK_KV`` keys, recompute ``p`` and ``ds`` and fold
    ``scale * ds k`` into dq. Returns ``dq [B,Tq,H,dh]``."""
    _check_shapes(q, k, v)
    b, _, h, dh = q.shape
    t_kv = k.shape[1]
    scale = _scale(dh)
    qf, dof = _fold(q), _fold(dout)
    kf, vf = _pad_keys(_fold(k)), _pad_keys(_fold(v))
    lse_f, d_f = lse.reshape(b * h, -1), dvec.reshape(b * h, -1)
    acc = torch.zeros_like(qf)
    for j0 in range(0, kf.shape[1], BLOCK_KV):
        kt, vt = kf[:, j0 : j0 + BLOCK_KV], vf[:, j0 : j0 + BLOCK_KV]
        _, ds = _p_ds(qf, kt, vt, dof, lse_f, d_f, j0, t_kv, scale)
        acc = acc + scale * (ds @ kt)
    return _unfold(acc, b, h)


def flash_bwd_dkv_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    dvec: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B6 in plain PyTorch, in the Pallas kernel's steps: per tile of
    ``BLOCK_Q`` queries, recompute ``p`` and ``ds`` and fold ``p^T dO`` into
    dv and ``scale * ds^T q`` into dk. Returns ``(dk, dv)``, each
    ``[B,Tkv,H,dh]``."""
    _check_shapes(q, k, v)
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    scale = _scale(dh)
    qf, dof = _fold(q), _fold(dout)
    kf, vf = _pad_keys(_fold(k)), _pad_keys(_fold(v))
    lse_f, d_f = lse.reshape(b * h, -1), dvec.reshape(b * h, -1)
    acc_k, acc_v = torch.zeros_like(kf), torch.zeros_like(vf)
    for i0 in range(0, t_q, BLOCK_Q):
        rows = slice(i0, i0 + BLOCK_Q)
        qt, dot = qf[:, rows], dof[:, rows]
        p, ds = _p_ds(qt, kf, vf, dot, lse_f[:, rows], d_f[:, rows], 0, t_kv, scale)
        acc_v = acc_v + p.transpose(1, 2) @ dot
        acc_k = acc_k + scale * (ds.transpose(1, 2) @ qt)
    return _unfold(acc_k[:, :t_kv], b, h), _unfold(acc_v[:, :t_kv], b, h)


def attention_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * out)`` as ``[B, H, Tq]``, the layout of lse (one
    plain line, as the JAX package computes it in XLA outside its kernels)."""
    return (dout * out).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of exact attention in plain PyTorch: ``D``, then B5's
    and B6's plain versions."""
    dvec = attention_delta(out, dout)
    dk, dv = flash_bwd_dkv_plain(q, k, v, dout, lse, dvec)
    return flash_bwd_dq_plain(q, k, v, dout, lse, dvec), dk, dv


def _check_bwd(q, k, v, dout, lse, dvec) -> None:
    _check_shapes(q, k, v)
    b, t_q, h, _ = q.shape
    if dout.shape != q.shape:
        raise ValueError(f"dO {tuple(dout.shape)} is not shaped like q {tuple(q.shape)}")
    if lse.shape != (b, h, t_q) or dvec.shape != (b, h, t_q):
        raise ValueError("lse and D must be [B, H, Tq]")
    for t in (q, k, v, dout, lse, dvec):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("flash attention backward takes contiguous float32 tensors on one card")


def _launch_dq(q, k, v, dout, lse, dvec):
    global BWD_DQ_LAUNCHES
    _check_bwd(q, k, v, dout, lse, dvec)
    b, t_q, h, dh = q.shape
    dq = torch.empty_like(q)
    if b * h * t_q == 0:
        return dq
    err = _build.launch(
        q.get_device(), _build.library().tip_flash_attention_bwd_dq,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dq.data_ptr(), b, t_q, k.shape[1], h, dh, _scale(dh),
    )
    _build.check(err, "tip_flash_attention_bwd_dq")
    BWD_DQ_LAUNCHES += 1
    return dq


def _launch_dkv(q, k, v, dout, lse, dvec):
    global BWD_DKV_LAUNCHES
    _check_bwd(q, k, v, dout, lse, dvec)
    b, t_q, h, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if b * h * t_q == 0:
        return dk.zero_(), dv.zero_()
    err = _build.launch(
        q.get_device(), _build.library().tip_flash_attention_bwd_dkv,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        dvec.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, t_q, k.shape[1], h, dh, _scale(dh),
    )
    _build.check(err, "tip_flash_attention_bwd_dkv")
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_bwd_dq(q, k, v, dout, lse, dvec) -> torch.Tensor:
    """dq (B5) from q, k, v, dO, lse and ``D``: the kernel for CUDA tensors
    (or raise), the plain version for CPU tensors."""
    return _on(q, _launch_dq, flash_bwd_dq_plain, q, k, v, dout, lse, dvec)


def flash_bwd_dkv(q, k, v, dout, lse, dvec) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` (B6) from q, k, v, dO, lse and ``D``: the kernel for
    CUDA tensors (or raise), the plain version for CPU tensors."""
    return _on(q, _launch_dkv, flash_bwd_dkv_plain, q, k, v, dout, lse, dvec)


class FlashAttention(torch.autograd.Function):
    """Exact attention with the flash backward, on either device.

    Forward: B4 (its plain version on the CPU), saving q, k, v, out and lse.
    Backward: ``D = rowsum(dO * out)``, then B5 and B6 (their plain versions
    on the CPU). The counterpart of the JAX package's ``_flash_core`` custom
    VJP.
    """

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dvec = attention_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, dvec)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, dvec)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention, ``[batch, seq, heads, head_dim]`` in and out,
    differentiable through ``FlashAttention``."""
    return FlashAttention.apply(q, k, v)
