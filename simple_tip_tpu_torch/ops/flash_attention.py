"""Flash-attention forward: the CUDA kernel, its plain PyTorch version, its counter.

Replaces the Pallas TPU kernel ``simple_tip_tpu/ops/flash_attention.py``
``_flash_kernel`` (via ``_flash_fwd_call``, public ``flash_attention``):
exact attention ``softmax(q k^T / sqrt(dh)) v`` with a streaming softmax over
tiles of keys, writing the output and the log-sum-exp of every query row
(the residual that the backward pass reuses). Layout is the JAX function's:
q ``[B, Tq, H, dh]``, k and v ``[B, Tkv, H, dh]``, out ``[B, Tq, H, dh]``;
the log-sum-exp is ``[B, H, Tq]``. float32 throughout; ``dh <= 128``, any
``Tq`` and ``Tkv >= 1``.

At the IMDB shapes (T=100, H=2, dh=32) the function is bound by operations,
narrowly (2.56 MFLOP and 102 KB a sequence). The kernel
(``csrc/flash_attention_fwd.cu``) keeps one block per (sequence-head, tile
of 64 queries), walks the key tiles inside the block with K and V staged in
shared memory and the running max, normaliser and accumulator in
registers; see the source for the design. The TPU kernel's 128-lane padding
of T is a TPU constraint and is gone: ragged key tiles are masked.

``flash_attention_fwd`` launches the kernel for CUDA tensors and runs
``flash_attention_plain`` for CPU tensors; ``flash_attention`` returns the
output only. ``LAUNCHES`` counts kernel launches and nothing else. Forward
only: the gradient (kernels B5 and B6) is not ported yet.
"""

import ctypes
import math
from typing import Tuple

import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
NEG_INF = -1e30  # large-finite, as in the TPU kernel: -inf breaks the first rescale
BLOCK_KV = 64  # key rows per tile, in the kernel and in the plain version
MAX_HEAD_DIM = 128


def _scale(dh: int) -> float:
    """1/sqrt(dh) rounded to float32, as the TPU kernel's ``np.float32``."""
    return float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32))


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("flash attention takes q [B,Tq,H,dh] and k, v [B,Tkv,H,dh]")
    b, _, h, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, dh):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if k.shape[1] == 0:
        raise ValueError("flash attention needs at least one key")


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

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], dh)

    qf, kf, vf = fold(q), fold(k), fold(v)
    pad = (-t_kv) % block_kv
    if pad:
        kf = torch.cat([kf, kf.new_zeros(b * h, pad, dh)], dim=1)
        vf = torch.cat([vf, vf.new_zeros(b * h, pad, dh)], dim=1)
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
    out = acc / l[:, :, None]
    lse = m + torch.log(l)
    return out.reshape(b, h, t_q, dh).permute(0, 2, 1, 3), lse.reshape(b, h, t_q)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    global LAUNCHES
    _check_shapes(q, k, v)
    for t in (q, k, v):
        if t.device != q.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("flash attention takes contiguous float32 tensors on one card")
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"flash attention takes head_dim <= {MAX_HEAD_DIM}, got {dh}")
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t_q, dtype=torch.float32, device=q.device)
    if b * h * t_q == 0:
        return out, lse
    lib = _build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tip_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, t_q, t_kv, h, dh, ctypes.c_float(_scale(dh)), stream,
        )
    _build.check(err, "tip_flash_attention_fwd")
    LAUNCHES += 1
    return out, lse


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,Tq,H,dh], lse [B,H,Tq])`` of exact attention.

    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version.
    """
    if q.device.type == "cuda":
        return _launch(q, k, v)
    if q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")
    return flash_attention_plain(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention, ``[batch, seq, heads, head_dim]`` in and out."""
    return flash_attention_fwd(q, k, v)[0]
