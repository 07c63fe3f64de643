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

The bf16 scoring mode (the TPU kernel with bfloat16 operands) has a
forward kernel of its own, ``csrc/flash_attention_fwd_bf16.cu`` (counter
``BF16_LAUNCHES``), which ``flash_attention_fwd`` takes for bfloat16 q, k
and v: the scores ``q k^T`` from bfloat16 operands summed in float32 on the
tensor cores (``mma.sync.m16n8k16``) and then scaled; the streaming max,
``l`` and the log-sum-exp in float32; ``p`` rounded to bfloat16 for
``p v``, which sums in float32; the output rounded to bfloat16. Where ``p``
is rounded depends on the running max, so the keys are folded in the TPU
kernel's own tiles (``jax_kv_block``: Tkv padded to 128 lanes, tiles of
at most 1024), each tile's max taken before its ``p``. ``bf16_route``
picks one of its two routes from (Tq, Tkv, head_dim): ``"tile"`` where
Tq and Tkv are at most ``TILE_KEYS`` (all keys one TPU tile) at a head
dim of ``TILE_HEAD_DIMS`` (IMDB's [B, 100, 2, 32] among them; persistent
blocks read each (batch, head) slab once and keep the scores in
registers), ``"two_pass"`` otherwise (each TPU tile walked twice in
sub-tiles of 64 keys). ``BF16_LAUNCHES`` counts both routes,
``BF16_TILE_LAUNCHES`` the one-tile route's. Training runs
float32, so there is no bf16 backward: ``FlashAttention.backward`` raises
on bfloat16 tensors.

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
BF16_LAUNCHES = 0  # both routes of the bf16 forward
BF16_TILE_LAUNCHES = 0  # its one-tile route
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
NEG_INF = -1e30  # large-finite, as in the TPU kernel: -inf breaks the first rescale
BLOCK_KV = 64  # key rows per tile of the plain versions (the kernels tile their own way)
BLOCK_Q = 64  # query rows per tile of B6's plain version
# The TPU kernel's key tiles (``_block_for``): lane-padded, at most MAX_BLOCK.
LANE = 128
MAX_BLOCK = 1024
# The bf16 forward's one-tile route: Tq and Tkv at most TILE_KEYS (all keys
# in one TPU tile; the kernel's kTileKeys) at the head dims its kernel is
# built for (the cases of tip_flash_attention_fwd_bf16_tile).
TILE_KEYS = 128
TILE_HEAD_DIMS = (16, 32, 64)


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


def jax_kv_block(t: int) -> int:
    """The TPU kernel's key tile for ``t`` keys (``_block_for``): the
    smallest multiple of 128 that covers the 128-padded length in the fewest
    tiles of at most 1024."""
    padded = -(-t // LANE) * LANE
    n_tiles = -(-padded // MAX_BLOCK)
    per_tile = -(-padded // n_tiles)
    return -(-per_tile // LANE) * LANE


def flash_attention_bf16_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 forward in plain PyTorch, in the TPU kernel's steps.

    q, k and v bfloat16 (or rounded to it); keys padded to the TPU kernel's
    tile (``jax_kv_block``) and folded tile by tile: ``s = (q k^T) * scale``
    summed in float32, keys at or past Tkv masked to -1e30, the running max
    ``m``, ``alpha`` and ``l`` in float32, ``p = exp(s - m_new)`` rounded to
    bfloat16 for ``p v`` (float32 sums). Returns ``(out [B,Tq,H,dh]`` in
    bfloat16 (``acc / l`` rounded), ``lse [B,H,Tq]`` float32).
    """
    _check_shapes(q, k, v)
    b, t_q, h, dh = q.shape
    t_kv = k.shape[1]
    scale = _scale(dh)
    block = jax_kv_block(t_kv)
    bf = torch.bfloat16

    def keys(x):
        x = _fold(x).to(bf).float()
        pad = (-t_kv) % block
        return torch.cat([x, x.new_zeros(x.shape[0], pad, dh)], dim=1) if pad else x

    qf, kf, vf = _fold(q).to(bf).float(), keys(k), keys(v)
    m = torch.full((b * h, t_q), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros(b * h, t_q, dtype=torch.float32, device=q.device)
    acc = torch.zeros(b * h, t_q, dh, dtype=torch.float32, device=q.device)
    for j0 in range(0, kf.shape[1], block):
        s = (qf @ kf[:, j0 : j0 + block].transpose(1, 2)) * scale
        col = j0 + torch.arange(block, device=q.device)
        s = torch.where(col < t_kv, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=2))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, :, None])
        l = l * alpha + p.sum(dim=2)
        acc = acc * alpha[:, :, None] + p.to(bf).float() @ vf[:, j0 : j0 + block]
        m = m_new
    lse = m + torch.log(l)
    return _unfold((acc / l[:, :, None]).to(bf), b, h), lse.reshape(b, h, t_q)


def bf16_route(t_q: int, t_kv: int, dh: int) -> str:
    """The bf16 forward's route for these shapes: ``"tile"`` where the TPU
    kernel folds every key in one tile of at most TILE_KEYS, Tq is at most
    TILE_KEYS too and ``dh`` is one of TILE_HEAD_DIMS, else ``"two_pass"``."""
    if jax_kv_block(t_kv) <= TILE_KEYS and t_q <= TILE_KEYS and dh in TILE_HEAD_DIMS:
        return "tile"
    return "two_pass"


def _launch_bf16(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    global BF16_LAUNCHES, BF16_TILE_LAUNCHES
    _check_shapes(q, k, v)
    index = q.get_device()
    if not (k.get_device() == index == v.get_device() and q.dtype is k.dtype is v.dtype
            is torch.bfloat16 and q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("the bf16 flash forward takes contiguous bfloat16 tensors on one card")
    b, t_q, h, dh = q.shape
    if dh % 16 or dh > 128:
        raise ValueError(f"the bf16 flash forward takes head_dim a multiple of 16 up to 128, "
                         f"got {dh}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("the bf16 flash forward reads 16-byte aligned tensors")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    if b * h * t_q == 0:
        return out, lse
    t_kv = k.shape[1]
    lib = _build.library()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            b, t_q, t_kv, h, dh)
    if bf16_route(t_q, t_kv, dh) == "tile":
        _build.check(_build.launch(index, lib.tip_flash_attention_fwd_bf16_tile, *args,
                                   _scale(dh)), "tip_flash_attention_fwd_bf16_tile")
        BF16_TILE_LAUNCHES += 1
    else:
        _build.check(_build.launch(index, lib.tip_flash_attention_fwd_bf16, *args,
                                   jax_kv_block(t_kv), _scale(dh)), "tip_flash_attention_fwd_bf16")
    BF16_LAUNCHES += 1
    return out, lse


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
    plain version. bfloat16 q goes through the bf16 forward (out in
    bfloat16, lse float32).
    """
    if q.dtype == torch.bfloat16:
        return _on(q, _launch_bf16, flash_attention_bf16_plain, q, k, v)
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
        if q.dtype != torch.float32:
            raise RuntimeError(
                f"the flash backward (B5, B6) takes float32; got {q.dtype} q/k/v: the bf16 "
                "mode scores only, training runs float32")
        dout = dout.contiguous()
        dvec = attention_delta(out, dout)
        dq = flash_bwd_dq(q, k, v, dout, lse, dvec)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, dvec)
        return dq, dk, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Exact attention, ``[batch, seq, heads, head_dim]`` in and out,
    differentiable through ``FlashAttention``."""
    return FlashAttention.apply(q, k, v)
