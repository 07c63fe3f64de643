"""Fused convnet forwards: the CUDA kernels, their plain versions, their counters.

Two Pallas TPU kernels of ``simple_tip_tpu/ops/fused_forward.py`` compute a
whole inference forward from NHWC images to probabilities, float32:

- ``_mnist_kernel`` (entry ``fused_mnist_probs``), ``MnistConvNet``: conv1 +
  relu, pool, conv2 + relu, floor pool, dense, softmax. Replaced by
  ``csrc/fused_mnist_forward.cu``; ~2.1 M FMAs an image (at the positions
  the pools keep) against 3.1 KB in and 40 B out. conv2 runs on the tensor
  cores in 3xTF32, conv1 and the dense layer on the float32 FMAs.
- ``_cifar_kernel`` (entry ``fused_cifar10_probs``), ``Cifar10ConvNet``:
  three VALID 3x3 convs with relu, floor pools 30 -> 15 and 13 -> 6, dense
  1024 -> 64 relu, dense 64 -> 10, softmax. Replaced by
  ``csrc/fused_cifar10_forward.cu``; ~4.1 M FMAs against 12 KB in and 40 B
  out. The three convs run on the tensor cores in 3xTF32, the dense layers
  on the float32 FMAs.

Both are bound by operations on this card. Each walks tiles of images
(``_MNIST_TILE``, ``_CIFAR_TILE``) in persistent blocks, one an SM, and
streams the big convolutions' weights through shared memory in chunks of
TF32 fragments (``tf32_fragments``: split into TF32 high and low parts and
laid out as the tensor cores' B operand, by the bridge, once per model);
see the sources for the designs. ``fused_mnist_probs`` and
``fused_cifar10_probs`` launch their kernel for CUDA tensors and run the
plain version for CPU tensors. ``LAUNCHES`` and ``CIFAR_LAUNCHES`` count
kernel launches and nothing else.
"""

from typing import Dict

import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
CIFAR_LAUNCHES = 0
# Blocks per SM: the shared memory a block of either kernel takes leaves
# room for one.
_BLOCKS_PER_SM = 1
_MNIST_TILE = 5  # images per pass of the MNIST kernel
_CIFAR_TILE = 4  # images per pass of the CIFAR-10 kernel
# The kernels' operands: weights the tensor cores multiply as TF32 fragments
# (``*_tc``, from the bridge), the rest as the plain versions read them.
_MNIST_OPS = ("w1", "b1", "w2_tc", "b2", "wd", "bd")
_CIFAR_OPS = ("w1_tc", "b1", "w2_tc", "b2", "w3_tc", "b3", "wd1", "bd1", "wd2", "bd2")


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero: the card's ``cvt.rna.tf32.f32`` on finite values."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_fragments(w: torch.Tensor) -> torch.Tensor:
    """A ``[K, N]`` float32 weight as the B operand of ``mma.sync.m16n8k8``
    TF32 tiles in 3xTF32: ``[ceil(K / 8), N / 8, 32, 4]``, where lane
    ``(g, t) = (lane // 4, lane % 4)`` of k-step ``ks`` and n-tile ``nt``
    holds ``(hi(w[8 ks + t, 8 nt + g]), hi(w[8 ks + t + 4, 8 nt + g]), lo(..),
    lo(..))``, ``hi = tf32_round(w)`` and ``lo = tf32_round(w - hi)``. Rows
    past K are zeros. A lane reads its part of a fragment in one 16-byte
    load."""
    k, n = w.shape
    if n % 8:
        raise ValueError(f"tf32_fragments takes N a multiple of 8, got {n}")
    w = torch.nn.functional.pad(w.float(), (0, 0, 0, (-k) % 8))
    hi = tf32_round(w)
    lo = tf32_round(w - hi)

    def frag(part):  # (ks, half, t, nt, g) -> (ks, nt, g, t, half)
        return part.reshape(-1, 2, 4, n // 8, 8).permute(0, 3, 4, 2, 1).reshape(-1, n // 8, 32, 2)

    return torch.cat([frag(hi), frag(lo)], dim=-1).contiguous()


def _check_operands(fused: Dict[str, torch.Tensor], names, x: torch.Tensor) -> list:
    """The kernel's operands in order; raises unless they and ``x`` are
    contiguous, 16-byte aligned float32 tensors on ``x``'s card."""
    missing = [k for k in names if k not in fused]
    if missing:
        raise ValueError(f"fused forward needs the bridge's operands {missing}")
    ops = [fused[k] for k in names]
    for t in [x, *ops]:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused forward takes contiguous float32 tensors on one card")
        if t.data_ptr() % 16:
            raise ValueError("the fused forwards read 16-byte aligned tensors")
    return ops


def fused_mnist_probs_plain(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in the Pallas kernel's steps.

    conv1 as 9 shifted FMAs, pool 26 -> 13, conv2 as one im2col matmul
    ``[B*121, 288] @ [288, 64]`` with patches in ``(dy, dx, c)`` order,
    floor pool 11 -> 5, NHWC flatten, dense and softmax.
    """
    b = x.shape[0]
    img = x.reshape(b, 28, 28)
    acc = torch.zeros(b, 26, 26, 32, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + img[:, dy : dy + 26, dx : dx + 26, None] * fused["w1"][dy * 3 + dx]
    h = torch.relu(acc + fused["b1"])
    h = h.reshape(b, 13, 2, 13, 2, 32).amax(dim=(2, 4))
    patches = torch.cat(
        [h[:, dy : dy + 11, dx : dx + 11, :] for dy in range(3) for dx in range(3)],
        dim=-1,
    )
    h2 = (patches.reshape(b * 121, 288) @ fused["w2"]).reshape(b, 11, 11, 64)
    h2 = torch.relu(h2 + fused["b2"])
    h2 = h2[:, :10, :10, :].reshape(b, 5, 2, 5, 2, 64).amax(dim=(2, 4))
    logits = h2.reshape(b, 1600) @ fused["wd"] + fused["bd"]
    return torch.softmax(logits, dim=-1)


def _launch(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    ops = _check_operands(fused, _MNIST_OPS, x)
    if tuple(ops[2].shape) != (36, 8, 32, 4):
        raise ValueError(f"w2_tc must be [36, 8, 32, 4], got {tuple(ops[2].shape)}")
    if tuple(x.shape[1:]) != (28, 28, 1):
        raise ValueError(f"fused forward takes NHWC [B, 28, 28, 1], got {tuple(x.shape)}")
    b = x.shape[0]
    out = torch.empty(b, 10, dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    sms = _build.sm_count(x.get_device())
    grid = min(-(-b // _MNIST_TILE), sms * _BLOCKS_PER_SM)
    err = _build.launch(
        x.get_device(), _build.library().tip_mnist_forward,
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(), b, grid,
    )
    _build.check(err, "tip_mnist_forward")
    LAUNCHES += 1
    return out


def fused_mnist_probs(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities ``[B, 10]`` for NHWC images ``x``.

    ``fused`` holds the bridge's kernel operands on ``x``'s device. CUDA
    tensors go through the kernel (or raise); CPU tensors through the plain
    version.
    """
    if x.device.type == "cuda":
        return _launch(fused, x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fused_mnist_probs_plain(fused, x)


def _im2col_conv(h: torch.Tensor, w: torch.Tensor, out_hw: int) -> torch.Tensor:
    """VALID 3x3 conv as one matmul ``[B*out^2, 9*C_in] @ [9*C_in, C_out]``,
    patches in ``(dy, dx, c)`` order (the TPU kernel's ``_im2col_conv``)."""
    b = h.shape[0]
    patches = torch.cat(
        [h[:, dy : dy + out_hw, dx : dx + out_hw, :] for dy in range(3) for dx in range(3)],
        dim=-1,
    )
    return (patches.reshape(b * out_hw * out_hw, -1) @ w).reshape(b, out_hw, out_hw, -1)


def _pool2(h: torch.Tensor, out_hw: int) -> torch.Tensor:
    """2x2 stride-2 max pool with floor semantics."""
    b, c = h.shape[0], h.shape[3]
    return h[:, : 2 * out_hw, : 2 * out_hw, :].reshape(b, out_hw, 2, out_hw, 2, c).amax(dim=(2, 4))


def fused_cifar10_probs_plain(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The CIFAR-10 kernel's function in plain PyTorch, in the Pallas
    kernel's steps: three im2col convs with relu, floor pools 30 -> 15 and
    13 -> 6, NHWC flatten to 1024, dense 64 relu, dense 10, softmax."""
    b = x.shape[0]
    h = torch.relu(_im2col_conv(x, fused["w1"], 30) + fused["b1"])
    h = _pool2(h, 15)
    h = torch.relu(_im2col_conv(h, fused["w2"], 13) + fused["b2"])
    h = _pool2(h, 6)
    h = torch.relu(_im2col_conv(h, fused["w3"], 4) + fused["b3"])
    hd = torch.relu(h.reshape(b, 1024) @ fused["wd1"] + fused["bd1"])
    return torch.softmax(hd @ fused["wd2"] + fused["bd2"], dim=-1)


def _launch_cifar10(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    global CIFAR_LAUNCHES
    ops = _check_operands(fused, _CIFAR_OPS, x)
    shapes = [tuple(ops[i].shape) for i in (0, 2, 4)]
    if shapes != [(4, 4, 32, 4), (36, 8, 32, 4), (72, 8, 32, 4)]:
        raise ValueError(f"w1_tc, w2_tc, w3_tc must be [4|36|72, 4|8|8, 32, 4], got {shapes}")
    if tuple(x.shape[1:]) != (32, 32, 3):
        raise ValueError(f"fused forward takes NHWC [B, 32, 32, 3], got {tuple(x.shape)}")
    b = x.shape[0]
    out = torch.empty(b, 10, dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    sms = _build.sm_count(x.get_device())
    grid = min(-(-b // _CIFAR_TILE), sms * _BLOCKS_PER_SM)
    err = _build.launch(
        x.get_device(), _build.library().tip_cifar10_forward,
        x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(), b, grid,
    )
    _build.check(err, "tip_cifar10_forward")
    CIFAR_LAUNCHES += 1
    return out


def fused_cifar10_probs(fused: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Softmax probabilities ``[B, 10]`` for NHWC CIFAR-10 images ``x``.

    ``fused`` holds the bridge's kernel operands on ``x``'s device. CUDA
    tensors go through the kernel (or raise); CPU tensors through the plain
    version.
    """
    if x.device.type == "cuda":
        return _launch_cifar10(fused, x)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return fused_cifar10_probs_plain(fused, x)
