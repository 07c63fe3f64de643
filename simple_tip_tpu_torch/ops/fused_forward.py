"""Fused MNIST forward: the CUDA kernel, its plain PyTorch version, its counter.

Replaces the Pallas TPU kernel ``simple_tip_tpu/ops/fused_forward.py``
``_mnist_kernel`` (entry ``fused_mnist_probs``): the whole inference forward
of ``MnistConvNet`` (conv1 + relu, pool, conv2 + relu, floor pool, dense,
softmax) from NHWC images to probabilities, float32.

On this card the function is bound by operations (~2.4 M FMAs an image
against 3.1 KB in and 40 B out). The kernel (``csrc/fused_mnist_forward.cu``)
keeps every intermediate and all weights in shared memory, so device memory
sees only images and probabilities; see the source for the design.

``fused_mnist_probs`` launches the kernel for CUDA tensors and runs
``fused_mnist_probs_plain`` for CPU tensors. ``LAUNCHES`` counts kernel
launches and nothing else.
"""

from typing import Dict

import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
# Blocks per SM: ~170 KB of shared memory a block leaves room for one.
_BLOCKS_PER_SM = 1


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
    ops = [fused[k] for k in ("w1", "b1", "w2", "b2", "wd", "bd")]
    for t in [x, *ops]:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fused forward takes contiguous float32 tensors on one card")
    if tuple(x.shape[1:]) != (28, 28, 1):
        raise ValueError(f"fused forward takes NHWC [B, 28, 28, 1], got {tuple(x.shape)}")
    b = x.shape[0]
    out = torch.empty(b, 10, dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(b, sms * _BLOCKS_PER_SM)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tip_mnist_forward(
            x.data_ptr(), *[t.data_ptr() for t in ops], out.data_ptr(), b, grid, stream
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
