"""The tensor-core arithmetic of kernels B1 and B3 (the fused convnet
forwards), emulated in plain torch on the CPU.

``csrc/fused_mnist_forward.cu`` (B1) runs conv2, and
``csrc/fused_cifar10_forward.cu`` (B3) all three convs, as im2col products
on ``mma.sync.m16n8k8`` TF32 tiles in 3xTF32: the activations split into
TF32 high and low parts as they are read, the weights arriving split and in
fragment order (``fused_forward.tf32_fragments``, the bridge's ``w*_tc``),
each 8-deep k-step of lo.hi + hi.lo + hi.hi summed from zero and added to
the float32 sum, K in the kernels' (dy, dx, c) order (B3's conv1 padded from
27 to 32 with zero weights). Rows are the kernels' own: per tile of images
(B1 5, B3 4), groups of 8 pooled positions whose m16 tile mt holds position
4 mt + g / 2 at pool tap (0, g % 2) in row g and (1, g % 2) in row g + 8;
past the tile's last position a row reads the last one and is dropped.
Pooling is the max of those 4 rows, then bias and relu; B3's conv3 takes
an image's 16 positions as one m-tile. The emulation decodes the bridge's
fragments back into the weights' TF32 parts (nearest; by truncation the
parts are cut from the weights instead), and holds the probabilities to
``fused_*_probs_plain`` at max-abs 1e-5 (the card check of
``chip_smoke.py``) and to the JAX package's Pallas kernels in interpret
mode at float32, on ``bridge.glorot_params`` weights; one TF32 product
without the low parts misses the check (on those weights with the last
dense kernel scaled by 10, so that the logits spread as training spreads
them). The kernels are held against the
plain versions on the card in ``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops.fused_forward import fused_cifar10_probs as pallas_cifar10_probs
from simple_tip_tpu.ops.fused_forward import fused_mnist_probs as pallas_mnist_probs
from simple_tip_tpu_torch.bridge import glorot_params, params_from_jax
from simple_tip_tpu_torch.ops import fused_forward
from test_torch_flash_backward_tc import _tf32
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

MNIST_TILE, CIFAR_TILE = 5, 4  # the kernels' images a tile
CARD_ATOL = 1e-5  # chip_smoke.py's B1/B3 check against the plain versions


def _unfragment(frag: torch.Tensor):
    """The ``[K, N]`` TF32 high and low parts held by ``tf32_fragments``'s
    ``[K / 8, N / 8, 32, 4]`` layout (lane ``4 g + t``: rows ``8 ks + t`` and
    ``8 ks + t + 4`` of column ``8 nt + g``)."""
    ks, nt = frag.shape[:2]
    x = frag.reshape(ks, nt, 8, 4, 2, 2)  # (ks, nt, g, t, part, half)
    x = x.permute(4, 0, 5, 3, 1, 2).reshape(2, ks * 8, nt * 8)  # (part, ks, half, t, nt, g)
    return x[0], x[1]


def _weight_parts(fused, name: str, rounding: str):
    """(hi, lo) of weight ``name`` as the kernel multiplies it."""
    if rounding == "nearest":
        return _unfragment(fused[f"{name}_tc"])
    w = fused[name]
    w = torch.nn.functional.pad(w, (0, 0, 0, (-w.shape[0]) % 8))
    hi = _tf32(w, rounding)
    return hi, _tf32(w - hi, rounding)


def _mm_tc(a, parts_b, rounding: str, parts: int = 3):
    """``a @ b`` as the kernels compute it: per 8-deep k-step, lo.hi + hi.lo
    + hi.hi (``parts=1``: hi.hi alone) summed from zero, then added to the
    float32 sum; ``parts_b`` = (b_hi, b_lo)."""
    b_hi, b_lo = parts_b
    a_hi = _tf32(a, rounding)
    a_lo = _tf32(a - a_hi, rounding)
    acc = torch.zeros(a.shape[0], b_hi.shape[1])
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        part = a_hi[:, ks] @ b_hi[ks]
        if parts == 3:
            part = a_lo[:, ks] @ b_hi[ks] + a_hi[:, ks] @ b_lo[ks] + part
        acc = acc + part
    return acc


def _pool_rows(n_pooled: int, per_image: int, side: int):
    """The kernels' rows for a tile of ``n_pooled`` pooled positions
    (``per_image`` an image, ``side`` x ``side`` an image): per group of 8,
    m-tile and row, (image, y, x) of the conv position, in row order."""
    groups = -(-n_pooled // 8)
    g = torch.arange(16) % 8
    ty = torch.arange(16) // 8
    rows = []
    for grp in range(groups):
        for mt in range(2):
            pq = torch.clamp(grp * 8 + 4 * mt + g // 2, max=n_pooled - 1)
            q = pq % per_image
            rows.append(torch.stack([pq // per_image, 2 * (q // side) + ty,
                                     2 * (q % side) + g % 2], dim=1))
    return torch.cat(rows), groups


def _patches(h: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """im2col rows of NHWC ``h`` at (image, y, x) ``rows``, in (dy, dx, c)
    order."""
    im, y, x = rows.unbind(1)
    return torch.cat([h[im, y + dy, x + dx] for dy in range(3) for dx in range(3)], dim=1)


def _pool_conv(h, parts_b, bias, n_pooled: int, per_image: int, side: int, rounding, parts,
               k_pad: int = 0):
    """A pooled conv of one tile as the kernels compute it: the product over
    their rows, the max of each position's 4 rows, bias and relu once.
    Returns ``[n_pooled, N]`` in pooled-position order."""
    rows, groups = _pool_rows(n_pooled, per_image, side)
    a = torch.nn.functional.pad(_patches(h, rows), (0, k_pad))
    c = _mm_tc(a, parts_b, rounding, parts)
    # rows (group, mt, ty, g // 2, g % 2) -> the position group * 8 + 4 mt + g // 2
    pooled = c.reshape(groups, 2, 2, 4, 2, -1).amax(dim=(2, 4)).reshape(groups * 8, -1)
    return torch.relu(pooled[:n_pooled] + bias)


def _tiles(x: torch.Tensor, tile: int):
    """``x`` padded with zero images to whole tiles, tile by tile."""
    pad = (-x.shape[0]) % tile
    x = torch.cat([x, x.new_zeros(pad, *x.shape[1:])])
    return x.split(tile)


def emulate_mnist(fused, x, rounding: str, parts: int = 3):
    """B1: conv1 on the FMAs (the plain version's sums), conv2 in 3xTF32 on
    the kernel's rows, dense and softmax in float32."""
    w2 = _weight_parts(fused, "w2", rounding)
    out = []
    for xt in _tiles(x, MNIST_TILE):
        img = xt.reshape(-1, 28, 28)
        acc = torch.zeros(img.shape[0], 26, 26, 32)
        for dy in range(3):
            for dx in range(3):
                acc = acc + img[:, dy : dy + 26, dx : dx + 26, None] * fused["w1"][dy * 3 + dx]
        h1 = torch.relu(acc.reshape(-1, 13, 2, 13, 2, 32).amax(dim=(2, 4)) + fused["b1"])
        h2 = _pool_conv(h1, w2, fused["b2"], MNIST_TILE * 25, 25, 5, rounding, parts)
        logits = h2.reshape(MNIST_TILE, 1600) @ fused["wd"] + fused["bd"]
        out.append(torch.softmax(logits, dim=-1))
    return torch.cat(out)[: x.shape[0]]


def emulate_cifar10(fused, x, rounding: str, parts: int = 3):
    """B3: conv1 (K 27 padded to 32), conv2 and conv3 in 3xTF32 on the
    kernel's rows, the dense layers and softmax in float32."""
    w1, w2, w3 = (_weight_parts(fused, n, rounding) for n in ("w1", "w2", "w3"))
    out = []
    for xt in _tiles(x, CIFAR_TILE):
        h1 = _pool_conv(xt, w1, fused["b1"], CIFAR_TILE * 225, 225, 15, rounding, parts,
                        k_pad=5).reshape(CIFAR_TILE, 15, 15, 32)
        h2 = _pool_conv(h1, w2, fused["b2"], CIFAR_TILE * 36, 36, 6, rounding, parts)
        h2 = h2.reshape(CIFAR_TILE, 6, 6, 64)
        pos = torch.arange(16)
        rows = torch.stack([torch.arange(CIFAR_TILE).repeat_interleave(16),
                            (pos // 4).repeat(CIFAR_TILE), (pos % 4).repeat(CIFAR_TILE)], dim=1)
        h3 = torch.relu(_mm_tc(_patches(h2, rows), w3, rounding, parts) + fused["b3"])
        hd = torch.relu(h3.reshape(CIFAR_TILE, 1024) @ fused["wd1"] + fused["bd1"])
        out.append(torch.softmax(hd @ fused["wd2"] + fused["bd2"], dim=-1))
    return torch.cat(out)[: x.shape[0]]


FAMILIES = {
    "mnist": (emulate_mnist, fused_forward.fused_mnist_probs_plain, pallas_mnist_probs,
              (28, 28, 1), 7),  # a whole tile of 5 and one of 2
    "cifar10": (emulate_cifar10, fused_forward.fused_cifar10_probs_plain, pallas_cifar10_probs,
                (32, 32, 3), 6),  # a whole tile of 4 and one of 2
}


def _case(family: str, seed: int):
    params = glorot_params(seed, family)
    shape, n = FAMILIES[family][3], FAMILIES[family][4]
    x = np.random.default_rng(seed).uniform(0, 1, size=(n, *shape)).astype(np.float32)
    return params, params_from_jax(params)["fused"], x


@pytest.mark.parametrize("rounding", ["truncate", "nearest"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_emulated_kernel_stays_inside_the_card_check(family, rounding):
    emulate, plain = FAMILIES[family][:2]
    _, fused, x = _case(family, seed=1)
    x = torch.from_numpy(x)
    err = float((emulate(fused, x, rounding) - plain(fused, x)).abs().max())
    assert err <= CARD_ATOL, f"{family}: emulated kernel off by {err}"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_emulated_kernel_matches_pallas_interpret(family):
    emulate, _, pallas = FAMILIES[family][:3]
    params, fused, x = _case(family, seed=2)
    got = emulate(fused, torch.from_numpy(x), "nearest").numpy()
    want = pallas(params, jnp.asarray(x), compute_dtype=jnp.float32, tile=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("family,last", [("cifar10", "wd2"), ("mnist", "wd")])
def test_one_tf32_product_fails_the_card_check(family, last):
    """Without the low parts (one TF32 product, 10 mantissa bits) the
    probabilities miss the 1e-5 check, where three products keep it: why
    the kernels take three. Glorot weights on U(0, 1) images give nearly
    flat probabilities (at most ~0.13), which hide the logits' error; the
    last dense kernel scaled by 10 spreads the logits as training does
    (largest probability ~0.4; a trained run reaches ~0.96)."""
    emulate, plain = FAMILIES[family][:2]
    _, fused, x = _case(family, seed=1)
    fused = {**fused, last: fused[last] * 10}
    x = torch.from_numpy(x)
    want = plain(fused, x)
    assert float((emulate(fused, x, "nearest") - want).abs().max()) <= CARD_ATOL
    assert float((emulate(fused, x, "nearest", parts=1) - want).abs().max()) > CARD_ATOL


@pytest.mark.parametrize("k,n", [(27, 32), (288, 64), (576, 64)])
def test_fragments_hold_the_weights_tf32_parts(k, n):
    """``tf32_fragments`` holds hi = rna(w) and lo = rna(w - hi) of every
    weight, zero past K, each part exact in TF32; hi + lo is w to ~2^-21."""
    w = torch.from_numpy(np.random.default_rng(k).normal(size=(k, n)).astype(np.float32))
    frag = fused_forward.tf32_fragments(w)
    assert tuple(frag.shape) == (-(-k // 8), n // 8, 32, 4)
    hi, lo = _unfragment(frag)
    assert torch.equal(hi[:k], _tf32(w, "nearest"))
    assert torch.equal(lo[:k], _tf32(w - hi[:k], "nearest"))
    assert not hi[k:].any() and not lo[k:].any()
    for part in (hi, lo):
        assert torch.equal(part, _tf32(part, "truncate"))
    assert float(((hi + lo)[:k] - w).abs().max()) <= 2.0 ** -21 * float(w.abs().max())


@pytest.mark.parametrize("n_pooled,per_image,side", [(125, 25, 5), (144, 36, 6), (900, 225, 15)])
def test_kernel_rows_cover_every_pool_window_once(n_pooled, per_image, side):
    """The kernels' rows hold each pooled position's 4 window taps exactly
    once (B1 conv2, B3 conv2, B3 conv1), plus clamped copies past the
    tile's last position."""
    rows, groups = _pool_rows(n_pooled, per_image, side)
    assert rows.shape[0] == groups * 32
    taps = {tuple(r) for r in rows.tolist()}
    want = {(im, 2 * py + ty, 2 * px + tx) for im in range(n_pooled // per_image)
            for py in range(side) for px in range(side) for ty in range(2) for tx in range(2)}
    assert taps == want
