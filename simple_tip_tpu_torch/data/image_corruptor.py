"""Image corruption generator of the port (MNIST-C / CIFAR-10-C style OOD sets).

Counterpart of the JAX package's ``data/image_corruptor.py``: the same 27
corruptions with the same severity tables, the same ``MNIST_C_KINDS`` and
``CIFAR10_C_KINDS``, and the same numpy-seeded allocation, severities and
permutation in ``corrupted_test_set``, on NHWC float32 tensors on the card
(or the CPU when asked). Each (kind, severity) group runs as batched tensor
ops over all its images.

Each corruption is two steps:

- ``draw(kind, severity, seed, global_indices, shape, device)``: the
  per-image random tensors, named as the JAX factory's draws (``z``,
  ``theta``, ``dy`` ...). Every random word is a pure function of (seed,
  global index, draw slot, element): Threefry-2x32 with 20 rounds, keyed by
  the seed, on the counter (global index, slot << 24 | element), in int64
  arithmetic masked to 32 bits (adds, rotations and xors; no products). So
  a subset corrupted at the same global indices is bit-equal to the
  full-set run, the words are the same on the CPU and the card, and no
  batch or chunk boundary moves them. ``jax.random``'s streams are not
  reproduced: JAX's own draws can be fed to ``apply`` instead.
- ``apply(kind, severity, x, draws)``: the deterministic rest.

Distributions from the words: uniform float32 from 24 bits; uniform
float64 from 53 bits; normal by Box-Muller in float64 (rounded to float32);
integers by the word modulo the range; Bernoulli(1/2) by the top bit.
Shot noise's Poisson counts are drawn by inversion of the CDF in float64
over a fixed ``POISSON_TERMS`` terms, one uniform per pixel.

So that the card and the CPU agree, convolutions are sums of shifted
images in a fixed tap order (elementwise products and sums, correctly
rounded on both), channel means are explicit sums, and every sine and
cosine (rotations, line rasters) is taken in float64. The noise fields of
fog, frost, spatter and elastic are blurred in float64: their stretch to
[0, 1] divides by a small range, which would carry float32 summation
noise of the blur's hundreds of taps into elastic's displacements. ``map_coordinates``
(order 1, constant 0) and ``jax.image.resize`` (linear with antialiasing,
and nearest at half-pixel centres) are written out as index arithmetic and
weight matrices as in JAX.
"""

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from simple_tip_tpu_torch.device import DeviceLike, resolve

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Inversion terms of the Poisson sampler: lambda <= 60, and P(X >= 160) at
# lambda 60 is below 1e-20.
POISSON_TERMS = 160
# Images a batch of one (kind, severity) group (~50 MB of CIFAR-10 floats).
CHUNK = 4096

# ---------------------------------------------------------------------------
# Counter-based random words
# ---------------------------------------------------------------------------


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values
    (the cipher of ``jax.random``'s default generator)."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def random_words(seed: int, global_indices: torch.Tensor, slot: int, count: int):
    """Two int64 tensors [N, count] of uint32 words for draw ``slot`` of the
    images at ``global_indices``."""
    n = global_indices.shape[0]
    dev = global_indices.device
    x0 = (global_indices.to(torch.int64) & _MASK).view(n, 1).expand(n, count)
    x1 = ((slot << 24) | torch.arange(count, device=dev, dtype=torch.int64)).view(1, count)
    return threefry2x32(seed & _MASK, (seed >> 32) & _MASK, x0, x1.expand(n, count))


def _uniform32(w0):
    return (w0 >> 8).to(torch.float32) * (2.0 ** -24)


def _sample(dist: str, seed: int, idx: torch.Tensor, slot: int, shape, lo=0.0, hi=1.0):
    count = int(np.prod(shape)) if shape else 1
    w0, w1 = random_words(seed, idx, slot, count)
    n = idx.shape[0]
    if dist == "uniform":
        out = _uniform32(w0)
        if (lo, hi) != (0.0, 1.0):
            out = out * np.float32(hi - lo) + np.float32(lo)
    elif dist == "uniform64":
        out = ((w0 >> 5) * (1 << 26) + (w1 >> 6)).to(torch.float64) * (2.0 ** -53)
    elif dist == "normal":
        u1 = (w0 + 1).to(torch.float64) * (2.0 ** -32)
        u2 = w1.to(torch.float64) * (2.0 ** -32)
        out = (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)).to(torch.float32)
    elif dist == "randint":
        out = lo + torch.remainder(w0, hi - lo)
    elif dist == "bernoulli":
        out = w0 >= (1 << 31)
    else:
        raise ValueError(dist)
    return out.view((n,) + tuple(shape))


def _sev(table, severity: int):
    return table[severity - 1]


def draw_plan(kind: str, severity: int, shape: Tuple[int, int, int]) -> List[Tuple]:
    """The draws of one corruption: ``[(name, dist, shape, lo, hi)]``, in
    slot order. ``shape`` is one image's (H, W, C)."""
    h, w, c = shape
    plane, grid = (h, w, 1), (h, w)
    if kind in ("gaussian_noise", "speckle_noise"):
        return [("z", "normal", shape, 0, 1)]
    if kind == "shot_noise":
        return [("u", "uniform64", shape, 0, 1)]
    if kind == "impulse_noise":
        return [("r", "uniform", shape, 0.0, 1.0)]
    if kind == "glass_blur":
        delta = _sev((1, 1, 1, 2, 2), severity)
        return [("dy", "randint", grid, -delta, delta + 1),
                ("dx", "randint", grid, -delta, delta + 1)]
    if kind == "motion_blur":
        return [("theta", "uniform", (), 0.0, np.pi)]
    if kind in ("fog", "frost", "spatter"):
        return [("field", "uniform", plane, 0.0, 1.0)]
    if kind == "snow":
        return [("flakes", "uniform", plane, 0.0, 1.0), ("theta", "uniform", (), 0.0, np.pi)]
    if kind == "elastic_transform":
        return [("field_y", "uniform", plane, 0.0, 1.0), ("field_x", "uniform", plane, 0.0, 1.0)]
    if kind in ("rotate", "shear"):
        return [("sign", "bernoulli", (), 0, 1)]
    if kind == "translate":
        return [("theta", "uniform", (), 0.0, 2 * np.pi)]
    if kind == "stripe":
        band = min(_sev((2, 3, 4, 5, 6), severity), max(1, h // 4))
        return [("top", "randint", (), h // 4, max(h // 4 + 1, 3 * h // 4 - band))]
    if kind == "dotted_line":
        plan = []
        for i in range(_sev((1, 1, 2, 2, 3), severity)):
            plan.append((f"theta_{i}", "uniform", (), 0.0, np.pi))
            plan.append((f"offset_{i}", "uniform", (), -h / 4.0, h / 4.0))
        return plan
    if kind == "zigzag":
        return [("phase", "uniform", (), 0.0, 2.0)]
    if kind in CORRUPTIONS:
        return []
    raise ValueError(f"unknown corruption {kind!r}; available: {sorted(CORRUPTIONS)}")


def draw(kind: str, severity: int, seed: int, global_indices, shape, device: DeviceLike = None
         ) -> Dict[str, torch.Tensor]:
    """The per-image random tensors of ``kind`` at ``severity`` for the
    images at ``global_indices`` (a pure function of seed, index and slot)."""
    dev = resolve(device)
    if not torch.is_tensor(global_indices):
        global_indices = torch.from_numpy(np.asarray(global_indices, dtype=np.int64))
    idx = global_indices.to(dev, torch.int64)
    return {name: _sample(dist, seed, idx, slot, s, lo, hi)
            for slot, (name, dist, s, lo, hi) in enumerate(draw_plan(kind, severity, shape))}


# ---------------------------------------------------------------------------
# Shared helpers (batched over N; NHWC)
# ---------------------------------------------------------------------------


def _depthwise_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Every channel of [N,H,W,C] convolved (cross-correlated, as XLA) with
    ``kernel`` [K,K] or per image [N,K,K], zero "SAME" padding (the extra
    row of an even kernel on the high side, as XLA). Taps are summed in
    row-major order."""
    kh, kw = kernel.shape[-2:]
    n, h, w, _ = x.shape
    top, left = (kh - 1) // 2, (kw - 1) // 2
    xp = F.pad(x, (0, 0, left, kw - 1 - left, top, kh - 1 - top))
    kernel = kernel.to(x.dtype)
    out = torch.zeros_like(x)
    for dy in range(kh):
        for dx in range(kw):
            tap = kernel[..., dy, dx]
            if tap.dim():
                tap = tap.view(n, 1, 1, 1)
            out = out + tap * xp[:, dy: dy + h, dx: dx + w, :]
    return out


def _gauss_kernel2d(sigma: float, radius: int) -> np.ndarray:
    ax = np.arange(-radius, radius + 1, dtype=np.float32)
    g = np.exp(np.float32(-0.5) * (ax / np.float32(max(sigma, 1e-6))) ** 2)
    g = g / g.sum()
    return np.outer(g, g)


def _gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    radius = min(max(1, int(3.0 * sigma)), x.shape[1] // 2)
    return _depthwise_conv(x, torch.from_numpy(_gauss_kernel2d(sigma, radius)).to(x.device))


def _grid(h: int, w: int, device, dtype=torch.float32):
    yy = torch.arange(h, device=device, dtype=dtype).view(h, 1).expand(h, w)
    xx = torch.arange(w, device=device, dtype=dtype).view(1, w).expand(h, w)
    return yy, xx


def _map_coordinates(x: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``map_coordinates(order=1, mode="constant", cval=0)`` of every
    channel of [N,H,W,C] at per-image pixel-index coordinates [N,H,W]: the
    four taps in JAX's order, each out-of-range tap 0."""
    n, h, w, c = x.shape
    flat = x.reshape(n * h * w, c)
    base = (torch.arange(n, device=x.device) * (h * w)).view(n, 1, 1)
    taps = []
    for coord, size in ((rows, h), (cols, w)):
        lower = torch.floor(coord)
        upper_w = coord - lower
        index = lower.to(torch.int64)
        taps.append(((index, 1 - upper_w), (index + 1, upper_w)))
    out = None
    for ri, wr in taps[0]:
        for ci, wc in taps[1]:
            valid = (ri >= 0) & (ri < h) & (ci >= 0) & (ci < w)
            at = base + ri.clamp(0, h - 1) * w + ci.clamp(0, w - 1)
            value = torch.where(valid[..., None], flat[at], torch.zeros((), device=x.device))
            term = (wr * wc)[..., None] * value
            out = term if out is None else out + term
    return out


def _affine_warp(x: torch.Tensor, mat, offset) -> torch.Tensor:
    """out(p) = x(centre + M (p - centre) + offset), bilinear; ``mat`` is a
    2x2 of floats or [N] tensors, ``offset`` two of them."""
    n, h, w, _ = x.shape
    yy, xx = _grid(h, w, x.device)
    py, px = yy - np.float32((h - 1) / 2.0), xx - np.float32((w - 1) / 2.0)

    def col(v):
        return v.view(n, 1, 1) if torch.is_tensor(v) else np.float32(v)

    (m00, m01), (m10, m11) = mat
    rows = (col(m00) * py + col(m01) * px) + np.float32((h - 1) / 2.0) + col(offset[0])
    cols = (col(m10) * py + col(m11) * px) + np.float32((w - 1) / 2.0) + col(offset[1])
    return _map_coordinates(x, rows.expand(n, h, w), cols.expand(n, h, w))


def _smooth_noise(u: torch.Tensor, sigma: float) -> torch.Tensor:
    """[N,H,W]: uniform noise [N,H,W,1] blurred and stretched to [0, 1] per image."""
    f = _gaussian_blur(u.to(torch.float64), sigma)[..., 0].to(torch.float32)
    lo = f.amin(dim=(1, 2), keepdim=True)
    hi = f.amax(dim=(1, 2), keepdim=True)
    return (f - lo) / torch.clamp(hi - lo, min=1e-6)


def _to_gray(x: torch.Tensor) -> torch.Tensor:
    total = x[..., 0:1]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i: i + 1]
    return total / np.float32(x.shape[-1])


def _clip(x):
    return torch.clamp(x, 0.0, 1.0)


def _f32(v) -> float:
    return float(np.float32(v))


def _motion_kernels(theta: torch.Tensor, k: int) -> torch.Tensor:
    """[N,k,k]: a soft rasterised line through the origin at each angle,
    the raster taken in float64."""
    n = theta.shape[0]
    ax = torch.arange(-(k // 2), k // 2 + 1, device=theta.device, dtype=torch.float64)
    yy, xx = ax.view(k, 1).expand(k, k), ax.view(1, k).expand(k, k)
    t = theta.to(torch.float64).view(n, 1, 1)
    perp = torch.abs(xx * torch.sin(t) - yy * torch.cos(t))
    along = torch.abs(xx * torch.cos(t) + yy * torch.sin(t))
    kern = ((perp <= 0.6) & (along <= k / 2)).to(torch.float32)
    return kern / torch.clamp(kern.sum(dim=(1, 2), keepdim=True), min=1.0)


def _resize_linear_matrix(m: int, n: int) -> np.ndarray:
    """[m, n] weights of ``jax.image.resize(..., "linear")`` along one axis
    from m to n samples, antialiased (a triangle stretched by m / n) when
    shrinking."""
    scale = n / m
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0), np.float32(1) - np.abs(x))
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def _resize_nearest_index(m: int, n: int) -> np.ndarray:
    """Source rows of ``jax.image.resize(..., "nearest")`` from m to n
    samples: half-pixel centres (torch's ``nearest-exact``)."""
    offsets = (np.arange(n, dtype=np.float32) + np.float32(0.5)) * np.float32(m) / np.float32(n)
    return np.floor(offsets.astype(np.float32)).astype(np.int64)


def _jpeg_dct() -> np.ndarray:
    n = np.arange(8, dtype=np.float64)
    k = np.arange(8, dtype=np.float64)[:, None]
    return np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))


# ---------------------------------------------------------------------------
# The deterministic step of each corruption: apply(severity, x, draws)
# ---------------------------------------------------------------------------


def _gaussian_noise(severity, x, d):
    c = _sev((0.08, 0.12, 0.18, 0.26, 0.38), severity)
    return _clip(x + c * d["z"])


def poisson_counts(u: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Poisson(rate) samples by inversion: the number of CDF terms at or
    below the float64 uniform ``u``, over ``POISSON_TERMS`` terms."""
    rate = rate.to(torch.float64)
    pmf = torch.exp(-rate)
    cdf = pmf
    counts = (u >= cdf).to(torch.int64)
    for j in range(1, POISSON_TERMS):
        pmf = pmf * rate / j
        cdf = cdf + pmf
        counts = counts + (u >= cdf).to(torch.int64)
    return counts


def _shot_noise(severity, x, d):
    lam = _sev((60.0, 25.0, 12.0, 5.0, 3.0), severity)
    return _clip(poisson_counts(d["u"], x * lam).to(torch.float32) / lam)


def _impulse_noise(severity, x, d):
    amount = _sev((0.03, 0.06, 0.09, 0.17, 0.27), severity)
    r = d["r"]
    x = torch.where(r < _f32(amount / 2), torch.ones_like(x), x)
    return torch.where(r > _f32(1.0 - amount / 2), torch.zeros_like(x), x)


def _speckle_noise(severity, x, d):
    c = _sev((0.15, 0.20, 0.35, 0.45, 0.60), severity)
    return _clip(x + x * c * d["z"])


def _gaussian_blur_c(severity, x, d):
    return _gaussian_blur(x, _sev((0.4, 0.6, 0.8, 1.1, 1.5), severity))


def _defocus_blur(severity, x, d):
    r = min(_sev((1, 2, 2, 3, 4), severity), x.shape[1] // 2 - 1)
    ax = np.arange(-r, r + 1, dtype=np.float32)
    yy, xx = np.meshgrid(ax, ax, indexing="ij")
    disk = (yy ** 2 + xx ** 2 <= r ** 2 + 0.5).astype(np.float32)
    return _depthwise_conv(x, torch.from_numpy(disk / disk.sum()).to(x.device))


def _glass_blur(severity, x, d):
    sigma = _sev((0.3, 0.5, 0.7, 0.8, 1.0), severity)
    n, h, w, c = x.shape
    x = _gaussian_blur(x, sigma)
    yy, xx = _grid(h, w, x.device, torch.int64)
    sy = torch.clamp(yy + d["dy"], 0, h - 1)
    sx = torch.clamp(xx + d["dx"], 0, w - 1)
    at = (torch.arange(n, device=x.device) * (h * w)).view(n, 1, 1) + sy * w + sx
    return _gaussian_blur(x.reshape(n * h * w, c)[at], sigma * 0.7)


def _motion_blur(severity, x, d):
    k = min(_sev((3, 5, 7, 9, 11), severity), x.shape[1] - 1) | 1
    return _depthwise_conv(x, _motion_kernels(d["theta"], k))


def _zoom_blur(severity, x, d):
    zmax = _sev((1.06, 1.11, 1.16, 1.21, 1.26), severity)
    factors = [1.0 + i * 0.02 for i in range(int(round((zmax - 1.0) / 0.02)) + 1)]
    acc = x
    for z in factors[1:]:
        s = np.float32(1.0) / np.float32(z)
        acc = acc + _affine_warp(x, ((s, 0.0), (0.0, s)), (0.0, 0.0))
    return _clip(acc / np.float32(len(factors)))


def _fog(severity, x, d):
    a = _sev((0.15, 0.25, 0.35, 0.45, 0.55), severity)
    field = _smooth_noise(d["field"], max(x.shape[1], x.shape[2]) / 6.0)[..., None]
    return _clip(x * _f32(1.0 - a) + a * (0.75 * field + 0.25))


def _frost(severity, x, d):
    a = _sev((0.20, 0.30, 0.40, 0.50, 0.60), severity)
    field = _smooth_noise(d["field"], 2.0)[..., None]
    return _clip(x * _f32(1.0 - 0.6 * a) + a * field * 0.9)


def _snow(severity, x, d):
    p = _sev((0.01, 0.02, 0.03, 0.05, 0.08), severity)
    flakes = (d["flakes"] < _f32(p)).to(x.dtype)
    flakes = _motion_blur(min(severity + 1, 5), flakes, {"theta": d["theta"]})
    peak = flakes.amax(dim=(1, 2, 3), keepdim=True)
    flakes = flakes / torch.clamp(peak, min=1e-6)
    whitened = _clip(x * 0.9 + 0.05)
    return _clip(torch.maximum(whitened, flakes * 0.8))


def _brightness(severity, x, d):
    return _clip(x + _sev((0.1, 0.2, 0.3, 0.4, 0.5), severity))


def _contrast(severity, x, d):
    c = _sev((0.75, 0.6, 0.45, 0.3, 0.2), severity)
    m = x.mean(dim=(1, 2, 3), keepdim=True)
    return _clip((x - m) * c + m)


def _saturate(severity, x, d):
    s = _sev((1.3, 1.6, 2.0, 2.5, 3.0), severity)
    gray = _to_gray(x)
    return _clip(gray + (x - gray) * s)


def _pixelate(severity, x, d):
    frac = _sev((0.75, 0.6, 0.5, 0.4, 0.3), severity)
    _, h, w, _ = x.shape
    sh, sw = max(1, int(h * frac)), max(1, int(w * frac))
    small = x
    if sh != h:
        wh = torch.from_numpy(_resize_linear_matrix(h, sh)).to(x.device)
        small = torch.einsum("nhwc,ha->nawc", small, wh)
    if sw != w:
        ww = torch.from_numpy(_resize_linear_matrix(w, sw)).to(x.device)
        small = torch.einsum("nawc,wb->nabc", small, ww)
    rows = torch.from_numpy(_resize_nearest_index(sh, h)).to(x.device)
    cols = torch.from_numpy(_resize_nearest_index(sw, w)).to(x.device)
    return small[:, rows][:, :, cols]


def _jpeg_compression(severity, x, d):
    strength = _sev((0.5, 0.8, 1.2, 1.8, 2.6), severity)
    n, h, w, c = x.shape
    ph, pw = (-h) % 8, (-w) % 8
    xp = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    xp = xp.to(torch.float64) - 0.5
    hh, ww = h + ph, w + pw
    dct = torch.from_numpy(_jpeg_dct()).to(x.device)
    blocks = xp.reshape(n, hh // 8, 8, ww // 8, 8, c).permute(0, 1, 3, 5, 2, 4)
    coefs = torch.einsum("ab,nijcbd,ed->nijcae", dct, blocks, dct)
    u = np.arange(8, dtype=np.float32)
    q = (np.float32(1.0) + u[:, None] + u[None, :]) * np.float32(strength) / np.float32(60.0)
    q = torch.from_numpy(q.astype(np.float64)).to(x.device)
    coefs = torch.round(coefs / q) * q
    out = torch.einsum("ab,nijcae,ed->nijcbd", dct, coefs, dct)
    out = out.permute(0, 1, 4, 2, 5, 3).reshape(n, hh, ww, c) + 0.5
    return _clip(out[:, :h, :w].to(torch.float32))


def _elastic_transform(severity, x, d):
    alpha = _sev((2.0, 3.0, 4.0, 5.0, 7.0), severity)
    n, h, w, _ = x.shape
    sigma = max(h, w) / 7.0
    dy = (_smooth_noise(d["field_y"], sigma) - 0.5) * 2.0 * alpha
    dx = (_smooth_noise(d["field_x"], sigma) - 0.5) * 2.0 * alpha
    yy, xx = _grid(h, w, x.device)
    return _map_coordinates(x, yy + dy, xx + dx)


def _sign(d):
    return torch.where(d["sign"], 1.0, -1.0).to(torch.float32)


def _rotate(severity, x, d):
    deg = _sev((5.0, 10.0, 15.0, 25.0, 35.0), severity)
    t = (_sign(d) * deg * np.pi / 180.0).to(torch.float64)
    cos, sin = torch.cos(t).to(torch.float32), torch.sin(t).to(torch.float32)
    return _affine_warp(x, ((cos, sin), (-sin, cos)), (0.0, 0.0))


def _shear(severity, x, d):
    s = _sev((0.1, 0.2, 0.3, 0.4, 0.5), severity)
    return _affine_warp(x, ((1.0, 0.0), (_sign(d) * s, 1.0)), (0.0, 0.0))


def _translate(severity, x, d):
    frac = _sev((0.05, 0.10, 0.15, 0.20, 0.25), severity)
    t = d["theta"].to(torch.float64)
    scale = np.float32(frac * x.shape[1])
    off = (torch.sin(t).to(torch.float32) * scale, torch.cos(t).to(torch.float32) * scale)
    return _affine_warp(x, ((1.0, 0.0), (0.0, 1.0)), off)


def _scale(severity, x, d):
    s = np.float32(1.0) / np.float32(_sev((0.9, 0.85, 0.8, 0.75, 0.7), severity))
    return _affine_warp(x, ((s, 0.0), (0.0, s)), (0.0, 0.0))


def _stripe(severity, x, d):
    n, h = x.shape[:2]
    band = min(_sev((2, 3, 4, 5, 6), severity), max(1, h // 4))
    rows = torch.arange(h, device=x.device).view(1, h)
    top = d["top"].view(n, 1)
    in_band = ((rows >= top) & (rows < top + band)).view(n, h, 1, 1)
    return torch.where(in_band, 1.0 - x, x)


def _dotted_line(severity, x, d):
    n, h, w, _ = x.shape
    yy, xx = _grid(h, w, x.device, torch.float64)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    out = x
    for i in range(_sev((1, 1, 2, 2, 3), severity)):
        t = d[f"theta_{i}"].to(torch.float64).view(n, 1, 1)
        offset = d[f"offset_{i}"].to(torch.float64).view(n, 1, 1)
        perp = (yy - cy) * torch.cos(t) - (xx - cx) * torch.sin(t) + offset
        along = (yy - cy) * torch.sin(t) + (xx - cx) * torch.cos(t)
        on = (torch.abs(perp) <= 0.6) & (torch.remainder(along, 4.0) < 2.0)
        out = torch.maximum(out, on[..., None].to(x.dtype))
    return out


def _zigzag(severity, x, d):
    freq = _sev((1.0, 1.5, 2.0, 2.5, 3.0), severity)
    n, h, w, _ = x.shape
    yy, xx = _grid(h, w, x.device)
    t = xx / np.float32(w) * np.float32(freq) * 2.0 + d["phase"].view(n, 1, 1)
    tri = 2.0 * torch.abs(t - torch.floor(t + 0.5))
    y_path = np.float32(h - 1) * (0.25 + 0.5 * tri)
    on = torch.abs(yy - y_path) <= 0.7
    return torch.maximum(x, on[..., None].to(x.dtype))


def _spatter(severity, x, d):
    thresh = _sev((0.86, 0.82, 0.78, 0.74, 0.70), severity)
    blobs = (_smooth_noise(d["field"], 1.2) > _f32(thresh)).to(x.dtype)[..., None]
    return torch.maximum(x, blobs * 0.9)


def _canny_edges(severity, x, d):
    thresh = _sev((0.5, 0.4, 0.3, 0.25, 0.2), severity)
    gray = _to_gray(x)
    sx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=torch.float32, device=x.device)
    gx = _depthwise_conv(gray, sx)[..., 0]
    gy = _depthwise_conv(gray, sx.T.contiguous())[..., 0]
    mag = torch.sqrt(gx ** 2 + gy ** 2)
    mag = mag / torch.clamp(mag.amax(dim=(1, 2), keepdim=True), min=1e-6)
    edges = (mag > _f32(thresh)).to(x.dtype)
    return edges[..., None].expand(x.shape).contiguous()


CORRUPTIONS = {
    "gaussian_noise": _gaussian_noise,
    "shot_noise": _shot_noise,
    "impulse_noise": _impulse_noise,
    "speckle_noise": _speckle_noise,
    "gaussian_blur": _gaussian_blur_c,
    "defocus_blur": _defocus_blur,
    "glass_blur": _glass_blur,
    "motion_blur": _motion_blur,
    "zoom_blur": _zoom_blur,
    "fog": _fog,
    "frost": _frost,
    "snow": _snow,
    "brightness": _brightness,
    "contrast": _contrast,
    "saturate": _saturate,
    "pixelate": _pixelate,
    "jpeg_compression": _jpeg_compression,
    "elastic_transform": _elastic_transform,
    "rotate": _rotate,
    "shear": _shear,
    "translate": _translate,
    "scale": _scale,
    "stripe": _stripe,
    "dotted_line": _dotted_line,
    "zigzag": _zigzag,
    "spatter": _spatter,
    "canny_edges": _canny_edges,
}

# The 15 MNIST-C corruption types (Mu & Gilmer 2019).
MNIST_C_KINDS: Tuple[str, ...] = (
    "shot_noise", "impulse_noise", "glass_blur", "motion_blur", "shear", "scale", "rotate",
    "brightness", "translate", "stripe", "fog", "spatter", "dotted_line", "zigzag",
    "canny_edges",
)

# The 15 primary CIFAR-10-C corruption types (Hendrycks & Dietterich 2019).
CIFAR10_C_KINDS: Tuple[str, ...] = (
    "gaussian_noise", "shot_noise", "impulse_noise", "defocus_blur", "glass_blur",
    "motion_blur", "zoom_blur", "snow", "frost", "fog", "brightness", "contrast",
    "elastic_transform", "pixelate", "jpeg_compression",
)


def _check(corruption: str, severity: int) -> None:
    if corruption not in CORRUPTIONS:
        raise ValueError(f"unknown corruption {corruption!r}; available: {sorted(CORRUPTIONS)}")
    if not 1 <= int(severity) <= 5:
        raise ValueError(f"severity must be in 1..5, got {severity}")


def apply(kind: str, severity: int, x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The deterministic step of ``kind`` on [N,H,W,C] float32 images in
    [0, 1] with the per-image ``draws`` (``draw``'s, or JAX's)."""
    _check(kind, severity)
    return CORRUPTIONS[kind](int(severity), x, draws)


def corrupt(x: torch.Tensor, kind: str, severity: int, seed: int,
            global_indices: torch.Tensor) -> torch.Tensor:
    """``apply`` of ``draw`` on the device of ``x``."""
    draws = draw(kind, severity, seed, global_indices, tuple(x.shape[1:]), x.device)
    return apply(kind, severity, x, draws)


def corrupt_images(
    x: np.ndarray,
    corruption: str,
    severity: int = 3,
    seed: int = 0,
    global_indices: Sequence[int] = None,
    chunk: int = CHUNK,
    device: DeviceLike = None,
) -> np.ndarray:
    """Corrupt a batch of [N,H,W,C] float images in [0, 1] on ``device``
    (the card by default). ``global_indices`` (default ``arange(N)``) drive
    the draws, so a subset corrupted at the same indices matches the
    full-set result exactly."""
    _check(corruption, severity)
    dev = resolve(device)
    x = np.asarray(x, dtype=np.float32)
    idx = np.arange(len(x)) if global_indices is None else np.asarray(global_indices)
    out = np.empty_like(x)
    for s in range(0, len(x), chunk):
        e = min(s + chunk, len(x))
        part = torch.from_numpy(x[s:e]).to(dev)
        out[s:e] = corrupt(part, corruption, int(severity), seed,
                           torch.from_numpy(idx[s:e].astype(np.int64))).cpu().numpy()
    return out


def _allocate(rng: np.random.Generator, n_source: int, total: int, n_kinds: int):
    """~equal per-kind sample allocation (the JAX package's draws)."""
    per = [total // n_kinds] * n_kinds
    for i in range(total - sum(per)):
        per[i] += 1
    return [rng.choice(n_source, size=p, replace=p > n_source) for p in per]


def corrupted_test_set(
    x_test: np.ndarray,
    y_test: np.ndarray,
    kinds: Sequence[str],
    total: int = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """An MNIST-C / CIFAR-10-C style corrupted set: ``total`` samples drawn
    ~equally across ``kinds`` with per-sample random severity 1..5, then
    permuted; allocation, severities and permutation are the JAX package's
    numpy draws, the images are corrupted on ``device`` (one batch per
    (kind, severity), in chunks of ``CHUNK``)."""
    dev = resolve(device)
    x_test = np.asarray(x_test, dtype=np.float32)
    y_test = np.asarray(y_test)
    total = total or len(x_test)
    rng = np.random.default_rng(seed)
    source = torch.from_numpy(x_test).to(dev)
    parts_x, parts_y = [], []
    for kind, idx in zip(kinds, _allocate(rng, len(x_test), total, len(kinds))):
        sevs = rng.integers(1, 6, size=len(idx))
        corrupted = torch.empty((len(idx),) + source.shape[1:], dtype=torch.float32, device=dev)
        for sev in np.unique(sevs):
            rows = np.flatnonzero(sevs == sev)
            for s in range(0, len(rows), CHUNK):
                sel = rows[s: s + CHUNK]
                src = torch.from_numpy(idx[sel].astype(np.int64))
                corrupted[torch.from_numpy(sel).to(dev)] = corrupt(
                    source[src.to(dev)], kind, int(sev), seed, src)
        parts_x.append(corrupted)
        parts_y.append(y_test[idx])
    perm = rng.permutation(total)
    images = torch.cat(parts_x)[torch.from_numpy(perm).to(dev)]
    return images.cpu().numpy(), np.concatenate(parts_y)[perm]


def mnist_c_like(x_test, y_test, total: int = None, seed: int = 0, device: DeviceLike = None):
    """MNIST-C-equivalent corrupted set from nominal test images."""
    return corrupted_test_set(x_test, y_test, MNIST_C_KINDS, total=total, seed=seed, device=device)


def cifar10_c_like(x_test, y_test, total: int = None, seed: int = 0, device: DeviceLike = None):
    """CIFAR-10-C-equivalent corrupted set from nominal test images."""
    return corrupted_test_set(x_test, y_test, CIFAR10_C_KINDS, total=total, seed=seed,
                              device=device)
