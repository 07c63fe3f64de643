"""Analytic FLOPs and HBM-byte counts, and the card's peaks, for MFU.

Counterpart of the JAX package's ``utils/flops.py``: the same analytic
counts, integer for integer.

- ``conv_net_forward_flops`` — analytic matmul/conv FLOPs (2·MACs
  convention) for the case-study convnets, layer by layer, matching the
  architectures in ``models/convnet.py``. Elementwise work (relu, pooling,
  softmax, uncertainty quantifiers) is excluded, the standard MFU
  convention.
- ``transformer_forward_flops`` — the IMDB transformer's matmul FLOPs
  (embed excluded: gather, not matmul; attention scored at 2·2·T²·D plus
  projections).
- ``training_step_flops`` — fwd + bwd ≈ 3× forward.
- ``conv_net_forward_hbm_bytes`` — the mandatory HBM bytes per input of a
  convnet forward whose layers write and read their activations.
- ``coverage_hbm_bytes`` — the mandatory HBM bytes per input of the fused
  chain's coverage metrics (the port's own: the JAX package read the
  chain's bytes from XLA's cost analysis).
- ``peak_flops`` / ``hbm_peak_bytes`` — the card's peaks from ``CARD_PEAKS``
  and a nominal CPU core. The table assumes no chip: a device kind that is
  not in it gets no peak (None) and a label that says so. Its one card is
  the NVIDIA H100 SXM (``NVIDIA H100 80GB HBM3``): HBM3 at 3.35e12 B/s and
  165e12 FLOP/s, the 3xTF32 tensor-core rate (three TF32 products a
  multiply-add: the precision kernels B1-B6 compute in), not the 67e12
  FLOP/s f32 FMA rate. The PCIe and NVL parts have other peaks and are not
  in the table.
- ``mfu`` — achieved / peak with the lookup applied (None without a peak).
"""

from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Analytic per-input forward FLOPs
# ---------------------------------------------------------------------------


def conv2d_flops(h_out: int, w_out: int, c_out: int, kh: int, kw: int, c_in: int) -> int:
    """2·MACs for one VALID conv layer at one input."""
    return 2 * h_out * w_out * c_out * kh * kw * c_in


def dense_flops(n_in: int, n_out: int) -> int:
    """FLOPs of one dense layer forward (multiply-add counted as 2)."""
    return 2 * n_in * n_out


def conv_net_forward_flops(model: str = "mnist") -> int:
    """Per-input forward matmul/conv FLOPs for the case-study convnets.

    Shapes follow VALID-padding arithmetic exactly; see models/convnet.py
    for the layer list these mirror.
    """
    if model in ("mnist", "fmnist"):
        # 28x28x1 -> conv 32 3x3 -> 26x26x32 -> pool -> 13x13x32
        #         -> conv 64 3x3 -> 11x11x64 -> pool -> 5x5x64 = 1600
        #         -> dense 10
        return (
            conv2d_flops(26, 26, 32, 3, 3, 1)
            + conv2d_flops(11, 11, 64, 3, 3, 32)
            + dense_flops(5 * 5 * 64, 10)
        )
    if model == "cifar10":
        # 32x32x3 -> conv 32 -> 30x30x32 -> pool -> 15x15x32
        #         -> conv 64 -> 13x13x64 -> pool -> 6x6x64
        #         -> conv 64 -> 4x4x64 = 1024 -> dense 64 -> dense 10
        return (
            conv2d_flops(30, 30, 32, 3, 3, 3)
            + conv2d_flops(13, 13, 64, 3, 3, 32)
            + conv2d_flops(4, 4, 64, 3, 3, 64)
            + dense_flops(4 * 4 * 64, 64)
            + dense_flops(64, 10)
        )
    raise ValueError(f"no FLOPs model for {model!r}")


def transformer_forward_flops(
    seq_len: int = 100,
    d_model: int = 32,
    n_heads: int = 2,
    d_ff: int = 32,
    n_layers: int = 1,
    pooled_dense: Sequence[Tuple[int, int]] = ((32, 20), (20, 2)),
) -> int:
    """Per-input matmul FLOPs for the IMDB transformer (embedding gather
    excluded — it is a memory op). Defaults mirror models/transformer.py's
    keras-parity configuration (reference: case_study_imdb.py), including
    the Keras ``key_dim=embed_dim`` quirk: total qkv width is
    ``n_heads * d_model``, wider than the residual stream."""
    qkv = n_heads * d_model
    per_layer = (
        # q, k, v projections d_model->qkv, out projection qkv->d_model
        (3 * dense_flops(d_model, qkv) + dense_flops(qkv, d_model)) * seq_len
        + 2 * 2 * seq_len * seq_len * qkv  # scores + values matmuls
        + (dense_flops(d_model, d_ff) + dense_flops(d_ff, d_model)) * seq_len
    )
    head = sum(dense_flops(i, o) for i, o in pooled_dense)
    return n_layers * per_layer + head


def training_step_flops(forward_flops_per_input: int, batch: int) -> int:
    """fwd+bwd ≈ 3× forward (each forward matmul costs two in backward)."""
    return 3 * forward_flops_per_input * batch


# ---------------------------------------------------------------------------
# Analytic per-input HBM traffic (roofline denominator)
# ---------------------------------------------------------------------------


def conv_net_forward_hbm_bytes(
    model: str = "mnist", act_bytes: int = 2, in_bytes: int = 4
) -> int:
    """Mandatory HBM bytes per input for the convnet forward.

    Counts: input read once + each layer's activation written once and read
    once by its consumer (the roofline accounting for a layer pipeline that
    materializes its activations, as the module forward and the fused chain
    do; a fused kernel that keeps them on chip moves less). Weights are
    excluded: they are read once per *batch*. The port's activations are
    f32: pass ``act_bytes=4``.
    """
    if model in ("mnist", "fmnist"):
        # activation element counts along models/convnet.py's forward
        acts = [26 * 26 * 32, 13 * 13 * 32, 11 * 11 * 64, 5 * 5 * 64, 10]
        inp = 28 * 28 * 1
    elif model == "cifar10":
        acts = [
            30 * 30 * 32,
            15 * 15 * 32,
            13 * 13 * 64,
            6 * 6 * 64,
            4 * 4 * 64,
            64,
            10,
        ]
        inp = 32 * 32 * 3
    else:
        raise ValueError(f"no HBM model for {model!r}")
    return inp * in_bytes + 2 * act_bytes * sum(acts)


def _score_bytes(bits: int) -> int:
    """Bytes of one coverage score: the smallest integer type that holds
    ``bits`` (``ops/coverage.sum_score``'s rule)."""
    if bits <= 2**15 - 1:
        return 2
    return 4 if bits <= 2**31 - 1 else 8


def coverage_hbm_bytes(taps: int, profile_bits: Sequence[int]) -> int:
    """Mandatory HBM bytes per input of the fused chain's coverage metrics.

    Counts: the input's ``taps`` f32 tap activations read once (by all the
    metrics together, as a fused pass would), and each metric's profile of
    ``profile_bits`` bits written once as packed 32-bit words, with its
    score. The per-neuron thresholds are read once a dispatch, not once an
    input, and are not counted here.
    """
    total = 4 * int(taps)
    for bits in profile_bits:
        total += 4 * -(-int(bits) // 32) + _score_bytes(int(bits))
    return total


#: The cards with known peaks: (lowercase device-kind substring, FLOP/s,
#: HBM bytes/s, label). The H100 SXM's FLOP/s is its dense TF32 tensor-core
#: rate over three products a multiply-add (3xTF32).
CARD_PEAKS = (
    (
        "h100 80gb hbm3",
        165e12,
        3.35e12,
        "NVIDIA H100 SXM 3xTF32 tensor-core peak (495e12 TF32 / 3), HBM3 3.35e12 B/s",
    ),
)


def _card(device_kind: str):
    kind = (device_kind or "").lower()
    for needle, flops, hbm, label in CARD_PEAKS:
        if needle in kind:
            return flops, hbm, label
    return None


def hbm_peak_bytes(device_kind: str = ""):
    """(peak_bytes_per_sec, label) for one card; (None, label) when the
    device kind is not in ``CARD_PEAKS``: no card is assumed."""
    card = _card(device_kind)
    if card is not None:
        return card[1], f"HBM bandwidth for {device_kind!r} ({card[2]})"
    return None, f"no HBM peak: device kind {device_kind!r} is not in the table"


# Nominal one-core x86 f32 peak: 2 FMA ports x 8 f32 lanes x 2 flops x ~3GHz.
_CPU_CORE_PEAK_F32 = 96e9


def peak_flops(platform: str, device_kind: str = "", cores: int = 1):
    """(peak_flop_per_sec, label) for one card or ``cores`` CPU cores;
    (None, label) for a device kind that is not in ``CARD_PEAKS``."""
    if platform == "cpu":
        return _CPU_CORE_PEAK_F32 * max(1, cores), (
            f"nominal {max(1, cores)}-core x86 f32 peak (2 FMA x 8 lanes x 3GHz/core)"
        )
    card = _card(device_kind)
    if card is not None:
        return card[0], card[2]
    return None, f"no FLOP/s peak: device kind {device_kind!r} is not in the table"


def mfu(
    achieved_flops_per_sec: float,
    platform: str,
    device_kind: str = "",
    cores: int = 1,
) -> Tuple[float, float, str]:
    """(mfu, peak, peak_label); mfu = achieved / nominal peak, and
    (None, None, label) when the device has no peak in the table."""
    peak, label = peak_flops(platform, device_kind, cores)
    if peak is None:
        return None, None, label
    return achieved_flops_per_sec / peak, peak, label
