"""DSA's masked nearest neighbour: the CUDA kernel, its plain version, its counter.

Replaces the Pallas TPU kernel ``simple_tip_tpu/ops/dsa_pallas.py``
``_nearest_kernel`` (launched by ``_masked_nearest_call``): per query row,
``min_t max(|x|^2 + |t|^2 - 2 x.t, 0)`` over the training rows whose label
equals (``want_same``) or differs from the query's label, with the index of
the minimum (lowest index on ties; an all-masked row gives ``(inf, 0)``).

On this card it is bound by operations: a ``[C, D] x [D, N]`` product with a
row-min epilogue. The kernel (``csrc/dsa_nearest.cu``) tiles queries x
training rows over blocks, keeps the distance tiles on chip and folds them
into per-block (min, argmin) partials, which a second kernel reduces; see
the source for the design. D is tiled, so unlike the TPU's VMEM-bound
2048-feature cap there is no cap on the feature count.

``masked_nearest`` launches the kernel for CUDA tensors and runs
``masked_nearest_plain`` for CPU tensors. ``LAUNCHES`` counts kernel
launches (one per call of the C entry point) and nothing else.
"""

from typing import Tuple

import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
PLAIN_CHUNK = 1024  # query rows per distance matrix of the plain version
_BM, _BN = 64, 64  # the kernel's block tile
_BLOCKS_PER_SM = 8  # enough blocks in flight to fill the card


def masked_nearest_plain(
    x: torch.Tensor,
    x_labels: torch.Tensor,
    train: torch.Tensor,
    train_sq: torch.Tensor,
    train_labels: torch.Tensor,
    want_same: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function as chunked distance matrices (the JAX package's
    XLA formulation of DSA, ``ops/surprise.py`` ``_prepare_device``)."""
    x_sq = (x * x).sum(dim=1)
    mins, args = [], []
    for start in range(0, x.shape[0], PLAIN_CHUNK):
        xb = x[start : start + PLAIN_CHUNK]
        d2 = x_sq[start : start + PLAIN_CHUNK, None] + train_sq[None, :] - 2.0 * (xb @ train.T)
        d2 = torch.clamp_min(d2, 0.0)
        same = x_labels[start : start + PLAIN_CHUNK, None] == train_labels[None, :]
        d2 = torch.where(same if want_same else ~same, d2, torch.inf)
        mins.append(d2.min(dim=1).values)
        args.append(d2.argmin(dim=1).to(torch.int32))
    return torch.cat(mins), torch.cat(args)


def _launch(x, x_labels, train, train_sq, train_labels, want_same):
    global LAUNCHES
    n_query, dim = x.shape
    n_train = train.shape[0]
    if n_train == 0:
        raise ValueError("masked nearest needs at least one training row")
    floats = (x, train, train_sq)
    ints = (x_labels, train_labels)
    for t in floats + ints:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("masked nearest takes contiguous tensors on one card")
    if any(t.dtype != torch.float32 for t in floats) or any(t.dtype != torch.int32 for t in ints):
        raise ValueError("masked nearest takes float32 rows and norms, int32 labels")
    if train.shape[1] != dim or train_sq.shape != (n_train,) or train_labels.shape != (n_train,):
        raise ValueError("masked nearest: training operands disagree in shape")
    if x_labels.shape != (n_query,):
        raise ValueError("masked nearest: one label per query row")
    out_min = torch.empty(n_query, dtype=torch.float32, device=x.device)
    out_arg = torch.empty(n_query, dtype=torch.int32, device=x.device)
    if n_query == 0:
        return out_min, out_arg
    x_sq = (x * x).sum(dim=1)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_blocks = -(-n_query // _BM)
    n_tiles = -(-n_train // _BN)
    n_split = max(1, min(n_tiles, -(-sms * _BLOCKS_PER_SM // row_blocks)))
    part_min = torch.empty(n_split, n_query, dtype=torch.float32, device=x.device)
    part_arg = torch.empty(n_split, n_query, dtype=torch.int32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tip_dsa_nearest(
            x.data_ptr(), x_sq.data_ptr(), x_labels.data_ptr(), n_query,
            train.data_ptr(), train_sq.data_ptr(), train_labels.data_ptr(), n_train,
            dim, int(want_same), n_split,
            part_min.data_ptr(), part_arg.data_ptr(),
            out_min.data_ptr(), out_arg.data_ptr(), stream,
        )
    _build.check(err, "tip_dsa_nearest")
    LAUNCHES += 1
    return out_min, out_arg


def masked_nearest(
    x: torch.Tensor,
    x_labels: torch.Tensor,
    train: torch.Tensor,
    train_sq: torch.Tensor,
    train_labels: torch.Tensor,
    want_same: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min_d2 [C] float32, argmin [C] int32)`` of query rows ``x`` against
    the class-masked training rows.

    ``train_sq`` holds the training rows' squared norms; labels are int32.
    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version.
    """
    if x.device.type == "cuda":
        return _launch(x, x_labels, train, train_sq, train_labels, want_same)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return masked_nearest_plain(x, x_labels, train, train_sq, train_labels, want_same)
