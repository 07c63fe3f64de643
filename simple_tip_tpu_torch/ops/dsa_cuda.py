"""DSA's masked nearest neighbour: the CUDA kernel, its plain version, its counter.

Replaces the Pallas TPU kernel ``simple_tip_tpu/ops/dsa_pallas.py``
``_nearest_kernel`` (launched by ``_masked_nearest_call``): per query row,
``min_t max(|x|^2 + |t|^2 - 2 x.t, 0)`` over the training rows whose label
equals (``want_same``) or differs from the query's label, with the index of
the minimum (lowest index on ties; an all-masked row gives ``(inf, 0)``).

On this card it is bound by operations: a ``[C, D] x [D, N]`` product with
a row-min epilogue. The kernel (``csrc/dsa_nearest.cu``) multiplies on the
tensor cores in 3xTF32 (float32-accurate), keeps the distance tiles on chip
and folds them into per-block (min, argmin) partials, which a second kernel
reduces; see the source for the design. Up to ``FMA_FEATURES`` features
(``tensor_cores`` decides, and tells the kernel) it multiplies in float32
FMA chains in the plain version's order instead, and it re-scores each
row's winner that way, so the d2 it returns is the plain version's. D is
tiled, so unlike the TPU's VMEM-bound 2048-feature cap there is no cap on
the feature count.

The kernel reads the training rows sorted by class (``ClassLayout``, built
once per training set by ``class_layout``) and walks the training tiles
that a ``QueryPlan`` lists for each tile of queries. ``plan_queries`` (once
per batch of queries, for both searches) sorts the queries by class and
lists, per ``tile_plans``, the tiles of the query tile's classes for the
same-class search and all but the tiles holding only the query tile's one
class for the other-class search. Planning is host work that small
searches do not repay, so below ``PLAN_MIN_WORK`` (``worth_planning``) a
call takes ``full_walk`` instead: queries in their own order, every tile. Ties are broken on the
original index, so neither the sort nor the walk changes the result.

``masked_nearest`` launches the kernel for CUDA tensors and runs
``masked_nearest_plain`` for CPU tensors (which ignores the layout and the
query plan).
``LAUNCHES`` counts kernel launches (one per call of the C entry point)
and nothing else.
"""

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch import _build

LAUNCHES = 0
PLAIN_CHUNK = 1024  # query rows per distance matrix of the plain version
# The kernel's block tile, query rows by training rows (kBM x kBN in
# csrc/dsa_nearest.cu, which refuses a plan made for any other tile).
BLOCK_QUERIES, BLOCK_TRAIN = 128, 128
FMA_FEATURES = 32  # up to this many padded features the kernel multiplies in f32 FMAs
# Query rows x training rows x features below which a search is cheaper to
# walk in full than to plan: there the whole walk costs the card less than
# the plan costs the host (IMDB's 500 x 7,500 x 20 badges; PERF.md).
PLAN_MIN_WORK = 10**9
_BLOCKS_PER_SM = 8  # enough blocks in flight to fill the card


def tensor_cores(dim: int) -> bool:
    """Whether the kernel multiplies rows of ``dim`` features on the tensor
    cores (3xTF32) rather than in float32 FMA chains."""
    return -(-dim // 4) * 4 > FMA_FEATURES


@dataclass(frozen=True)
class ClassLayout:
    """Training rows sorted stably by class, as the kernel reads them.

    ``rows`` [N, D4] (D zero-padded to a multiple of 4 for 16-byte loads),
    ``sq`` their squared norms, ``labels`` (int32) and ``index`` (int32, the
    original row of each sorted row) on the rows' device; ``classes`` and
    ``offsets`` (int64 numpy arrays) give the sorted rows of class
    ``classes[i]`` as ``offsets[i]:offsets[i + 1]``.
    """

    rows: torch.Tensor
    sq: torch.Tensor
    labels: torch.Tensor
    index: torch.Tensor
    classes: np.ndarray
    offsets: np.ndarray


def _pad_features(x: torch.Tensor) -> torch.Tensor:
    pad = (-x.shape[1]) % 4
    return torch.nn.functional.pad(x, (0, pad)) if pad else x.contiguous()


def class_layout(
    train: torch.Tensor, train_sq: torch.Tensor, train_labels: torch.Tensor
) -> ClassLayout:
    """The class-sorted layout of a training set (built once per ``DSA``)."""
    order = torch.argsort(train_labels.long(), stable=True)
    labels = train_labels.index_select(0, order)
    classes, counts = np.unique(labels.cpu().numpy(), return_counts=True)
    return ClassLayout(
        rows=_pad_features(train.index_select(0, order)),
        sq=train_sq.index_select(0, order).contiguous(),
        labels=labels.to(torch.int32).contiguous(),
        index=order.to(torch.int32),
        classes=classes.astype(np.int64),
        offsets=np.concatenate([[0], np.cumsum(counts)]).astype(np.int64),
    )


def tile_plans(sorted_labels: np.ndarray, layout: ClassLayout) -> dict:
    """Per tile of ``BLOCK_QUERIES`` class-sorted queries, the training tiles
    (of ``BLOCK_TRAIN`` sorted rows) that each search visits: ``{want_same:
    int32 [tiles, 4]}``, rows ``(s0, e0, s1, e1)`` for tiles ``s0:e0`` then
    ``s1:e1``.

    Same class: the tiles that hold rows of the classes from the tile's
    first to its last label. Other class: every tile, except, where the
    query tile holds one class, the tiles that hold only that class.
    ``sorted_labels`` are the queries' labels in sorted order.
    """
    block_queries, block_train = BLOCK_QUERIES, BLOCK_TRAIN
    sorted_labels = np.asarray(sorted_labels, dtype=np.int64)
    n = sorted_labels.size
    n_train = int(layout.offsets[-1])
    n_tiles = -(-n_train // block_train)
    ends = np.minimum(np.arange(1, -(-n // block_queries) + 1) * block_queries, n)
    lo, hi = sorted_labels[::block_queries], sorted_labels[ends - 1]
    # sorted training rows [first, end) hold the classes lo..hi (empty if none)
    first = layout.offsets[np.searchsorted(layout.classes, lo, side="left")]
    end = layout.offsets[np.searchsorted(layout.classes, hi, side="right")]
    zero = np.zeros_like(first)
    s0 = first // block_train
    same = (s0, np.where(end > first, -(-end // block_train), s0), zero, zero)
    # tiles lying wholly inside rows [first, end) of the tile's one class
    inner_first = -(-first // block_train)
    inner_end = np.where(end == n_train, n_tiles, end // block_train)
    skip = (lo == hi) & (inner_first < inner_end)
    full = np.full_like(first, n_tiles)
    other = (zero, np.where(skip, inner_first, full), np.where(skip, inner_end, full), full)
    return {True: np.stack(same, axis=1).astype(np.int32),
            False: np.stack(other, axis=1).astype(np.int32)}


def visited_tiles(plan: np.ndarray) -> np.ndarray:
    """Training tiles each query tile of ``plan`` visits."""
    return (plan[:, 1] - plan[:, 0]) + (plan[:, 3] - plan[:, 2])


@dataclass(frozen=True)
class QueryPlan:
    """A batch of queries sorted stably by class, with both searches' tile
    plans: ``order`` (int32, the original row of each sorted query),
    ``plans`` (``tile_plans``), ``tile`` (the (query, training) tile they
    were made for), ``visits`` ({want_same: (total, most) training tiles a
    query tile visits}) and ``packed`` (the order and the same-class and
    other-class plans in one int32 tensor on the queries' device, so a
    batch costs one copy to the card)."""

    order: np.ndarray
    plans: dict
    tile: Tuple[int, int]
    visits: dict
    packed: torch.Tensor


def plan_queries(labels: np.ndarray, layout: ClassLayout, device: torch.device) -> QueryPlan:
    """The ``QueryPlan`` of queries with class ``labels`` (host integers)
    against ``layout``; a DSA score call builds one for its two searches.
    The copy to a card goes from pinned memory and does not wait for the
    card, so the score calls before it keep running."""
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable").astype(np.int32)
    plans = tile_plans(labels[order], layout)
    tiles = {same: visited_tiles(plan) for same, plan in plans.items()}
    visits = {same: (int(v.sum()), int(v.max(initial=0))) for same, v in tiles.items()}
    packed = torch.from_numpy(np.concatenate([order, plans[True].ravel(), plans[False].ravel()]))
    if device.type == "cuda":
        packed = packed.pin_memory().to(device, non_blocking=True)
    return QueryPlan(order, plans, (BLOCK_QUERIES, BLOCK_TRAIN), visits, packed)


def worth_planning(n_query: int, n_train: int, dim: int) -> bool:
    """Whether a search of this size repays its ``plan_queries``."""
    return n_query * n_train * dim >= PLAN_MIN_WORK


@functools.lru_cache(maxsize=16)
def _full_walk(n_query: int, n_train: int, device: torch.device, tile: Tuple[int, int]):
    block_queries, block_train = tile
    n_tiles = -(-n_train // block_train)
    plan = np.zeros((-(-n_query // block_queries), 4), np.int32)
    plan[:, 1] = n_tiles
    order = np.arange(n_query, dtype=np.int32)
    visits = (plan.shape[0] * n_tiles, n_tiles)
    packed = torch.from_numpy(np.concatenate([order, plan.ravel(), plan.ravel()])).to(device)
    return QueryPlan(order, {True: plan, False: plan}, tile, {True: visits, False: visits},
                     packed)


def full_walk(n_query: int, n_train: int, device: torch.device) -> QueryPlan:
    """The ``QueryPlan`` that visits every training tile for every tile of
    ``n_query`` queries in their own order (the kernel's masks then keep the
    allowed pairs); built once per size and device."""
    return _full_walk(n_query, n_train, device, (BLOCK_QUERIES, BLOCK_TRAIN))


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


def _launch(x, x_labels, train, train_sq, train_labels, want_same, layout, queries):
    global LAUNCHES
    n_query, dim = x.shape
    n_train = train.shape[0]
    if n_train == 0:
        raise ValueError("masked nearest needs at least one training row")
    dev = x.device
    floats = (x, train, train_sq)
    ints = (x_labels, train_labels)
    for t in floats + ints:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("masked nearest takes contiguous tensors on one card")
    if any(t.dtype != torch.float32 for t in floats) or any(t.dtype != torch.int32 for t in ints):
        raise ValueError("masked nearest takes float32 rows and norms, int32 labels")
    if train.shape[1] != dim or train_sq.shape != (n_train,) or train_labels.shape != (n_train,):
        raise ValueError("masked nearest: training operands disagree in shape")
    if x_labels.shape != (n_query,):
        raise ValueError("masked nearest: one label per query row")
    if layout is None:
        layout = class_layout(train, train_sq, train_labels)
    elif layout.rows.device != dev or layout.rows.shape[0] != n_train:
        raise ValueError("masked nearest: the class layout is not of these training rows")
    out_min = torch.empty(n_query, dtype=torch.float32, device=dev)
    out_arg = torch.empty(n_query, dtype=torch.int32, device=dev)
    if n_query == 0:
        return out_min, out_arg
    if queries is None:
        queries = full_walk(n_query, n_train, dev)
    elif queries.order.shape != (n_query,) or queries.packed.device != dev:
        raise ValueError("masked nearest: the query plan is not of these queries")
    total, most = queries.visits[want_same]
    per_block = max(1, -(-total // (_build.sm_count(x.get_device()) * _BLOCKS_PER_SM)))
    n_split = max(1, -(-most // per_block))
    order_ptr = queries.packed.data_ptr()
    plan_ptr = order_ptr + 4 * (n_query + (0 if want_same else queries.plans[True].size))
    x_sq = (x * x).sum(dim=1)
    xp = _pad_features(x)
    part = torch.empty(2, n_split, n_query, dtype=torch.int32, device=dev)  # min, arg
    err = _build.launch(
        x.get_device(), _build.library().tip_dsa_nearest,
        xp.data_ptr(), x_sq.data_ptr(), x_labels.data_ptr(), n_query,
        layout.rows.data_ptr(), layout.sq.data_ptr(), layout.labels.data_ptr(),
        layout.index.data_ptr(), n_train, xp.shape[1], int(want_same),
        int(tensor_cores(dim)), plan_ptr, *queries.tile, per_block, n_split, order_ptr,
        x.data_ptr(), train.data_ptr(), train_sq.data_ptr(), dim,
        part.data_ptr(), part.data_ptr() + 4 * n_split * n_query,
        out_min.data_ptr(), out_arg.data_ptr(),
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
    layout: Optional[ClassLayout] = None,
    queries: Optional[QueryPlan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(min_d2 [C] float32, argmin [C] int32)`` of query rows ``x`` against
    the class-masked training rows.

    ``train_sq`` holds the training rows' squared norms; labels are int32;
    ``layout`` is ``class_layout`` of the training operands (built here per
    call where it is not given) and ``queries`` ``plan_queries`` of
    ``x_labels`` (where it is not given, the kernel takes ``full_walk``).
    CUDA tensors go through the kernel (or raise); CPU tensors through the
    plain version, which ignores the layout and the plan.
    """
    if x.device.type == "cuda":
        return _launch(x, x_labels, train, train_sq, train_labels, want_same, layout, queries)
    if x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return masked_nearest_plain(x, x_labels, train, train_sq, train_labels, want_same)
