"""Port parity for kernel B2 (DSA's masked nearest neighbour) and for DSA.

On the CPU the port's DSA runs the kernel's plain version; it is held
against the JAX package's ``DSA`` on its XLA path (``use_pallas=False``)
and against ``PallasDSABackend.score(..., interpret=True)`` with CHUNK and
TILE shrunk so that several tiles accumulate, at rtol 1e-4, including
classes that the 30% training subsample misses (DSA = inf there on both
sides). The kernel's class-sorted walk (``class_layout``, ``plan_queries``)
is emulated here in plain torch, tile by tile in the kernel's order, and
held against the plain version and the Pallas kernel in interpret mode on
integer-valued features, where every distance is exact and ties are
common. The CUDA kernel is held against the plain version on the card in
``test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simple_tip_tpu.ops import dsa_pallas
from simple_tip_tpu.ops.surprise import DSA as JaxDSA
from simple_tip_tpu_torch.ops import dsa_cuda
from simple_tip_tpu_torch.ops import surprise as port_surprise
from simple_tip_tpu_torch.ops.surprise import DSA, subsample_indices
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

INT_MAX = 2**31 - 1


def _data(seed: int = 0):
    rng = np.random.RandomState(seed)
    acts = rng.random((384, 32)).astype(np.float32)
    labels = rng.randint(0, 4, size=384)
    kept = subsample_indices(0.3, 384, 0)
    missed = np.setdiff1d(np.arange(384), kept)[:2]
    labels[missed] = 4  # a class that the 30% subsample misses
    test = rng.random((200, 32)).astype(np.float32)
    tlabels = rng.randint(0, 5, size=200)
    return acts, labels, test, tlabels


@pytest.mark.parametrize("subsampling", [1.0, 0.3])
def test_plain_dsa_matches_jax_xla_path(subsampling):
    acts, labels, test, tlabels = _data()
    ref = JaxDSA(acts, labels, subsampling=subsampling)
    ref.use_pallas = False
    want = ref(test, tlabels)
    got = DSA(torch.from_numpy(acts), labels, subsampling=subsampling)(
        torch.from_numpy(test), tlabels
    )
    assert got.dtype == np.float64 == want.dtype
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    if subsampling < 1:
        kept = labels[subsample_indices(subsampling, len(labels), 0)]
        assert 4 not in kept and np.isinf(got[tlabels == 4]).all()


def test_plain_dsa_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(dsa_pallas, "CHUNK", 128)
    monkeypatch.setattr(dsa_pallas, "TILE", 128)
    acts, labels, test, tlabels = _data(1)
    ref = JaxDSA(acts, labels, subsampling=0.3)
    backend = dsa_pallas.PallasDSABackend(ref.train_activations, ref.train_predictions)
    want = backend.score(test, tlabels, interpret=True)
    port = DSA(torch.from_numpy(acts), labels, subsampling=0.3)
    np.testing.assert_array_equal(port.rows.numpy(), ref.train_activations - port.mean.numpy())
    got = port(torch.from_numpy(test), tlabels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_plain_nearest_ties_and_masked_rows():
    train = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [5.0, 5.0]])
    train_sq = (train * train).sum(1)
    train_labels = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    x = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    labels = torch.tensor([0, 7], dtype=torch.int32)
    d2, idx = dsa_cuda.masked_nearest(x, labels, train, train_sq, train_labels, True)
    assert idx.dtype == torch.int32
    assert idx.tolist() == [0, 0]  # tie between rows 0 and 2 -> 0; all masked -> 0
    assert d2[0].item() == 0.0 and torch.isinf(d2[1])
    d2, idx = dsa_cuda.masked_nearest(x, labels, train, train_sq, train_labels, False)
    assert idx.tolist() == [3, 0]



def test_centred_searches_stay_accurate_far_from_the_origin():
    """Traces with a large common offset: the port centres them before the
    float32 d^2 expansion, so DSA agrees with a float64 DSA to rtol 1e-5
    (the uncentred expansion cancels to ~1e-2 here)."""
    rng = np.random.default_rng(3)
    offset = rng.uniform(5, 10, size=20)
    acts = (offset + rng.normal(0, 0.05, size=(300, 20))).astype(np.float32)
    labels = rng.integers(0, 3, size=300)
    test = (offset + rng.normal(0, 0.05, size=(80, 20))).astype(np.float32)
    tlabels = rng.integers(0, 3, size=80)
    got = DSA(torch.from_numpy(acts), labels, badge_size=16)(torch.from_numpy(test), tlabels)
    train, x = acts.astype(np.float64), test.astype(np.float64)
    d2 = ((x[:, None] - train[None]) ** 2).sum(-1)
    same = tlabels[:, None] == labels[None]
    nearest = np.where(same, d2, np.inf).argmin(1)
    a = np.sqrt(np.where(same, d2, np.inf).min(1))
    d2b = ((train[nearest][:, None] - train[None]) ** 2).sum(-1)
    b = np.sqrt(np.where(~same, d2b, np.inf).min(1))
    np.testing.assert_allclose(got, a / b, rtol=1e-5, atol=0)


def test_distances_are_exact_where_the_classes_lie_far_apart():
    """Classes far apart relative to their spread, as in a trained model's
    traces: centring leaves |x|^2 / d^2 near 500, where the float32
    expansion alone is off the float64 DSA by ~1e-4. The port recomputes
    the chosen rows' distances as |x - t|, so DSA agrees with a float64
    DSA to rtol 1e-5 wherever the nearest row is not a near tie (best and
    second best more than 1e-4 apart); at a near tie either row is
    nearest within float32 rounding."""
    rng = np.random.default_rng(5)
    centres = rng.normal(0, 3, size=(4, 64))
    labels = rng.integers(0, 4, size=400)
    acts = (centres[labels] + rng.normal(0, 0.1, size=(400, 64))).astype(np.float32)
    tlabels = rng.integers(0, 4, size=200)
    test = (centres[tlabels] + rng.normal(0, 0.1, size=(200, 64))).astype(np.float32)
    got = DSA(torch.from_numpy(acts), labels)(torch.from_numpy(test), tlabels)
    train, x = acts.astype(np.float64), test.astype(np.float64)
    same = tlabels[:, None] == labels[None]
    d = np.sqrt(np.where(same, ((x[:, None] - train[None]) ** 2).sum(-1), np.inf))
    nearest = d.argmin(1)
    a = d.min(1)
    db = np.sqrt(((train[nearest][:, None] - train[None]) ** 2).sum(-1))
    b = np.where(~same, db, np.inf).min(1)
    ranked = np.sort(d, axis=1)
    clear = (ranked[:, 1] - ranked[:, 0]) > 1e-4 * ranked[:, 0]
    assert clear.mean() > 0.9
    np.testing.assert_allclose(got[clear], (a / b)[clear], rtol=1e-5, atol=0)


def _better(v, i, bv, bi):
    return (v < bv) | ((v == bv) & (i < bi))


def _emulated_nearest(x, x_labels, train, train_sq, train_labels, want_same, layout,
                      queries=None, per_block=3):
    """The kernel's walk in plain torch: queries sorted by class (the query
    plan, built here where not given), per query tile only the planned
    training tiles of the layout (at the plan's tile), split into blocks of
    ``per_block`` tiles, each block's (min, original index) folded
    lexicographically, the blocks reduced, results scattered back."""
    if queries is None:
        queries = dsa_cuda.plan_queries(x_labels.numpy(), layout, x.device)
    block_q, block_t = queries.tile
    order = torch.from_numpy(queries.order).long()
    assert torch.equal(queries.packed[: len(order)].long(), order)
    plan = queries.plans[want_same]
    xs, xl = x[order], x_labels[order]
    xs_sq = (x * x).sum(1)[order]
    n_train, dim = train.shape
    out_min = torch.full((x.shape[0],), torch.inf)
    out_arg = torch.zeros(x.shape[0], dtype=torch.int32)
    for qt, (s0, e0, s1, e1) in enumerate(plan.tolist()):
        rows = slice(qt * block_q, (qt + 1) * block_q)
        tiles = [*range(s0, e0), *range(s1, e1)]
        v = torch.full((xs[rows].shape[0],), torch.inf)
        vi = torch.full_like(v, INT_MAX, dtype=torch.int64)
        for b0 in range(0, len(tiles), per_block):  # one block of the grid
            bv, bi = torch.full_like(v, torch.inf), torch.full_like(vi, INT_MAX)
            for tile in tiles[b0 : b0 + per_block]:
                cols = slice(tile * block_t, min((tile + 1) * block_t, n_train))
                dot = xs[rows] @ layout.rows[cols, :dim].T
                d2 = torch.clamp_min(xs_sq[rows, None] + layout.sq[None, cols] - 2.0 * dot, 0.0)
                allowed = (xl[rows, None] == layout.labels[None, cols]) == want_same
                idx = layout.index[cols].long().expand_as(d2)
                d2 = torch.where(allowed, d2, torch.inf)
                idx = torch.where(allowed, idx, INT_MAX)
                tv = d2.min(1).values
                ti = torch.where(d2 == tv[:, None], idx, INT_MAX).min(1).values
                take = _better(tv, ti, bv, bi)
                bv, bi = torch.where(take, tv, bv), torch.where(take, ti, bi)
            take = _better(bv, bi, v, vi)
            v, vi = torch.where(take, bv, v), torch.where(take, bi, vi)
        out_min[order[rows]] = v
        out_arg[order[rows]] = torch.where(torch.isinf(v), 0, vi).to(torch.int32)
    return out_min, out_arg


def _small_tiles(monkeypatch):
    """Plans of 8 queries x 8 training rows, so that the small cases span
    several tiles (the card's kernel refuses any tile but its own)."""
    monkeypatch.setattr(dsa_cuda, "BLOCK_QUERIES", 8)
    monkeypatch.setattr(dsa_cuda, "BLOCK_TRAIN", 8)


def _plan_case(name):
    """Integer-valued rows (exact distances, many ties) for one plan case,
    sized for ``_small_tiles``."""
    rng = np.random.default_rng(PLAN_CASES.index(name))
    if name == "ties_across_a_class_boundary":
        labels = np.repeat([0, 1, 2], [5, 6, 13])
        train = rng.integers(0, 3, size=(24, 4))
        train[[4, 5, 11]] = train[0]  # one row in classes 0, 0, 1 and 2
        perm = rng.permutation(24)  # so that sorted and original order differ
        train, labels = train[perm], labels[perm]
        x_labels = np.array([2] * 9 + [0] * 3)
        x = rng.integers(0, 3, size=(12, 4))
        x[:4] = train[0]  # class-2 queries whose nearest other-class rows tie
    elif name == "a_class_without_training_rows":
        labels = rng.integers(0, 3, size=30)
        labels[labels == 1] = 2
        train = rng.integers(0, 4, size=(30, 5))
        x_labels = rng.integers(0, 3, size=20)
        x = rng.integers(0, 4, size=(20, 5))
    elif name == "a_class_filling_whole_tiles":
        labels = np.repeat([0, 1, 2], [16, 8, 13])
        rng.shuffle(labels)
        train = rng.integers(0, 3, size=(37, 4))
        x_labels = np.array([1] * 9 + [0] * 8 + [2] * 3)
        x = rng.integers(0, 3, size=(20, 4))
    elif name == "ten_classes":
        labels = rng.integers(0, 10, size=200)
        train = rng.integers(0, 4, size=(200, 6))
        x_labels = rng.integers(0, 10, size=90)
        x = rng.integers(0, 4, size=(90, 6))
    else:  # "rows_not_a_multiple_of_the_tile"
        labels = rng.integers(0, 4, size=53)
        train = rng.integers(0, 3, size=(53, 3))
        x_labels = rng.integers(0, 4, size=29)
        x = rng.integers(0, 3, size=(29, 3))
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    return f32(x), i32(x_labels), f32(train), i32(labels)


PLAN_CASES = [
    "ties_across_a_class_boundary",
    "a_class_without_training_rows",
    "a_class_filling_whole_tiles",
    "ten_classes",
    "rows_not_a_multiple_of_the_tile",
]


def _jax_nearest(x, x_labels, train, train_sq, train_labels, want_same):
    """The Pallas kernel in interpret mode, training rows padded to its tile
    as ``PallasDSABackend`` pads them (+inf norms, label -2)."""
    n, d = train.shape
    n_pad = -(-n // dsa_pallas.TILE) * dsa_pallas.TILE
    t = np.zeros((n_pad, d), np.float32)
    t[:n] = train.numpy()
    tsq = np.full(n_pad, np.inf, np.float32)
    tsq[:n] = train_sq.numpy()
    tlab = np.full(n_pad, -2, np.int32)
    tlab[:n] = train_labels.numpy()
    got = dsa_pallas._masked_nearest_call(
        jnp.asarray(x.numpy()), jnp.asarray(x_labels.numpy()), jnp.asarray(t),
        jnp.asarray(tsq), jnp.asarray(tlab), want_same, interpret=True)
    return tuple(np.asarray(a) for a in got)


@pytest.mark.parametrize("want_same", [True, False], ids=["same", "other"])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_planned_walk_matches_plain_and_pallas(case, want_same, monkeypatch):
    _small_tiles(monkeypatch)
    x, x_labels, train, labels = _plan_case(case)
    train_sq = (train * train).sum(1)
    layout = dsa_cuda.class_layout(train, train_sq, labels)
    args = (x, x_labels, train, train_sq, labels, want_same)
    got_min, got_arg = _emulated_nearest(*args, layout, per_block=2)
    want_min, want_arg = dsa_cuda.masked_nearest_plain(*args)
    assert torch.equal(got_min, want_min) and torch.equal(got_arg, want_arg)
    jax_min, jax_arg = _jax_nearest(*args)
    np.testing.assert_array_equal(got_min.numpy(), jax_min)
    np.testing.assert_array_equal(got_arg.numpy(), jax_arg)


@pytest.mark.parametrize("want_same", [True, False], ids=["same", "other"])
@pytest.mark.parametrize("case", PLAN_CASES)
def test_full_walk_matches_plain(case, want_same, monkeypatch):
    """The walk a search below ``PLAN_MIN_WORK`` takes: queries in their own
    order, every training tile, the masks keeping the allowed pairs."""
    _small_tiles(monkeypatch)
    x, x_labels, train, labels = _plan_case(case)
    train_sq = (train * train).sum(1)
    layout = dsa_cuda.class_layout(train, train_sq, labels)
    walk = dsa_cuda.full_walk(len(x), len(train), x.device)
    n_tiles = -(-len(train) // 8)
    assert walk.tile == (8, 8) and walk.visits[want_same] == (-(-len(x) // 8) * n_tiles, n_tiles)
    np.testing.assert_array_equal(walk.order, np.arange(len(x)))
    args = (x, x_labels, train, train_sq, labels, want_same)
    got_min, got_arg = _emulated_nearest(*args, layout, walk, per_block=2)
    want_min, want_arg = dsa_cuda.masked_nearest_plain(*args)
    assert torch.equal(got_min, want_min) and torch.equal(got_arg, want_arg)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_skips_only_tiles_without_allowed_pairs(case, monkeypatch):
    """Every skipped (query tile, training tile) holds no allowed pair, and
    the two searches together visit fewer tiles than two full walks."""
    _small_tiles(monkeypatch)
    x, x_labels, train, labels = _plan_case(case)
    layout = dsa_cuda.class_layout(train, (train * train).sum(1), labels)
    np.testing.assert_array_equal(np.sort(layout.index.numpy()), np.arange(len(labels)))
    assert torch.equal(layout.labels, labels[layout.index.long()])
    assert torch.equal(layout.rows[:, : train.shape[1]], train[layout.index.long()])
    xl = np.sort(x_labels.numpy(), kind="stable")
    n_tiles = -(-len(labels) // 8)
    n_qt = -(-len(xl) // 8)
    visits = 0
    for want_same in (True, False):
        plan = dsa_cuda.tile_plans(xl, layout)[want_same]
        assert plan.dtype == np.int32 and plan.shape == (n_qt, 4)
        visits += int(dsa_cuda.visited_tiles(plan).sum())
        for qt, (s0, e0, s1, e1) in enumerate(plan.tolist()):
            planned = {*range(s0, e0), *range(s1, e1)}
            assert planned <= set(range(n_tiles))
            q = xl[qt * 8 : (qt + 1) * 8]
            for tile in set(range(n_tiles)) - planned:
                t = layout.labels[tile * 8 : (tile + 1) * 8].numpy()
                allowed = (q[:, None] == t[None, :]) == want_same
                assert not allowed.any(), (want_same, qt, tile)
    assert visits < 2 * n_qt * n_tiles
    if case == "a_class_filling_whole_tiles":
        other = dsa_cuda.tile_plans(xl, layout)[False]
        # query tile 0 holds only class 0, whose 16 rows are sorted tiles 0 and 1
        assert other[0].tolist() == [0, 0, 2, n_tiles]
        same = dsa_cuda.tile_plans(xl, layout)[True]
        assert same[0].tolist() == [0, 2, 0, 0]


@pytest.mark.parametrize("queries,rows", [(10_000, 18_000), (10_000, 15_000)], ids=["mnist", "cifar10"])
def test_plan_halves_the_work_at_the_paths_sizes(queries, rows):
    """At the convnet paths' sizes (10 classes, the kernel's real tiles) the
    two searches of a score call visit about half the tiles of two full
    walks: each (query, training row) pair about once."""
    rng = np.random.default_rng(queries + rows)
    labels = torch.from_numpy(rng.integers(0, 10, size=rows).astype(np.int32))
    train = torch.zeros(rows, 1)
    layout = dsa_cuda.class_layout(train, train[:, 0], labels)
    xl = np.sort(rng.integers(0, 10, size=queries), kind="stable")
    visits = sum(int(dsa_cuda.visited_tiles(plan).sum())
                 for plan in dsa_cuda.tile_plans(xl, layout).values())
    full = -(-queries // dsa_cuda.BLOCK_QUERIES) * -(-rows // dsa_cuda.BLOCK_TRAIN)
    assert 0.5 * full <= visits <= 0.56 * (2 * full)


def test_dsa_with_the_class_layout_matches_plain_and_jax(monkeypatch):
    """The slice's DSA with every search walked as the kernel walks it (the
    class layout a DSA on the card builds, its query plan per score call,
    the real 128 x 128 tiles) equals the plain DSA bit for bit, and the JAX
    package at rtol 1e-4."""
    rng = np.random.default_rng(11)
    acts = rng.random((700, 24)).astype(np.float32)
    labels = rng.integers(0, 10, size=700)
    test = rng.random((300, 24)).astype(np.float32)
    tlabels = rng.integers(0, 10, size=300)
    plain_dsa = DSA(torch.from_numpy(acts), labels, badge_size=130)
    assert plain_dsa.layout is None  # the CPU's search ignores it, so none is built
    plain = plain_dsa(torch.from_numpy(test), tlabels)
    monkeypatch.setattr(dsa_cuda, "PLAN_MIN_WORK", 0)  # plan even these small searches
    plans = []

    def walk(*args):
        assert args[-1] is not None  # the DSA's own query plan
        plans.append(args[-1])
        return _emulated_nearest(*args)

    monkeypatch.setattr(port_surprise, "masked_nearest", walk)
    dsa = DSA(torch.from_numpy(acts), labels, badge_size=130)
    dsa.layout = dsa_cuda.class_layout(dsa.rows, dsa.rows_sq, dsa.train_labels)
    walked = dsa(torch.from_numpy(test), tlabels)
    assert len(plans) == 2 * 3 and plans[0] is plans[1]  # one plan per score call
    np.testing.assert_array_equal(walked, plain)
    ref = JaxDSA(acts, labels)
    ref.use_pallas = False
    np.testing.assert_allclose(walked, ref(test, tlabels), rtol=1e-4, atol=1e-6)


def test_dsa_walks_small_searches_in_full(monkeypatch):
    """Searches below ``PLAN_MIN_WORK`` (IMDB's 500-row badges) take no
    query plan, so the kernel walks every tile; the scores are the plain
    DSA's bit for bit. The convnet paths' searches are planned."""
    assert not dsa_cuda.worth_planning(500, 7_500, 20)
    assert dsa_cuda.worth_planning(10_000, 18_000, 1_600)
    assert dsa_cuda.worth_planning(10_000, 15_000, 2_304)
    rng = np.random.default_rng(12)
    acts = rng.random((400, 20)).astype(np.float32)
    labels = rng.integers(0, 2, size=400)
    test = rng.random((250, 20)).astype(np.float32)
    tlabels = rng.integers(0, 2, size=250)
    plain = DSA(torch.from_numpy(acts), labels, badge_size=100)(torch.from_numpy(test), tlabels)
    walks = []

    def walk(*args):
        assert args[-1] is None  # no plan: the kernel takes the full walk
        walks.append(args[-2])
        x = args[0]
        return _emulated_nearest(*args[:-1], dsa_cuda.full_walk(len(x), 400, x.device))

    monkeypatch.setattr(port_surprise, "masked_nearest", walk)
    dsa = DSA(torch.from_numpy(acts), labels, badge_size=100)
    dsa.layout = dsa_cuda.class_layout(dsa.rows, dsa.rows_sq, dsa.train_labels)
    walked = dsa(torch.from_numpy(test), tlabels)
    assert len(walks) == 2 * 3 and all(w is dsa.layout for w in walks)
    np.testing.assert_array_equal(walked, plain)
