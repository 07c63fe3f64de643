"""The fused route's functions: predict -> quantify -> profile-pack, and rank.

Counterpart of the JAX package's ``ops/fused_chain.py``. One chain function
maps a badge of inputs to predictions, every point uncertainty quantifier
and every coverage metric's (scores, bit-packed profiles); the activations
never leave the device. ``engine/run_program.py`` resolves it into a
program (a CUDA graph on the card, the eager closure on the CPU) and runs
the rank (the greedy CAM phase) eagerly over the accumulated profiles.

Every function here is plain torch and launches no kernel of its own but
those of the model (kernel B4 in the IMDB transformer's attention). Nothing
in the chain reads the host: no ``.item()``, no data-dependent shape, no
upload, so it can be captured in a CUDA graph once its tables are on the
device.

Packed words are int32 (CUDA torch has little uint32 support) with the JAX
package's layout, bit j of word k = section 32k + j, so their bytes equal
the JAX package's uint32 words and they feed ``device_cam_greedy`` as they
are.

Exact int8 profile coding (``ThresholdCodebook``): NAC, NBC, SNAC and KMNC
are per-neuron threshold comparisons, so each neuron's activation is coded
as the count of cutpoints it passes, and every metric bit is recovered by
integer comparisons against the cuts' ranks. The coding is exact: the same
bits and scores as the plain metrics.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.ops.coverage import (
    KMNC,
    NAC,
    NBC,
    SNAC,
    flatten_layers,
    sum_score,
)
from simple_tip_tpu_torch.ops.prioritizers import device_cam_greedy
from simple_tip_tpu_torch.ops.uncertainty import POINT_PRED_QUANTIFIERS


def pack_bits_u32(flat: torch.Tensor) -> torch.Tensor:
    """Boolean ``[B, W]`` as int32 words ``[B, ceil(W/32)]``, bit j of word
    k = section 32k + j (``prioritizers.pack_profiles``' layout); the bytes
    equal the JAX package's uint32 words.

    The sum of distinct powers of two is their bitwise or, and no partial
    sum leaves int32 (bit 31 is -2**31, the other bits sum to at most
    2**31 - 1), so the int32 arithmetic is exact.
    """
    b, w = flat.shape
    pad = (-w) % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros(b, pad)], dim=1)
    weights = torch.ones(32, dtype=torch.int64, device=flat.device) << torch.arange(
        32, device=flat.device
    )
    weights = torch.where(weights >= 2**31, weights - 2**32, weights).to(torch.int32)
    bits = flat.reshape(b, -1, 32).to(torch.int32)
    return (bits * weights).sum(dim=2, dtype=torch.int32)


def _host_f64(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value, np.float64)


class ThresholdCodebook:
    """Exact int8 interval coding of the threshold-family coverage metrics.

    Build time (host numpy): every cutpoint the configured NAC/NBC/SNAC/KMNC
    instances compare against, as a (value, strict) pair per neuron, sorted
    so that passing is monotone: at equal values the inclusive ``>=`` cut
    sorts before the strict ``>`` cut, so an activation passing any cut
    passes all lower-ranked ones (the prefix property).

    Apply time: one sweep over the cuts yields the per-neuron pass count,
    the int8 code, and every metric's bits derive from it:

    - ``a > t`` / ``a >= t``  <=>  ``code > rank(cut)``
    - NBC low (``a <= min_b``) <=> ``code <= rank`` and ``a`` is not NaN
      (the inverted comparison would otherwise fire on NaN activations)
    - KMNC bucket i (``e_i <= a < e_{i+1}``) <=>
      ``(code > rank(e_i)) & (code <= rank(e_{i+1}))``

    TKNC is rank-based (top-k), not threshold-based, and keeps its own
    formulation.
    """

    def __init__(self, metrics: Dict[str, object]):
        self._cuts: List[Tuple[object, bool]] = []  # (value scalar/[N], strict)
        self._specs: Dict[str, tuple] = {}
        for mid, m in metrics.items():
            if isinstance(m, NAC):
                self._specs[mid] = ("ge", self._cut(m.cov_threshold, True))
            elif isinstance(m, SNAC):
                self._specs[mid] = ("ge", self._cut(m.max_boundaries, False))
            elif isinstance(m, NBC):
                self._specs[mid] = (
                    "nbc",
                    self._cut(m.min_boundaries, True),
                    self._cut(m.max_boundaries, False),
                )
            elif isinstance(m, KMNC):
                # the plain metric's edges, in its float32 arithmetic
                edges = [m.lo + m.jumps * i for i in range(m.sections + 1)]
                self._specs[mid] = ("kmnc", [self._cut(e, False) for e in edges])
        if len(self._cuts) > 127:
            raise ValueError(f"{len(self._cuts)} cutpoints exceed the int8 code range")
        self._finalized: Dict[int, tuple] = {}
        self._on_device: Dict[Tuple[int, str], tuple] = {}

    def _cut(self, value, strict: bool) -> int:
        self._cuts.append((value, strict))
        return len(self._cuts) - 1

    @property
    def num_cuts(self) -> int:
        """K, the cut table's width."""
        return len(self._cuts)

    def covers(self, mid: str) -> bool:
        """True when this metric's bits derive from the code."""
        return mid in self._specs

    def spec_signature(self) -> tuple:
        """Hashable structural identity of the coding: metric ids, spec
        kinds, cut indices and per-cut strictness. Group members must agree
        on it (their cut values differ; those ride the table)."""

        def _norm(spec):
            return tuple(tuple(x) if isinstance(x, list) else x for x in spec)

        return (
            tuple((mid, _norm(spec)) for mid, spec in sorted(self._specs.items())),
            tuple(s for _, s in self._cuts),
        )

    def _ensure(self, n_neurons: int):
        """Per-neuron sorted cut table and per-cut ranks (host numpy, cached
        per neuron count)."""
        cached = self._finalized.get(n_neurons)
        if cached is not None:
            return cached
        vals = np.stack(
            [np.broadcast_to(_host_f64(v).reshape(-1), (n_neurons,)) for v, _ in self._cuts],
            axis=1,
        )  # [N, K]
        strict = np.array([s for _, s in self._cuts], dtype=bool)  # [K]
        strict_b = np.broadcast_to(strict, vals.shape)
        # primary key: cut value; secondary: strictness (inclusive first),
        # the order that makes pass-sets prefix-closed
        order = np.lexsort((strict_b, vals), axis=1)
        rank = np.argsort(order, axis=1).astype(np.int32)  # [N, K]: cut j -> rank
        sorted_vals = np.take_along_axis(vals, order, axis=1)
        sorted_strict = np.take_along_axis(strict_b, order, axis=1)
        entry = (sorted_vals, sorted_strict, rank)
        self._finalized[n_neurons] = entry
        return entry

    def table(self, n_neurons: int):
        """The cut table as host arrays: ``(sorted_vals f32 [N, K],
        sorted_strict bool [N, K], rank int32 [N, K])``; the values were
        float32 cuts, so the narrowing is exact."""
        sorted_vals, sorted_strict, rank = self._ensure(n_neurons)
        return (
            np.asarray(sorted_vals, np.float32),
            np.asarray(sorted_strict, bool),
            np.asarray(rank, np.int32),
        )

    def device_table(self, n_neurons: int, device: torch.device):
        """``table`` as tensors on ``device``, uploaded once and cached (a
        captured chain must find them there)."""
        key = (n_neurons, str(device))
        cached = self._on_device.get(key)
        if cached is None:
            cached = tuple(torch.from_numpy(t).to(device) for t in self.table(n_neurons))
            self._on_device[key] = cached
        return cached

    def apply(self, flat_acts: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``{metric_id: (scores, bool profiles)}`` from one coded sweep over
        ``flat_acts`` ``[B, N]`` (``flatten_layers``' output); profile shapes
        are the plain metrics' own."""
        return self.apply_tables(
            flat_acts, self.device_table(flat_acts.shape[1], flat_acts.device)
        )

    def apply_tables(
        self, flat_acts: torch.Tensor, tables
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """``apply`` with the cut table given as tensors (a ``table``-shaped
        triple), as the grouped chain passes each member's."""
        sorted_vals, sorted_strict, rank = tables
        code = torch.zeros(flat_acts.shape, dtype=torch.int32, device=flat_acts.device)
        for j in range(sorted_vals.shape[1]):
            v = sorted_vals[:, j]
            code += torch.where(sorted_strict[:, j], flat_acts > v, flat_acts >= v)
        # the quantized representation: one byte per neuron carries every
        # threshold metric's information through the rest of the chain
        code = code.to(torch.int8).to(torch.int32)
        nan = torch.isnan(flat_acts)
        out = {}
        for mid, spec in self._specs.items():
            if spec[0] == "ge":
                prof = code > rank[:, spec[1]]
            elif spec[0] == "nbc":
                low = (code <= rank[:, spec[1]]) & ~nan
                high = code > rank[:, spec[2]]
                prof = torch.stack([low, high], dim=-1)
            else:  # kmnc
                rs = [rank[:, i] for i in spec[1]]
                prof = torch.stack(
                    [(code > rs[i]) & (code <= rs[i + 1]) for i in range(len(rs) - 1)],
                    dim=-1,
                )
            out[mid] = (sum_score(prof), prof)
        return out


def _probs_and_acts(net, xb, layer_ids):
    probs, taps = net(xb)
    return probs, [taps[i] for i in layer_ids]


def _pack_masked(p: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    packed = pack_bits_u32(p.reshape(p.shape[0], -1))
    return packed.masked_fill(~mask[:, None], 0)


def make_chain_fn(
    layer_ids: Sequence,
    metrics: Dict[str, object],
    quantifiers: Optional[Dict] = None,
    int8_profiles: bool = False,
):
    """The whole-chain function ``(net, x, valid) -> (pred, unc, cov)``.

    ``net`` is one of the port's models with its weights (the JAX
    function's ``params``): one forward gives ``(probs, taps)``, as flax's
    ``apply`` does. ``valid`` is an int32 0-dim tensor: rows at index
    ``valid`` and above are badge padding and get all-zero packed profiles,
    so the CAM phase can never pick them; their other outputs are sliced
    off by the caller. Returns ``pred`` [B] (argmax), ``unc`` a dict of [B]
    uncertainties (the per-phase route's names) and ``cov`` a dict of
    ``(scores, packed int32 words)`` per metric id.
    """
    quantifiers = dict(POINT_PRED_QUANTIFIERS if quantifiers is None else quantifiers)
    layer_ids = tuple(i for i in layer_ids if isinstance(i, int))
    codebook = ThresholdCodebook(metrics) if int8_profiles else None

    def chain(net, xb, valid):
        probs, acts = _probs_and_acts(net, xb, layer_ids)
        pred = probs.argmax(dim=1)
        unc = {name: fn(probs)[1] for name, fn in quantifiers.items()}
        mask = torch.arange(xb.shape[0], device=xb.device) < valid
        coded = codebook.apply(flatten_layers(acts)) if codebook is not None else {}
        cov = {}
        for mid, metric in metrics.items():
            s, p = coded[mid] if mid in coded else metric(acts)
            cov[mid] = (s, _pack_masked(p, mask))
        return pred, unc, cov

    return chain


def make_member_chain_fn(
    layer_ids: Sequence,
    metrics: Dict[str, object],
    quantifiers: Optional[Dict] = None,
):
    """One group member's chain with its cut table as an input:
    ``(net, tables, xb, valid) -> (pred, unc, cov)``.

    The threshold families' boundaries are each member's own training
    statistics, so they always ride the int8 codebook with the cut table an
    argument (``ThresholdCodebook.table``'s triple), while the config-only
    metrics (TKNC) stay closed over. ``metrics`` supplies the coding
    structure and must be structurally the same for every member (callers
    check ``ThresholdCodebook.spec_signature``).
    """
    quantifiers = dict(POINT_PRED_QUANTIFIERS if quantifiers is None else quantifiers)
    layer_ids = tuple(i for i in layer_ids if isinstance(i, int))
    codebook = ThresholdCodebook(metrics)

    def member_chain(net, tables, xb, valid):
        probs, acts = _probs_and_acts(net, xb, layer_ids)
        pred = probs.argmax(dim=1)
        unc = {name: fn(probs)[1] for name, fn in quantifiers.items()}
        mask = torch.arange(xb.shape[0], device=xb.device) < valid
        coded = codebook.apply_tables(flatten_layers(acts), tables)
        cov = {}
        for mid, metric in metrics.items():
            s, p = coded[mid] if codebook.covers(mid) else metric(acts)
            cov[mid] = (s, _pack_masked(p, mask))
        return pred, unc, cov

    return member_chain


def _stack_members(outs):
    """Per-member ``(pred, unc, cov)`` stacked over a leading G axis."""
    preds, uncs, covs = zip(*outs)
    unc = {name: torch.stack([u[name] for u in uncs]) for name in uncs[0]}
    cov = {
        mid: (torch.stack([c[mid][0] for c in covs]), torch.stack([c[mid][1] for c in covs]))
        for mid in covs[0]
    }
    return torch.stack(preds), unc, cov


def make_group_chain_fn(
    layer_ids: Sequence,
    metrics: Dict[str, object],
    quantifiers: Optional[Dict] = None,
):
    """The chain over a group of G independently trained models:
    ``(nets, tables, x, valid, alive) -> (pred [G,B], unc {name: [G,B]},
    cov {mid: ([G,B], [G,B,W])})``.

    ``nets`` are G modules of one architecture, each with its weights; the
    members run one after another inside the one function, so one program
    (one CUDA graph) scores the whole group on a badge. ``tables`` is a
    ``ThresholdCodebook.table`` triple stacked to [G, N, K] (each member's
    own thresholds, ``make_member_chain_fn``), and ``alive`` an int32 0-dim
    tensor: members at index ``alive`` and above are the padding of a
    ragged last group (member 0 repeated) and get all-zero packed profiles,
    so one program serves it. (The JAX package's other form, shared
    metrics for every member, has no caller here.)
    """
    member = make_member_chain_fn(layer_ids, metrics, quantifiers=quantifiers)

    def group_chain(nets, tables, xb, valid, alive):
        pred, unc, cov = _stack_members(
            [member(net, tuple(t[g] for t in tables), xb, valid) for g, net in enumerate(nets)]
        )
        live = torch.arange(len(nets), device=xb.device) < alive
        cov = {
            mid: (s, packed.masked_fill(~live[:, None, None], 0))
            for mid, (s, packed) in cov.items()
        }
        return pred, unc, cov

    return group_chain


def select_top_k(values: torch.Tensor, valid, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest of the first ``valid`` values (the AL
    top-k select).

    Rows at index ``valid`` and above are badge padding and sort to the
    bottom. Tie policy: a stable ascending sort, so among equal values the
    higher index wins a contested last slot, equal to ``np.argsort(values,
    kind="stable")[-k:]``; ascending by value, best last.
    """
    idx = torch.arange(values.shape[0], device=values.device)
    masked = torch.where(idx < valid, values.to(torch.float32), float("-inf"))
    return torch.sort(masked, stable=True).indices[-int(k):]


def make_select_fn(k: int):
    """``(values, valid) -> top-k indices`` with ``k`` closed over."""

    def select(values, valid):
        return select_top_k(values, valid, k)

    return select


def make_group_select_fn(k: int):
    """``(values [G, N], valid) -> [G, k]``: ``select_top_k`` per member row
    with the shared badge-padding ``valid``."""

    def select(values, valid):
        return torch.stack([select_top_k(row, valid, k) for row in values])

    return select


def rank_badges(badges) -> torch.Tensor:
    """Greedy CAM picks (int64, in order) over equally wide packed badges,
    concatenated; badge-padding rows are all-zero, so never picked."""
    badges = list(badges)
    packed = badges[0] if len(badges) == 1 else torch.cat(badges, dim=0)
    return device_cam_greedy(packed)


def rank_badges_grouped(badges) -> List[torch.Tensor]:
    """``rank_badges`` per member over [G, B, W] badges: one pick list per
    member."""
    badges = list(badges)
    packed = badges[0] if len(badges) == 1 else torch.cat(badges, dim=1)
    return [device_cam_greedy(p) for p in packed]
