"""Shared preparation of the training traces for the SA variants, and the
disk cache of fitted SA scorers.

Counterpart of the serial part of the JAX package's ``engine/sa_prep.py``:

- ``SharedTrainPrep`` flattens the training traces and partitions them by
  predicted class once, for every variant, and ``debit_for`` charges that
  shared cost into each variant's setup record (the flatten to every
  variant, the partition also to the three per-class ones);
- ``VariantFitter`` builds the registry's variants from it, one after
  another on one device;
- ``SAFitCache`` keeps each fitted scorer on disk under
  ``TIP_SA_CACHE_DIR`` (default ``$TIP_ASSETS/sa_fit_cache``; ``off``
  disables it), keyed by (case study, model id, fingerprint, variant), so
  the active-learning phase and every later process reuse the fits of
  ``test_prio``. The fingerprint (``content_fingerprint``) hashes the
  weights in flax layout, the training set and the taps, in the JAX
  package's order, under this package's own version string and a ``torch``
  tag: an entry of one package never loads in the other. A handler of the
  bf16 scoring mode adds a ``bfloat16`` tag (``dtype_tags``): its traces
  are the bf16 model's, so its fits are another entry. float32 keys carry
  no dtype tag and are the keys of earlier versions. The JAX package's
  keys hash no compute dtype (a deliberate difference).
- the cache counts its outcomes as the JAX package does
  (``sa_fit_cache.{hit,miss,stale,corrupt,store,evict}`` counters and
  ``sa_cache`` events in ``obs``), and retries an entry's read on transient
  ``OSError``s under the ``sa_cache`` retry scope before it is a miss.

Entries hold no device: every tensor is written as a host array and read
back onto the device the reading handler runs on (``load``), so an entry
written on the card loads in a CPU process. The JAX package's process pool,
its whole-variant fan-out and its two-stage fit pipeline are not ported:
every fit of the port runs on the card, where the JAX package pools only
host fits.
"""

import hashlib
import io
import logging
import os
import pickle
from typing import Callable, Dict, Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from simple_tip_tpu_torch import obs
from simple_tip_tpu_torch.config import output_folder
from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.ops.surprise import (
    DSA,
    MultiModalSA,
    _as_rows,
    _by_class_discriminator,
    _class_predictions,
)
from simple_tip_tpu_torch.ops.timer import Timer
from simple_tip_tpu_torch.resilience import faults
from simple_tip_tpu_torch.resilience.retry import RetryPolicy
from simple_tip_tpu_torch.utils.artifacts_io import atomic_write_bytes, sweep_orphan_tmp

logger = logging.getLogger(__name__)

#: The variants fitted one SA per predicted class (they share the partition).
BY_CLASS = ("pc-lsa", "pc-mdsa", "pc-mlsa")

#: Bump when the entry layout or a fit setting of the registry changes;
#: entries of another version are misses.
CACHE_FORMAT_VERSION = "sa-fit-cache-torch-v1"
#: The tag that keys this package's entries apart from the JAX package's.
BACKEND_TAG = "torch"


class SharedTrainPrep:
    """Flat training traces on the device and their by-class partition."""

    def __init__(self, train_ats, train_pred, device: torch.device):
        flat_timer, part_timer = Timer(device=device), Timer(device=device)
        with flat_timer:
            self.flat = _as_rows(train_ats, device)
            self.pred = _class_predictions(train_pred)
        with part_timer:
            self.class_views: Dict[int, torch.Tensor] = {}
            for c in np.unique(self.pred):
                idx = torch.from_numpy(np.flatnonzero(self.pred == c)).to(device)
                self.class_views[int(c)] = self.flat[idx]
        self.flatten_debit = flat_timer.get()
        self.partition_debit = part_timer.get()

    def debit_for(self, sa_name: str) -> float:
        """Shared-prep seconds owed by ``sa_name``'s setup record."""
        if sa_name in BY_CLASS:
            return self.flatten_debit + self.partition_debit
        return self.flatten_debit


class VariantFitter:
    """Builds registry variants from one ``SharedTrainPrep`` on ``device``;
    ``dsa_badge_size`` chunks DSA's scoring."""

    def __init__(self, prep: SharedTrainPrep, device: torch.device,
                 dsa_badge_size: Optional[int] = None):
        self.prep = prep
        self.device = device
        self.dsa_badge_size = dsa_badge_size

    def dsa(self, subsampling) -> DSA:
        return DSA(self.prep.flat, self.prep.pred, subsampling=subsampling,
                   badge_size=self.dsa_badge_size)

    def by_class(self, modal: Callable) -> MultiModalSA:
        """One ``modal(traces)`` per predicted class, from the partition."""
        modal_sa = {c: modal(acts) for c, acts in self.prep.class_views.items()}
        return MultiModalSA(discriminator=_by_class_discriminator, modal_sa=modal_sa)

    def with_kmeans(self, modal: Callable, potential_k: Iterable[int],
                    subsampling) -> MultiModalSA:
        """One ``modal(traces)`` per cluster of silhouette-scored k-means."""
        return MultiModalSA.build_with_kmeans(
            self.prep.flat, self.prep.pred, lambda acts, _: modal(acts), potential_k,
            subsampling=subsampling, device=self.device)


# -- the fingerprint -----------------------------------------------------------


def _tree_leaves(tree) -> Iterator:
    """The leaves of a nested dict in flax's tree order (keys sorted)."""
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _tree_leaves(tree[key])
    else:
        yield tree


def content_fingerprint(
    version: str, params, training_dataset, layers: Sequence, *tags: str
) -> str:
    """sha256 of one (weights, training set, taps) triple and the cache tags,
    in the JAX package's order: the version string, ``repr(list(layers))``,
    each tag, each leaf of the flax-layout tree ``params`` (shape, dtype,
    bytes), then the training array (shape, dtype, bytes). It needs no
    forward pass, so a warm cache skips the training traces."""
    h = hashlib.sha256()
    h.update(version.encode())
    h.update(repr(list(layers)).encode())
    for tag in tags:
        h.update(tag.encode())
    for leaf in _tree_leaves(params):
        arr = np.asarray(leaf)
        h.update(str(arr.shape).encode() + str(arr.dtype).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    data = np.asarray(training_dataset)
    h.update(str(data.shape).encode() + str(data.dtype).encode())
    h.update(np.ascontiguousarray(data).tobytes())
    return h.hexdigest()


def dtype_tags(compute_dtype) -> tuple:
    """The cache-key tags of a model's scoring compute dtype: none for
    float32 (None), so that float32 keys stay those of earlier versions;
    ``("bfloat16",)`` for the bf16 scoring mode, whose traces differ."""
    if compute_dtype is None or str(compute_dtype) in ("float32", "torch.float32"):
        return ()
    return ("bfloat16",)


def train_fingerprint(params, training_dataset, sa_layers: Sequence,
                      compute_dtype=None) -> str:
    """The SA fit cache's key: ``content_fingerprint`` of this package's
    version under the ``torch`` tag (the JAX package tags its cluster
    backend there), and the bf16 scoring mode's tag (``dtype_tags``)."""
    return content_fingerprint(
        CACHE_FORMAT_VERSION, params, training_dataset, sa_layers, BACKEND_TAG,
        *dtype_tags(compute_dtype),
    )


def sa_cache_max_bytes() -> Optional[int]:
    """Size cap of the cache directory from ``TIP_SA_CACHE_MAX_BYTES``: a
    byte count or a ``k``/``m``/``g``-suffixed size; empty, ``0``, ``off``,
    ``unlimited`` or ``none`` is no cap (None)."""
    raw = os.environ.get("TIP_SA_CACHE_MAX_BYTES", "").strip().lower()
    if not raw:
        return None
    if raw in ("0", "off", "unlimited", "none"):
        return None
    mult = 1
    if raw[-1] in ("k", "m", "g"):
        mult = {"k": 1024, "m": 1024**2, "g": 1024**3}[raw[-1]]
        raw = raw[:-1]
    try:
        return int(float(raw) * mult)
    except ValueError:
        raise ValueError(
            f"TIP_SA_CACHE_MAX_BYTES={raw!r} not recognized (bytes, or k/m/g suffix)"
        )


# -- device-neutral pickles ------------------------------------------------------


class _HostPickler(pickle.Pickler):
    """Pickles every tensor as a host array and every ``torch.device`` as a
    placeholder, so the stream names no device."""

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            return ("tensor", obj.detach().cpu().numpy())
        if isinstance(obj, torch.device):
            return ("device",)
        return None


class _DeviceUnpickler(pickle.Unpickler):
    """Reads a ``_HostPickler`` stream with its tensors and devices on ``device``."""

    def __init__(self, file, device: torch.device):
        super().__init__(file)
        self.device = device

    def persistent_load(self, pid):
        if pid[0] == "tensor":
            return torch.from_numpy(pid[1]).to(self.device)
        if pid[0] == "device":
            return self.device
        raise pickle.UnpicklingError(f"unknown persistent id {pid[0]!r}")


# -- the SA fit cache ------------------------------------------------------------


class SAFitCache:
    """Disk cache of the fitted scorers of the five registry variants.

    One file per (case study, model id, fingerprint, variant): the meta
    dict, then the scorer with every tensor on the host. Writes are atomic
    (``atomic_write_bytes``), so processes may share the directory; a load
    checks the meta before it reads the scorer, and any read failure is a
    logged miss, which the refit overwrites. Stores never raise.
    """

    def __init__(self, root: str, case_study: str, model_ref: str, fingerprint: str,
                 device: torch.device):
        self.root = root
        self.case_study = case_study
        self.model_ref = model_ref
        self.fingerprint = fingerprint
        self.device = device
        sweep_orphan_tmp(self.root)

    @classmethod
    def from_env(cls, case_study: Optional[str], model_id, params, training_dataset,
                 sa_layers, device: DeviceLike = None,
                 compute_dtype=None) -> Optional["SAFitCache"]:
        """The cache of ``TIP_SA_CACHE_DIR`` (None when ``off`` or ``0``) for
        the flax-layout ``params`` of a model scoring in ``compute_dtype``;
        its loads land on ``device``."""
        raw = os.environ.get("TIP_SA_CACHE_DIR", "").strip()
        if raw.lower() in ("off", "0"):
            return None
        if not raw:
            raw = os.path.join(output_folder(), "sa_fit_cache")
        return cls(
            root=raw,
            case_study=case_study or "default",
            model_ref="na" if model_id is None else str(model_id),
            fingerprint=train_fingerprint(params, training_dataset, sa_layers, compute_dtype),
            device=resolve(device),
        )

    def path(self, sa_name: str) -> str:
        return os.path.join(
            self.root,
            f"{self.case_study}_{self.model_ref}_{self.fingerprint[:16]}_{sa_name}.pkl",
        )

    def _read(self, path: str, sa_name: str, device: torch.device):
        """One read of an entry: ``(True, scorer)``, or ``(False, None)``
        when its meta is another version's, variant's or fingerprint's (the
        scorer is then not read)."""
        with open(path, "rb") as f:
            meta = pickle.load(f)
            if (
                meta["version"] != CACHE_FORMAT_VERSION
                or meta["variant"] != sa_name
                or meta["fingerprint"] != self.fingerprint
            ):
                return False, None
            return True, _DeviceUnpickler(f, device).load()

    def load(self, sa_name: str, device: DeviceLike = None):
        """The cached scorer with its tensors on ``device`` (default: the
        cache's), or None for a missing, stale or unreadable entry.

        A transient ``OSError`` (a briefly unavailable shared mount, not a
        bad pickle, which no retry fixes) is retried under the ``sa_cache``
        scope of the retry policy before the entry is a miss. Each outcome
        counts in ``sa_fit_cache.{hit,miss,stale,corrupt}`` with an
        ``sa_cache`` event. The ``sa_cache.load`` fault seam
        (``resilience/faults.py``) may garble the entry on disk first
        (``corrupt``): the read then fails and the entry is a logged miss,
        which the refit overwrites."""
        path = self.path(sa_name)
        device = self.device if device is None else resolve(device)
        fault = faults.maybe_inject("sa_cache.load", variant=sa_name, path=path)
        if fault is not None and fault.kind == "corrupt":
            faults.corrupt_file(path)
        try:
            fresh, scorer = RetryPolicy.from_env(
                scope="sa_cache", attempts=2, base_s=0.05, deadline_s=10.0
            ).call(
                self._read, path, sa_name, device,
                transient=(OSError,), fatal=(FileNotFoundError,),
                describe=f"sa-fit cache read ({sa_name})",
            )
        except FileNotFoundError:
            obs.counter("sa_fit_cache.miss").inc()
            obs.event("sa_cache", variant=sa_name, outcome="miss")
            return None
        except Exception as e:  # noqa: BLE001 - an unreadable entry is refitted
            logger.warning("sa-fit cache entry corrupt for %s (%s: %r); refitting",
                           sa_name, path, e)
            obs.counter("sa_fit_cache.corrupt").inc()
            obs.event("sa_cache", variant=sa_name, outcome="corrupt")
            return None
        if not fresh:
            logger.info("sa-fit cache STALE for %s (%s)", sa_name, path)
            obs.counter("sa_fit_cache.stale").inc()
            obs.event("sa_cache", variant=sa_name, outcome="stale")
            return None
        obs.counter("sa_fit_cache.hit").inc()
        obs.event("sa_cache", variant=sa_name, outcome="hit")
        try:
            os.utime(path)  # LRU recency: a hit is the last to be evicted
        except OSError:
            pass
        return scorer

    def store(self, sa_name: str, scorer) -> None:
        """Write one fitted scorer (atomic; a failure warns, never raises),
        counted in ``sa_fit_cache.store``; entries evicted past the size cap
        count in ``sa_fit_cache.evict``."""
        path = self.path(sa_name)
        try:
            os.makedirs(self.root, exist_ok=True)
            meta = {
                "version": CACHE_FORMAT_VERSION,
                "variant": sa_name,
                "fingerprint": self.fingerprint,
                "case_study": self.case_study,
                "model_ref": self.model_ref,
            }
            buf = io.BytesIO()
            pickle.dump(meta, buf, protocol=4)
            _HostPickler(buf, protocol=4).dump(scorer)
            atomic_write_bytes(path, buf.getvalue())
            logger.info("sa-fit cache stored %s (%s)", sa_name, path)
            obs.counter("sa_fit_cache.store").inc()
            self._sweep(keep=path)
        except Exception as e:  # noqa: BLE001 - the cache only saves time
            logger.warning("sa-fit cache store failed for %s (%r)", sa_name, e)

    def _sweep(self, keep: str) -> None:
        """Evict the least recently used ``.pkl`` entries until the directory
        fits ``TIP_SA_CACHE_MAX_BYTES``, never ``keep`` (the entry just
        written)."""
        cap = sa_cache_max_bytes()
        if cap is None:
            return
        entries = []
        for name in os.listdir(self.root):
            if not name.endswith(".pkl"):
                continue
            full = os.path.join(self.root, name)
            try:
                st = os.stat(full)
            except OSError:
                continue
            entries.append((st.st_mtime, st.st_size, full))
        total = sum(size for _, size, _ in entries)
        keep = os.path.abspath(keep)
        for _, size, full in sorted(entries):
            if total <= cap:
                break
            if os.path.abspath(full) == keep:
                continue
            try:
                os.unlink(full)
            except OSError:
                continue
            total -= size
            logger.info("sa-fit cache evicted %s (cap %d bytes)", full, cap)
            obs.counter("sa_fit_cache.evict").inc()
            obs.event("sa_cache", outcome="evict", path=full)
