"""Neuron-coverage worker: one pass of aggregate statistics over the training
set, then 12 configured coverage metrics with CAM orders per test set.

Counterpart of the JAX package's ``CoverageWorker``: the same metric
configuration (NBC_0/0.5/1, SNAC_0/0.5/1, NAC_0/0.75, TKNC_1/2/3, KMNC_2),
the same per-metric setup debits for the shared statistics, and the CAM
sanity check. The training statistics persist in the coverage-statistics
cache (``engine/coverage_stats_cache.py``): on a hit the training pass is
skipped and each debit is the load time (``stats_cache_outcome``). Profiles
are computed per badge on the device; ``spill`` says where they wait for
CAM: ``memory`` keeps them packed on the device, ``disk`` writes each
badge's scores and packed profiles as ``.npy`` files under
``$TIP_ASSETS/.tmp`` (the JAX package's layout) and reads them back to the
device for CAM, removing them after, and ``auto`` picks ``memory`` when
twice the JAX package's estimate of the packed profiles fits the device's
free memory. The CAM greedy phase runs on the device; only the pick list
and the scores reach the host.
"""

import os
import secrets
import shutil
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.bridge import params_to_jax
from simple_tip_tpu_torch.config import output_folder
from simple_tip_tpu_torch.engine.coverage_stats_cache import CoverageStatsCache
from simple_tip_tpu_torch.engine.model_handler import BaseModel
from simple_tip_tpu_torch.ops.coverage import (
    KMNC,
    NAC,
    NBC,
    SNAC,
    TKNC,
    CoverageMethod,
    make_fused_profile_fn,
)
from simple_tip_tpu_torch.ops.prioritizers import cam_order_device, words_from_packbits
from simple_tip_tpu_torch.ops.stats import DeviceAggregateStatisticsCollector
from simple_tip_tpu_torch.ops.timer import Timer

PROFILE_BADGE_SIZE = 512


SPILLS = ("auto", "memory", "disk")


def free_memory(device: torch.device) -> int:
    """Free bytes where the profiles would wait: the card's free memory, or
    the host's available pages."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


class CoverageWorker:
    """The 12 configured neuron-coverage instances over one model;
    ``spill`` is ``auto``, ``memory`` or ``disk`` (module docstring)."""

    def __init__(self, base_model: BaseModel, training_set: np.ndarray, spill: str = "auto"):
        if spill not in SPILLS:
            raise ValueError(f"spill={spill!r}: use one of {SPILLS}")
        self.base_model = base_model
        self.device = base_model.device
        self.spill = spill
        self.metrics: Dict[str, CoverageMethod] = {}
        self.setup_times: Dict[str, float] = {}
        # no two workers share a spill directory
        self.temp_random = secrets.token_urlsafe(16)

        net = base_model.net
        stats_cache = CoverageStatsCache.from_env(
            params_to_jax(net.family, net), training_set, base_model.activation_layers,
            compute_dtype=getattr(net, "compute_dtype", None))
        self.stats_cache_outcome = "off" if stats_cache is None else "miss"
        stats = None
        if stats_cache is not None:
            with Timer(device=self.device) as load_timer:
                stats = stats_cache.load(self.device)
        if stats is not None:
            self.stats_cache_outcome = "hit"
            nbc_debit = snac_debit = kmnc_debit = load_timer.get()
        else:
            agg_stats = DeviceAggregateStatisticsCollector()
            pred_timer = Timer(start=True, device=self.device)
            for activations in base_model.walk_activations(
                training_set, badge_size=PROFILE_BADGE_SIZE
            ):
                pred_timer.stop()
                agg_stats.track(activations)
                pred_timer.start()
            pred_timer.stop()
            stats = agg_stats.get()
            if stats_cache is not None:
                stats_cache.store(stats)
            nbc_debit = (
                agg_stats.min_timer.get()
                + agg_stats.max_timer.get()
                + pred_timer.get()
                + agg_stats.welford_timer.get()
            )
            snac_debit = (
                agg_stats.welford_timer.get() + agg_stats.max_timer.get() + pred_timer.get()
            )
            kmnc_debit = agg_stats.min_timer.get() + agg_stats.max_timer.get() + pred_timer.get()
        self.stats = stats
        mins, maxs, std = stats
        for scaler in (0, 0.5, 1):
            self._add_metric(
                f"NBC_{scaler}",
                lambda s=scaler: NBC(mins=mins, maxs=maxs, stds=std, scaler=s),
                time_debit=nbc_debit,
            )
        for scaler in (0, 0.5, 1):
            self._add_metric(
                f"SNAC_{scaler}",
                lambda s=scaler: SNAC(maxs=maxs, stds=std, scaler=s),
                time_debit=snac_debit,
            )
        self._add_metric("NAC_0", lambda: NAC(cov_threshold=0.0))
        self._add_metric("NAC_0.75", lambda: NAC(cov_threshold=0.75))
        for k in (1, 2, 3):
            self._add_metric(f"TKNC_{k}", lambda kk=k: TKNC(top_neurons=kk))
        # KMNC_1000/KMNC_10000 of the DeepGini paper are too expensive; the
        # reference uses KMNC_2.
        self._add_metric(
            "KMNC_2", lambda: KMNC(mins, maxs, sections=2), time_debit=kmnc_debit
        )
        self._fused_fn = make_fused_profile_fn(self.metrics)

    def _add_metric(
        self,
        metric_id: str,
        metric_supplier: Callable[[], CoverageMethod],
        time_debit: float = 0.0,
    ):
        with Timer(device=self.device) as timer:
            self.metrics[metric_id] = metric_supplier()
        self.setup_times[metric_id] = time_debit + timer.get()

    def _badges(self, test_dataset: np.ndarray, times):
        """Per badge, ``{metric_id: (scores, packed profiles)}`` on the
        device; pred and quant time are accumulated into ``times``."""
        walk = self.base_model.walk_activations(test_dataset, badge_size=PROFILE_BADGE_SIZE)
        while True:
            with Timer(device=self.device) as pred_timer:
                activations = next(walk, None)
            if activations is None:
                return
            with Timer(device=self.device) as quant_timer:
                fused_out = self._fused_fn(activations)
            quant_time = quant_timer.get() / len(self.metrics)
            for metric_id in fused_out:
                times[metric_id][1] += pred_timer.get()
                times[metric_id][2] += quant_time
            yield fused_out

    def _resolve_spill(self, test_dataset: np.ndarray) -> str:
        """``spill``, with ``auto`` resolved by the JAX package's estimate of
        the packed profiles (one bit per neuron and section) against
        ``free_memory``."""
        if self.spill != "auto":
            return self.spill
        sample = self.base_model.get_activations(test_dataset[:1])
        neurons = sum(int(np.prod(a.shape[1:])) for a in sample)
        sections = {"NBC": 2, "KMNC": 2}
        per_sample_bits = sum(
            neurons * sections.get(mid.split("_")[0], 1) for mid in self.metrics
        )
        estimate = per_sample_bits // 8 * test_dataset.shape[0]
        return "memory" if estimate * 2 < free_memory(self.device) else "disk"

    def _temp_root(self) -> str:
        return os.path.join(output_folder(), ".tmp", f"{self.temp_random}-prepared-profiles")

    def _spill_to_disk(self, test_dataset: np.ndarray, ds_id, times) -> None:
        """Each badge's scores and packed profiles as
        ``{metric}/{ds_id}-scores/{b}.npy`` and ``{ds_id}-profiles/{b}.npy``."""
        for metric_id in self.metrics:
            folder = os.path.join(self._temp_root(), metric_id)
            shutil.rmtree(folder, ignore_errors=True)
            os.makedirs(os.path.join(folder, f"{ds_id}-scores"))
            os.makedirs(os.path.join(folder, f"{ds_id}-profiles"))
        for b, fused_out in enumerate(self._badges(test_dataset, times)):
            for metric_id, (s, p) in fused_out.items():
                folder = os.path.join(self._temp_root(), metric_id)
                np.save(os.path.join(folder, f"{ds_id}-scores", f"{b}.npy"), s.cpu().numpy())
                np.save(os.path.join(folder, f"{ds_id}-profiles", f"{b}.npy"), p.cpu().numpy())

    @staticmethod
    def _concatenate_arrays_in_folder(folder: str) -> np.ndarray:
        files = sorted((f for f in os.listdir(folder) if f.endswith(".npy")),
                       key=lambda f: int(f.split(".")[0]))
        return np.concatenate([np.load(os.path.join(folder, f)) for f in files], axis=0)

    def _read_spilled(self, metric_id: str, ds_id) -> Tuple[np.ndarray, torch.Tensor]:
        """(scores, packed profiles on the device) of one metric, its spill
        folder removed."""
        folder = os.path.join(self._temp_root(), metric_id)
        scores = self._concatenate_arrays_in_folder(os.path.join(folder, f"{ds_id}-scores"))
        packed = self._concatenate_arrays_in_folder(os.path.join(folder, f"{ds_id}-profiles"))
        shutil.rmtree(folder, ignore_errors=True)
        return scores, torch.from_numpy(packed).to(self.device)

    def evaluate_all(
        self, test_dataset: np.ndarray, test_dataset_id
    ) -> Tuple[Dict[str, List[float]], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """All coverages + CAM orders for one test set.

        Returns ``(times, scores, cam_orders)`` with times =
        ``[setup, pred, quant, cam]`` per metric.
        """
        times = {m: [setup, 0.0, 0.0] for m, setup in self.setup_times.items()}
        mode = self._resolve_spill(test_dataset)
        if mode == "memory":
            badges = list(self._badges(test_dataset, times))
            scores = {m: torch.cat([b[m][0] for b in badges]) for m in self.metrics}
            packed = {m: torch.cat([b[m][1] for b in badges]) for m in self.metrics}
            del badges
        else:
            self._spill_to_disk(test_dataset, test_dataset_id, times)
        all_scores, cam_orders = {}, {}
        for metric_id in self.metrics:
            if mode == "memory":
                all_scores[metric_id] = scores.pop(metric_id).cpu().numpy()
                profiles = packed.pop(metric_id)
            else:
                all_scores[metric_id], profiles = self._read_spilled(metric_id, test_dataset_id)
            with Timer(device=self.device) as timer:
                words = words_from_packbits(profiles)
                cam_orders[metric_id] = cam_order_device(all_scores[metric_id], words)
            times[metric_id].append(timer.get())
            self._cam_sanity_check(cam_orders[metric_id], all_scores[metric_id])
        if mode == "disk":
            shutil.rmtree(self._temp_root(), ignore_errors=True)
        return times, all_scores, cam_orders

    @staticmethod
    def _cam_sanity_check(cam_order: np.ndarray, scores: np.ndarray) -> None:
        if not len(cam_order) == len(set(cam_order.tolist())) == scores.shape[0]:
            raise RuntimeError("CAM order is not unique or not complete")
