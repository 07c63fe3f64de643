"""Neuron-coverage worker: one pass of aggregate statistics over the training
set, then 12 configured coverage metrics with CAM orders per test set.

Counterpart of the JAX package's ``CoverageWorker``: the same metric
configuration (NBC_0/0.5/1, SNAC_0/0.5/1, NAC_0/0.75, TKNC_1/2/3, KMNC_2),
the same per-metric setup debits for the shared statistics, and the CAM
sanity check. Profiles are computed per badge on the device and kept there
packed; the CAM greedy phase runs on the device too, and only the pick list
and the scores reach the host. Not ported: the disk spill and the
coverage-statistics cache.
"""

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

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


class CoverageWorker:
    """The 12 configured neuron-coverage instances over one model."""

    def __init__(self, base_model: BaseModel, training_set: np.ndarray):
        self.base_model = base_model
        self.device = base_model.device
        self.metrics: Dict[str, CoverageMethod] = {}
        self.setup_times: Dict[str, float] = {}

        agg_stats = DeviceAggregateStatisticsCollector()
        pred_timer = Timer(start=True, device=self.device)
        for activations in base_model.walk_activations(
            training_set, badge_size=PROFILE_BADGE_SIZE
        ):
            pred_timer.stop()
            agg_stats.track(activations)
            pred_timer.start()
        pred_timer.stop()
        mins, maxs, std = agg_stats.get()

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

    def _profiles(self, test_dataset: np.ndarray, times):
        """Per metric: (scores, packed profiles) over the whole test set, on
        the device; pred and quant time are accumulated into ``times``."""
        scores = {m: [] for m in self.metrics}
        packed = {m: [] for m in self.metrics}
        walk = self.base_model.walk_activations(test_dataset, badge_size=PROFILE_BADGE_SIZE)
        while True:
            with Timer(device=self.device) as pred_timer:
                activations = next(walk, None)
            if activations is None:
                break
            with Timer(device=self.device) as quant_timer:
                fused_out = self._fused_fn(activations)
            quant_time = quant_timer.get() / len(self.metrics)
            for metric_id, (s, p) in fused_out.items():
                times[metric_id][1] += pred_timer.get()
                times[metric_id][2] += quant_time
                scores[metric_id].append(s)
                packed[metric_id].append(p)
        return (
            {m: torch.cat(v) for m, v in scores.items()},
            {m: torch.cat(v) for m, v in packed.items()},
        )

    def evaluate_all(
        self, test_dataset: np.ndarray, test_dataset_id
    ) -> Tuple[Dict[str, List[float]], Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """All coverages + CAM orders for one test set.

        Returns ``(times, scores, cam_orders)`` with times =
        ``[setup, pred, quant, cam]`` per metric.
        """
        times = {m: [setup, 0.0, 0.0] for m, setup in self.setup_times.items()}
        scores, packed = self._profiles(test_dataset, times)
        all_scores, cam_orders = {}, {}
        for metric_id in self.metrics:
            all_scores[metric_id] = scores[metric_id].cpu().numpy()
            with Timer(device=self.device) as timer:
                words = words_from_packbits(packed.pop(metric_id))
                cam_orders[metric_id] = cam_order_device(all_scores[metric_id], words)
            times[metric_id].append(timer.get())
            self._cam_sanity_check(cam_orders[metric_id], all_scores[metric_id])
        return times, all_scores, cam_orders

    @staticmethod
    def _cam_sanity_check(cam_order: np.ndarray, scores: np.ndarray) -> None:
        if not len(cam_order) == len(set(cam_order.tolist())) == scores.shape[0]:
            raise RuntimeError("CAM order is not unique or not complete")
