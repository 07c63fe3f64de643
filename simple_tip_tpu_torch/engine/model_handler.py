"""Model-centric utilities: predictions + uncertainties, activation walking.

Counterpart of the JAX package's ``engine/model_handler.py`` ``BaseModel``.
A model is ``(model_def, params)``: ``model_def`` an instance of one of the
port's models (``MnistConvNet``, ``Cifar10ConvNet``, ``ImdbTransformer``;
its own weights are not used) and ``params`` the bridge's
``{"module": state_dict, "fused": kernel operands}``. Timing keeps the
reference's record semantics: per quantifier ``[setup, pred, quant, cam]``
with the prediction time measured once and shared; timers synchronise the
card.
"""

import copy
import logging
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from simple_tip_tpu_torch.device import DeviceLike, resolve
from simple_tip_tpu_torch.models.predict import (
    mc_dropout_votes,
    predict,
    tap_ids,
    walk_taps,
)
from simple_tip_tpu_torch.ops.timer import Timer
from simple_tip_tpu_torch.ops.uncertainty import POINT_PRED_QUANTIFIERS

DROPOUT_SAMPLE_SIZE = 200

logger = logging.getLogger(__name__)


class BaseModel:
    """Wraps (module, params) on one device with prediction, uncertainty and
    activation utilities."""

    def __init__(
        self,
        model_def,
        params,
        activation_layers: Optional[List] = None,
        include_last_layer: bool = False,
        batch_size: int = 32,
        device: DeviceLike = None,
    ):
        self.device = resolve(device)
        self.net = copy.deepcopy(model_def).to(self.device).eval()
        self.net.load_state_dict(params["module"])
        self.fused = {k: v.to(self.device) for k, v in params["fused"].items()}
        self.activation_layers = activation_layers
        self.include_last_layer = include_last_layer
        self.batch_size = batch_size

    def get_pred_and_uncertainty(
        self, x: np.ndarray, seed: int = 0
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray], Dict[str, List[float]]]:
        """Point predictions plus all uncertainty quantifications.

        Returns ``(pred, {name: uncertainty}, {name: [setup, pred, quant,
        cam]})`` with names matching the artifact contract: softmax, pcs,
        softmax_entropy, deep_gini, and VR when the model has dropout.
        ``seed`` seeds the MC-dropout generator.
        """
        with Timer(device=self.device) as pred_timer:
            probs = predict(self.net, self.fused, x, self.device)
        pred_time = pred_timer.get()

        uncertainties: Dict[str, np.ndarray] = {}
        times: Dict[str, List[float]] = {}
        pred = None
        for name, quantifier in POINT_PRED_QUANTIFIERS.items():
            with Timer(device=self.device) as q_timer:
                q_pred, unc = quantifier(probs)
            if pred is None:
                pred = q_pred.cpu().numpy()
            uncertainties[name] = unc.cpu().numpy()
            times[name] = [0, pred_time, q_timer.get(), 0]

        if getattr(self.net, "has_dropout", False):
            logger.info("Collecting MC-Dropout samples")
            generator = torch.Generator(device=self.device).manual_seed(seed)
            with Timer(device=self.device) as sampling_timer:
                counts = mc_dropout_votes(
                    self.net,
                    x,
                    n_samples=DROPOUT_SAMPLE_SIZE,
                    generator=generator,
                    batch_size=max(self.batch_size, 128),
                    device=self.device,
                )
            with Timer(device=self.device) as quant_timer:
                majority_count = counts.max(dim=1).values.cpu().numpy()
                vr = 1.0 - majority_count / DROPOUT_SAMPLE_SIZE
            uncertainties["VR"] = vr
            times["VR"] = [0, sampling_timer.get(), quant_timer.get(), 0]
        else:
            logger.warning(
                "No stochastic layers found in model. Skipping stochastic quantifiers."
            )
        return pred, uncertainties, times

    def _layer_ids(self) -> List[int]:
        if self.activation_layers is None:
            raise ValueError("No activation layers specified")
        return tap_ids(self.activation_layers)

    def get_activations(self, x: np.ndarray) -> List[torch.Tensor]:
        """Tapped layer activations (NHWC) of the whole of ``x`` on the device."""
        chunks = list(self.walk_activations(x))
        return [torch.cat([c[i] for c in chunks], dim=0) for i in range(len(chunks[0]))]

    def walk_activations(
        self, x: np.ndarray, badge_size: Optional[int] = None
    ) -> Iterator[List[torch.Tensor]]:
        """Stream activations badge by badge over a potentially large dataset."""
        return walk_taps(
            self.net,
            x,
            self._layer_ids(),
            self.include_last_layer,
            badge_size or self.batch_size,
            self.device,
        )
