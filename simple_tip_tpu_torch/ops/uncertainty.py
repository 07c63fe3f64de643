"""Softmax-based uncertainty quantifiers on torch tensors.

Same conventions as the JAX package's ``ops/uncertainty.py``: each returns
``(predictions, uncertainty)`` where higher means more likely
misclassified (confidences are negated), entropy is in bits (log base 2),
and the registry keys are the artifact names.
"""

from typing import Tuple

import torch


def max_softmax(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla softmax score: uncertainty = -max(softmax)."""
    return probs.argmax(dim=1), -probs.max(dim=1).values


def pcs(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prediction-confidence score: uncertainty = -(max - second_max)."""
    top2 = torch.topk(probs, 2, dim=1).values
    return probs.argmax(dim=1), -(top2[:, 0] - top2[:, 1])


def softmax_entropy(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax entropy: -sum p log2 p (0 log 0 := 0)."""
    positive = probs > 0
    logs = torch.where(positive, torch.log2(torch.where(positive, probs, 1.0)), 0.0)
    return probs.argmax(dim=1), -(probs * logs).sum(dim=1)


def deep_gini(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepGini impurity: 1 - sum(softmax^2)."""
    return probs.argmax(dim=1), 1 - (probs * probs).sum(dim=1)


def variation_ratio(sampled_probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """MC-dropout variation ratio over ``(samples, batch, classes)`` softmax
    outputs: VR = 1 - (votes for the majority class) / samples; the
    prediction is the majority class (lowest class on ties)."""
    num_samples, _, num_classes = sampled_probs.shape
    votes = sampled_probs.argmax(dim=2)
    counts = torch.nn.functional.one_hot(votes, num_classes).sum(dim=0)
    majority_count, _ = counts.max(dim=1)
    return counts.argmax(dim=1), 1.0 - majority_count.double() / num_samples


POINT_PRED_QUANTIFIERS = {
    "softmax": max_softmax,
    "pcs": pcs,
    "softmax_entropy": softmax_entropy,
    "deep_gini": deep_gini,
}
