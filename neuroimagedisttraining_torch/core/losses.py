"""Loss functions (counterpart of ``neuroimagedisttraining_tpu/core/losses.py``).

ABCD sex classification trains binary cross-entropy on a single logit; the
image path trains softmax cross-entropy, and the regression head of
``AlexNet3DRegression`` a squared error. A model that returns a list
(``[logits, features]``) is scored on its first output.
"""
from __future__ import annotations

from typing import Callable

import torch


def _first_output(out):
    """The logits of a model that returns ``[logits, features]`` (the
    reference's deeper and regression AlexNets); any other output as it
    is."""
    if isinstance(out, (tuple, list)):
        return out[0]
    return out


def bce_with_logits_per_example(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-example BCE with logits; logits ``[B, 1]`` or ``[B]``.

    The smooth form ``x*(1-y) + softplus(-x)``: its gradient is
    ``sigmoid(x) - y`` everywhere, as the reference's is. Softplus is
    ``logaddexp(-x, 0)``, exact for every ``x`` (torch's ``F.softplus``
    switches to the identity above its threshold)."""
    logits = _first_output(logits)
    logits = logits.reshape(logits.shape[0], -1)[:, 0]
    labels = labels.to(logits.dtype)
    return logits * (1.0 - labels) + torch.logaddexp(
        -logits, torch.zeros_like(logits))


def softmax_ce_per_example(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy; logits ``[B, K]``, integer labels
    ``[B]``."""
    logits = _first_output(logits)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.take_along_dim(
        logp, labels.reshape(-1, 1).to(torch.int64), dim=-1)[:, 0]


def mse_per_example(preds: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Per-example squared error of the first output column (the
    regression head)."""
    preds = _first_output(preds)
    preds = preds.reshape(preds.shape[0], -1)[:, 0]
    return torch.square(preds - targets.to(preds.dtype))


PER_EXAMPLE_LOSSES = {
    "bce": bce_with_logits_per_example,
    "ce": softmax_ce_per_example,
    "mse": mse_per_example,
}


def bce_with_logits_loss(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits_per_example(logits, labels).mean()


def softmax_ce_loss(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    return softmax_ce_per_example(logits, labels).mean()


def mse_loss(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return mse_per_example(preds, targets).mean()


def make_loss_fn(loss_type: str) -> Callable:
    if loss_type not in PER_EXAMPLE_LOSSES:
        raise ValueError(f"unknown loss type: {loss_type!r}")
    per_ex = PER_EXAMPLE_LOSSES[loss_type]
    return lambda logits, labels: per_ex(logits, labels).mean()


def predictions(logits: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Hard predictions, the reference's rule: ``logit >= 0`` (sigmoid >=
    0.5) for BCE, argmax otherwise (the MSE head included)."""
    logits = _first_output(logits)
    if loss_type == "bce":
        return (logits.reshape(logits.shape[0], -1)[:, 0] >= 0.0).to(
            torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)
