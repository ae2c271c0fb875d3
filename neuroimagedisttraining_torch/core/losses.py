"""Loss functions (counterpart of ``neuroimagedisttraining_tpu/core/losses.py``).

ABCD sex classification trains binary cross-entropy on a single logit.
"""
from __future__ import annotations

from typing import Callable

import torch


def bce_with_logits_per_example(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-example BCE with logits; logits ``[B, 1]`` or ``[B]``.

    The smooth form ``x*(1-y) + softplus(-x)``: its gradient is
    ``sigmoid(x) - y`` everywhere, as the reference's is. Softplus is
    ``logaddexp(-x, 0)``, exact for every ``x`` (torch's ``F.softplus``
    switches to the identity above its threshold)."""
    logits = logits.reshape(logits.shape[0], -1)[:, 0]
    labels = labels.to(logits.dtype)
    return logits * (1.0 - labels) + torch.logaddexp(
        -logits, torch.zeros_like(logits))


PER_EXAMPLE_LOSSES = {"bce": bce_with_logits_per_example}


def make_loss_fn(loss_type: str) -> Callable:
    if loss_type not in PER_EXAMPLE_LOSSES:
        raise ValueError(f"unknown loss type: {loss_type!r}")
    per_ex = PER_EXAMPLE_LOSSES[loss_type]
    return lambda logits, labels: per_ex(logits, labels).mean()


def predictions(logits: torch.Tensor, loss_type: str) -> torch.Tensor:
    """Hard predictions: ``logit >= 0`` (sigmoid >= 0.5) for BCE, argmax
    otherwise."""
    if loss_type == "bce":
        return (logits.reshape(logits.shape[0], -1)[:, 0] >= 0.0).to(
            torch.int32)
    return logits.argmax(dim=-1).to(torch.int32)
