"""Hyperparameters and parameter-tree helpers (counterpart of
``neuroimagedisttraining_tpu/core/state.py``).

A parameter tree here is a ``dict`` of name -> tensor, in the model's
``state_dict`` naming; a stacked tree has a leading client axis on every
leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class HyperParams:
    """Local-training hyperparameters: torch.optim.SGD(lr * lr_decay**round,
    momentum, weight_decay), gradient-norm clip at ``grad_clip``,
    ``local_epochs`` epochs of ``steps_per_epoch`` batches of
    ``batch_size``, drawn as per-epoch shuffles (the reference's "epoch"
    batching; its "replacement" mode is not ported)."""

    lr: float = 1e-3
    lr_decay: float = 0.998
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 10.0
    local_epochs: int = 2
    steps_per_epoch: int = 4
    batch_size: int = 16

    @property
    def local_steps(self) -> int:
        return self.local_epochs * self.steps_per_epoch


def clone_tree(tree: Tree) -> Tree:
    return {k: v.clone() for k, v in tree.items()}


def broadcast_tree(tree: Tree, n: int) -> Tree:
    """``n`` copies of ``tree`` along a new leading client axis."""
    return {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
            for k, v in tree.items()}


def weighted_tree_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """Weighted sum over the leading client axis of every leaf — the dense
    sample-weighted aggregation."""
    return {k: torch.tensordot(weights.to(x.dtype), x, dims=1)
            for k, x in stacked.items()}
