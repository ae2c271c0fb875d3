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
    ``batch_size``. ``batching`` "epoch" (the default) draws per-epoch
    shuffles, each client consuming its own ``ceil(n_i / batch)`` batches
    per epoch; "replacement" draws every step's batch uniformly with
    replacement from the client's valid rows, every step active."""

    lr: float = 1e-3
    lr_decay: float = 0.998
    momentum: float = 0.0
    weight_decay: float = 0.0
    grad_clip: float = 10.0
    local_epochs: int = 2
    steps_per_epoch: int = 4
    batch_size: int = 16
    batching: str = "epoch"

    def __post_init__(self):
        if self.batching not in ("epoch", "replacement"):
            raise ValueError(f"batching {self.batching!r} not in "
                             "('epoch', 'replacement')")

    @property
    def local_steps(self) -> int:
        return self.local_epochs * self.steps_per_epoch


def clone_tree(tree: Tree) -> Tree:
    return {k: v.clone() for k, v in tree.items()}


def clone_generator(g: torch.Generator) -> torch.Generator:
    """A fresh generator on ``g``'s device in ``g``'s exact state: drawing
    from either leaves the other where it was."""
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def broadcast_tree(tree: Tree, n: int) -> Tree:
    """``n`` copies of ``tree`` along a new leading client axis."""
    return {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
            for k, v in tree.items()}


def zeros_like_tree(tree: Tree) -> Tree:
    return {k: torch.zeros_like(v) for k, v in tree.items()}


def tree_index(tree: Tree, idx: torch.Tensor) -> Tree:
    """Rows ``idx`` of the leading (client) axis of every leaf."""
    return {k: v.index_select(0, idx) for k, v in tree.items()}


def tree_scatter_update(tree: Tree, idx: torch.Tensor, update: Tree) -> Tree:
    """``tree`` with rows ``idx`` of every leaf replaced by ``update``'s
    (leading axis ``len(idx)``); out of place, like the reference."""
    return {k: v.index_copy(0, idx, update[k]) for k, v in tree.items()}


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``sum`` over the leading axis, added in index order (a fixed order
    on every device)."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _weighted_sums(xs, weights: torch.Tensor):
    """``sum_c w[c] * x[c]`` over the leading axis of each tensor of ``xs``,
    from zero, in static client order, one rounding per multiply and per
    add, as multi-tensor ops (two launches per client for all tensors)."""
    w = weights.to(xs[0].dtype)
    acc = [torch.zeros_like(x[0]) for x in xs]
    for c in range(xs[0].shape[0]):
        acc = torch._foreach_add(acc, torch._foreach_mul([x[c] for x in xs],
                                                         w[c]))
    return acc


def weighted_sum(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``sum_c w[c] * x[c]`` over the leading axis of ``x``, from zero, in
    static client order, one rounding per multiply and per add.

    This is the plain version of the weighted-sum kernel
    (``ops/kernels.py::fused_weighted_sum``), through which every f32 and
    bf16 aggregate of the port contracts: the kernel on the card, this on
    the CPU, the same bits on both. It is elementwise per output value, so
    it gives the same bits for a whole leaf as for any bucket cut from it
    (``agg_impl`` "bucketed" equals "dense" bit for bit), and no global
    setting can move it (a ``tensordot`` on the card would run in TF32 when
    ``torch.backends.cuda.matmul.allow_tf32`` is set)."""
    return _weighted_sums([x], weights)[0]


def mix_over_clients(mix: torch.Tensor, stacked: Tree) -> Tree:
    """Contract a ``[C, C]`` mixing (or adjacency) matrix against the
    leading client axis of every leaf: ``out_i = sum_j mix[i, j] *
    leaf_j``, the gossip step of DisPFL and DPSGD. One f32 matrix product
    per leaf, as the reference's ``tensordot`` is (its order of the sums
    differs by round-off only; a 0/1 matrix against 0/1 masks gives exact
    counts)."""
    out = {}
    for k, v in stacked.items():
        c = v.shape[0]
        out[k] = torch.matmul(mix.to(v.dtype), v.reshape(c, -1)).reshape(
            v.shape)
    return out


def weighted_tree_sum(stacked: Tree, weights: torch.Tensor) -> Tree:
    """:func:`weighted_sum` over every leaf at once, as multi-tensor ops:
    the plain version of the dense sample-weighted aggregation."""
    return dict(zip(stacked, _weighted_sums(list(stacked.values()),
                                            weights)))
