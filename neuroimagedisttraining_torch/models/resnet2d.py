"""The CIFAR ResNet-18s (counterpart of
``neuroimagedisttraining_tpu/models/resnet2d.py``).

* :class:`ResNet18GN`: a 3x3 stem of 64 (no max-pool), four stages of
  64/128/256/512 planes of basic blocks (2 each by default), a 4x4 average
  pool and one dense layer; GroupNorm everywhere;
* :class:`TinyResNet18`: the 64x64 variant, a stride-2 stem and a 3x3/s2
  max-pool (padding 1, with -inf) before the stages, a global mean;
* :class:`OriginalResNet18`: :class:`ResNet18GN` with flax's BatchNorm in
  place of GroupNorm. Its running statistics live outside the parameters,
  as flax's ``batch_stats``: :meth:`OriginalResNet18.apply_with_stats`
  runs it on them (a training forward returns the updated ones). The
  federated algorithms run a model on its parameters alone, so there, as
  in the JAX package, its first forward raises
  :class:`~.layers.ScopeCollectionNotFound` with flax's message: the FL
  trainers use the GroupNorm twin.

Input ``(B, H, W, C)``; ``sample_shape`` ``(H, W, C)`` fixes the input
channels and the dense layer's width. Module names are flax's auto-names
(``Conv_i``, ``GroupNorm_i``, ``BatchNorm_i``, ``BasicBlock2D_i``,
``_BNBasicBlock2D_i``, ``Dense_0``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .layers import (
    avg_pool2d,
    batch_stats_scope,
    BatchNorm,
    channels_first,
    Conv2d,
    Dense,
    flatten,
    group_norm,
    image_shape,
    init_batch_stats,
    max_pool2d,
    name_batch_norms,
)

PLANES = (64, 128, 256, 512)


class BasicBlock2D(nn.Module):
    """Two 3x3 convs (the first strided) with GroupNorm, the residual
    through a 1x1 conv and its GroupNorm where the stride or the width
    changes; no conv bias. NCHW in and out."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 norm=group_norm):
        super().__init__()
        self.norm_name = ("BatchNorm" if norm is BatchNorm
                          else "GroupNorm")
        self.Conv_0 = Conv2d(in_planes, planes, 3, stride, 1, use_bias=False)
        setattr(self, f"{self.norm_name}_0", norm(planes))
        self.Conv_1 = Conv2d(planes, planes, 3, 1, 1, use_bias=False)
        setattr(self, f"{self.norm_name}_1", norm(planes))
        self.downsample = stride != 1 or in_planes != planes
        if self.downsample:
            self.Conv_2 = Conv2d(in_planes, planes, 1, stride,
                                 use_bias=False)
            setattr(self, f"{self.norm_name}_2", norm(planes))

    def _norm(self, i: int, x, train: bool):
        mod = getattr(self, f"{self.norm_name}_{i}")
        return mod(x, train) if isinstance(mod, BatchNorm) else mod(x)

    def forward(self, x, train: bool = False):
        y = torch.relu(self._norm(0, self.Conv_0(x), train))
        y = self._norm(1, self.Conv_1(y), train)
        res = (self._norm(2, self.Conv_2(x), train) if self.downsample
               else x)
        return torch.relu(y + res)


class _BNBasicBlock2D(BasicBlock2D):
    """:class:`BasicBlock2D` with BatchNorm."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__(in_planes, planes, stride, norm=BatchNorm)


def _add_stages(model: nn.Module, block, num_blocks: Sequence[int]) -> None:
    cin, i = PLANES[0], 0
    model.block_names = []
    for stage, (planes, n) in enumerate(zip(PLANES, num_blocks)):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            name = f"{block.__name__}_{i}"
            setattr(model, name, block(cin, planes, stride))
            model.block_names.append(name)
            cin, i = planes, i + 1


def _strided(size: int, num_blocks: Sequence[int]) -> int:
    """An extent after the stages' stride-2 heads (k3/s2/p1)."""
    for n in num_blocks[1:4]:
        if n:
            size = (size - 1) // 2 + 1
    return size


class ResNet18GN(nn.Module):
    """The CIFAR ResNet-18 with GroupNorm everywhere."""

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 64, 3, 1, 1, use_bias=False)
        self.GroupNorm_0 = group_norm(64)
        _add_stages(self, BasicBlock2D, num_blocks)
        h, w = _strided(h, num_blocks) // 4, _strided(w, num_blocks) // 4
        self.Dense_0 = Dense(h * w * self._width(num_blocks), num_classes)

    @staticmethod
    def _width(num_blocks: Sequence[int]) -> int:
        used = [p for p, n in zip(PLANES, num_blocks) if n]
        return used[-1] if used else PLANES[0]

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(channels_first(x))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(flatten(avg_pool2d(x, 4, 4)))


class TinyResNet18(nn.Module):
    """The 64x64 ResNet-18: a 3x3/s2 stem, GroupNorm, relu and a 3x3/s2
    max-pool (padding 1) before the stages; a global mean."""

    def __init__(self, num_classes: int = 200,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 sample_shape: Tuple[int, ...] = (64, 64, 3)):
        super().__init__()
        self.num_classes = num_classes
        c = image_shape(type(self).__name__, sample_shape)[2]
        self.Conv_0 = Conv2d(c, 64, 3, 2, 1, use_bias=False)
        self.GroupNorm_0 = group_norm(64)
        _add_stages(self, BasicBlock2D, num_blocks)
        self.Dense_0 = Dense(ResNet18GN._width(num_blocks), num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(channels_first(x))))
        x = max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


class OriginalResNet18(nn.Module):
    """The BatchNorm CIFAR ResNet-18 (module docstring)."""

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 64, 3, 1, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(64)
        _add_stages(self, _BNBasicBlock2D, num_blocks)
        h, w = _strided(h, num_blocks) // 4, _strided(w, num_blocks) // 4
        self.Dense_0 = Dense(h * w * ResNet18GN._width(num_blocks),
                             num_classes)
        name_batch_norms(self)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.BatchNorm_0(self.Conv_0(channels_first(x)),
                                        train))
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        return self.Dense_0(flatten(avg_pool2d(x, 4, 4)))

    def init_batch_stats(self) -> Dict[str, torch.Tensor]:
        """The running statistics flax's init gives: means 0, variances
        1."""
        return init_batch_stats(self)

    def apply_with_stats(self, params: Dict[str, torch.Tensor],
                         batch_stats: Dict[str, torch.Tensor], x,
                         train: bool = False):
        """The model on ``params`` and the running statistics
        ``batch_stats``: flax's ``apply({"params": p, "batch_stats": s},
        x, train=train, mutable=["batch_stats"] if train else False)``.
        Returns the logits, and in training ``(logits, new_stats)``."""
        with batch_stats_scope(self, batch_stats) as updates:
            out = torch.func.functional_call(self, params, (x,),
                                             {"train": train})
        if train:
            return out, dict(updates)
        return out
