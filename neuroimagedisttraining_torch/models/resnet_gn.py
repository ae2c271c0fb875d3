"""The ImageNet-layout ResNet with GroupNorm (counterpart of
``neuroimagedisttraining_tpu/models/resnet_gn.py``): a 7x7/s2 stem of 64
with GroupNorm and relu, a 3x3/s2 max-pool (padding 1, with -inf), four
stages of 64 * 2^i features (basic blocks for ResNet-18/34, bottlenecks of
4x expansion for ResNet-50), a global mean and one dense layer. Every conv
is He-normal with no bias; each residual branch's last GroupNorm starts at
scale zero (the zero-init residual), so every block starts as identity.

Input ``(B, H, W, C)``; ``sample_shape`` ``(H, W, C)`` fixes the input
channels. Module names are flax's auto-names (``Conv_i``, ``GroupNorm_i``,
``_BasicBlockGN_i`` / ``_BottleneckGN_i``, ``Dense_0``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import (
    Conv2d,
    Dense,
    channels_first,
    group_norm,
    he_normal_,
    image_shape,
    max_pool2d,
)


def _conv(cin: int, cout: int, k: int, s: int = 1, p: int = 0) -> Conv2d:
    return Conv2d(cin, cout, k, s, p, use_bias=False, kernel_init=he_normal_)


class _BasicBlockGN(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = _conv(in_features, features, 3, strides, 1)
        self.GroupNorm_0 = group_norm(features)
        self.Conv_1 = _conv(features, features, 3, 1, 1)
        self.GroupNorm_1 = group_norm(features, zero_scale=True)
        self.downsample = in_features != features or strides != 1
        if self.downsample:
            self.Conv_2 = _conv(in_features, features, 1, strides)
            self.GroupNorm_2 = group_norm(features)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        r = self.GroupNorm_2(self.Conv_2(x)) if self.downsample else x
        return torch.relu(y + r)


class _BottleneckGN(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out = features * 4
        self.Conv_0 = _conv(in_features, features, 1)
        self.GroupNorm_0 = group_norm(features)
        self.Conv_1 = _conv(features, features, 3, strides, 1)
        self.GroupNorm_1 = group_norm(features)
        self.Conv_2 = _conv(features, out, 1)
        self.GroupNorm_2 = group_norm(out, zero_scale=True)
        self.downsample = in_features != out or strides != 1
        if self.downsample:
            self.Conv_3 = _conv(in_features, out, 1, strides)
            self.GroupNorm_3 = group_norm(out)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        r = self.GroupNorm_3(self.Conv_3(x)) if self.downsample else x
        return torch.relu(y + r)


class ResNetGN(nn.Module):
    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False,
                 sample_shape: Tuple[int, ...] = (224, 224, 3)):
        super().__init__()
        self.num_classes = num_classes
        block = _BottleneckGN if bottleneck else _BasicBlockGN
        c = image_shape(type(self).__name__, sample_shape)[2]
        self.Conv_0 = _conv(c, 64, 7, 2, 3)
        self.GroupNorm_0 = group_norm(64)
        cin, i = 64, 0
        self.block_names = []
        for stage, n_blocks in enumerate(stage_sizes):
            feats = 64 * (2 ** stage)
            for b in range(n_blocks):
                strides = 2 if (stage > 0 and b == 0) else 1
                name = f"{block.__name__}_{i}"
                setattr(self, name, block(cin, feats, strides))
                self.block_names.append(name)
                cin, i = feats * block.expansion, i + 1
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.Conv_0(channels_first(x))))
        x = max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet18_gn(num_classes: int = 1000, **kw) -> ResNetGN:
    return ResNetGN(num_classes=num_classes, stage_sizes=(2, 2, 2, 2),
                    bottleneck=False, **kw)


def resnet34_gn(num_classes: int = 1000, **kw) -> ResNetGN:
    return ResNetGN(num_classes=num_classes, stage_sizes=(3, 4, 6, 3),
                    bottleneck=False, **kw)


def resnet50_gn(num_classes: int = 1000, **kw) -> ResNetGN:
    return ResNetGN(num_classes=num_classes, stage_sizes=(3, 4, 6, 3),
                    bottleneck=True, **kw)
