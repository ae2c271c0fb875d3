"""ResNet-IP, the additively decomposed (global + personal) CIFAR ResNet
(counterpart of ``neuroimagedisttraining_tpu/models/resnet_ip.py``).

Every conv, norm affine and dense weight exists twice, a global leg
(``*_g``) and a personal leg (``*_v``), and the forward uses their sum: one
conv (or matmul) a layer on ``w_g + w_v``. The norms are stateless
batch-statistic norms (BatchNorm without running statistics, eps 1e-5, the
biased variance as ``mean((x - mean)^2)``) at training and evaluation
alike. Initialization: ``kernel_g`` He-normal (convs) or LeCun-normal (the
dense layer), ``scale_g`` ones, every ``*_v`` and bias zeros.

No leaf is named ``kernel``, so SNIP and the sparse masks see no maskable
leaf (as in the reference). Structure: a 3x3 stem of 16, three stages of
16/32/64 bottlenecks (expansion 4; ``layers`` per stage, (3, 3, 3) being
ResNet-29), a global mean and the dense layer; ``kd`` returns ``[features,
logits]``. Input ``(B, H, W, C)``; ``sample_shape`` fixes the input
channels. Module names are flax's auto-names (``_DualConv_i``,
``_DualNorm_i``, ``_BottleneckIP_i``, ``_DualDense_0``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    _pair,
    channels_first,
    he_normal_,
    image_shape,
    lecun_normal_,
)


def _batch_stat_norm(x, scale, bias, eps: float = 1e-5):
    """Batch statistics over (N, H, W) of NCHW ``x``: the mean, and the
    variance around it in at least float32 (``jnp.var``'s), then the
    affine."""
    dims = (0, 2, 3)
    mu = x.mean(dims, keepdim=True)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var = ((xf - xf.mean(dims, keepdim=True)) ** 2).mean(
        dims, keepdim=True).to(x.dtype)
    y = (x - mu) / torch.sqrt(var + eps)
    c = (1, -1, 1, 1)
    return y * scale.reshape(c) + bias.reshape(c)


class _DualConv(nn.Module):
    """A conv of kernel ``kernel_g + kernel_v`` (OIHW), no bias."""

    def __init__(self, in_features: int, features: int, kernel,
                 strides=1, padding: int = 0):
        super().__init__()
        shape = (features, in_features) + _pair(kernel)
        self.strides, self.padding = _pair(strides), padding
        self.kernel_g = nn.Parameter(torch.empty(shape))
        self.kernel_v = nn.Parameter(torch.zeros(shape))

    def reset_parameters(self, generator: torch.Generator) -> None:
        he_normal_(self.kernel_g, self.kernel_g[0].numel(), generator)
        nn.init.zeros_(self.kernel_v)

    def forward(self, x):
        return F.conv2d(x, self.kernel_g + self.kernel_v, None, self.strides,
                        self.padding)


class _DualNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale_g = nn.Parameter(torch.ones(features))
        self.scale_v = nn.Parameter(torch.zeros(features))
        self.bias_g = nn.Parameter(torch.zeros(features))
        self.bias_v = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator) -> None:
        nn.init.ones_(self.scale_g)
        for p in (self.scale_v, self.bias_g, self.bias_v):
            nn.init.zeros_(p)

    def forward(self, x):
        return _batch_stat_norm(x, self.scale_g + self.scale_v,
                                self.bias_g + self.bias_v)


class _DualDense(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel_g = nn.Parameter(torch.empty(features, in_features))
        self.kernel_v = nn.Parameter(torch.zeros(features, in_features))
        self.bias_g = nn.Parameter(torch.zeros(features))
        self.bias_v = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel_g, self.kernel_g.shape[1], generator)
        for p in (self.kernel_v, self.bias_g, self.bias_v):
            nn.init.zeros_(p)

    def forward(self, x):
        return F.linear(x, self.kernel_g + self.kernel_v,
                        self.bias_g + self.bias_v)


class _BottleneckIP(nn.Module):
    """1x1, 3x3 (strided) and 1x1 (to 4x) dual convs with dual norms, the
    residual through a dual 1x1 conv and norm where the shape changes."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self._DualConv_0 = _DualConv(in_planes, planes, 1)
        self._DualNorm_0 = _DualNorm(planes)
        self._DualConv_1 = _DualConv(planes, planes, 3, stride, 1)
        self._DualNorm_1 = _DualNorm(planes)
        self._DualConv_2 = _DualConv(planes, out, 1)
        self._DualNorm_2 = _DualNorm(out)
        self.downsample = in_planes != out or stride != 1
        if self.downsample:
            self._DualConv_3 = _DualConv(in_planes, out, 1, stride)
            self._DualNorm_3 = _DualNorm(out)

    def forward(self, x):
        y = torch.relu(self._DualNorm_0(self._DualConv_0(x)))
        y = torch.relu(self._DualNorm_1(self._DualConv_1(y)))
        y = self._DualNorm_2(self._DualConv_2(y))
        if self.downsample:
            x = self._DualNorm_3(self._DualConv_3(x))
        return torch.relu(y + x)


class ResNetIP(nn.Module):
    """ResNet_ip: ``layers`` (3, 3, 3) is ResNet-29, (6, 6, 6) ResNet-56,
    (12, 12, 12) ResNet-110."""

    def __init__(self, num_classes: int = 10,
                 layers: Sequence[int] = (3, 3, 3), kd: bool = False,
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        self.kd = kd
        c = image_shape(type(self).__name__, sample_shape)[2]
        self._DualConv_0 = _DualConv(c, 16, 3, 1, 1)
        self._DualNorm_0 = _DualNorm(16)
        cin, i = 16, 0
        self.block_names = []
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64),
                                                       layers)):
            for b in range(n_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"_BottleneckIP_{i}"
                setattr(self, name, _BottleneckIP(cin, planes, stride))
                self.block_names.append(name)
                cin, i = planes * 4, i + 1
        self._DualDense_0 = _DualDense(cin, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self._DualNorm_0(self._DualConv_0(
            channels_first(x))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = x.mean(dim=(2, 3))
        logits = self._DualDense_0(x)
        return [x, logits] if self.kd else logits
