"""The small 2D CNN zoo for the CIFAR and MNIST families (counterpart of
``neuroimagedisttraining_tpu/models/cnn2d.py``).

* :class:`CNNCifar10` / :class:`CNNCifar100`: two 5x5 VALID convs of 64,
  each with relu and a 2x2 max-pool, then dense 384, 192 and the classes;
* :class:`CNNOriginalFedAvg`: the FedAvg paper's CNN, two 5x5 SAME convs
  (32, 64) with 2x2 max-pools, dense 512 and the classes;
* :class:`LeNet5`: the SNIP paper's variant, 5x5 VALID convs of 20 and 50
  with 2x2 max-pools, dense 500 and the classes;
* :class:`VGG11` / :class:`VGG16`: configurations A and D of 3x3 convs
  (padding 1) with GroupNorm and relu, 2x2 max-pools, one dense layer;
* :class:`CNNDropOut`: two 3x3 VALID convs (32, 64), a 2x2 max-pool,
  dropout 0.25, dense 128, dropout 0.5 and the classes.

Input ``(B, H, W, C)``; ``sample_shape`` ``(H, W, C)`` fixes the input
channels and the first dense layer's width (the reference infers both at
init). Module names are flax's auto-names (``Conv_i``, ``GroupNorm_i``,
``Dense_i``), so the reference's parameters convert name for name; the
flatten is channels-last, so its dense kernels carry over row for row. The
dropout layers apply in the reference's NHWC layout, so its keep masks
feed in unchanged (``models/layers.py::dropout``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import (
    channels_first,
    channels_last,
    Conv2d,
    Dense,
    dropout,
    flatten,
    group_norm,
    image_shape,
    max_pool2d,
)


def _out(size: int, k: int, s: int = 1, pad: int = 0) -> int:
    """A VALID (or ``pad``-per-side) window's output extent."""
    return (size + 2 * pad - k) // s + 1


class _CNNCifar(nn.Module):
    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 64, 5, padding="VALID")
        self.Conv_1 = Conv2d(64, 64, 5, padding="VALID")
        for _ in range(2):
            h, w = _out(h, 5) // 2, _out(w, 5) // 2
        self.Dense_0 = Dense(h * w * 64, 384)
        self.Dense_1 = Dense(384, 192)
        self.Dense_2 = Dense(192, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        x = max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = torch.relu(self.Dense_0(flatten(x)))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x)


class CNNCifar10(_CNNCifar):
    def __init__(self, num_classes: int = 10, **kw):
        super().__init__(num_classes, **kw)


class CNNCifar100(_CNNCifar):
    def __init__(self, num_classes: int = 100, **kw):
        super().__init__(num_classes, **kw)


class CNNOriginalFedAvg(nn.Module):
    """McMahan et al.'s FedAvg CNN; ``sample_shape`` defaults to MNIST's."""

    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 32, 5, padding="SAME")
        self.Conv_1 = Conv2d(32, 64, 5, padding="SAME")
        h, w = h // 2 // 2, w // 2 // 2
        self.Dense_0 = Dense(h * w * 64, 512)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        x = max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = torch.relu(self.Dense_0(flatten(x)))
        return self.Dense_1(x)


class LeNet5(nn.Module):
    """The SNIP paper's LeNet-5 (no padding in the first conv)."""

    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 20, 5, padding="VALID")
        self.Conv_1 = Conv2d(20, 50, 5, padding="VALID")
        for _ in range(2):
            h, w = _out(h, 5) // 2, _out(w, 5) // 2
        self.Dense_0 = Dense(h * w * 50, 500)
        self.Dense_1 = Dense(500, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        x = max_pool2d(torch.relu(self.Conv_0(x)), 2, 2)
        x = max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        x = torch.relu(self.Dense_0(flatten(x)))
        return self.Dense_1(x)


VGG_CFG_A = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M")
VGG_CFG_D = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class _VGG(nn.Module):
    cfg: Sequence = VGG_CFG_A

    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (32, 32, 3),
                 use_group_norm: bool = True):
        super().__init__()
        self.num_classes = num_classes
        self.use_group_norm = use_group_norm
        h, w, c = image_shape(type(self).__name__, sample_shape)
        i = 0
        for v in self.cfg:
            if v == "M":
                h, w = h // 2, w // 2
                continue
            setattr(self, f"Conv_{i}", Conv2d(c, v, 3, padding=1))
            if use_group_norm:
                setattr(self, f"GroupNorm_{i}", group_norm(v))
            c, i = v, i + 1
        self.Dense_0 = Dense(h * w * c, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        i = 0
        for v in self.cfg:
            if v == "M":
                x = max_pool2d(x, 2, 2)
                continue
            x = getattr(self, f"Conv_{i}")(x)
            if self.use_group_norm:
                x = getattr(self, f"GroupNorm_{i}")(x)
            x = torch.relu(x)
            i += 1
        return self.Dense_0(flatten(x))


class VGG11(_VGG):
    cfg = VGG_CFG_A


class VGG16(_VGG):
    cfg = VGG_CFG_D


class CNNDropOut(nn.Module):
    """The "Adaptive Federated Optimization" EMNIST CNN: 3x3 convs of 32
    and 64, a 2x2 max-pool, dropout 0.25 (slot 0), dense 128, dropout 0.5
    (slot 1), the classes. ``sample_shape`` defaults to (28, 28, 1)."""

    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (28, 28, 1)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.Conv_0 = Conv2d(c, 32, 3, padding="VALID")
        self.Conv_1 = Conv2d(32, 64, 3, padding="VALID")
        h, w = _out(_out(h, 3), 3) // 2, _out(_out(w, 3), 3) // 2
        self.Dense_0 = Dense(h * w * 64, 128)
        self.Dense_1 = Dense(128, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        x = torch.relu(self.Conv_0(x))
        x = max_pool2d(torch.relu(self.Conv_1(x)), 2, 2)
        # the reference drops in its NHWC layout
        x = dropout(channels_last(x), 0.25, train, rng, 0)
        x = torch.relu(self.Dense_0(x.reshape(x.shape[0], -1)))
        x = dropout(x, 0.5, train, rng, 1)
        return self.Dense_1(x)
