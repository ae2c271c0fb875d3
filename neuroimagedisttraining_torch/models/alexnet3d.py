"""AlexNet3D over phase-decomposed volumes, and the CI-scale 3D CNNs
(counterpart of ``neuroimagedisttraining_tpu/models/alexnet3d.py``).

Public inputs keep the reference's layouts — phased ``(B, D', H', 8, W')``
for the s2d models, ``(B, D, H, W, 1)`` for :class:`SmallCNN3D` — and are
permuted to NCDHW inside. Spatial arithmetic (VALID convs, floor-mode pools)
matches the reference, so on the canonical 121x145x121 volume the flatten
width is 256.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    Conv3d,
    Dense,
    PhasedStemKernel,
    S2DStemConv,
    dropout,
    flatten,
    group_norm,
    max_pool3d,
    num_groups,
    phased_input,
)


def _group_stats(zf, groups: int, eps: float):
    """Per-(sample, group) mean and std of an NCDHW f32 tensor, broadcast
    back per channel as ``(B, C, 1, 1, 1)``; variance ``E[z^2] - E[z]^2``
    clipped at 0. Shared by both S2DStemStage branches."""
    b, c = zf.shape[:2]
    zg = zf.reshape(b, groups, -1)
    mu = zg.mean(-1)
    var = (zg * zg).mean(-1) - mu * mu
    sig = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    per = c // groups
    shape = (b, c, 1, 1, 1)
    return (mu.repeat_interleave(per, dim=1).reshape(shape),
            sig.repeat_interleave(per, dim=1).reshape(shape))


class S2DStemStage(PhasedStemKernel):
    """The AlexNet3D stem stage: k5/s2 phased conv, GroupNorm, relu and
    MaxPool3d(3, 3), with the pool hoisted before the normalize affine
    (``pool_first``, the reference's default).

    Max-pool commutes with a monotone per-channel affine + relu. Channels
    with a negative GroupNorm scale need the window minimum instead, so
    ``sign(scale)`` is folded into the conv kernel and bias: one max-pool on
    the signed conv output ``zs`` serves every channel, and the full-size
    normalized tensor is never built. The GroupNorm statistics always come
    from the pre-pool conv output. ``pool_first=False`` is the textbook
    order with the same parameters.

    Parameters: ``kernel`` (masked phased conv), ``bias``, and the GroupNorm
    pair ``scale``/``bias_gn``. Input phased, output NCDHW."""

    def __init__(self, features: int = 64, max_groups: int = 32,
                 pool_first: bool = True, eps: float = 1e-6):
        from ..ops.s2d import KERNEL

        super().__init__(KERNEL, features)
        self.bias = nn.Parameter(torch.zeros(features))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias_gn = nn.Parameter(torch.zeros(features))
        self.groups = num_groups(features, max_groups)
        self.pool_first = pool_first
        self.eps = eps

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        nn.init.zeros_(self.bias)
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias_gn)

    def forward(self, x):
        x = phased_input(x)
        w = self.masked()
        gamma = self.scale.float().reshape(1, -1, 1, 1, 1)
        beta = self.bias_gn.float().reshape(1, -1, 1, 1, 1)
        if not self.pool_first:
            z = F.conv3d(x, w, self.bias)
            mu, sig = _group_stats(z.float(), self.groups, self.eps)
            y = torch.relu((z.float() - mu) / sig * gamma + beta).to(z.dtype)
            return max_pool3d(y, 3, 3)
        sign = torch.where(self.scale >= 0, 1.0, -1.0).to(w.dtype)
        zs = F.conv3d(x, w * sign.reshape(-1, 1, 1, 1, 1), self.bias * sign)
        sf = sign.float().reshape(1, -1, 1, 1, 1)
        mu, sig = _group_stats(zs.float() * sf, self.groups, self.eps)
        sel = max_pool3d(zs, 3, 3).float() * sf
        return torch.relu((sel - mu) / sig * gamma + beta).to(zs.dtype)


def _alexnet_flat_width(sample_shape: Tuple[int, ...], width: int) -> int:
    """Flatten width of AlexNet3DS2D for a phased ``(D', H', 8, W')``
    sample: stem conv (k3 VALID) + pool3, conv k3 VALID + pool3, three
    padded convs, pool3."""
    d, h, _, w = sample_shape
    out = 1
    for s in (d, h, w):
        s = (s - 2) // 3
        s = (s - 2) // 3
        out *= s // 3
    return out * width


class AlexNet3DS2D(nn.Module):
    """AlexNet3D over phase-decomposed input: same function class and output
    as the dense-stem AlexNet3D. ``sample_shape`` is the phased per-sample
    shape, ``(61, 73, 8, 61)`` for the 121x145x121 ABCD volume; it fixes the
    first dense layer's width. The stem's GroupNorm lives in the stem stage,
    so the remaining norms are ``GroupNorm_0..3``."""

    def __init__(self, num_classes: int = 1, dropout_rate: float = 0.5,
                 widths: tuple = (64, 128, 192, 192, 128),
                 pool_first: bool = True,
                 sample_shape: Tuple[int, ...] = (61, 73, 8, 61)):
        super().__init__()
        w1, w2, w3, w4, w5 = widths
        self.dropout_rate = dropout_rate
        self.S2DStemStage_0 = S2DStemStage(features=w1, pool_first=pool_first)
        self.Conv3d_0 = Conv3d(w1, w2, kernel_size=3)
        self.GroupNorm_0 = group_norm(w2)
        self.Conv3d_1 = Conv3d(w2, w3, kernel_size=3, padding=1)
        self.GroupNorm_1 = group_norm(w3)
        self.Conv3d_2 = Conv3d(w3, w4, kernel_size=3, padding=1)
        self.GroupNorm_2 = group_norm(w4)
        self.Conv3d_3 = Conv3d(w4, w5, kernel_size=3, padding=1)
        self.GroupNorm_3 = group_norm(w5)
        flat = _alexnet_flat_width(tuple(sample_shape), w5)
        if flat < 1:
            raise ValueError(f"sample_shape {sample_shape} is too small for "
                             "AlexNet3DS2D's three pools")
        self.Dense_0 = Dense(flat, 64)
        self.Dense_1 = Dense(64, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = self.S2DStemStage_0(x)
        x = torch.relu(self.GroupNorm_0(self.Conv3d_0(x)))
        x = max_pool3d(x, 3, 3)
        x = torch.relu(self.GroupNorm_1(self.Conv3d_1(x)))
        x = torch.relu(self.GroupNorm_2(self.Conv3d_2(x)))
        x = torch.relu(self.GroupNorm_3(self.Conv3d_3(x)))
        x = max_pool3d(x, 3, 3)
        x = dropout(flatten(x), self.dropout_rate, train, rng, 0)
        x = torch.relu(self.Dense_0(x))
        x = dropout(x, self.dropout_rate, train, rng, 1)
        return self.Dense_1(x)


class SmallCNN3D(nn.Module):
    """Tiny 3D CNN for CI-scale runs: conv(k3/s2/p1) + GroupNorm + relu,
    conv(k3/p1) + relu, global average pool, dense. Input
    ``(B, D, H, W, 1)``."""

    def __init__(self, num_classes: int = 1, width: int = 8,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.Conv3d_0 = Conv3d(1, width, kernel_size=3, strides=2, padding=1)
        self.GroupNorm_0 = group_norm(width)
        self.Conv3d_1 = Conv3d(width, width * 2, kernel_size=3, padding=1)
        self.Dense_0 = Dense(width * 2, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = x.permute(0, 4, 1, 2, 3)
        x = torch.relu(self.GroupNorm_0(self.Conv3d_0(x)))
        x = torch.relu(self.Conv3d_1(x)).mean(dim=(2, 3, 4))
        x = dropout(x, self.dropout_rate, train, rng, 0)
        return self.Dense_0(x)


class SmallCNN3DS2D(nn.Module):
    """:class:`SmallCNN3D` over phased input (k3/s2/p1 stem spec): per
    sample ``ops.s2d.phased_sample_shape(vol, kernel=3, pad=1)``."""

    def __init__(self, num_classes: int = 1, width: int = 8,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.S2DStemConv_0 = S2DStemConv(width, kernel_size=3)
        self.GroupNorm_0 = group_norm(width)
        self.Conv3d_0 = Conv3d(width, width * 2, kernel_size=3, padding=1)
        self.Dense_0 = Dense(width * 2, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.S2DStemConv_0(x)))
        x = torch.relu(self.Conv3d_0(x)).mean(dim=(2, 3, 4))
        x = dropout(x, self.dropout_rate, train, rng, 0)
        return self.Dense_0(x)
