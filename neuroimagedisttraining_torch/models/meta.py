"""Hypernetwork (mask -> weight) models (counterpart of
``neuroimagedisttraining_tpu/models/meta.py``).

* :class:`CNNCifar10Meta`: the bias-free CIFAR CNN whose conv kernels are a
  hypernetwork's targets: 5x5 VALID convs of 64 (``meta_conv1``,
  ``meta_conv2``), each with relu and a 3x3/s2 max-pool, and the dense
  ``meta_fc1``; :func:`init_random_mask` its random dense-ratio mask.
* :class:`MetaNet`: the mask-conditioned weight generator, flatten(mask)
  -> 50 -> 50 -> |target|, reshaped to the target shape, He-uniform.
* :class:`MetaResNet20`: a width-scalable ResNet-20 whose every conv
  kernel is generated by a per-layer MLP (:class:`_ScaleHyperConv`,
  ``fc11`` -> relu -> ``fc12``) from the layer's channel scale, the
  inactive channels masked to zero, each conv followed by the affine-free
  batch-statistic norm over the active channels
  (:func:`_masked_batch_stat_norm`). Widths 16/32/64 (x4 bottleneck
  expansion), 2 blocks a stage; without scale ids every layer runs at the
  largest scale.

A generated kernel is reshaped ``(kh, kw, in, out)`` as the reference
reshapes it, then permuted to OIHW for ``F.conv2d``, so ``fc12``'s rows are
the reference's. Input ``(B, H, W, C)``; ``sample_shape`` fixes the input
channels (and :class:`CNNCifar10Meta`'s dense width).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    _pair,
    channels_first,
    Conv2d,
    Dense,
    flatten,
    he_uniform_,
    image_shape,
    max_pool2d,
    normal_init,
)


class CNNCifar10Meta(nn.Module):
    """conv5x5(64) -> pool3/s2 -> conv5x5(64) -> pool3/s2 -> fc, no biases;
    the fc input is 4x4x64 at 32x32."""

    def __init__(self, num_classes: int = 10,
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        h, w, c = image_shape(type(self).__name__, sample_shape)
        self.meta_conv1 = Conv2d(c, 64, 5, padding="VALID", use_bias=False)
        self.meta_conv2 = Conv2d(64, 64, 5, padding="VALID", use_bias=False)
        for _ in range(2):
            h, w = (h - 4 - 3) // 2 + 1, (w - 4 - 3) // 2 + 1
        self.meta_fc1 = Dense(h * w * 64, num_classes, use_bias=False)

    def forward(self, x, train: bool = False, rng=None):
        x = channels_first(x)
        x = max_pool2d(torch.relu(self.meta_conv1(x)), 3, 2)
        x = max_pool2d(torch.relu(self.meta_conv2(x)), 3, 2)
        return self.meta_fc1(flatten(x))


def init_random_mask(shape: Tuple[int, ...], dense_ratio: float = 0.2, *,
                     generator: Optional[torch.Generator] = None,
                     scores: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A random {0, 1} mask of ``shape`` with ``int(dense_ratio * size)``
    ones (``ops.sparsity.random_mask_array``; ``scores`` the uniform
    draws, else from ``generator``)."""
    from ..ops.sparsity import random_mask_array

    return random_mask_array(shape, dense_ratio, scores=scores,
                             generator=generator)


class MetaNet(nn.Module):
    """flatten(mask) -> Dense(50) -> relu -> Dense(50) -> relu ->
    Dense(|target|), reshaped to ``target_shape``; He-uniform kernels."""

    def __init__(self, target_shape: Tuple[int, ...], hidden: int = 50,
                 mask_size: Optional[int] = None):
        super().__init__()
        self.target_shape = tuple(int(s) for s in target_shape)
        size = int(np.prod(self.target_shape))
        n_in = size if mask_size is None else int(mask_size)
        self.Dense_0 = Dense(n_in, hidden, kernel_init=he_uniform_)
        self.Dense_1 = Dense(hidden, hidden, kernel_init=he_uniform_)
        self.Dense_2 = Dense(hidden, size, kernel_init=he_uniform_)

    def forward(self, mask):
        x = torch.relu(self.Dense_0(mask.reshape(-1)))
        x = torch.relu(self.Dense_1(x))
        return self.Dense_2(x).reshape(self.target_shape)


class _ScaleHyperConv(nn.Module):
    """A conv whose full-width ``(kh, kw, max_in, max_out)`` kernel is
    generated from the channel scale by ``fc11`` (1 -> hidden), relu and
    ``fc12`` (hidden -> the kernel's size), its ``[:in_active,
    :out_active]`` corner kept by a mask multiply; no bias."""

    def __init__(self, max_in: int, max_out: int, kernel=(3, 3),
                 strides=(1, 1), padding: int = 1, hidden: int = 32):
        super().__init__()
        kh, kw = _pair(kernel)
        self.kernel = (kh, kw)
        self.max_in, self.max_out = max_in, max_out
        self.strides, self.padding = _pair(strides), padding
        size = kh * kw * max_in * max_out
        self.fc11 = Dense(1, hidden)
        self.fc12 = Dense(hidden, size, kernel_init=normal_init(
            1.0 / np.sqrt(hidden * kh * kw * max_in)))

    def forward(self, x, scale, in_active, out_active):
        kh, kw = self.kernel
        # the scale in the hypernetwork's dtype (bf16 under mixed precision)
        h = torch.relu(self.fc11(scale.reshape(1).to(
            self.fc11.kernel.dtype)))
        w = self.fc12(h).reshape(kh, kw, self.max_in, self.max_out)
        dev = w.device
        in_mask = (torch.arange(self.max_in, device=dev) < in_active).to(
            w.dtype)
        out_mask = (torch.arange(self.max_out, device=dev) < out_active).to(
            w.dtype)
        w = w * in_mask[None, None, :, None] * out_mask[None, None, None, :]
        return F.conv2d(x, w.permute(3, 2, 0, 1), None, self.strides,
                        self.padding)


def _masked_batch_stat_norm(x, active, eps: float = 1e-5):
    """Affine-free batch-statistic norm over the channels below
    ``active`` of NCHW ``x`` (the inactive ones are zero and stay so)."""
    c = x.shape[1]
    chan = (torch.arange(c, device=x.device) < active).to(x.dtype).reshape(
        1, c, 1, 1)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mu = x.sum(dim=(0, 2, 3), keepdim=True) / n
    var = ((x - mu) ** 2 * chan).sum(dim=(0, 2, 3), keepdim=True) / n
    y = (x - mu) / torch.sqrt(var + eps)
    return y * chan


def _active(width: int, scale: torch.Tensor) -> torch.Tensor:
    """``int32(width * scale)`` in float32, as the reference computes it."""
    return (torch.tensor(float(width), dtype=torch.float32,
                         device=scale.device) * scale).to(torch.int32)


class MetaResNet20(nn.Module):
    """The hypernetwork-generated, width-scalable ResNet-20 (module
    docstring); ``forward`` takes per-stage output scale ids and per-block
    mid scale ids into ``channel_scales``."""

    N_STAGES = 3
    WIDTHS = (16, 32, 64)
    EXPANSION = 4

    def __init__(self, num_classes: int = 10,
                 channel_scales: Sequence[float] = (0.25, 0.5, 0.75, 1.0),
                 blocks_per_stage: int = 2,
                 sample_shape: Tuple[int, ...] = (32, 32, 3)):
        super().__init__()
        self.num_classes = num_classes
        self.channel_scales = tuple(channel_scales)
        self.blocks_per_stage = blocks_per_stage
        self.in_channels = image_shape(type(self).__name__,
                                       sample_shape)[2]
        n = 0

        def add(*args, **kw) -> str:
            nonlocal n
            name = f"_ScaleHyperConv_{n}"
            setattr(self, name, _ScaleHyperConv(*args, **kw))
            n += 1
            return name

        # the layer names in the reference's creation order
        self.plan = [add(self.in_channels, self.WIDTHS[0], (3, 3),
                         padding=1)]
        cin = self.WIDTHS[0]
        self.blocks = []
        for stage in range(self.N_STAGES):
            planes = self.WIDTHS[stage]
            out_ch = planes * self.EXPANSION
            for b in range(blocks_per_stage):
                stride = 2 if (stage > 0 and b == 0) else 1
                names = [add(cin, planes, (1, 1), padding=0),
                         add(planes, planes, (3, 3), padding=1,
                             strides=(stride, stride)),
                         add(planes, out_ch, (1, 1), padding=0)]
                down = None
                if cin != out_ch or stride != 1:
                    down = add(cin, out_ch, (1, 1), padding=0,
                               strides=(stride, stride))
                self.blocks.append((stage, names, down))
                cin = out_ch
        self.Dense_0 = Dense(cin, num_classes)

    def forward(self, x, train: bool = False, rng=None,
                stage_scale_ids=None, mid_scale_ids=None):
        x = channels_first(x)
        dev = x.device
        scales = torch.tensor(self.channel_scales, dtype=torch.float32,
                              device=dev)
        last = len(self.channel_scales) - 1
        if stage_scale_ids is None:
            stage_scale_ids = [last] * self.N_STAGES
        if mid_scale_ids is None:
            mid_scale_ids = [last] * (self.N_STAGES * self.blocks_per_stage)
        s0 = scales[int(stage_scale_ids[0])]
        out0 = _active(self.WIDTHS[0], s0)
        in_ch = torch.tensor(self.in_channels, dtype=torch.int32,
                             device=dev)
        x = torch.relu(_masked_batch_stat_norm(
            getattr(self, self.plan[0])(x, s0, in_ch, out0), out0))
        in_active = out0
        for bi, (stage, (c1, c2, c3), down) in enumerate(self.blocks):
            planes = self.WIDTHS[stage]
            s_out = scales[int(stage_scale_ids[stage])]
            out_active = _active(planes * self.EXPANSION, s_out)
            s_mid = scales[int(mid_scale_ids[bi])]
            mid_active = _active(planes, s_mid)
            y = getattr(self, c1)(x, s_mid, in_active, mid_active)
            y = torch.relu(_masked_batch_stat_norm(y, mid_active))
            y = getattr(self, c2)(y, s_mid, mid_active, mid_active)
            y = torch.relu(_masked_batch_stat_norm(y, mid_active))
            y = getattr(self, c3)(y, s_out, mid_active, out_active)
            y = _masked_batch_stat_norm(y, out_active)
            if down is not None:
                x = _masked_batch_stat_norm(
                    getattr(self, down)(x, s_out, in_active, out_active),
                    out_active)
            x = torch.relu(x + y)
            in_active = out_active
        return self.Dense_0(x.mean(dim=(2, 3)))
