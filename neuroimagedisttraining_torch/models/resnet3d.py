"""The 3-stage 3D ResNet (ResNet_l3) for ABCD volumes and its phased-stem
twin (counterpart of ``neuroimagedisttraining_tpu/models/resnet3d.py``).

:class:`ResNet3DL3`: a ``Conv3d(1 -> 64, k3, s2, p3)`` stem, GroupNorm, relu
and ``max_pool3d(3, 2, 1)``; three stages of 64/128/256 planes of basic or
bottleneck blocks; ``avg_pool3d(3, 3)``, flatten, ``Dense(512)`` and
``Dense(num_classes)``; returns ``[logits, features]``, the features the
first dense layer's output. GroupNorm stands where the original has
BatchNorm3d, as in the JAX package. :class:`ResNet3DL3S2D` computes the same
function over phase-decomposed volumes (``ops.s2d.phase_decompose(x,
kernel=3, pad=3)``), its stem the plain pool-first
:func:`models.alexnet3d.phased_stem_stage`.

Module names mirror flax's auto-names (``Conv3d_0``, ``GroupNorm_0``,
``BasicBlock3D_i``, ``S2DResNetStem_0``, ``Dense_0``), so the reference's
parameters convert name for name (``convert.jax_params_to_torch``). The
first dense layer's width comes from ``sample_shape``: 3072 at 121x145x121,
256 at 29x33x29, the smallest volume whose pools all fit.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from .alexnet3d import phased_stem_stage
from .layers import (
    Conv3d,
    Dense,
    PhasedStemKernel,
    avg_pool3d,
    flatten,
    group_norm,
    max_pool3d,
    num_groups,
)

#: the original's stem, ``Conv3d(1, 64, k3, s2, p3)``
RESNET_STEM_KERNEL = 3
RESNET_STEM_PAD = 3
#: the stem's max-pool (kernel, stride, padding)
STEM_POOL = (3, 2, 1)
PLANES = (64, 128, 256)


class BasicBlock3D(nn.Module):
    """Two 3x3x3 convs with GroupNorm, the residual through a 1x1 conv and
    its GroupNorm where the stride or the width changes. No conv bias.
    Input and output NCDHW."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv3d_0 = Conv3d(in_planes, planes, 3, stride, 1,
                               use_bias=False)
        self.GroupNorm_0 = group_norm(planes)
        self.Conv3d_1 = Conv3d(planes, planes, 3, 1, 1, use_bias=False)
        self.GroupNorm_1 = group_norm(planes)
        self.downsample = stride != 1 or in_planes != planes
        if self.downsample:
            self.Conv3d_2 = Conv3d(in_planes, planes, 1, stride, 0,
                                   use_bias=False)
            self.GroupNorm_2 = group_norm(planes)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv3d_0(x)))
        y = self.GroupNorm_1(self.Conv3d_1(y))
        res = self.GroupNorm_2(self.Conv3d_2(x)) if self.downsample else x
        return torch.relu(y + res)


class Bottleneck3D(nn.Module):
    """1x1, 3x3x3 (strided) and 1x1 convs to ``4 * planes`` channels, each
    with GroupNorm, the residual through a 1x1 conv and its GroupNorm where
    the stride or the width changes. No conv bias."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out = planes * self.expansion
        self.Conv3d_0 = Conv3d(in_planes, planes, 1, use_bias=False)
        self.GroupNorm_0 = group_norm(planes)
        self.Conv3d_1 = Conv3d(planes, planes, 3, stride, 1, use_bias=False)
        self.GroupNorm_1 = group_norm(planes)
        self.Conv3d_2 = Conv3d(planes, out, 1, use_bias=False)
        self.GroupNorm_2 = group_norm(out)
        self.downsample = stride != 1 or in_planes != out
        if self.downsample:
            self.Conv3d_3 = Conv3d(in_planes, out, 1, stride, 0,
                                   use_bias=False)
            self.GroupNorm_3 = group_norm(out)

    def forward(self, x):
        y = torch.relu(self.GroupNorm_0(self.Conv3d_0(x)))
        y = torch.relu(self.GroupNorm_1(self.Conv3d_1(y)))
        y = self.GroupNorm_2(self.Conv3d_2(y))
        res = self.GroupNorm_3(self.Conv3d_3(x)) if self.downsample else x
        return torch.relu(y + res)


_BLOCKS = {"basic": BasicBlock3D, "bottleneck": Bottleneck3D}


def _add_stages(model: nn.Module, block: str, layers: Sequence[int]) -> int:
    """The three stages as ``<Block>_i`` attributes of ``model``, numbered
    across stages as flax numbers them; returns the output channels."""
    if block not in _BLOCKS:
        raise ValueError(f"unknown block {block!r}; available: "
                         f"{sorted(_BLOCKS)}")
    cls = _BLOCKS[block]
    cin, i = PLANES[0], 0
    model.block_names = []
    for stage, (planes, n_blocks) in enumerate(zip(PLANES, layers)):
        for b in range(n_blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            name = f"{cls.__name__}_{i}"
            setattr(model, name, cls(cin, planes, stride))
            model.block_names.append(name)
            cin, i = planes * cls.expansion, i + 1
    return cin


def _flat_width(model: str, extent: Tuple[int, int, int],
                layers: Sequence[int], channels: int, shown: str) -> int:
    """Flatten width for the stem conv's output ``extent``: the stem pool,
    a stride-2 conv at the head of each later non-empty stage, the 3x3x3/s3
    average pool; a ``ValueError`` naming the input (``shown``) where a
    window no longer fits."""
    out = 1
    for s in extent:
        s = (s + 2 - 3) // 2 + 1  # the stem's max-pool(3, 2, 1)
        for n_blocks in layers[1:]:
            if n_blocks:
                s = (s - 1) // 2 + 1  # k3/s2/p1 conv, 1x1/s2 residual
        s = (s - 3) // 3 + 1 if s >= 3 else 0  # avg_pool3d(3, 3)
        out *= s
    if out < 1:
        raise ValueError(
            f"{model}: {shown} is too small for its stem, stages and "
            "3x3x3/s3 average pool (a volume needs at least 29 voxels a "
            "side)")
    return out * channels


def _head(model: nn.Module, x):
    """The stages, avg_pool3d(3, 3), flatten (channels-last), Dense_0 and
    Dense_1; returns ``[logits, features]``."""
    for name in model.block_names:
        x = getattr(model, name)(x)
    x1 = model.Dense_0(flatten(avg_pool3d(x, 3, 3)))
    return [model.Dense_1(x1), x1]


class ResNet3DL3(nn.Module):
    """ResNet_l3 on ``(B, D, H, W, 1)`` volumes; ``sample_shape`` ``(D, H, W,
    1)`` fixes the first dense layer's width and must be at least 29 a
    side."""

    def __init__(self, num_classes: int = 1, layers: Sequence[int] = (2, 2, 2),
                 block: str = "basic",
                 sample_shape: Tuple[int, ...] = (121, 145, 121, 1)):
        super().__init__()
        self.num_classes = num_classes  # the output count
        self.Conv3d_0 = Conv3d(1, PLANES[0], RESNET_STEM_KERNEL, 2,
                               RESNET_STEM_PAD, use_bias=False)
        self.GroupNorm_0 = group_norm(PLANES[0])
        cout = _add_stages(self, block, layers)
        vol = tuple(int(s) for s in sample_shape[:3])
        extent = tuple((s + 2 * RESNET_STEM_PAD - RESNET_STEM_KERNEL) // 2 + 1
                       for s in vol)
        flat = _flat_width("ResNet3DL3", extent, layers, cout,
                           "the volume " + "x".join(map(str, vol)))
        self.Dense_0 = Dense(flat, 512)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.Conv3d_0(x.permute(0, 4, 1, 2,
                                                                3))))
        return _head(self, max_pool3d(x, *STEM_POOL))


class S2DResNetStem(PhasedStemKernel):
    """The ResNet stem over phased input: the ``(64, 8, 2, 2, 2)`` masked
    phased kernel (27 of 64 slots carry taps), no conv bias, the GroupNorm
    pair ``scale``/``bias_gn``, relu and the stem's ``max_pool3d(3, 2,
    1)``, pool-first or in the textbook order
    (:func:`models.alexnet3d.phased_stem_stage`, plain torch on every
    device). Input phased, output NCDHW."""

    def __init__(self, features: int = 64, max_groups: int = 32,
                 pool_first: bool = True, eps: float = 1e-6):
        super().__init__(RESNET_STEM_KERNEL, features)
        self.scale = nn.Parameter(torch.ones(features))
        self.bias_gn = nn.Parameter(torch.zeros(features))
        self.groups = num_groups(features, max_groups)
        self.pool_first = pool_first
        self.eps = eps

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias_gn)

    def forward(self, x):
        return phased_stem_stage(x, self.masked(), None, self.scale,
                                 self.bias_gn, self.groups, self.eps,
                                 STEM_POOL, self.pool_first)


class ResNet3DL3S2D(nn.Module):
    """ResNet_l3 over phased ``(B, D', H', 8, W')`` volumes, ``(64, 76, 8,
    64)`` for 121x145x121: the same function and outputs as
    :class:`ResNet3DL3`; the stem's GroupNorm lives in
    :class:`S2DResNetStem`. ``sample_shape`` is the phased per-sample
    shape."""

    def __init__(self, num_classes: int = 1, layers: Sequence[int] = (2, 2, 2),
                 block: str = "basic", pool_first: bool = True,
                 sample_shape: Tuple[int, ...] = (64, 76, 8, 64)):
        super().__init__()
        self.num_classes = num_classes  # the output count
        self.S2DResNetStem_0 = S2DResNetStem(PLANES[0], pool_first=pool_first)
        cout = _add_stages(self, block, layers)
        d, h, _, w = (int(s) for s in sample_shape)
        flat = _flat_width("ResNet3DL3S2D", (d - 1, h - 1, w - 1), layers,
                           cout, "the phased sample shape "
                           + "x".join(map(str, sample_shape)))
        self.Dense_0 = Dense(flat, 512)
        self.Dense_1 = Dense(512, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        return _head(self, self.S2DResNetStem_0(x))


def convert_resnet3d_params(params: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """A :class:`ResNet3DL3` parameter dict as :class:`ResNet3DL3S2D`'s: the
    stem kernel remapped tap for tap into ``S2DResNetStem_0.kernel``, the
    stem GroupNorm's pair moved into the stem as ``scale``/``bias_gn``,
    every block and dense leaf unchanged."""
    from ..ops.s2d import remap_stem_kernel

    w = params["Conv3d_0.kernel"]  # OIDHW; the remap takes DHWIO
    phased = remap_stem_kernel(w.detach().cpu().permute(2, 3, 4, 1, 0)
                               .numpy(), RESNET_STEM_KERNEL)
    out = {"S2DResNetStem_0.kernel": torch.from_numpy(phased).permute(
               4, 3, 0, 1, 2).contiguous().to(w.device, w.dtype),
           "S2DResNetStem_0.scale": params["GroupNorm_0.scale"],
           "S2DResNetStem_0.bias_gn": params["GroupNorm_0.bias"]}
    for k, v in params.items():
        if k.split(".")[0] not in ("Conv3d_0", "GroupNorm_0"):
            out[k] = v
    return out
