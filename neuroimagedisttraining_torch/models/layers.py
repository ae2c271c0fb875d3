"""Shared layers (counterpart of ``neuroimagedisttraining_tpu/models/layers.py``).

Modules take NCDHW inside the network. Parameters carry the reference's
names — conv and dense weights are ``kernel`` (the leaves SNIP masks), the
GroupNorm affine pair is ``scale``/``bias`` — in PyTorch's layouts: conv
kernels OIDHW, dense kernels ``(out, in)``. Initialization follows the
reference's initializers (LeCun truncated normal kernels, zero biases, unit
norm scales), drawn from an explicit ``torch.Generator``.

GroupNorm is the reference's, not ``F.group_norm``: eps 1e-6, the largest
group count <= 32 dividing the channels, statistics in float32 with the
variance as ``E[x^2] - E[x]^2`` clipped at 0.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Ints3 = Union[int, Tuple[int, int, int]]

#: stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _triple(v: Ints3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator,
                  scale: float = 1.0) -> torch.Tensor:
    """variance_scaling(scale, "fan_in", "truncated_normal") in place."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class Conv3d(nn.Module):
    """3D conv with torch-style integer padding (0 = VALID)."""

    def __init__(self, in_features: int, features: int, kernel_size: Ints3,
                 strides: Ints3 = 1, padding: Ints3 = 0,
                 use_bias: bool = True):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.padding = _triple(padding)
        self.kernel = nn.Parameter(
            torch.empty((features, in_features) + self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv3d(x, self.kernel, self.bias, self.strides, self.padding)


class Dense(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[1], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.kernel, self.bias)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NC... input (see module docstring)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        b, c = x.shape[:2]
        bcast = (b, c) + (1,) * (x.dim() - 2)
        xf = x.float()
        xg = xf.reshape(b, self.num_groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        per = c // self.num_groups
        mean_c = mean.repeat_interleave(per, dim=1).reshape(bcast)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(per, dim=1)
               * self.scale.float()).reshape(bcast)
        y = (xf - mean_c) * mul + self.bias.float().reshape((1, c) + bcast[2:])
        return y.to(x.dtype)


def num_groups(channels: int, max_groups: int = 32) -> int:
    """The largest group count <= max_groups dividing channels."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def group_norm(channels: int, max_groups: int = 32) -> GroupNorm:
    return GroupNorm(num_groups(channels, max_groups), channels)


def max_pool3d(x, kernel: Ints3, strides: Ints3, padding: Ints3 = 0):
    """MaxPool3d, floor mode, on NCDHW."""
    return F.max_pool3d(x, _triple(kernel), _triple(strides), _triple(padding))


def flatten(x):
    """Flatten in channels-last order (NDHWC), the reference's layout, so
    its first dense kernel carries over without a row permutation."""
    if x.dim() > 2:
        x = x.permute(0, *range(2, x.dim()), 1)
    return x.reshape(x.shape[0], -1)


class DropoutProbe:
    """Passed as a forward's ``rng``: records each dropout layer it meets as
    ``(slot, shape, keep_prob)``, in call order, and drops nothing. The
    fused round (``algorithms/base.py``) sizes its keep-mask buffers from
    it and draws into them in this order, the order the generator path
    draws."""

    def __init__(self):
        self.calls = []


def dropout(x, rate: float, train: bool, rng, slot: int):
    """Inverted dropout. ``rng`` is a ``torch.Generator`` (draws keep masks
    on ``x``'s device), a sequence of precomputed boolean keep masks, one
    per dropout layer, indexed by ``slot``, or a :class:`DropoutProbe`."""
    if not train or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    if isinstance(rng, torch.Generator):
        keep = torch.rand(x.shape, generator=rng, device=x.device) < keep_prob
    elif rng is None:
        raise ValueError("dropout in train mode needs a generator or masks")
    elif isinstance(rng, DropoutProbe):
        rng.calls.append((slot, tuple(x.shape), keep_prob))
        return x
    else:
        keep = torch.as_tensor(rng[slot], device=x.device)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class PhasedStemKernel(nn.Module):
    """The masked phased stem kernel ``(F, 8, r, r, r)``: the remapped slots
    without a tap are held at zero by a constant mask applied at use, so the
    model class stays the dense stride-2 stem's. Init is LeCun truncated
    normal with the variance scaled to the dense stem's (fan_in counts all
    ``r^3*8`` slots, only ``kernel^3`` carry taps)."""

    def __init__(self, stem_kernel: int, features: int):
        super().__init__()
        from ..ops.s2d import N_PHASES, r_kernel, stem_slot_mask

        r = r_kernel(stem_kernel)
        self.stem_kernel = stem_kernel
        self.kernel = nn.Parameter(torch.empty((features, N_PHASES) + (r,) * 3))
        mask = np.transpose(stem_slot_mask(stem_kernel), (4, 3, 0, 1, 2))
        self.register_buffer("slot_mask", torch.from_numpy(mask.copy()),
                             persistent=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        slots = self.kernel[0].numel()
        lecun_normal_(self.kernel, slots, generator,
                      scale=slots / float(self.stem_kernel ** 3))

    def masked(self) -> torch.Tensor:
        return self.kernel * self.slot_mask.to(self.kernel.dtype)


def phased_input(x):
    """``(B, D', H', 8, W')`` phased volumes -> ``(B, 8, D', H', W')``."""
    return x.permute(0, 3, 1, 2, 4)


class S2DStemConv(PhasedStemKernel):
    """Masked phased conv equal to a one-channel stride-2 stem conv
    ``Conv3d(1 -> F, kernel_size, stride 2, padding)``, over input phased by
    ``ops.s2d.phase_decompose(x, kernel_size, padding)``. Returns NCDHW."""

    def __init__(self, features: int, kernel_size: int = 3,
                 use_bias: bool = True):
        super().__init__(kernel_size, features)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.conv3d(phased_input(x), self.masked(), self.bias)
