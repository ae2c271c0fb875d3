"""Shared layers (counterpart of ``neuroimagedisttraining_tpu/models/layers.py``).

Modules take NCDHW (the 3D models) or NCHW (the 2D models) inside the
network. Parameters carry the reference's
names — conv and dense weights are ``kernel`` (the leaves SNIP masks), the
GroupNorm affine pair is ``scale``/``bias`` — in PyTorch's layouts: conv
kernels OIDHW, dense kernels ``(out, in)``. Initialization follows the
reference's initializers (LeCun truncated normal kernels, zero biases, unit
norm scales), drawn from an explicit ``torch.Generator``.

GroupNorm is the reference's, not ``F.group_norm``: eps 1e-6, the largest
group count <= 32 dividing the channels, statistics in float32 (float64
kept) with the variance as ``E[x^2] - E[x]^2`` clipped at 0. :class:`BatchNorm` is flax's
``nn.BatchNorm`` (eps 1e-5, momentum 0.9 on the running averages of the
batch mean and the BIASED batch variance), its running statistics given
by the caller (:func:`batch_stats_scope`), as flax's ``batch_stats``
collection is.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

Ints3 = Union[int, Tuple[int, int, int]]
Ints2 = Union[int, Tuple[int, int]]
#: a 2D conv's padding: "VALID", "SAME", an int per side, or ((top,
#: bottom), (left, right)), as flax's ``nn.Conv`` takes it
Padding2 = Union[str, int, Tuple[Tuple[int, int], Tuple[int, int]]]

#: stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _triple(v: Ints3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


def _pair(v: Ints2) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator,
                  scale: float = 1.0) -> torch.Tensor:
    """variance_scaling(scale, "fan_in", "truncated_normal") in place."""
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def image_shape(model: str, sample_shape) -> Tuple[int, int, int]:
    """``(H, W, C)`` of a 2D model's per-sample shape; a ``ValueError``
    naming the model and the shape for anything else (a volume)."""
    if len(sample_shape) != 3:
        raise ValueError(
            f"{model}: takes (H, W, C) images; the sample shape "
            f"{'x'.join(str(int(v)) for v in sample_shape)} is not one")
    h, w, c = (int(v) for v in sample_shape)
    return h, w, c


def he_normal_(t: torch.Tensor, fan_in: int,
               generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(2, "fan_in", "truncated_normal") in place."""
    return lecun_normal_(t, fan_in, generator, scale=2.0)


def he_uniform_(t: torch.Tensor, fan_in: int,
                generator: torch.Generator) -> torch.Tensor:
    """variance_scaling(2, "fan_in", "uniform") in place."""
    limit = math.sqrt(6.0 / fan_in)
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def normal_init(std: float) -> Callable:
    """``normal(std)`` as a kernel initializer (the fan-in is unused)."""
    def init(t: torch.Tensor, fan_in: int, generator: torch.Generator):
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)
    return init


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


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """flax's "SAME" padding of one axis: the output ``ceil(size / s)``,
    the padding split with the extra one at the end."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """flax ``nn.Conv`` over NCHW: ``padding`` "VALID", "SAME", an int per
    side or per-side pairs; the kernel OIHW, LeCun normal by default
    (``kernel_init(t, fan_in, generator)`` otherwise), the bias zeros."""

    def __init__(self, in_features: int, features: int, kernel_size: Ints2,
                 strides: Ints2 = 1, padding: Padding2 = 0,
                 use_bias: bool = True,
                 kernel_init: Callable = lecun_normal_):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.kernel_init = kernel_init
        self.kernel = nn.Parameter(
            torch.empty((features, in_features) + self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel_init(self.kernel, self.kernel[0].numel(), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return conv2d(x, self.kernel, self.bias, self.strides, self.padding)


def conv2d(x, kernel, bias, strides: Ints2 = 1, padding: Padding2 = 0):
    """``F.conv2d`` with flax's padding forms (see :class:`Conv2d`)."""
    strides = _pair(strides)
    if padding == "VALID":
        padding = 0
    if padding == "SAME":
        padding = tuple(_same_pads(x.shape[2 + i], kernel.shape[2 + i],
                                   strides[i]) for i in range(2))
    if isinstance(padding, int):
        return F.conv2d(x, kernel, bias, strides, padding)
    (top, bottom), (left, right) = padding
    if top == bottom and left == right:
        return F.conv2d(x, kernel, bias, strides, (top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), kernel, bias,
                    strides)


class Dense(nn.Module):
    """flax ``nn.Dense``: the kernel ``(out, in)``, LeCun normal by default
    (``kernel_init`` otherwise), the bias zeros."""

    def __init__(self, in_features: int, features: int,
                 use_bias: bool = True,
                 kernel_init: Callable = lecun_normal_):
        super().__init__()
        self.kernel_init = kernel_init
        self.kernel = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.kernel_init(self.kernel, self.kernel.shape[1], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        return F.linear(x, self.kernel, self.bias)


def _stat_type(x):
    """``x`` in its norm's statistics type: at least float32, float64
    kept (flax's ``promote_types(dtype, float32)``)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm`` over NC... input (see module docstring)."""

    def __init__(self, num_groups: int, features: int, eps: float = 1e-6,
                 zero_scale: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.zero_scale = zero_scale  # scale_init zeros
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.constant_(self.scale, 0.0 if self.zero_scale else 1.0)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        b, c = x.shape[:2]
        bcast = (b, c) + (1,) * (x.dim() - 2)
        xf = _stat_type(x)
        xg = xf.reshape(b, self.num_groups, -1)
        mean = xg.mean(-1)
        var = torch.clamp((xg * xg).mean(-1) - mean * mean, min=0.0)
        per = c // self.num_groups
        mean_c = mean.repeat_interleave(per, dim=1).reshape(bcast)
        mul = (torch.rsqrt(var + self.eps).repeat_interleave(per, dim=1)
               * self.scale.to(xf.dtype)).reshape(bcast)
        y = (xf - mean_c) * mul + self.bias.to(xf.dtype).reshape(
            (1, c) + bcast[2:])
        return y.to(x.dtype)


def num_groups(channels: int, max_groups: int = 32) -> int:
    """The largest group count <= max_groups dividing channels."""
    g = min(max_groups, channels)
    while channels % g:
        g -= 1
    return g


def group_norm(channels: int, max_groups: int = 32,
               zero_scale: bool = False) -> GroupNorm:
    return GroupNorm(num_groups(channels, max_groups), channels,
                     zero_scale=zero_scale)


class ScopeCollectionNotFound(ValueError):
    """A :class:`BatchNorm` run without running statistics: flax's error of
    the same name, with its message."""


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over NC... input, eps 1e-5.
    Training normalizes by the batch statistics (float32, the variance
    ``E[x^2] - E[x]^2`` clipped at 0, i.e. biased) and updates the running
    averages ``momentum * avg + (1 - momentum) * stat``; evaluation
    normalizes by the running averages. The averages are not the module's
    state: a forward reads them from, and writes the updated ones to, the
    :func:`batch_stats_scope` it runs in (flax's ``batch_stats``
    collection, keyed ``<module>.mean`` / ``<module>.var``), and raises
    :class:`ScopeCollectionNotFound` outside one, as flax does when the
    collection is missing."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        #: (the scope's stats, the dict its updates go to, this module's
        #: key prefix), set by batch_stats_scope
        self._scope: Optional[tuple] = None
        #: the flax scope path the error names (name_batch_norms)
        self._path = "BatchNorm_0"

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x, train: bool = False):
        if self._scope is None:
            raise ScopeCollectionNotFound(
                'Tried to access "mean" from collection "batch_stats" in '
                f'"/{self._path}" but the collection is empty.')
        stats, updates, prefix = self._scope
        c = x.shape[1]
        bcast = (1, c) + (1,) * (x.dim() - 2)
        xf = _stat_type(x)
        if train:
            dims = [0] + list(range(2, x.dim()))
            mean = xf.mean(dims)
            var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            m = self.momentum
            updates[prefix + "mean"] = m * stats[prefix + "mean"] + (
                1 - m) * mean
            updates[prefix + "var"] = m * stats[prefix + "var"] + (
                1 - m) * var
        else:
            mean, var = stats[prefix + "mean"], stats[prefix + "var"]
        mul = (torch.rsqrt(var + self.eps) * self.scale.to(xf.dtype)
               ).reshape(bcast)
        y = (xf - mean.reshape(bcast)) * mul + self.bias.to(
            xf.dtype).reshape(bcast)
        return y.to(x.dtype)


def init_batch_stats(model: nn.Module,
                     device=None) -> Dict[str, torch.Tensor]:
    """The initial running statistics of every :class:`BatchNorm` of
    ``model``: means 0, variances 1, keyed ``<module>.mean`` /
    ``<module>.var``."""
    out = {}
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            n = mod.scale.shape[0]
            dev = device if device is not None else mod.scale.device
            out[name + ".mean"] = torch.zeros(n, device=dev)
            out[name + ".var"] = torch.ones(n, device=dev)
    return out


@contextlib.contextmanager
def batch_stats_scope(model: nn.Module, stats: Dict[str, torch.Tensor]):
    """Run ``model``'s :class:`BatchNorm` layers on the running statistics
    ``stats``; yields the dict the training forwards write the updated
    statistics to (flax's ``mutable=["batch_stats"]``)."""
    updates: Dict[str, torch.Tensor] = {}
    mods = [(n, m) for n, m in model.named_modules()
            if isinstance(m, BatchNorm)]
    for name, mod in mods:
        mod._scope = (stats, updates, name + ".")
    try:
        yield updates
    finally:
        for _, mod in mods:
            mod._scope = None


def name_batch_norms(model: nn.Module) -> None:
    """Each :class:`BatchNorm` of ``model`` told its flax scope path (the
    error outside a scope names it)."""
    for name, mod in model.named_modules():
        if isinstance(mod, BatchNorm):
            mod._path = name.replace(".", "/")


class _OverlappingMaxPool(torch.autograd.Function):
    """``F.max_pool2d`` / ``F.max_pool3d`` over overlapping windows with a
    backward that sums each input's window gradients in a fixed order. The
    backward of the library's max pool on the card adds every window's
    gradient into its argmax with an atomic add, so where one pixel or
    voxel wins several windows the sum's order, and its last bits, change
    from run to run. Here the windows are split into classes by their index
    modulo ``ceil(k / s)`` per axis: within a class no two windows overlap,
    so each class is one scatter-add that meets every input at most once,
    and the classes are added one after another in a float32 (float64 for
    a float64 input) accumulator. The forward is the library's, its indices
    the first maximum of each window."""

    @staticmethod
    def forward(ctx, x, kernel, strides, padding):
        pool = F.max_pool3d if len(kernel) == 3 else F.max_pool2d
        out, idx = pool(x, kernel, strides, padding, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.in_shape = x.shape
        ctx.classes = tuple(-(-k // s) for k, s in zip(kernel, strides))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, c = g.shape[:2]
        acc = torch.zeros(
            (b, c, int(np.prod(ctx.in_shape[2:]))), device=g.device,
            dtype=torch.promote_types(g.dtype, torch.float32))
        for phase in itertools.product(*(range(n) for n in ctx.classes)):
            sl = (slice(None), slice(None)) + tuple(
                slice(p, None, n) for p, n in zip(phase, ctx.classes))
            acc.scatter_add_(2, idx[sl].reshape(b, c, -1),
                             g[sl].reshape(b, c, -1).to(acc.dtype))
        return acc.reshape(ctx.in_shape).to(g.dtype), None, None, None


def _max_pool(x, k: tuple, s: tuple, p: tuple):
    if all(si >= ki for ki, si in zip(k, s)):
        pool = F.max_pool3d if len(k) == 3 else F.max_pool2d
        return pool(x, k, s, p)
    return _OverlappingMaxPool.apply(x, k, s, p)


def max_pool3d(x, kernel: Ints3, strides: Ints3, padding: Ints3 = 0):
    """MaxPool3d, floor mode, on NCDHW. Overlapping windows (a stride below
    the kernel, the ResNet stem's 3/s2/p1) take
    :class:`_OverlappingMaxPool`, whose backward is the same every run;
    the others ``F.max_pool3d`` as it is (each input meets at most one
    window there)."""
    return _max_pool(x, _triple(kernel), _triple(strides), _triple(padding))


def max_pool2d(x, kernel: Ints2, strides: Ints2, padding: Ints2 = 0):
    """flax's ``nn.max_pool`` on NCHW: VALID, or ``padding`` per side with
    -inf (the padding never wins a window), floor mode; overlapping
    windows as in :func:`max_pool3d`."""
    return _max_pool(x, _pair(kernel), _pair(strides), _pair(padding))


def avg_pool3d(x, kernel: Ints3, strides: Optional[Ints3] = None,
               padding: Ints3 = 0):
    """AvgPool3d, floor mode, on NCDHW; ``strides`` defaults to ``kernel``
    and the padding counts in every window's mean, as flax's
    ``nn.avg_pool`` counts it (``count_include_pad=True``). A bf16 or fp16
    input is averaged in float32 and rounded once, as the card's kernel
    does it (the CPU has no reduced-precision kernel)."""
    k = _triple(kernel)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return F.avg_pool3d(xf, k, _triple(strides if strides is not None else k),
                        _triple(padding), ceil_mode=False,
                        count_include_pad=True).to(x.dtype)


def avg_pool2d(x, kernel: Ints2, strides: Optional[Ints2] = None):
    """flax's VALID ``nn.avg_pool`` on NCHW (``strides`` defaults to
    ``kernel``), a bf16 or fp16 input averaged in float32 as
    :func:`avg_pool3d` does."""
    k = _pair(kernel)
    xf = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    return F.avg_pool2d(xf, k, _pair(strides if strides is not None else k),
                        0, ceil_mode=False).to(x.dtype)


def channels_first(x):
    """NHWC (NDHWC) input -> NCHW (NCDHW)."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def channels_last(x):
    """NCHW (NCDHW) -> NHWC (NDHWC), the reference's layout."""
    return x.permute(0, *range(2, x.dim()), 1)


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
