"""The AlexNet3D family and the CI-scale 3D CNNs (counterpart of
``neuroimagedisttraining_tpu/models/alexnet3d.py``): AlexNet3D over
phase-decomposed volumes, the dense-stem :class:`AlexNet3D`,
:class:`AlexNet3DDeeper` and :class:`AlexNet3DRegression`.

Public inputs keep the reference's layouts — phased ``(B, D', H', 8, W')``
for the s2d models, ``(B, D, H, W, 1)`` for the dense-stem models and
:class:`SmallCNN3D` — and are permuted to NCDHW inside. Spatial arithmetic
(VALID convs, floor-mode pools) matches the reference, so on the canonical
121x145x121 volume the flatten width is 256 (512 for the deeper model).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable

from ..ops import kernels
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
    clipped at 0 (the textbook branch of S2DStemStage)."""
    b = zf.shape[0]
    zg = zf.reshape(b, groups, -1)
    return _broadcast_stats(zg.mean(-1), (zg * zg).mean(-1), zf.shape[1],
                            eps)


def _group_stats_from_sums(s1, s2, groups: int, count: int, eps: float):
    """:func:`_group_stats` from per-(sample, channel) f32 sums ``s1`` of z
    and ``s2`` of z^2 over ``count`` voxels each (the pool-first branch,
    which never holds z in float32)."""
    b, c = s1.shape
    n = float(count * (c // groups))
    return _broadcast_stats(s1.reshape(b, groups, -1).sum(-1) / n,
                            s2.reshape(b, groups, -1).sum(-1) / n, c, eps)


def _broadcast_stats(mu, ez2, channels: int, eps: float):
    var = ez2 - mu * mu
    sig = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    per = channels // mu.shape[1]
    shape = (mu.shape[0], channels, 1, 1, 1)
    return (mu.repeat_interleave(per, dim=1).reshape(shape),
            sig.repeat_interleave(per, dim=1).reshape(shape))


class StemStage(torch.autograd.Function):
    """The pool-first stem stage's full-resolution part as one autograd node:
    ``(x, ws, bs) -> (pooled, s1, s2)``.

    ``x`` is the phased volume ``(B, D', H', 8, W')``, ``ws`` the masked,
    sign-folded kernel ``(F, 8, 3, 3, 3)`` and ``bs`` the sign-folded bias;
    ``pooled`` is the 3x3x3/s3 max-pool of the conv output ``zs`` (returned
    as an NCDHW view of channels-last storage), ``s1`` and ``s2`` the f32
    (f64 for a float64 stage) per-(sample, channel) sums of ``zs`` and
    ``zs^2``. Forward is :func:`ops.kernels.stem_fwd`; backward is
    :func:`ops.kernels.stem_bwd` with ``ties="first"`` (torch's max-pool
    rule, so the gradient is the plain composition's), which also returns
    the bias gradient (``dzs`` summed per channel, in the same pass on the
    card), then the conv's weight and input gradients (``torch.nn.grad``,
    cuDNN on the card). Only ``x``, ``ws``, ``zs`` and ``pooled`` are kept
    for the backward. On the CPU both kernels run their plain versions, so
    the same composition runs on every device."""

    @staticmethod
    def forward(ctx, x, ws, bs):
        zs, pooled, s1, s2 = kernels.stem_fwd(x, ws, bs)
        ctx.save_for_backward(x, ws, zs, pooled)
        return pooled.permute(0, 4, 1, 2, 3), s1, s2

    @staticmethod
    @once_differentiable
    def backward(ctx, g_pooled, g_s1, g_s2):
        x, ws, zs, pooled = ctx.saved_tensors
        gp = g_pooled.permute(0, 2, 3, 4, 1).to(zs.dtype).contiguous()
        want_db = ctx.needs_input_grad[2]
        res = kernels.stem_bwd(zs, pooled, gp, g_s1.contiguous(),
                               g_s2.contiguous(), ties="first",
                               bias_grad=want_db)
        dzs, dbs = res if want_db else (res, None)
        dz = dzs.permute(0, 4, 1, 2, 3)  # NCDHW view of channels-last
        # channels-last input too, so the conv backward takes dz as it is
        # (cuDNN's kernels are NDHWC) instead of copying it to NCDHW
        xin = phased_input(x).contiguous(memory_format=torch.channels_last_3d)
        dx = dws = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv3d_input(
                xin.shape, ws, dz).permute(0, 2, 3, 1, 4)
        if ctx.needs_input_grad[1]:
            dws = torch.nn.grad.conv3d_weight(xin, ws.shape, dz)
        return dx, dws, dbs


class S2DStemStage(PhasedStemKernel):
    """The AlexNet3D stem stage: k5/s2 phased conv, GroupNorm, relu and
    MaxPool3d(3, 3), with the pool hoisted before the normalize affine
    (``pool_first``, the reference's default).

    Max-pool commutes with a monotone per-channel affine + relu. Channels
    with a negative GroupNorm scale need the window minimum instead, so
    ``sign(scale)`` is folded into the conv kernel and bias: one max-pool on
    the signed conv output ``zs`` serves every channel, and the full-size
    normalized tensor is never built. The GroupNorm statistics always come
    from the pre-pool conv output. The pool-first branch runs its
    full-resolution part (conv, bias, pool, sums) as :class:`StemStage`, on
    the stem kernels on the card; only ``(B, F, D/3, H/3, W/3)`` and
    ``(B, F)`` tensors are left for plain torch. ``pool_first=False`` is the
    textbook order with the same parameters (``F.conv3d``).

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
        w = self.masked()
        gamma = self.scale.float().reshape(1, -1, 1, 1, 1)
        beta = self.bias_gn.float().reshape(1, -1, 1, 1, 1)
        if not self.pool_first:
            z = F.conv3d(phased_input(x), w, self.bias)
            mu, sig = _group_stats(z.float(), self.groups, self.eps)
            y = torch.relu((z.float() - mu) / sig * gamma + beta).to(z.dtype)
            return max_pool3d(y, 3, 3)
        sign = torch.where(self.scale >= 0, 1.0, -1.0).to(w.dtype)
        pooled, s1, s2 = StemStage.apply(
            x, w * sign.reshape(-1, 1, 1, 1, 1), self.bias * sign)
        sf = sign.float()
        # sum(z) = sign * sum(zs); sum(z^2) = sum(zs^2)
        count = (x.shape[1] - 2) * (x.shape[2] - 2) * (x.shape[4] - 2)
        mu, sig = _group_stats_from_sums(s1 * sf, s2, self.groups, count,
                                         self.eps)
        sel = pooled.float() * sf.reshape(1, -1, 1, 1, 1)
        return torch.relu((sel - mu) / sig * gamma + beta).to(pooled.dtype)


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
        self.num_classes = num_classes  # the output count
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


#: the dense-stem stacks' spatial stages, in order: ("conv", kernel, stride,
#: padding) or ("pool",) for a 3x3x3/s3 max-pool
_FEATURES_STAGES = (("conv", 5, 2, 0), ("pool",), ("conv", 3, 1, 0),
                    ("pool",), ("conv", 3, 1, 1), ("conv", 3, 1, 1),
                    ("conv", 3, 1, 1), ("pool",))
_DEEPER_STAGES = _FEATURES_STAGES[:-1] + (("conv", 3, 1, 1), ("pool",))


def _dense_flat_width(model: str, sample_shape: Tuple[int, ...],
                      stages, width: int) -> int:
    """Flatten width of a dense-stem AlexNet for an NDHWC ``(D, H, W[, 1])``
    sample; a ``ValueError`` naming the volume where a window no longer
    fits (the reference's initializer fails there too)."""
    vol = tuple(int(s) for s in sample_shape[:3])
    out = 1
    for s in vol:
        for st in stages:
            k, stride, pad = (3, 3, 0) if st[0] == "pool" else st[1:]
            if s + 2 * pad < k:
                raise ValueError(
                    f"{model}: the volume {'x'.join(map(str, vol))} is too "
                    "small for its convs and three 3x3x3/s3 pools (each "
                    "side needs at least 69 voxels)")
            s = (s + 2 * pad - k) // stride + 1
        out *= s
    return out * width


class _Features(nn.Module):
    """The 5-conv feature stack of AlexNet3D_Dropout: conv k5/s2, pool,
    conv k3, pool, three padded k3 convs, pool; each conv followed by
    GroupNorm and relu. Input and output NCDHW."""

    def __init__(self, widths: tuple = (64, 128, 192, 192, 128)):
        super().__init__()
        w1, w2, w3, w4, w5 = widths
        self.Conv3d_0 = Conv3d(1, w1, kernel_size=5, strides=2)
        self.GroupNorm_0 = group_norm(w1)
        self.Conv3d_1 = Conv3d(w1, w2, kernel_size=3)
        self.GroupNorm_1 = group_norm(w2)
        self.Conv3d_2 = Conv3d(w2, w3, kernel_size=3, padding=1)
        self.GroupNorm_2 = group_norm(w3)
        self.Conv3d_3 = Conv3d(w3, w4, kernel_size=3, padding=1)
        self.GroupNorm_3 = group_norm(w4)
        self.Conv3d_4 = Conv3d(w4, w5, kernel_size=3, padding=1)
        self.GroupNorm_4 = group_norm(w5)

    def forward(self, x):
        x = max_pool3d(torch.relu(self.GroupNorm_0(self.Conv3d_0(x))), 3, 3)
        x = max_pool3d(torch.relu(self.GroupNorm_1(self.Conv3d_1(x))), 3, 3)
        x = torch.relu(self.GroupNorm_2(self.Conv3d_2(x)))
        x = torch.relu(self.GroupNorm_3(self.Conv3d_3(x)))
        x = torch.relu(self.GroupNorm_4(self.Conv3d_4(x)))
        return max_pool3d(x, 3, 3)


def _head(model: nn.Module, x, train: bool, rng):
    """The dense head shared by the dense-stem models: dropout, Dense(64),
    relu, dropout, Dense (``model.Dense_0``, ``model.Dense_1``)."""
    x = dropout(flatten(x), model.dropout_rate, train, rng, 0)
    x = torch.relu(model.Dense_0(x))
    x = dropout(x, model.dropout_rate, train, rng, 1)
    return model.Dense_1(x)


class AlexNet3D(nn.Module):
    """AlexNet3D_Dropout with its dense stem: ``Conv3d(1 -> 64, k5, s2)``
    on the volume itself (cuDNN on the card; the reference runs it through
    XLA's conv, with no Pallas kernel), then the rest of
    :class:`_Features` and the dense head. Input ``(B, D, H, W, 1)``;
    ``sample_shape`` ``(D, H, W, 1)`` fixes the first dense layer's width
    (256 at 121x145x121) and must be at least 69 per side."""

    def __init__(self, num_classes: int = 1, dropout_rate: float = 0.5,
                 sample_shape: Tuple[int, ...] = (121, 145, 121, 1)):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_classes = num_classes  # the output count
        flat = _dense_flat_width("AlexNet3D", sample_shape, _FEATURES_STAGES,
                                 128)
        self._Features_0 = _Features()
        self.Dense_0 = Dense(flat, 64)
        self.Dense_1 = Dense(64, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = self._Features_0(x.permute(0, 4, 1, 2, 3))
        return _head(self, x, train, rng)


class AlexNet3DDeeper(nn.Module):
    """AlexNet3D_Deeper_Dropout: six conv/GroupNorm/relu stages (widths 64,
    128, 192, 384, 256, 256; pools after the first, second and last), the
    dense head; returns ``[logits, logits]`` as the reference does. The
    flatten width is 512 at 121x145x121."""

    WIDTHS = (64, 128, 192, 384, 256, 256)

    def __init__(self, num_classes: int = 1, dropout_rate: float = 0.5,
                 sample_shape: Tuple[int, ...] = (121, 145, 121, 1)):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_classes = num_classes  # the output count
        flat = _dense_flat_width("AlexNet3DDeeper", sample_shape,
                                 _DEEPER_STAGES, self.WIDTHS[-1])
        specs = (dict(kernel_size=5, strides=2), dict(kernel_size=3)) + \
            (dict(kernel_size=3, padding=1),) * 4
        cin = 1
        for i, (w, spec) in enumerate(zip(self.WIDTHS, specs)):
            setattr(self, f"Conv3d_{i}", Conv3d(cin, w, **spec))
            setattr(self, f"GroupNorm_{i}", group_norm(w))
            cin = w
        self.Dense_0 = Dense(flat, 64)
        self.Dense_1 = Dense(64, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = x.permute(0, 4, 1, 2, 3)
        for i in range(len(self.WIDTHS)):
            conv = getattr(self, f"Conv3d_{i}")
            x = torch.relu(getattr(self, f"GroupNorm_{i}")(conv(x)))
            if i in (0, 1, 5):
                x = max_pool3d(x, 3, 3)
        x = _head(self, x, train, rng)
        return [x, x]


class AlexNet3DRegression(nn.Module):
    """AlexNet3D_Dropout_Regression: :class:`AlexNet3D`'s stack with
    ``num_outputs`` outputs; returns ``[pred, features]``, the features the
    pre-flatten activations in the reference's NDHWC layout."""

    def __init__(self, num_outputs: int = 1, dropout_rate: float = 0.5,
                 sample_shape: Tuple[int, ...] = (121, 145, 121, 1)):
        super().__init__()
        self.dropout_rate = dropout_rate
        flat = _dense_flat_width("AlexNet3DRegression", sample_shape,
                                 _FEATURES_STAGES, 128)
        self._Features_0 = _Features()
        self.Dense_0 = Dense(flat, 64)
        self.Dense_1 = Dense(64, num_outputs)

    def forward(self, x, train: bool = False, rng=None):
        feats = self._Features_0(x.permute(0, 4, 1, 2, 3))
        pred = _head(self, feats, train, rng)
        return [pred, feats.permute(0, 2, 3, 4, 1)]


class SmallCNN3D(nn.Module):
    """Tiny 3D CNN for CI-scale runs: conv(k3/s2/p1) + GroupNorm + relu,
    conv(k3/p1) + relu, global average pool, dense. Input
    ``(B, D, H, W, 1)``."""

    def __init__(self, num_classes: int = 1, width: int = 8,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.num_classes = num_classes  # the output count
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
        self.num_classes = num_classes  # the output count
        self.S2DStemConv_0 = S2DStemConv(width, kernel_size=3)
        self.GroupNorm_0 = group_norm(width)
        self.Conv3d_0 = Conv3d(width, width * 2, kernel_size=3, padding=1)
        self.Dense_0 = Dense(width * 2, num_classes)

    def forward(self, x, train: bool = False, rng=None):
        x = torch.relu(self.GroupNorm_0(self.S2DStemConv_0(x)))
        x = torch.relu(self.Conv3d_0(x)).mean(dim=(2, 3, 4))
        x = dropout(x, self.dropout_rate, train, rng, 0)
        return self.Dense_0(x)
