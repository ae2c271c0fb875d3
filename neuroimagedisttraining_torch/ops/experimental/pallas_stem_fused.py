"""The fused stem forward: conv + 3x3x3/s3 max-pool + GroupNorm statistics
in one pass (counterpart of
``neuroimagedisttraining_tpu/ops/experimental/pallas_stem_fused.py``).

``fused_stem_fwd`` keeps the reference's name and outputs and runs on the
stem forward kernel (``ops/kernels.py::stem_fwd``). Its statistics are
``[B, n, 2, F]`` partials whose sum over axis 1 is the contract; the port
reduces them on the card already, so ``n`` is 1. The reference's fixed
extents (B = 8, 61x73x8x61) are TPU tiling limits and are not kept: any
shape the kernel takes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .pallas_stem import kernel_from_wt


def fused_stem_fwd(x: torch.Tensor, wt: torch.Tensor):
    """x: ``(B, D', H', 8, W')``; wt: ``(F, 216)`` remapped kernel. Returns
    ``(zs (B, D, H, W, F), pooled (B, D//3, H//3, W//3, F), stats [B, 1, 2,
    F] f32)`` with ``stats[:, 0, 0]`` the sum and ``stats[:, 0, 1]`` the sum
    of squares of ``zs`` per (sample, channel)."""
    zs, pooled, s1, s2 = kernels.stem_fwd(
        x, kernel_from_wt(wt.to(x.dtype)), None)
    return zs, pooled, torch.stack([s1, s2], dim=1)[:, None]


def ref(x: torch.Tensor, w: torch.Tensor):
    """The plain spelling: ``w`` is the ``(3, 3, 3, 8, F)`` DHWIO kernel.
    Returns ``(zs, pooled, (sum, sum of squares))``, NDHWC."""
    z = F.conv3d(x.permute(0, 3, 1, 2, 4), w.permute(4, 3, 0, 1, 2))
    pooled = F.max_pool3d(z, 3, 3)
    zs = z.permute(0, 2, 3, 4, 1)
    zf = zs.float()
    return zs, pooled.permute(0, 2, 3, 4, 1), (zf.sum((1, 2, 3)),
                                               (zf * zf).sum((1, 2, 3)))
