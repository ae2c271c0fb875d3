"""The fused stem forward from the staged-unfold lhs, with bias
(counterpart of
``neuroimagedisttraining_tpu/ops/experimental/pallas_stem_v3.py``).

``make_stem_lhs`` builds the reference's ``(3 rot, 3 dy, F, 72)`` lhs
variants bit for bit; ``fused_stem_fwd_v3`` recovers the kernel from them and
runs the stem forward kernel (``ops/kernels.py::stem_fwd``) with the bias.
The bias is added as the reference's ``ref`` and the model spell it: after
the conv is rounded to the working type, in the working type. (The TPU
kernel adds it in f32 before its one rounding.) Any shape the kernel takes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels


def make_stem_lhs(w: torch.Tensor) -> torch.Tensor:
    """``(3 rot, 3 dy, F, 72)`` lhs variants from the ``(3, 3, 3, 8, F)``
    kernel. Column ``s*24 + dx*8 + p`` of variant ``(rot, dy)`` holds
    ``w[dz, dy, dx, p, :]`` with ``dz = (s - rot) % 3``."""
    w = torch.as_tensor(w)
    f = w.shape[-1]
    out = torch.zeros((3, 3, f, 72), dtype=w.dtype, device=w.device)
    for rot in range(3):
        for dy in range(3):
            for s in range(3):
                dz = (s - rot) % 3
                out[rot, dy, :, s * 24:(s + 1) * 24] = w[dz, dy].reshape(
                    24, f).T
    return out


def kernel_from_lhs(lhs: torch.Tensor) -> torch.Tensor:
    """The port's ``(F, 8, 3, 3, 3)`` stem kernel from the lhs: variant
    ``rot = 0`` holds tap ``dz`` in ring slot ``s = dz``."""
    f = lhs.shape[2]
    w = lhs[0].reshape(3, f, 3, 3, 8)  # (dy, F, dz, dx, p)
    return w.permute(1, 4, 2, 0, 3).contiguous()


def fused_stem_fwd_v3(x: torch.Tensor, lhs: torch.Tensor,
                      bias: torch.Tensor):
    """x: ``(B, D', H', 8, W')``; lhs: :func:`make_stem_lhs` of the kernel;
    bias: ``(F,)``. Returns ``(zs + bias, maxpool3(zs + bias), stats [B, 1,
    2, F])``, NDHWC, the statistics as in ``pallas_stem_fused``."""
    zs, pooled, s1, s2 = kernels.stem_fwd(
        x, kernel_from_lhs(lhs.to(x.dtype)), bias.to(x.dtype))
    return zs, pooled, torch.stack([s1, s2], dim=1)[:, None]


def ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """The plain spelling, ``w`` the ``(3, 3, 3, 8, F)`` DHWIO kernel."""
    z = F.conv3d(x.permute(0, 3, 1, 2, 4), w.permute(4, 3, 0, 1, 2))
    z = z + bias.to(z.dtype).reshape(1, -1, 1, 1, 1)
    pooled = F.max_pool3d(z, 3, 3)
    zs = z.permute(0, 2, 3, 4, 1)
    zf = zs.float()
    return zs, pooled.permute(0, 2, 3, 4, 1), (zf.sum((1, 2, 3)),
                                               (zf * zf).sum((1, 2, 3)))
