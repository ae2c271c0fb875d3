"""Max-pool and GroupNorm statistics of the stem's conv output, with a
one-pass backward (counterpart of
``neuroimagedisttraining_tpu/ops/experimental/pallas_stem_bwd.py``).

``pool_sum_sumsq(zs)`` returns ``(maxpool3_s3(zs), sum(zs), sum(zs^2))`` for
an NDHWC ``zs``. Its forward is plain torch, as the reference's is plain
XLA; its backward is the stem backward kernel (``ops/kernels.py::stem_bwd``)
with ties split evenly, the reference kernel's contract:
``dzs = gS1 + 2 gS2 zs + [zs == pooled] gm / tie_count``. (The port's
training path routes ties to the first maximum instead, torch's rule.)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import kernels


def supported_shape(zs_shape) -> bool:
    """Whether the backward kernel takes an NDHWC ``zs`` of this shape: five
    axes, F a multiple of 8 up to ``kernels.STEM_MAX_F``. (The reference's
    gate admits only the canonical extents, a TPU tiling limit.)"""
    if len(zs_shape) != 5 or min(zs_shape) < 1:
        return False
    f = zs_shape[-1]
    return f % 8 == 0 and 8 <= f <= kernels.STEM_MAX_F


def _pool_sum_sumsq_fwd_impl(zs: torch.Tensor):
    """The plain forward: floor-mode max-pool and the two f32 sums."""
    m = F.max_pool3d(zs.permute(0, 4, 1, 2, 3), 3, 3).permute(0, 2, 3, 4, 1)
    zf = zs.float()
    return m, zf.sum((1, 2, 3)), (zf * zf).sum((1, 2, 3))


class _PoolSumSumsq(torch.autograd.Function):

    @staticmethod
    def forward(ctx, zs):
        m, s1, s2 = _pool_sum_sumsq_fwd_impl(zs)
        m = m.contiguous()
        ctx.save_for_backward(zs, m)
        return m, s1, s2

    @staticmethod
    @once_differentiable
    def backward(ctx, gm, gs1, gs2):
        zs, m = ctx.saved_tensors
        sdt = kernels.stem_stats_dtype(zs.dtype)
        return kernels.stem_bwd(zs.contiguous(), m,
                                gm.to(m.dtype).contiguous(),
                                gs1.to(sdt).contiguous(),
                                gs2.to(sdt).contiguous(), ties="split")


def pool_sum_sumsq(zs: torch.Tensor):
    """(maxpool3_s3(zs), sum(zs), sum(zs^2)) with the fused one-pass
    backward. ``zs`` is ``(B, D, H, W, F)``; forward is plain torch."""
    if not supported_shape(tuple(zs.shape)):
        raise ValueError(f"pool_sum_sumsq: unsupported zs shape "
                         f"{tuple(zs.shape)}")
    return _PoolSumSumsq.apply(zs)
