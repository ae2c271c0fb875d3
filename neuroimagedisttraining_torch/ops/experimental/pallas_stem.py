"""The stem conv alone (counterpart of
``neuroimagedisttraining_tpu/ops/experimental/pallas_stem.py``).

``stem_conv_pallas`` keeps the reference's name and contract and runs on the
stem forward kernel (``ops/kernels.py::stem_fwd``) with no bias, no pool
and no statistics. The reference's tiling limits (W <= 64, H' >= 10) are TPU
limits and are not kept.
"""
from __future__ import annotations

import torch

from .. import kernels

R = 3       # remapped kernel extent per dim
P8 = 8      # phases


def kernel_from_wt(wt: torch.Tensor) -> torch.Tensor:
    """``(F, 216)`` remapped kernel, ``k = ((dz*3+dy)*3+dx)*8 + p`` -> the
    port's ``(F, 8, 3, 3, 3)`` stem kernel (a permuted copy)."""
    f = wt.shape[0]
    return wt.reshape(f, R, R, R, P8).permute(0, 4, 1, 2, 3).contiguous()


def stem_conv_pallas(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x: ``(B, D', H', 8, W')`` phased volume; wt: ``(F, 216)`` remapped
    kernel (``k = ((dz*3+dy)*3+dx)*8 + p``). Returns the VALID stride-1
    conv ``(B, D'-2, H'-2, W'-2, F)`` in ``x``'s type, matching lax.conv on
    NDHCW/DHWIO."""
    if x.dim() != 5 or x.shape[3] != P8:
        raise ValueError(f"phase axis must be {P8}, got shape "
                         f"{tuple(x.shape)}")
    zs, _, _, _ = kernels.stem_fwd(x, kernel_from_wt(wt.to(x.dtype)), None,
                                   pool=False, stats=False)
    return zs
