"""Space-to-depth (phase-decomposed) stem for single-channel 3D volumes
(counterpart of ``neuroimagedisttraining_tpu/ops/s2d.py``).

A stride-2 conv over a one-channel volume equals a stride-1 conv over its 8
stride-2 phase subgrids taken as input channels, with the kernel remapped
tap for tap. Volumes are stored phase-decomposed once, in the reference's
layout: per sample ``(D', H', 8, W')`` (phases next-to-minor).

Tap bijection (per axis, stride 2, kernel k): original tap t reads phase
``t % 2`` at offset ``t // 2``; for k=5 the remapped kernel is 3 wide and the
(offset 2, phase 1) slot is unused — 125 of 216 slots carry taps, the rest
stay zero under :func:`stem_slot_mask`.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

STRIDE = 2
KERNEL = 5  # the AlexNet3D stem: k5, s2, no padding
N_PHASES = STRIDE ** 3


def r_kernel(kernel: int = KERNEL) -> int:
    """Remapped per-axis kernel extent: ceil(kernel / stride)."""
    return -(-kernel // STRIDE)


def out_extent(size: int, kernel: int = KERNEL, pad: int = 0) -> int:
    """Stride-2 conv output extent with torch-style integer padding."""
    return (size + 2 * pad - kernel) // STRIDE + 1


def phase_extent(size: int, kernel: int = KERNEL, pad: int = 0) -> int:
    """Phase-subgrid extent whose stride-1 ``r_kernel`` conv yields exactly
    ``out_extent(size)`` positions."""
    return out_extent(size, kernel, pad) + r_kernel(kernel) - 1


def phase_decompose(x, kernel: int = KERNEL, pad: int = 0):
    """``(..., D, H, W)`` volume -> ``(..., D', H', 8, W')`` phased, for
    numpy arrays or torch tensors. The conv's padding ``pad`` is applied
    here (left), and zeros on the right top each phase up to its extent.
    Phase index is ``pd*4 + ph*2 + pw``."""
    is_torch = isinstance(x, torch.Tensor)
    D, H, W = x.shape[-3:]
    exts = tuple(phase_extent(s, kernel, pad) for s in (D, H, W))
    need = [2 * e for e in exts]
    right = [max(0, n - s - pad) for n, s in zip(need, (D, H, W))]
    if is_torch:
        # F.pad takes (last-dim left, right, ...) pairs, innermost first
        x = torch.nn.functional.pad(
            x, (pad, right[2], pad, right[1], pad, right[0]))
    else:
        x = np.pad(x, [(0, 0)] * (x.ndim - 3) + [(pad, r) for r in right])
    phases = [
        x[..., i::2, j::2, k::2][..., :exts[0], :exts[1], :exts[2]]
        for i in (0, 1) for j in (0, 1) for k in (0, 1)
    ]
    return torch.stack(phases, dim=-2) if is_torch else np.stack(phases, -2)


def remap_stem_kernel(w, kernel: int = None) -> np.ndarray:
    """``(k,k,k,1,F)`` stem kernel -> ``(r,r,r,8,F)`` phased kernel (the
    reference's DHWIO layout; numpy in, numpy out)."""
    w_np = np.asarray(w, dtype=np.float32)
    k = kernel if kernel is not None else w_np.shape[0]
    r = r_kernel(k)
    w2 = np.zeros((r,) * 3 + (N_PHASES, w_np.shape[-1]), dtype=np.float32)
    for td in range(k):
        for th in range(k):
            for tw in range(k):
                ph = (td % 2) * 4 + (th % 2) * 2 + (tw % 2)
                w2[td // 2, th // 2, tw // 2, ph, :] = w_np[td, th, tw, 0, :]
    return w2


def stem_slot_mask(kernel: int = KERNEL) -> np.ndarray:
    """``(r,r,r,8,1)`` 0/1 mask of the remapped slots that carry taps,
    derived from the remap itself."""
    return remap_stem_kernel(np.ones((kernel,) * 3 + (1, 1), np.float32))


def convert_alexnet3d_params(params) -> dict:
    """Map a dense-stem AlexNet3D param tree (the reference's naming, numpy
    leaves) to the AlexNet3DS2D tree: the stem kernel is remapped tap for
    tap into ``S2DStemStage_0``, which also owns the stem GroupNorm's affine
    pair; the remaining GroupNorms are renumbered 0..3."""
    feats = params["_Features_0"]
    out = {"S2DStemStage_0": {
        "kernel": remap_stem_kernel(feats["Conv3d_0"]["Conv_0"]["kernel"]),
        "bias": feats["Conv3d_0"]["Conv_0"]["bias"],
        "scale": feats["GroupNorm_0"]["scale"],
        "bias_gn": feats["GroupNorm_0"]["bias"],
    }}
    for i in range(1, 5):
        out[f"Conv3d_{i-1}"] = feats[f"Conv3d_{i}"]
        out[f"GroupNorm_{i-1}"] = feats[f"GroupNorm_{i}"]
    out["Dense_0"] = params["Dense_0"]
    out["Dense_1"] = params["Dense_1"]
    return out


def phased_sample_shape(volume: Tuple[int, int, int], kernel: int = KERNEL,
                        pad: int = 0) -> Tuple[int, ...]:
    """Stored per-sample shape for a ``(D, H, W)`` volume: (D', H', 8, W')."""
    d, h, w = volume
    return (phase_extent(d, kernel, pad), phase_extent(h, kernel, pad),
            N_PHASES, phase_extent(w, kernel, pad))
