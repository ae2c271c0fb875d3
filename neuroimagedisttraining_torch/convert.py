"""Parameters of the JAX reference package -> this package's ``state_dict``.

The reference's params are a nested dict (flax naming, numpy leaves); the
result maps this package's parameter names to float32 CPU tensors:

* conv kernels DHWIO -> OIDHW (``Conv3d_i/Conv_0/kernel`` -> ``Conv3d_i.kernel``);
* the phased stem kernel ``(r, r, r, 8, F)`` -> ``(F, 8, r, r, r)``; its
  slot mask is applied at use, as in the reference;
* dense kernels ``(in, out)`` -> ``(out, in)``; the flatten is channels-last
  on both sides, so no row permutation;
* GroupNorm ``scale``/``bias`` and the stem stage's ``scale``/``bias_gn``
  unchanged.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _leaf(module: str, name: str, value) -> np.ndarray:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if a.ndim == 5:  # DHWIO (convs and the phased stem) -> OIDHW
            return a.transpose(4, 3, 0, 1, 2)
        if a.ndim == 2:  # dense (in, out) -> (out, in)
            return a.T
        raise ValueError(f"{module}.kernel: unexpected shape {a.shape}")
    return a


def jax_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A reference param tree (AlexNet3DS2D, SmallCNN3D, SmallCNN3DS2D) as
    this package's ``state_dict``."""
    out = {}
    for module, leaves in params.items():
        if set(leaves) == {"Conv_0"}:  # Conv3d wraps one flax Conv
            leaves = leaves["Conv_0"]
        for name, value in leaves.items():
            out[f"{module}.{name}"] = torch.from_numpy(
                np.array(_leaf(module, name, value), order="C"))
    return out
