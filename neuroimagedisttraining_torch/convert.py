"""Parameters of the JAX reference package -> this package's ``state_dict``.

The reference's params are a nested dict (flax naming, numpy leaves); the
result maps this package's parameter names to float32 CPU tensors:

* conv kernels DHWIO -> OIDHW (``Conv3d_i/Conv_0/kernel`` ->
  ``Conv3d_i.kernel``; nested scopes keep their names,
  ``_Features_0/Conv3d_i/Conv_0/kernel`` -> ``_Features_0.Conv3d_i.kernel``);
* the phased stem kernel ``(r, r, r, 8, F)`` -> ``(F, 8, r, r, r)``; its
  slot mask is applied at use, as in the reference;
* dense kernels ``(in, out)`` -> ``(out, in)``; the flatten is channels-last
  on both sides, so no row permutation;
* GroupNorm ``scale``/``bias`` and the stem stage's ``scale``/``bias_gn``
  unchanged.

The aggregation wires flatten a tree the reference's way (``tree_to_vec``
in ``parallel/collectives.py``): leaves in ``jax.tree_util.tree_leaves``
order, which is sorted flax keys (:func:`reference_leaf_order`), each leaf in
the reference's layout (:func:`to_reference_layout`). The int8 wire's
bucket scales and the top-k leaf groups depend on which values share a
bucket, so this makes the port's ``[C, N]`` matrix the reference's, element
for element.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Mapping

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


def _walk(prefix: str, node: Mapping, out: Dict[str, torch.Tensor]) -> None:
    if set(node) == {"Conv_0"}:  # Conv3d wraps one flax Conv
        node = node["Conv_0"]
    for name, value in node.items():
        if isinstance(value, Mapping):  # a submodule's scope
            _walk(f"{prefix}{name}.", value, out)
        else:
            out[prefix + name] = torch.from_numpy(
                np.array(_leaf(prefix[:-1], name, value), order="C"))


def jax_params_to_torch(params: Mapping) -> Dict[str, torch.Tensor]:
    """A reference param tree (the AlexNet3D family, SmallCNN3D,
    SmallCNN3DS2D) as this package's ``state_dict``; nested flax scopes
    (``_Features_0/Conv3d_i/Conv_0``) become dotted names
    (``_Features_0.Conv3d_i.kernel``)."""
    out: Dict[str, torch.Tensor] = {}
    _walk("", params, out)
    return out


def reference_leaf_order(keys: Iterable[str]) -> List[str]:
    """The ``state_dict`` names in the reference's ``tree_leaves`` order:
    sorted scope by scope, then by leaf name (``Conv3d_i`` wraps a single
    ``Conv_0``, which does not change the order)."""
    return sorted(keys, key=lambda k: k.split("."))


def _is_kernel(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == "kernel"


def to_reference_layout(name: str, t: torch.Tensor,
                        lead: int = 0) -> torch.Tensor:
    """Leaf ``name`` in the reference's layout, as a permuted view: conv and
    stem kernels OIDHW -> DHWIO, dense kernels ``(out, in)`` -> ``(in, out)``,
    every other leaf unchanged. The first ``lead`` axes (a client axis) stay
    in front. The inverse of :func:`jax_params_to_torch`'s per-leaf
    transpose."""
    nd = t.dim() - lead
    if _is_kernel(name) and nd in (2, 5):
        keep = tuple(range(lead))
        perm = (2, 3, 4, 1, 0) if nd == 5 else (1, 0)
        return t.permute(keep + tuple(lead + i for i in perm))
    return t


def from_reference_layout(name: str, t: torch.Tensor,
                          lead: int = 0) -> torch.Tensor:
    """The inverse of :func:`to_reference_layout`, as a permuted view."""
    nd = t.dim() - lead
    if _is_kernel(name) and nd in (2, 5):
        keep = tuple(range(lead))
        perm = (4, 3, 0, 1, 2) if nd == 5 else (1, 0)
        return t.permute(keep + tuple(lead + i for i in perm))
    return t
