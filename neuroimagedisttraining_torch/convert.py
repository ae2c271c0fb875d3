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

:func:`jax_state_to_torch` turns a whole reference algorithm state, given as
numpy arrays (a restored orbax checkpoint's), into this package's state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping, Optional

import numpy as np
import torch


def _leaf(module: str, name: str, value, lead: int = 0) -> np.ndarray:
    a = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        keep = tuple(range(lead))
        nd = a.ndim - lead
        if nd == 5:  # DHWIO (convs and the phased stem) -> OIDHW
            return a.transpose(keep + tuple(lead + i
                                            for i in (4, 3, 0, 1, 2)))
        if nd == 2:  # dense (in, out) -> (out, in)
            return a.transpose(keep + (lead + 1, lead))
        raise ValueError(f"{module}.kernel: unexpected shape {a.shape}")
    return a


def _walk(prefix: str, node: Mapping, out: Dict[str, torch.Tensor],
          lead: int = 0) -> None:
    if set(node) == {"Conv_0"}:  # Conv3d wraps one flax Conv
        node = node["Conv_0"]
    for name, value in node.items():
        if isinstance(value, Mapping):  # a submodule's scope
            _walk(f"{prefix}{name}.", value, out, lead)
        else:
            out[prefix + name] = torch.from_numpy(
                np.array(_leaf(prefix[:-1], name, value, lead), order="C"))


def jax_params_to_torch(params: Mapping,
                        lead: int = 0) -> Dict[str, torch.Tensor]:
    """A reference param tree (the AlexNet3D family, SmallCNN3D,
    SmallCNN3DS2D) as this package's ``state_dict``; nested flax scopes
    (``_Features_0/Conv3d_i/Conv_0``) become dotted names
    (``_Features_0.Conv3d_i.kernel``). The first ``lead`` axes of every
    leaf (a client axis) stay in front."""
    out: Dict[str, torch.Tensor] = {}
    _walk("", params, out, lead)
    return out


#: the state fields that stack one tree per client
_STACKED = ("personal_params", "agg_residual", "masks")


def jax_state_to_torch(template: Any, fields: Mapping[str, Any],
                       generator: Optional[torch.Generator] = None) -> Any:
    """A reference algorithm state as this package's, shaped like
    ``template`` (the port's ``init_state`` of the same configuration: its
    field set, dtypes and device). ``fields`` maps the reference state's
    field names to their numpy values: the parameter trees
    (``global_params``, ``mask``) and the per-client stacks
    (``personal_params``, ``agg_residual``, ``masks``) as nested flax
    trees, ``eval_cache`` as its dict of ``[C]`` arrays. The reference's
    PRNG key has no torch counterpart: the state carries ``generator``
    (the template's by default). A field the template holds as None must
    be absent or None in ``fields``, and the reverse."""
    out: Dict[str, Any] = {}
    for f in dataclasses.fields(template):
        like = getattr(template, f.name)
        if f.name == "generator":
            out[f.name] = like if generator is None else generator
            continue
        v = fields.get(f.name)
        if (like is None) != (v is None):
            raise ValueError(
                f"{f.name}: the reference state has "
                f"{'None' if v is None else 'a value'}, the template "
                f"{'None' if like is None else 'a value'}")
        if like is None:
            out[f.name] = None
        elif f.name == "eval_cache":
            out[f.name] = {k: torch.as_tensor(np.asarray(v[k])).to(
                like[k].device, like[k].dtype) for k in like}
        else:
            tree = jax_params_to_torch(v, lead=int(f.name in _STACKED))
            if sorted(tree) != sorted(like):
                raise ValueError(f"{f.name}: the reference tree's leaves "
                                 "differ from the template's")
            out[f.name] = {k: tree[k].to(like[k].device, like[k].dtype)
                           for k in like}
    return dataclasses.replace(template, **out)


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
