"""Model registry (counterpart of ``neuroimagedisttraining_tpu/models/__init__.py``).

``create_model`` returns an ``nn.Module``; training and evaluation run it
functionally, with per-client parameter dicts, through the uniform
``apply_fn(params, x, train, rng)`` of :func:`make_apply_fn`.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .alexnet3d import (
    AlexNet3D,
    AlexNet3DDeeper,
    AlexNet3DRegression,
    AlexNet3DS2D,
    SmallCNN3D,
    SmallCNN3DS2D,
)

ApplyFn = Callable[..., Any]


def _regression(num_classes: int = 1, **kwargs) -> AlexNet3DRegression:
    return AlexNet3DRegression(num_outputs=num_classes, **kwargs)


_REGISTRY = {
    # the reference's dense-stem AlexNets (--model flags)
    "3dcnn": AlexNet3D,
    "3dcnn_deeper": AlexNet3DDeeper,
    "3dcnn_regression": _regression,
    # AlexNet3D over phase-decomposed input (ops/s2d.py)
    "3dcnn_s2d": AlexNet3DS2D,
    # CI-scale models
    "small3dcnn": SmallCNN3D,
    "small3dcnn_s2d": SmallCNN3DS2D,
}


#: the model keys this package has
MODEL_NAMES = tuple(sorted(_REGISTRY))


def create_model(name: str, num_classes: int = 1, **kwargs) -> torch.nn.Module:
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[key](num_classes=num_classes, **kwargs)


def init_params(model: torch.nn.Module,
                generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Fresh parameters from ``generator`` with the reference's initializers,
    as a detached dict on the model's device (the model's own parameters are
    re-initialized too)."""
    for mod in model.modules():
        if mod is not model and hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def make_apply_fn(model: torch.nn.Module,
                  compute_dtype: Optional[torch.dtype] = None,
                  channel_inject: bool = False) -> ApplyFn:
    """``apply_fn(params, x, train, rng)``: the model run on ``params``.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) is mixed precision as the
    reference does it: float32 master weights stay with the optimizer, the
    parameters and the input are cast on entry so convolutions and matmuls
    run in ``compute_dtype``, and every floating output is cast back to
    float32 (each tensor of a list output, as the deeper and regression
    AlexNets return).

    ``channel_inject`` appends the trailing channel axis to the batch at
    apply time (the reference's per-batch ``x.unsqueeze(1)``): the cohort
    of ``--layout flat`` is stored channel-less."""

    def _out(t):
        return t.float() if t.is_floating_point() else t

    def apply_fn(params, x, train: bool, rng=None):
        if channel_inject:
            x = x[..., None]
        if compute_dtype is not None:
            params = {k: v.to(compute_dtype) for k, v in params.items()}
            x = x.to(compute_dtype)
        out = torch.func.functional_call(model, params, (x,),
                                         {"train": train, "rng": rng})
        if compute_dtype is None:
            return out
        if isinstance(out, (list, tuple)):
            return [_out(t) for t in out]
        return _out(out)

    return apply_fn


__all__ = ["AlexNet3D", "AlexNet3DDeeper", "AlexNet3DRegression",
           "AlexNet3DS2D", "MODEL_NAMES", "SmallCNN3D", "SmallCNN3DS2D",
           "create_model",
           "init_params", "make_apply_fn"]
