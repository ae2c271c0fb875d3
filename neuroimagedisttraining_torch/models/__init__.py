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
from .cnn2d import (
    CNNCifar10,
    CNNCifar100,
    CNNDropOut,
    CNNOriginalFedAvg,
    LeNet5,
    VGG11,
    VGG16,
)
from .meta import CNNCifar10Meta, MetaNet, MetaResNet20, init_random_mask
from .resnet2d import OriginalResNet18, ResNet18GN, TinyResNet18
from .resnet3d import ResNet3DL3, ResNet3DL3S2D, convert_resnet3d_params
from .resnet_gn import ResNetGN, resnet18_gn, resnet34_gn, resnet50_gn
from .resnet_ip import ResNetIP

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
    # the 3-stage 3D ResNet and its twin over phase-decomposed input
    "3dresnet": ResNet3DL3,
    "3dresnet_s2d": ResNet3DL3S2D,
    # CI-scale models
    "small3dcnn": SmallCNN3D,
    "small3dcnn_s2d": SmallCNN3DS2D,
    # the 2D image models (NHWC input; sample_shape (H, W, C))
    "resnet18": ResNet18GN,
    # BatchNorm variant: forward/eval parity with running statistics
    # (OriginalResNet18.apply_with_stats); the FL trainers use the GN twin
    "original_resnet18": OriginalResNet18,
    "resnet_ip": ResNetIP,
    "resnet_meta": MetaResNet20,
    "tiny_resnet18": TinyResNet18,
    "cnn_cifar10": CNNCifar10,
    "cnn_cifar100": CNNCifar100,
    "cnn": CNNOriginalFedAvg,
    "lenet5": LeNet5,
    "vgg11": VGG11,
    "vgg16": VGG16,
    "cnn_dropout": CNNDropOut,
    "cnn_cifar10_meta": CNNCifar10Meta,
    "resnet18_gn": resnet18_gn,
    "resnet34_gn": resnet34_gn,
    "resnet50_gn": resnet50_gn,
}

#: the 2D image models' keys (input ``(B, H, W, C)``)
MODELS_2D = ("cnn", "cnn_cifar10", "cnn_cifar100", "cnn_cifar10_meta",
             "cnn_dropout", "lenet5", "original_resnet18", "resnet18",
             "resnet18_gn", "resnet34_gn", "resnet50_gn", "resnet_ip",
             "resnet_meta", "tiny_resnet18", "vgg11", "vgg16")


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
    re-initialized too). A BatchNorm model's running statistics are not
    parameters (``OriginalResNet18.init_batch_stats``)."""
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
    of ``--layout flat`` is stored channel-less.

    ``apply_fn.model`` is ``model``."""

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

    #: the module it runs (``functional_call`` swaps its parameters while a
    #: call runs: two threads must not share one)
    apply_fn.model = model
    return apply_fn


__all__ = ["AlexNet3D", "AlexNet3DDeeper", "AlexNet3DRegression",
           "AlexNet3DS2D", "CNNCifar10", "CNNCifar100", "CNNCifar10Meta",
           "CNNDropOut", "CNNOriginalFedAvg", "LeNet5", "MODELS_2D",
           "MODEL_NAMES", "MetaNet", "MetaResNet20", "OriginalResNet18",
           "ResNet18GN", "ResNet3DL3", "ResNet3DL3S2D", "ResNetGN",
           "ResNetIP", "SmallCNN3D", "SmallCNN3DS2D", "TinyResNet18",
           "VGG11", "VGG16", "convert_resnet3d_params", "create_model",
           "init_params", "init_random_mask", "make_apply_fn",
           "resnet18_gn", "resnet34_gn", "resnet50_gn"]
