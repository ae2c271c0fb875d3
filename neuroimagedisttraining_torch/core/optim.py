"""SGD with torch.optim.SGD semantics over lists of tensors (counterpart of
``neuroimagedisttraining_tpu/core/optim.py``).

Update order, as the reference's local optimizer:
  g   <- g + wd * p          (weight decay added to the *clipped* gradient)
  buf <- momentum * buf + g
  p   <- p - lr * buf
Each multiply-add is rounded once (:func:`fma`): the reference, compiled by
XLA, contracts each into a fused multiply-add, and so does the CUDA kernel
(``csrc/masked_sgd.cu``).
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def _f64(x) -> torch.Tensor:
    """``x`` rounded to float32 first (a Python float enters as f32, as a
    weakly typed scalar does in the reference), then widened exactly."""
    return torch.as_tensor(x, dtype=torch.float32).double()


def fma(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c`` (one rounding, as a hardware
    fused multiply-add), for float32 tensors or Python floats.

    The product of two f32 values is exact in f64. The f64 sum is made
    round-to-odd (TwoSum gives the exact residual; an inexact sum with an
    even last bit steps one ulp toward it), and round-to-odd at 53 bits
    followed by round-to-nearest at 24 bits is the correct rounding of the
    exact value."""
    a64, b64, c64 = _f64(a), _f64(b), _f64(c)
    prod = a64 * b64
    s = prod + c64
    bb = s - prod
    err = (prod - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    total = sum(torch.sum(torch.square(g.float())) for g in tensors)
    return torch.sqrt(total)


def clip_by_global_norm(grads: List[torch.Tensor],
                        max_norm: float) -> List[torch.Tensor]:
    """torch.nn.utils.clip_grad_norm_ semantics: scale = max_norm /
    (norm + 1e-6), capped at 1."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return [g * scale.to(g.dtype) for g in grads]


def sgd_momentum_step(params: List[torch.Tensor], momenta: List[torch.Tensor],
                      grads: List[torch.Tensor], lr, momentum: float,
                      weight_decay: float
                      ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """One torch-order SGD step; returns (new_params, new_momenta). A zero
    ``weight_decay`` or ``momentum`` needs no branch: ``fma(0, x, g)`` is
    ``g``."""
    neg_lr = -torch.as_tensor(lr, dtype=torch.float32)
    new_p, new_m = [], []
    for p, m, g in zip(params, momenta, grads):
        m = fma(momentum, m, fma(weight_decay, p, g))
        new_p.append(fma(neg_lr, m, p))
        new_m.append(m)
    return new_p, new_m
