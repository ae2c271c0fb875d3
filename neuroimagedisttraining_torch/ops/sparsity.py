"""SNIP saliency and the global top-k mask (counterpart of
``neuroimagedisttraining_tpu/ops/sparsity.py``, the parts SalientGrads
runs).

* SNIP scores: ``|dL/dm|`` for an all-ones multiplier ``m`` on every kernel
  leaf (``dL/dm`` at ``m = 1`` is ``(dL/dw) * w``).
* Global mask: normalize the mean scores by their sum, keep the
  ``int(n * keep_ratio)`` largest with a ``>=`` threshold; only conv/dense
  kernels are masked, every other leaf gets an all-ones mask.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from ..convert import reference_leaf_order, to_reference_layout
from ..core.losses import make_loss_fn
from ..core.state import Tree


def kernel_flags(params: Tree) -> Dict[str, bool]:
    """True for conv/dense kernel leaves (names ending in ``kernel``)."""
    return {k: k.rsplit(".", 1)[-1] == "kernel" for k in params}


def mask_density(mask: Tree) -> float:
    """Fraction of nonzero mask entries over the kernel leaves."""
    return float(mask_density_tensor(mask))


def mask_density_tensor(mask: Tree) -> torch.Tensor:
    """:func:`mask_density` as a 0-d float64 tensor on the mask's device,
    with no wait on the card (an eval a CUDA graph can hold): the count is
    exact in float64 and the division correctly rounded, so it holds the
    same value as the Python division."""
    flags = kernel_flags(mask)
    leaves = [m for k, m in mask.items() if flags[k]]
    nnz = sum(torch.count_nonzero(m) for m in leaves)
    return nnz.double() / float(sum(m.numel() for m in leaves))


def host_live_indices(mask: Tree,
                      stacked: bool = False) -> List[Optional[torch.Tensor]]:
    """The gather plan of mask-aware sparse aggregation
    (``parallel/collectives.py``): for each leaf, in the reference's leaf
    order (:func:`convert.reference_leaf_order`), the int64 flat indices of
    its live (nonzero) coordinates in the reference's layout — or ``None``
    for leaves that stay dense (non-kernel leaves, and kernels with no dead
    coordinate). ``stacked=True`` reads ``[C, ...]`` per-client masks and
    returns the union of live coordinates over the client axis. The indices
    stay on the mask's device."""
    flags = kernel_flags(mask)
    out = []
    for k in reference_leaf_order(mask):
        m = to_reference_layout(k, mask[k], lead=int(stacked))
        live = (m != 0).any(dim=0) if stacked else m != 0
        live = live.reshape(-1)
        if not flags[k] or bool(live.all()):
            out.append(None)
        else:
            out.append(torch.nonzero(live).reshape(-1))
    return out


def make_snip_score_fn(apply_fn, loss_type: str, batch_size: int) -> Callable:
    """``snip_scores(params, x, y, n_valid, n_iters, *, idx=None, rng=None)``:
    the mean over ``n_iters`` batches of one client's shard of ``|dL/dm|``
    per kernel leaf (zeros elsewhere).

    ``idx`` (``[n_iters, batch_size]`` row indices) is the random seam;
    when it is None the batches are drawn uniformly with replacement from
    the valid rows on ``rng``, the ``torch.Generator`` that also draws the
    dropout masks."""
    loss_fn = make_loss_fn(loss_type)

    def batch_scores(params, xb, yb, drop):
        flags = kernel_flags(params)
        ones = {k: torch.ones_like(v, requires_grad=True)
                for k, v in params.items() if flags[k]}
        masked = {k: v * ones[k] if flags[k] else v
                  for k, v in params.items()}
        loss = loss_fn(apply_fn(masked, xb, train=True, rng=drop), yb)
        grads = torch.autograd.grad(loss, list(ones.values()))
        g = dict(zip(ones, grads))
        return {k: g[k].abs() if flags[k] else torch.zeros_like(v)
                for k, v in params.items()}

    def snip_scores(params, x, y, n_valid: int, n_iters: int, *,
                    idx: Optional[torch.Tensor] = None, rng=None):
        params = {k: v.detach() for k, v in params.items()}
        total = None
        for it in range(n_iters):
            if idx is None:
                bi = torch.randint(0, max(int(n_valid), 1), (batch_size,),
                                   generator=rng, device=rng.device)
            else:
                bi = torch.as_tensor(idx[it])
            bi = bi.to(x.device)
            s = batch_scores(params, x[bi], y[bi], rng)
            total = s if total is None else {k: total[k] + s[k] for k in s}
        return {k: t / n_iters for k, t in total.items()}

    return snip_scores


def mask_from_scores(scores: Tree, keep_ratio: float) -> Tree:
    """Global top-k binary mask from a (mean) score tree: threshold by the
    exact k-th largest normalized kernel score (the threshold kernel on the
    GPU), then build each kernel leaf's mask with the score-mask kernel."""
    from .kernels import fused_score_mask
    from .topk_select import select_threshold

    flags = kernel_flags(scores)
    names = [k for k in scores if flags[k]]
    flat = torch.cat([scores[k].reshape(-1) for k in names])
    norm = torch.sum(flat)
    n_keep = max(1, int(flat.numel() * keep_ratio))
    threshold = select_threshold((flat / norm).reshape(1, -1), n_keep)
    masks = dict(zip(names, fused_score_mask(
        [scores[k].contiguous() for k in names], norm, threshold)))
    return {k: masks[k].to(v.dtype) if flags[k] else torch.ones_like(v)
            for k, v in scores.items()}
