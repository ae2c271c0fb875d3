"""SNIP saliency and the global top-k mask (counterpart of
``neuroimagedisttraining_tpu/ops/sparsity.py``, the parts SalientGrads
runs).

* SNIP scores: ``|dL/dm|`` for an all-ones multiplier ``m`` on every kernel
  leaf (``dL/dm`` at ``m = 1`` is ``(dL/dw) * w``).
* Global mask: normalize the mean scores by their sum, keep the
  ``int(n * keep_ratio)`` largest with a ``>=`` threshold; only conv/dense
  kernels are masked, every other leaf gets an all-ones mask.
* Stratified SNIP (``stratified_sampling``): "balanced" scores 25 batches
  drawn with per-example probability inversely proportional to the class
  count; "exact" replays the original's ``StratifiedKFold(25, shuffle=True,
  random_state=42)`` folds and scores each fold's train side
  (:func:`stratified_fold_schedule`, a numpy replica of the splitter: the
  card's machine has no scikit-learn).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import reference_leaf_order, to_reference_layout
from ..core.losses import PER_EXAMPLE_LOSSES, make_loss_fn
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


def _mask_scores(apply_fn, loss_of, params: Tree, xb, yb, drop) -> Tree:
    """``|dL/dm|`` at an all-ones multiplier ``m`` on every kernel leaf
    (zeros elsewhere), ``L = loss_of(logits, yb)``."""
    flags = kernel_flags(params)
    ones = {k: torch.ones_like(v, requires_grad=True)
            for k, v in params.items() if flags[k]}
    masked = {k: v * ones[k] if flags[k] else v for k, v in params.items()}
    loss = loss_of(apply_fn(masked, xb, train=True, rng=drop), yb)
    grads = torch.autograd.grad(loss, list(ones.values()))
    g = dict(zip(ones, grads))
    return {k: g[k].abs() if flags[k] else torch.zeros_like(v)
            for k, v in params.items()}


def balanced_probs(y: torch.Tensor, n_valid: int,
                   num_classes: int) -> torch.Tensor:
    """Stratified "balanced" draws' per-row probabilities over a padded
    shard: valid rows weighted ``1 / count(class)``, normalized."""
    valid = (torch.arange(y.shape[0], device=y.device)
             < int(n_valid)).to(torch.float32)
    yc = torch.clamp(y.to(torch.int64), 0, num_classes - 1)
    counts = torch.zeros(num_classes, device=y.device).index_add_(
        0, yc, valid)
    p = valid / torch.clamp(counts[yc], min=1.0)
    return p / torch.clamp(p.sum(), min=1e-9)


def make_snip_score_fn(apply_fn, loss_type: str, batch_size: int,
                       stratified: bool = False,
                       num_classes: int = 2) -> Callable:
    """``snip_scores(params, x, y, n_valid, n_iters, *, idx=None, rng=None)``:
    the mean over ``n_iters`` batches of one client's shard of ``|dL/dm|``
    per kernel leaf (zeros elsewhere).

    ``idx`` (``[n_iters, batch_size]`` row indices) is the random seam;
    when it is None the batches are drawn with replacement on ``rng``, the
    ``torch.Generator`` that also draws the dropout masks: uniformly from
    the valid rows, or with ``stratified`` from :func:`balanced_probs`
    (every class weighing the same in the saliency mean)."""
    loss_fn = make_loss_fn(loss_type)

    def snip_scores(params, x, y, n_valid: int, n_iters: int, *,
                    idx: Optional[torch.Tensor] = None, rng=None):
        params = {k: v.detach() for k, v in params.items()}
        p = None
        if stratified and idx is None:
            p = balanced_probs(y, n_valid, num_classes).to(rng.device)
        total = None
        for it in range(n_iters):
            if idx is not None:
                bi = torch.as_tensor(idx[it])
            elif p is not None:
                bi = torch.multinomial(p, batch_size, replacement=True,
                                       generator=rng)
            else:
                bi = torch.randint(0, max(int(n_valid), 1), (batch_size,),
                                   generator=rng, device=rng.device)
            bi = bi.to(x.device)
            s = _mask_scores(apply_fn, loss_fn, params, x[bi], y[bi], rng)
            total = s if total is None else {k: total[k] + s[k] for k in s}
        return {k: t / n_iters for k, t in total.items()}

    return snip_scores


# -- the exact stratified folds ----------------------------------------------

def stratified_kfold_train_sides(y, n_splits: int = 25,
                                 seed: int = 42) -> List[np.ndarray]:
    """The train-side indices of ``StratifiedKFold(n_splits, shuffle=True,
    random_state=seed).split(zeros, y)`` (scikit-learn 1.9), in split
    order, for the labels a cohort holds (integer classes, or float
    targets of integral value): classes encoded in order of first
    appearance, each fold's count of a class from the round-robin
    ``bincount`` over the sorted labels, each class's fold ids shuffled by
    one ``RandomState(seed)``. Raises the splitter's ``ValueError`` when
    there are fewer rows than splits, or fewer than ``n_splits`` members
    in every class, and warns as it does when some class has fewer."""
    y = np.asarray(y).reshape(-1)
    n = y.shape[0]
    if n_splits > n:
        raise ValueError(
            ("Cannot have number of splits n_splits={0} greater"
             " than the number of samples: n_samples={1}.").format(
                 n_splits, n))
    if y.dtype.kind == "f" and not np.all(np.equal(np.mod(y, 1), 0)):
        raise ValueError(
            "Supported target types are: ('binary', 'multiclass'). Got "
            "'continuous' instead.")
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_counts = np.bincount(y_encoded)
    min_groups = np.min(y_counts)
    if np.all(n_splits > y_counts):
        raise ValueError(
            "n_splits=%d cannot be greater than the"
            " number of members in each class." % (n_splits))
    if n_splits > min_groups:
        warnings.warn(
            "The least populated class in y has only %d"
            " members, which is less than n_splits=%d."
            % (min_groups, n_splits), UserWarning)
    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)])
    rng = np.random.RandomState(seed)
    test_folds = np.empty(n, dtype="i")
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    indices = np.arange(n)
    return [indices[test_folds != i] for i in range(n_splits)]


def stratified_fold_schedule(y, n_valid: int, n_splits: int = 25,
                             seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """One client's exact stratified scoring schedule: ``(idx, w)``, each
    ``[n_splits, L]``, row ``k`` the train side of fold ``k`` of the valid
    labels ``y[:n_valid]``, padded to the longest with index 0 and weight
    0 (so the weighted loss ignores the padding exactly)."""
    trains = stratified_kfold_train_sides(np.asarray(y)[:int(n_valid)],
                                          n_splits=n_splits, seed=seed)
    length = max(len(t) for t in trains)
    idx = np.zeros((n_splits, length), np.int32)
    w = np.zeros((n_splits, length), np.float32)
    for k, tr in enumerate(trains):
        idx[k, :len(tr)] = tr
        w[k, :len(tr)] = 1.0
    return idx, w


def stacked_fold_schedules(y_all, n_all, n_splits: int = 25,
                           seed: int = 42) -> Tuple[np.ndarray, np.ndarray]:
    """Every client's schedule, ``[C, n_splits, L]`` with one global L; a
    client whose labels the splitter refuses raises ``ValueError`` naming
    it and the "balanced" mode."""
    y_all, n_all = np.asarray(y_all), np.asarray(n_all)
    per = []
    for c in range(y_all.shape[0]):
        try:
            per.append(stratified_fold_schedule(
                y_all[c], int(n_all[c]), n_splits=n_splits, seed=seed))
        except ValueError as e:
            raise ValueError(
                f"exact stratified SNIP needs >= {n_splits} samples of "
                f"every class on every client; client {c} is too small "
                f"({e}). Use stratified_mode='balanced' "
                "(--stratified_mode balanced) for small shards.") from e
    length = max(i.shape[1] for i, _ in per)

    def pad(a, fill):
        out = np.full((a.shape[0], length), fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out

    return (np.stack([pad(i, 0) for i, _ in per]),
            np.stack([pad(w, 0.0) for _, w in per]))


def make_snip_fold_score_fn(apply_fn, loss_type: str) -> Callable:
    """``fold_scores(params, x, y, fold_idx, fold_w, rng=None)``: the mean
    over the ``[n_splits, L]`` schedule's rows of ``|dL/dm|`` of the
    weighted loss ``sum(w * per_example) / max(sum(w), 1)`` of each row's
    batch (``rng`` draws the dropout masks)."""
    per_example = PER_EXAMPLE_LOSSES[loss_type]

    def fold_scores(params, x, y, fold_idx, fold_w, rng=None):
        params = {k: v.detach() for k, v in params.items()}
        fold_idx = torch.as_tensor(fold_idx).to(x.device, torch.int64)
        fold_w = torch.as_tensor(fold_w).to(x.device, torch.float32)
        n_splits = fold_idx.shape[0]
        total = None
        for k in range(n_splits):
            bi, w = fold_idx[k], fold_w[k]

            def loss_of(logits, yb):
                per_ex = per_example(logits, yb)
                return torch.sum(per_ex * w) / torch.clamp(w.sum(), min=1.0)

            s = _mask_scores(apply_fn, loss_of, params, x[bi], y[bi], rng)
            total = s if total is None else {k2: total[k2] + s[k2]
                                             for k2 in s}
        return {k: t / n_splits for k, t in total.items()}

    return fold_scores


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
