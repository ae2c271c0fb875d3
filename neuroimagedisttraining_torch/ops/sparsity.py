"""SNIP saliency, the global top-k mask and the per-client masks of DisPFL
and SubAvg (counterpart of ``neuroimagedisttraining_tpu/ops/sparsity.py``).

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
* DisPFL's masks: the ERK (or uniform) per-layer sparsities, random masks
  at them, and the per-round mask evolution: fire the smallest live
  weights at a cosine-annealed rate, regrow as many dead ones by gradient
  magnitude. SubAvg's magnitude prune and mask distance.

The evolution functions keep the reference's tie rules and its float32
counts: a k-th smallest value by a full sort and a gather whose index stays
on the device (no wait on the card), fire keeping ``|p| > thr``, regrow
growing ``|g| >= thr`` where ``thr`` is finite, prune zeroing
``|p| < thr``. Each takes a tree of one client, or with ``lead=1`` a stacked
tree, one client a row.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import math
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import (
    from_reference_layout,
    reference_leaf_order,
    to_reference_layout,
)
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
    if not ones:
        # no maskable leaf (ResNet-IP): every score is zero; the forward
        # still takes its dropout draws
        with torch.no_grad():
            apply_fn(params, xb, train=True, rng=drop)
        return {k: torch.zeros_like(v) for k, v in params.items()}
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


def _augmented(augment_fn, xb, draws, rng):
    """``xb`` through the training augmentation (``draws``, else drawn from
    ``rng``), or as it is without one."""
    if augment_fn is None:
        return xb
    if draws is None:
        from ..data.cifar import crop_flip_draws

        draws = crop_flip_draws(rng, xb.shape[0])
    return augment_fn(xb, torch.as_tensor(draws).to(xb.device))


def make_snip_score_fn(apply_fn, loss_type: str, batch_size: int,
                       stratified: bool = False, num_classes: int = 2,
                       augment_fn: Optional[Callable] = None) -> Callable:
    """``snip_scores(params, x, y, n_valid, n_iters, *, idx=None, rng=None,
    augment=None)``: the mean over ``n_iters`` batches of one client's
    shard of ``|dL/dm|`` per kernel leaf (zeros elsewhere).

    ``idx`` (``[n_iters, batch_size]`` row indices) is the random seam;
    when it is None the batches are drawn with replacement on ``rng``, the
    ``torch.Generator`` that also draws the dropout masks: uniformly from
    the valid rows, or with ``stratified`` from :func:`balanced_probs`
    (every class weighing the same in the saliency mean).
    ``augment_fn(xb, draws)`` is the training augmentation, applied to
    every scoring batch as the local steps apply it (the original scores
    the transform-bearing train loader's batches): batch ``i`` with
    ``augment[i]`` (``[n_iters, 3, batch_size]``), else with draws from
    ``rng`` after the batch's rows and before its dropout masks."""
    loss_fn = make_loss_fn(loss_type)

    def snip_scores(params, x, y, n_valid: int, n_iters: int, *,
                    idx: Optional[torch.Tensor] = None, rng=None,
                    augment=None):
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
            xb = _augmented(augment_fn, x[bi], None if augment is None
                            else augment[it], rng)
            s = _mask_scores(apply_fn, loss_fn, params, xb, y[bi], rng)
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


def make_snip_fold_score_fn(apply_fn, loss_type: str,
                            augment_fn: Optional[Callable] = None
                            ) -> Callable:
    """``fold_scores(params, x, y, fold_idx, fold_w, rng=None,
    augment=None)``: the mean over the ``[n_splits, L]`` schedule's rows of
    ``|dL/dm|`` of the weighted loss ``sum(w * per_example) / max(sum(w),
    1)`` of each row's batch (``rng`` draws the dropout masks). With
    ``augment_fn`` each row's batch is augmented, with ``augment[k]``
    (``[n_splits, 3, L]``) or draws from ``rng`` before its dropout
    masks."""
    per_example = PER_EXAMPLE_LOSSES[loss_type]

    def fold_scores(params, x, y, fold_idx, fold_w, rng=None, augment=None):
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

            xb = _augmented(augment_fn, x[bi], None if augment is None
                            else augment[k], rng)
            s = _mask_scores(apply_fn, loss_of, params, xb, y[bi], rng)
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
    if not names:
        # a model without a kernel leaf (ResNet-IP's dual leaves): the
        # reference's concatenation of no score fails with this message
        raise ValueError("Need at least one array to concatenate.")
    flat = torch.cat([scores[k].reshape(-1) for k in names])
    norm = torch.sum(flat)
    n_keep = max(1, int(flat.numel() * keep_ratio))
    threshold = select_threshold((flat / norm).reshape(1, -1), n_keep)
    masks = dict(zip(names, fused_score_mask(
        [scores[k].contiguous() for k in names], norm, threshold)))
    return {k: masks[k].to(v.dtype) if flags[k] else torch.ones_like(v)
            for k, v in scores.items()}


# -- ERK allocation and random masks (DisPFL) ---------------------------------

def param_shapes(params: Tree,
                 kernels_only: bool = True) -> Dict[str, Tuple[int, ...]]:
    """Each leaf's shape in the reference's layout, in its leaf order
    (the order :func:`erk_sparsities` sums its budget in); kernel leaves
    only unless ``kernels_only`` is False."""
    flags = kernel_flags(params)
    return {k: tuple(to_reference_layout(k, params[k]).shape)
            for k in reference_leaf_order(params)
            if not kernels_only or flags[k]}


def erk_sparsities(
    shapes: Dict[str, Tuple[int, ...]],
    dense_ratio: float = 0.5,
    erk_power_scale: float = 1.0,
    tabu: Tuple[str, ...] = (),
) -> Dict[str, float]:
    """Erdos-Renyi-Kernel per-layer sparsities at the global density
    ``dense_ratio``: raw probability ``(sum(shape) / prod(shape)) **
    power``; a layer whose scaled probability would pass 1 turns dense and
    the balancing factor ``eps`` is solved again. The budget is a float64
    sum in ``shapes``' order (pass :func:`param_shapes`, the reference's
    leaf order: another order rounds ``eps`` differently)."""
    density = dense_ratio
    if density >= 1.0:
        return {name: 0.0 for name in shapes}
    dense_layers = set(tabu)
    while True:
        divisor = 0.0
        rhs = 0.0
        raw = {}
        for name, shape in shapes.items():
            n = float(np.prod(shape))
            if name in dense_layers:
                rhs -= n * (1.0 - density)
            else:
                rhs += n * density
                raw[name] = (np.sum(shape) / np.prod(shape)) ** erk_power_scale
                divisor += raw[name] * n
        eps = rhs / divisor
        max_prob = max(raw.values())
        if max_prob * eps > 1.0:
            for name, p in raw.items():
                if p == max_prob:
                    dense_layers.add(name)
        else:
            break
    return {name: 0.0 if name in dense_layers else 1.0 - eps * raw[name]
            for name in shapes}


def uniform_sparsities(
    shapes: Dict[str, Tuple[int, ...]],
    dense_ratio: float = 0.5,
    tabu: Tuple[str, ...] = (),
) -> Dict[str, float]:
    """Every non-tabu layer at sparsity ``1 - dense_ratio`` (DisPFL's
    ``--uniform``)."""
    return {name: 0.0 if name in tabu else 1.0 - dense_ratio
            for name in shapes}


def random_mask_array(shape: Tuple[int, ...], density: float, *,
                      scores: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      dtype=torch.float32) -> torch.Tensor:
    """A random {0, 1} mask of ``shape`` with ``int(density * size)`` ones:
    the entries whose uniform score is at least the k-th largest. ``scores``
    (flat, ``size`` values) is the random seam; else they are drawn from
    ``generator`` on its device."""
    size = int(np.prod(shape))
    n_dense = int(density * size)
    dev = (scores.device if scores is not None
           else generator.device if generator is not None else None)
    if n_dense <= 0:
        return torch.zeros(shape, dtype=dtype, device=dev)
    if n_dense >= size:
        return torch.ones(shape, dtype=dtype, device=dev)
    if scores is None:
        scores = torch.rand(size, generator=generator, device=dev)
    scores = scores.reshape(-1)
    thresh = torch.sort(scores, descending=True).values[n_dense - 1]
    return (scores >= thresh).to(dtype).reshape(shape)


def random_masks_from_sparsities(
    params: Tree, sparsities_fn: Callable[[str, Tuple[int, ...]], float],
    generator: Optional[torch.Generator] = None,
    scores: Optional[Tree] = None,
) -> Tree:
    """Random binary masks at per-leaf sparsity ``sparsities_fn(name,
    shape)`` (DisPFL's mask init); every other leaf all ones. Each kernel
    leaf's mask is made in the reference's layout from uniform scores in
    that layout (``scores[name]``, flat, the seam; else drawn from
    ``generator`` in the reference's leaf order), then laid out as this
    package's leaf."""
    flags = kernel_flags(params)
    out = {}
    for k in reference_leaf_order(params):
        p = params[k]
        if not flags[k]:
            out[k] = torch.ones_like(p)
            continue
        shape = tuple(to_reference_layout(k, p).shape)
        m = random_mask_array(
            shape, 1.0 - sparsities_fn(k, shape),
            scores=None if scores is None else torch.as_tensor(
                scores[k]).to(p.device),
            generator=generator, dtype=p.dtype)
        out[k] = from_reference_layout(k, m.to(p.device)).contiguous()
    return {k: out[k] for k in params}


# -- fire / regrow (DisPFL) and magnitude prune (SubAvg) ----------------------

@functools.lru_cache(maxsize=1)
def _cosf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").cosf
    fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return fn


def cosine_annealing(anneal_factor: float, round_idx,
                     total_rounds: int) -> torch.Tensor:
    """DisPFL's drop rate ``anneal_factor / 2 * (1 + cos(pi * round /
    total_rounds))`` as a 0-d float32 CPU tensor, bit for bit the
    reference's round program: XLA folds ``round / T * pi`` into ``round *
    f32(f32(1 / T) * f32(pi))`` and lowers ``cos`` on the CPU to the C
    library's ``cosf`` (torch's and numpy's vectorised float32 cosines
    differ from it by an ulp on some inputs, which can flip a drop
    count)."""
    f32 = np.float32
    step = f32(f32(1.0) / f32(max(total_rounds, 1))) * f32(math.pi)
    angle = f32(f32(round_idx) * step)
    cos = f32(_cosf()(float(angle)))
    return torch.tensor(f32(f32(cos + f32(1.0)) * f32(anneal_factor / 2.0)))


def _rows(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` as ``[*lead axes, n]``."""
    return t.reshape(tuple(t.shape[:lead]) + (-1,))


def _per_row(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-row value ``v`` (shape ``like.shape[:lead]``) broadcastable
    against ``like``."""
    return v.reshape(tuple(v.shape) + (1,) * (like.dim() - v.dim()))


def _kth_smallest(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The k-th smallest (1-indexed) of each row of ``values`` ``[..., n]``
    for a per-row int64 ``k`` on the device: a sort and a gather (``k``
    clamped into ``[1, n]``)."""
    s = torch.sort(values, dim=-1).values
    idx = torch.clamp(k - 1, 0, values.shape[-1] - 1)
    return torch.gather(s, -1, idx.unsqueeze(-1)).squeeze(-1)


def _scalar(value, device) -> torch.Tensor:
    """A 0-d float32 tensor of ``value`` on ``device``, made there (a fill,
    not a copy from the host: no wait on the card)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _counts_f32(count: torch.Tensor, rate) -> torch.Tensor:
    """``ceil(rate * count)`` as int64, the product in float32 (``rate`` a
    Python float, or a 0-d float32 tensor on the card)."""
    rate = (rate.to(count.device) if isinstance(rate, torch.Tensor)
            else _scalar(rate, count.device))
    return torch.ceil(rate * count.to(torch.float32)).to(torch.int64)


def live_counts(mask: Tree, lead: int = 0) -> Dict[str, torch.Tensor]:
    """Per-leaf live-weight counts (int64, one per row with ``lead``)."""
    return {k: _rows(m != 0, lead).sum(-1) for k, m in mask.items()}


def fire_mask(mask: Tree, params: Tree, drop_rate, lead: int = 0) -> Tree:
    """Drop the ``drop_rate`` fraction (a float32 value; the count
    ``ceil(rate * n_live)``) of the smallest-``|w|`` live weights of each
    kernel leaf: keep ``|w| > thr``, ``thr`` the count-th smallest live
    magnitude. A zero count keeps the leaf; non-kernel leaves stay."""
    flags = kernel_flags(mask)
    out = {}
    for k, m in mask.items():
        if not flags[k]:
            out[k] = m
            continue
        live = m != 0
        a = params[k].abs()
        n_drop = _counts_f32(_rows(live, lead).sum(-1), drop_rate)
        score = torch.where(live, a, torch.full_like(a, math.inf))
        thresh = _kth_smallest(_rows(score, lead), n_drop)
        keep = (a > _per_row(thresh, a)) & live
        out[k] = torch.where(_per_row(n_drop, m) > 0, keep.to(m.dtype), m)
    return out


def regrow_mask(mask: Tree, grads: Tree, n_regrow: Dict[str, torch.Tensor],
                lead: int = 0) -> Tree:
    """Regrow the ``n_regrow[name]`` largest-``|g|`` dead weights of each
    kernel leaf: grow ``|g| >= thr`` where ``thr``, the n-th largest dead
    magnitude, is finite (so fire then regrow keeps each live count, up to
    ties). A zero count keeps the leaf; non-kernel leaves stay."""
    flags = kernel_flags(mask)
    out = {}
    for k, m in mask.items():
        if not flags[k]:
            out[k] = m
            continue
        dead = m == 0
        a = grads[k].abs()
        n = n_regrow[k]
        score = _rows(torch.where(dead, a, torch.full_like(a, -math.inf)),
                      lead)
        thresh = _kth_smallest(score,
                               score.shape[-1] - torch.clamp(n, min=1) + 1)
        grown = dead & (a >= _per_row(thresh, a)) & \
            _per_row(torch.isfinite(thresh), a)
        out[k] = torch.where(_per_row(n, m) > 0,
                             torch.maximum(m, grown.to(m.dtype)), m)
    return out


def magnitude_prune_mask(mask: Tree, params: Tree, prune_ratio: float,
                         lead: int = 0) -> Tree:
    """SubAvg's prune: per kernel leaf, zero the mask where ``|w| < thr``,
    ``thr`` the ``ceil(prune_ratio * n_alive)``-th smallest live magnitude
    (the count in float32, at least 1). A leaf with nothing alive stays;
    non-kernel leaves stay."""
    flags = kernel_flags(mask)
    out = {}
    for k, m in mask.items():
        if not flags[k]:
            out[k] = m
            continue
        alive = m != 0
        a = params[k].abs()
        n_alive = _rows(alive, lead).sum(-1)
        rank = _counts_f32(n_alive, prune_ratio)
        score = torch.where(alive, a, torch.full_like(a, math.inf))
        thresh = _kth_smallest(_rows(score, lead), torch.clamp(rank, min=1))
        pruned = torch.where(a < _per_row(thresh, a), torch.zeros_like(m), m)
        out[k] = torch.where(_per_row(n_alive, m) > 0, pruned, m)
    return out


def fraction_f32(count: torch.Tensor, total: int) -> torch.Tensor:
    """``count / total`` in float32 as the reference's compiled programs
    compute it: XLA turns a division by a constant into a product by its
    float32 reciprocal."""
    recip = np.float32(np.float32(1.0) / np.float32(total))
    return count.to(torch.float32) * _scalar(recip, count.device)


def mask_distance(mask_a: Tree, mask_b: Tree, lead: int = 0) -> torch.Tensor:
    """SubAvg's distance of two masks: the mean over leaves (in the
    reference's order) of each leaf's hamming fraction, in float32 (one
    per row with ``lead``), rounded as the reference's round program
    computes it: each fraction the count times the float32 reciprocal of
    the leaf's size, and the sum of those products contracted into fused
    multiply-adds as XLA:CPU emits them (``fma(c0, r0, c1 * r1)``, then
    ``fma(ck, rk, sum)``)."""
    from ..core.optim import fma

    keys = reference_leaf_order(mask_a)
    terms = []
    for k in keys:
        a, b = mask_a[k], mask_b[k]
        count = _rows((a != 0) != (b != 0), lead).sum(-1).to(torch.float32)
        recip = _scalar(np.float32(1.0) / np.float32(
            _rows(a, lead).shape[-1]), count.device)
        terms.append((count, recip))
    total = terms[0][0] * terms[0][1]
    if len(terms) > 1:
        total = fma(terms[0][0], terms[0][1], terms[1][0] * terms[1][1])
        for count, recip in terms[2:]:
            total = fma(count, recip, total)
    return fraction_f32(total, len(keys))


def mask_density_f32(tree: Tree, lead: int = 0) -> torch.Tensor:
    """The nonzero fraction of a tree's kernel leaves in float32, as the
    reference's round program computes it (one per row with ``lead``)."""
    flags = kernel_flags(tree)
    leaves = [tree[k] for k in reference_leaf_order(tree) if flags[k]]
    nnz = sum(_rows(t != 0, lead).sum(-1) for t in leaves)
    return fraction_f32(nnz, sum(_rows(t, lead).shape[-1] for t in leaves))


def client_mask_densities(masks: Tree) -> torch.Tensor:
    """Each client's kernel density of the stacked masks, ``[C]`` float32,
    a true division of its live count by its kernel size."""
    flags = kernel_flags(masks)
    leaves = [masks[k] for k in reference_leaf_order(masks) if flags[k]]
    nnz = sum(_rows(t != 0, 1).sum(-1) for t in leaves).to(torch.float32)
    tot = sum(_rows(t, 1).shape[-1] for t in leaves)
    return nnz / _scalar(tot, nnz.device)


def mean_mask_density(masks: Tree) -> torch.Tensor:
    """The mean over clients of the stacked masks' kernel densities, in
    float32, as the reference's eval computes it outside its round program:
    each client's fraction (:func:`client_mask_densities`), their mean (a
    jitted reduction) the sum times the float32 reciprocal of the client
    count."""
    dens = client_mask_densities(masks)
    return fraction_f32(dens.sum(), dens.shape[0])
