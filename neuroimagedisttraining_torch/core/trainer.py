"""Local training and evaluation of one client (counterpart of
``neuroimagedisttraining_tpu/core/trainer.py``).

Where the reference vmaps a pure function over clients and scans over
steps, this runs one client at a time with a Python step loop. The
semantics are the reference's epoch batching: per epoch, a shuffle of the
client's valid rows; each client consumes its own ``ceil(n_i / batch)``
batches, the last one partial (padded slots carry zero loss weight), and
steps past that are no-ops (skipped here, since nothing runs in lockstep).

``hp.batching == "replacement"`` draws every step's batch uniformly with
replacement from the client's valid rows instead (the reference's other
mode): every step runs, each loss the plain mean of its full batch.

The random draws enter as arguments — the epoch permutations (or the
with-replacement batch indices), the crop-and-flip draws of an augmented
dataset and the dropout masks, drawn by the round from its
``torch.Generator`` (``algorithms/base.py``), so a test can feed the
reference's draws.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import kernels
from . import capture
from .losses import PER_EXAMPLE_LOSSES, predictions
from .optim import clip_by_global_norm, fma
from .state import HyperParams, Tree


def round_lr(hp: HyperParams, round_idx: int) -> torch.Tensor:
    """``lr * lr_decay ** round`` in float32, as the reference computes it
    (a 0-d CPU tensor)."""
    f32 = torch.float32
    return torch.tensor(hp.lr, dtype=f32) * torch.pow(
        torch.tensor(hp.lr_decay, dtype=f32),
        torch.tensor(float(round_idx), dtype=f32))


def epoch_permutations(generator: torch.Generator, n_valid: int, epochs: int,
                       length: int, n_rows: int = 0) -> torch.Tensor:
    """``[epochs, length]`` shuffles: per epoch, a uniform order of the valid
    rows ``[0, n_valid)`` first, then the padded rows in order (their loss
    weight is zero). The draw domain is ``max(length, n_rows)``, as in the
    reference."""
    domain = max(length, int(n_rows))
    dev = generator.device
    rows = []
    for _ in range(epochs):
        perm = torch.randperm(int(n_valid), generator=generator, device=dev)
        pad = torch.arange(int(n_valid), domain, device=dev)
        rows.append(torch.cat([perm, pad])[:length])
    return torch.stack(rows).to(torch.int64)


def replacement_batches(generator: torch.Generator, n_valid: int,
                        hp: HyperParams) -> torch.Tensor:
    """Replacement batching's row indices for one client, ``[epochs,
    steps_per_epoch * batch]`` (the layout of :func:`epoch_permutations`,
    step ``s`` reading the ``s``-th run of ``batch`` values): each uniform
    in ``[0, max(n_valid, 1))``."""
    idx = torch.randint(0, max(int(n_valid), 1),
                        (hp.local_steps * hp.batch_size,),
                        generator=generator, device=generator.device)
    return idx.reshape(hp.local_epochs, -1)


def active_steps(hp: HyperParams, n_valid: int,
                 full_batches: bool = False) -> List[int]:
    """The local steps a client of ``n_valid`` rows runs: per epoch its
    first ``ceil(n_valid / batch_size)`` batches (every step with
    ``full_batches``); the others are no-ops."""
    return [s for s in range(hp.local_steps)
            if full_batches
            or (s % hp.steps_per_epoch) * hp.batch_size < int(n_valid)]


def optimizer_step(params: List[torch.Tensor], momenta: List[torch.Tensor],
                   grads: List[torch.Tensor], masks: List[torch.Tensor],
                   lr: torch.Tensor, hp: HyperParams, mask_grads: bool = False,
                   pull: Optional[torch.Tensor] = None,
                   targets: Optional[List[torch.Tensor]] = None) -> None:
    """One local optimizer step on the leaves, in place: clip by the global
    norm, the masked SGD kernel (the gradient masked with ``mask_grads``,
    else the weights after the step), then with ``pull`` (``-lr *
    prox_lambda``, a 0-d float32 tensor) Ditto's prox pull toward
    ``targets``, ``p + pull * (p - target)`` rounded once."""
    grads = clip_by_global_norm(grads, hp.grad_clip)
    kernels.fused_masked_sgd_step(params, momenta, grads, masks, lr,
                                  momentum=hp.momentum, wd=hp.weight_decay,
                                  mask_grads=mask_grads)
    if pull is not None:
        for p, t in zip(params, targets):
            p.copy_(fma(pull, p - t, p))


def make_client_update(apply_fn, loss_type: str, hp: HyperParams,
                       full_batches: bool = False, remat: bool = False,
                       label_flip: Optional[Callable] = None,
                       mask_grads: bool = False,
                       prox_lambda: float = 0.0,
                       augment_fn: Optional[Callable] = None) -> Callable:
    """Build ``client_update(params, mask, x, y, n_valid, client, perms, lr,
    dropout=None, flip=None, momentum=None, prox_target=None, n_rows=None,
    augment=None) -> (params, momentum, mean_loss)``.

    ``params`` is updated in place (pass a copy); the optimizer step is
    clip-by-global-norm, then the masked SGD kernel
    (:func:`ops.kernels.fused_masked_sgd_step`): by default with the
    post-step ``p *= mask`` of SalientGrads (an all-ones mask is plain
    SGD); with ``mask_grads`` the gradient is masked instead and no
    post-step mask is applied (DisPFL's and SubAvg's masked SGD). The
    reference applies both there; they agree because a masked coordinate
    starts at zero with zero momentum and so stays zero, which the callers
    guarantee (DisPFL re-masks after its mask evolution, SubAvg starts
    from the masked global model).
    ``prox_lambda`` > 0 is Ditto's pull after each step, ``p <- p - lr *
    prox_lambda * (p - prox_target)``, one rounding for the multiply-add as
    the reference's compiled chain has it (:func:`core.optim.fma`).
    ``momentum`` (a tree, copied) is the initial momentum, zeros when None:
    SubAvg's second leg continues from its first leg's.
    ``full_batches`` asserts every batch is full and every step active:
    every client holds at least ``steps_per_epoch * batch_size`` rows, or
    the batching is "replacement".
    ``remat`` runs each batch's forward and loss under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
    nothing saved): the activations are recomputed in the backward, so the
    forward runs twice a step (the stem forward kernel too) for less live
    memory. The dropout masks are inputs, so the recompute is the same
    function; nothing is drawn inside it.
    ``flip`` (a 0-d bool tensor) flips the client's labels through
    ``label_flip(y, flip)``, the ``labelflip`` fault
    (``robust.faults.make_labelflip_fn``).
    ``augment_fn(xb, draws)`` (``data.cifar.CropFlip``, the reference's
    RandomCrop and flip) transforms every gathered training batch, step
    ``s`` with ``augment[s]`` (``[local_steps, 3, batch]``, the client's
    crop and flip draws, ``data.cifar.crop_flip_draws``); evaluation never
    sees it.

    ``x`` and ``y`` are the whole cohort's ``[C, rows, ...]`` arrays and
    ``client`` a one-element int64 tensor on their device: each batch is
    gathered from that client's rows through it. ``perms`` is the client's
    ``[epochs, steps_per_epoch * batch_size]`` row order (under
    replacement batching, :func:`replacement_batches`), ``lr`` the round's
    rate as a 0-d float32 tensor (on the card, the masked SGD kernel reads
    it there) and ``dropout`` a per-step sequence of dropout keep-mask
    sequences (None for a model without dropout). ``n_valid`` (a host int)
    fixes the steps the client runs (:func:`active_steps`); ``n_rows``, a
    0-d tensor on the device holding the same count, is what the loss
    weights of a partial batch read where it is given (the round body's
    buffer, so a CUDA graph of the body serves every count with the same
    steps). A client update reads nothing else the host decides per round:
    the round body of ``algorithms/base.py``, which a CUDA graph can
    hold; each step ends at a boundary where that graph's capture may go
    on in the next graph of a chain (``core.capture``)."""
    per_example = PER_EXAMPLE_LOSSES[loss_type]
    spe, bs = hp.steps_per_epoch, hp.batch_size
    full_batches = full_batches or hp.batching == "replacement"

    def batch_loss(names, leaves, xb, yb, w, drop):
        logits = apply_fn(dict(zip(names, leaves)), xb, train=True, rng=drop)
        per_ex = per_example(logits, yb).float()
        if w is None:
            return per_ex.mean()
        return torch.sum(per_ex * w) / torch.clamp(w.sum(), min=1.0)

    def client_update(params: Tree, mask: Tree, x, y, n_valid: int,
                      client: torch.Tensor, perms: torch.Tensor,
                      lr: torch.Tensor, dropout: Optional[Sequence] = None,
                      flip: Optional[torch.Tensor] = None,
                      momentum: Optional[Tree] = None,
                      prox_target: Optional[Tree] = None,
                      n_rows: Optional[torch.Tensor] = None,
                      augment: Optional[torch.Tensor] = None):
        n_valid = int(n_valid)
        count = n_valid if n_rows is None else n_rows
        n_rows = x.shape[1]
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        moms = [torch.zeros_like(p) if momentum is None
                else momentum[k].clone() for k, p in zip(names, leaves)]
        masks = [mask[k] for k in names]
        pull = targets = None
        if prox_lambda:
            pull = -(lr * torch.full((), prox_lambda, dtype=torch.float32,
                                     device=lr.device))
            targets = [prox_target[k] for k in names]
        flat = perms.reshape(-1)
        losses = []
        for s in active_steps(hp, n_valid, full_batches):
            pos = s % spe
            start = (s // spe) * (spe * bs) + pos * bs
            idx = torch.clamp(flat[start:start + bs], max=n_rows - 1)
            xb, yb = x[client, idx], y[client, idx]
            if augment_fn is not None:
                xb = augment_fn(xb, augment[s])
            if flip is not None:
                yb = label_flip(yb, flip)
            drop = None if dropout is None else dropout[s]
            w = None if full_batches else (
                (pos * bs + torch.arange(bs, device=x.device))
                < count).float()
            if remat:
                loss = checkpoint(batch_loss, names, leaves, xb, yb, w, drop,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                loss = batch_loss(names, leaves, xb, yb, w, drop)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                # cuDNN may hand a conv's weight gradient back channels-last
                # (SmallCNN3D's channel-1 input is); the kernel reads dense
                # row-major leaves
                optimizer_step(leaves, moms, [g.contiguous() for g in grads],
                               masks, lr, hp, mask_grads=mask_grads,
                               pull=pull, targets=targets)
            losses.append(loss.detach())
            capture.step_boundary()
        mean_loss = (torch.stack(losses).mean() if losses
                     else torch.zeros((), device=x.device))
        out = {k: p.detach() for k, p in zip(names, leaves)}
        return out, dict(zip(names, moms)), mean_loss

    return client_update


def make_eval_fn(apply_fn, loss_type: str, eval_batch: int = 32) -> Callable:
    """``eval_client(params, x, y, n_valid) -> (correct, loss_sum, total)``
    over a padded ``[m_max, ...]`` test shard in chunks of
    ``min(eval_batch, m_max)``; rows at index >= n_valid are ignored.
    ``n_valid`` is a host int, or a 0-d device tensor (returned as
    ``total``): the eval-cache refresh of a round body reads a selected
    client's count on the device, where a CUDA graph can hold it. Both
    give the same bits."""
    per_example = PER_EXAMPLE_LOSSES[loss_type]

    @torch.no_grad()
    def eval_client(params: Tree, x, y, n_valid):
        if not isinstance(n_valid, torch.Tensor):
            n_valid = int(n_valid)
        m_max = x.shape[0]
        eb = max(1, min(eval_batch, m_max))
        correct = torch.zeros((), dtype=torch.int64, device=x.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for start in range(0, m_max, eb):
            xb, yb = x[start:start + eb], y[start:start + eb]
            logits = apply_fn(params, xb, train=False)
            valid = (start + torch.arange(xb.shape[0], device=x.device)) \
                < n_valid
            preds = predictions(logits, loss_type)
            correct += torch.sum((preds == yb.to(torch.int32)) & valid)
            per_ex = per_example(logits, yb)
            loss_sum += torch.sum(per_ex * valid.to(per_ex.dtype))
        return correct, loss_sum, n_valid

    return eval_client
