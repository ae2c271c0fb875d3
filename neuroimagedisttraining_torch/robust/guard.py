"""The non-finite quarantine inside the round (counterpart of
``neuroimagedisttraining_tpu/robust/guard.py``).

One per-client screen of the ``[S, ...]``-stacked updates before the
aggregate; the clients that fail it (or dropped out) are zero-weighted,
their rows replaced by exact zeros, the weights renormalized over the
survivors, and with no survivor the previous global model carries.

Every transform is a select, never arithmetic, so a round in which every
client is ok gives bit for bit the unguarded aggregate. The reference gates
the quarantine behind a ``lax.cond`` on ``all(ok)``; a captured CUDA graph
cannot branch on a device value, so here the selects always run (the
weight renormalization sits behind a scalar select): one spelling for the
eager and the fused loop, bitwise the unguarded aggregate on a clean round.

On a client mesh each rank holds only its own clients' rows, while the
weights and the survivor flags ``ok`` cover every selected client (the
flags gathered in draw order, ``parallel.mesh.gather_flags``): the
functions that select rows take the rank's own flags as ``rows_ok``, and
the renormalization and the survivor count read all of ``ok``, so every
rank renormalizes alike and a clean round stays bitwise the unguarded one.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from ..core.state import Tree, row_sum

#: renormalization floor, reached only when every client is quarantined
#: (and the aggregate is then discarded by ``carry_if_empty``)
_EPS = 1e-12


def _row_select(ok: torch.Tensor, ndim: int) -> torch.Tensor:
    """The per-client bool vector broadcast against an [S, ...] leaf."""
    return ok.reshape(ok.shape + (1,) * (ndim - 1))


def finite_screen(stacked: Tree) -> torch.Tensor:
    """[S] bool: each client's rows finite in every leaf."""
    flags = None
    for x in stacked.values():
        f = torch.isfinite(x).reshape(
            x.shape[0], math.prod(x.shape[1:])).all(dim=1)
        flags = f if flags is None else flags & f
    if flags is None:
        raise ValueError("finite_screen: empty tree")
    return flags


def quarantine(stacked: Tree, weights: torch.Tensor, ok: torch.Tensor,
               rows_ok: Optional[torch.Tensor] = None
               ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
    """The ``~ok`` clients quarantined: their rows select-replaced by exact
    zeros, their weights zeroed and the weights renormalized over the
    survivors. Returns ``(sanitized, new_weights, survivors)``, the last an
    int32 count. With every client ok it is a bitwise no-op: the rows are
    selected as they are and a scalar select keeps the weights. ``rows_ok``
    (default ``ok``) flags the rows ``stacked`` holds, where those are a
    mesh rank's own clients and ``ok`` every client's."""
    rows_ok = ok if rows_ok is None else rows_ok
    w_masked = torch.where(ok, weights, torch.zeros_like(weights))
    total = row_sum(w_masked)
    any_bad = ~ok.all()
    new_weights = torch.where(
        any_bad, w_masked / torch.clamp(total, min=_EPS), weights)
    sanitized = {k: torch.where(_row_select(rows_ok, x.dim()), x,
                                torch.zeros_like(x))
                 for k, x in stacked.items()}
    survivors = ok.to(torch.int32).sum()
    return sanitized, new_weights, survivors


def carry_if_empty(aggregate: Tree, fallback: Tree,
                   survivors: torch.Tensor) -> Tree:
    """No survivor: the previous global model instead of the aggregate."""
    keep = survivors > 0
    return {k: torch.where(keep, a, fallback[k].to(a.dtype))
            for k, a in aggregate.items()}


def guarded_aggregate(stacked: Tree, weights: torch.Tensor, ok: torch.Tensor,
                      aggregate_fn: Callable[[Tree, torch.Tensor], Tree],
                      fallback: Tree,
                      rows_ok: Optional[torch.Tensor] = None) -> Tree:
    """The quarantined aggregate: ``aggregate_fn(stacked, weights)`` of the
    sanitized rows and renormalized weights, ``fallback`` (the previous
    global model) when nobody survived. Any wire serves as
    ``aggregate_fn``: zero rows of zero weight add nothing. ``rows_ok`` as
    in :func:`quarantine`."""
    sanitized, w_new, survivors = quarantine(stacked, weights, ok, rows_ok)
    return carry_if_empty(aggregate_fn(sanitized, w_new), fallback,
                          survivors)


def merge_residual(ok: torch.Tensor, new_rows: Tree, prev_rows: Tree) -> Tree:
    """The top-k residual under quarantine: a quarantined client shipped
    nothing, and its compensated delta may carry the poison the screen
    caught, so its residual row keeps its previous value (a row select: a
    NaN of ``new_rows`` cannot leak)."""
    return {k: torch.where(_row_select(ok, n.dim()), n, prev_rows[k])
            for k, n in new_rows.items()}


def merge_updates(ok: torch.Tensor, updates: Tree, personal: Tree,
                  sel: torch.Tensor) -> Tree:
    """The rows to scatter back into the [C, ...] personal stack: each
    selected client's update where it survived, its previous personal row
    (``personal[sel]``) where it was quarantined or dropped."""
    return {k: torch.where(_row_select(ok, u.dim()), u,
                           personal[k].index_select(0, sel))
            for k, u in updates.items()}
