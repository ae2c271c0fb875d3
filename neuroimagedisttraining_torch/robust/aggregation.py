"""Byzantine-robust aggregation: the transform defenses and the robust
estimators (counterpart of ``neuroimagedisttraining_tpu/robust/
aggregation.py``).

* Transform defenses: norm-difference clipping (``diff / max(1,
  |diff|/bound)``) and weak-DP Gaussian noise, applied to every client's
  update before the weighted mean (:class:`RobustAggregator`).
* Robust estimators (``robust_agg``): the weighted mean REPLACED by a
  statistic over the ``[S, D]`` delta matrix: coordinate-wise median,
  trimmed mean, Krum, Multi-Krum, and ``norm_krum`` (Krum on norm-clipped
  rows). They read the guard's survivor set from the weights (a zero
  weight never reported: a zeroed row would still vote in a median) and are
  unweighted over the survivors, as the reference's.

The reference computes these in XLA outside any Pallas kernel; here they
are ``torch.sort`` and ``torch.matmul`` over the delta matrix, with the
reference's tie-breaks (the first index wins). Every count is a device
tensor and every pick an ``index_select``, so a CUDA graph holds them. The
weak-DP noise is an input (the round's draw, ``RoundInputs.dp_noise``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..convert import reference_leaf_order
from ..core.state import Tree, row_sum

#: the ``robust_agg`` family ("none" = the plain weighted mean)
ROBUST_AGGS = ("none", "median", "trimmed_mean", "krum", "multikrum",
               "norm_krum")


def resolve_krum_f(krum_f: int, n: int) -> int:
    """Krum's Byzantine allowance for ``n`` rows: an explicit positive
    value, else ``max(1, ceil(0.2 * n))``."""
    if krum_f > 0:
        return int(krum_f)
    return max(1, -(-n // 5))


def _pick(srt: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a 0-d device index) of ``srt``."""
    return srt.index_select(0, i.reshape(1))[0]


def _masked_median(mat, ok, m):
    """Coordinate-wise median over the ``ok`` rows: masked rows sort to
    +inf; with ``m`` survivors it reads sorted rows ``(m-1)//2`` and
    ``m//2``."""
    big = torch.where(ok[:, None], mat, torch.full_like(mat, float("inf")))
    srt = torch.sort(big, dim=0).values
    lo = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(m, 2, rounding_mode="floor"), min=0)
    return 0.5 * (_pick(srt, lo) + _pick(srt, hi))


def _masked_trimmed_mean(mat, ok, m, trim_frac: float):
    """Coordinate-wise trimmed mean: per coordinate the ``floor(trim * m)``
    largest and smallest survivor values dropped (at most ``(m-1)//2`` per
    side), the rest averaged."""
    s = mat.shape[0]
    big = torch.where(ok[:, None], mat, torch.full_like(mat, float("inf")))
    srt = torch.sort(big, dim=0).values
    t = torch.floor(trim_frac * m.to(torch.float32)).to(torch.int32)
    t = torch.minimum(torch.clamp(t, min=0), torch.clamp(
        torch.div(m - 1, 2, rounding_mode="floor"), min=0))
    idx = torch.arange(s, device=mat.device)[:, None]
    keep = (idx >= t) & (idx < m - t)
    cnt = torch.clamp(m - 2 * t, min=1).to(torch.float32)
    return row_sum(torch.where(keep, srt, torch.zeros_like(srt))) / cnt


def _krum_scores(rows, ok, m, f_eff: int):
    """Per survivor row, the sum of its ``m - f - 2`` smallest squared
    distances to the other survivors (the Gram expansion, clamped at 0);
    +inf for the others."""
    s = rows.shape[0]
    sq = torch.sum(rows * rows, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (rows @ rows.T)
    d2 = torch.clamp(d2, min=0.0)
    eye = torch.eye(s, dtype=torch.bool, device=rows.device)
    valid = ok[None, :] & ~eye
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    srt = torch.sort(d2, dim=1).values
    nb = torch.minimum(torch.clamp(m - f_eff - 2, min=1),
                       torch.clamp(m - 1, min=1))
    nbmask = torch.arange(s, device=rows.device)[None, :] < nb
    scores = torch.sum(torch.where(nbmask, srt, torch.zeros_like(srt)),
                       dim=1)
    return torch.where(ok, scores, torch.full_like(scores, float("inf")))


def robust_combine_mat(mat: torch.Tensor, weights: torch.Tensor, kind: str,
                       *, trim_frac: float = 0.2, krum_f: int = 0,
                       norm_bound: float = 5.0) -> torch.Tensor:
    """The ``[S, D]`` delta rows combined into one ``[D]`` robust delta.
    ``weights`` give only the survivor set (``weights > 0``). With no
    survivor the result is meaningless by construction:
    ``guard.carry_if_empty`` selects the fallback over it."""
    if kind not in ROBUST_AGGS or kind == "none":
        raise ValueError(
            f"robust_combine_mat: kind {kind!r} not a robust estimator "
            f"(one of {ROBUST_AGGS[1:]})")
    mat = mat.to(torch.float32)
    ok = weights > 0
    m = ok.to(torch.int32).sum()
    if kind == "median":
        return _masked_median(mat, ok, m)
    if kind == "trimmed_mean":
        return _masked_trimmed_mean(mat, ok, m, trim_frac)
    s = mat.shape[0]
    f_eff = resolve_krum_f(krum_f, s)
    rows = mat
    if kind == "norm_krum":
        # the norm clip as Krum's pre-selection stage: the winner is a
        # clipped row, so even a mis-selected attacker is norm-bounded
        norms = torch.sqrt(torch.sum(rows * rows, dim=1, keepdim=True))
        rows = rows / torch.clamp(norms / norm_bound, min=1.0)
    scores = _krum_scores(rows, ok, m, f_eff)
    if kind in ("krum", "norm_krum"):
        # one survivor: every score is inf; return that survivor
        sel = torch.where(m > 1, torch.argmin(scores),
                          torch.argmax(ok.to(torch.int32)))
        return _pick(rows, sel)
    # multikrum: the uniform mean of the q lowest-scoring survivors
    q = torch.minimum(torch.clamp(m - f_eff - 2, min=1),
                      torch.clamp(m, min=1))
    order = torch.argsort(scores, stable=True)
    qmask = (torch.arange(s, device=mat.device) < q)[:, None]
    picked = rows.index_select(0, order)
    return (row_sum(torch.where(qmask, picked, torch.zeros_like(picked)))
            / q.to(torch.float32))


def _client_norms(diff: Tree) -> torch.Tensor:
    """[S] L2 norm of each client's whole delta tree, the per-leaf squared
    sums added in the reference's leaf order. Each client's sum is a
    reduction of its own row alone: on the card a reduction over the rows
    of an ``[S, n]`` matrix splits each row's sum by ``S``, and a client's
    norm must not depend on how many rows the tree holds (a mesh rank's
    block or the whole draw)."""
    total = None
    for k in reference_leaf_order(diff):
        d = diff[k]
        sq = d * d
        rows = [torch.sum(sq[i]) for i in range(d.shape[0])]
        sq = torch.stack(rows) if rows else sq.new_zeros((0,))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def norm_diff_clipping(stacked: Tree, global_: Tree,
                       norm_bound: float) -> Tree:
    """Each client's difference to the global model clipped to
    ``norm_bound``: ``w_g + diff / max(1, |diff| / bound)``, over an
    ``[S, ...]``-stacked tree."""
    diff = {k: p - global_[k] for k, p in stacked.items()}
    scale = 1.0 / torch.clamp(_client_norms(diff) / norm_bound, min=1.0)
    out = {}
    for k, d in diff.items():
        sc = scale.reshape((d.shape[0],) + (1,) * (d.dim() - 1))
        out[k] = global_[k] + d * sc.to(d.dtype)
    return out


def add_gaussian_noise(tree: Tree, noise: Tree, stddev: float) -> Tree:
    """Weak-DP defense: ``x + stddev * noise`` on every leaf, ``noise``
    the standard-normal draw shaped like ``tree``."""
    return {k: x + stddev * noise[k] for k, x in tree.items()}


class RobustAggregator:
    """The defense applied to the stacked client models before the
    aggregate: ``defense_type`` "none", "norm_diff_clipping" or "weak_dp"
    (clipping, then noise)."""

    def __init__(self, defense_type: str = "none", norm_bound: float = 5.0,
                 stddev: float = 0.025):
        if defense_type not in ("none", "norm_diff_clipping", "weak_dp"):
            raise ValueError(f"unknown defense type {defense_type!r}")
        self.defense_type = defense_type
        self.norm_bound = norm_bound
        self.stddev = stddev

    @property
    def needs_noise(self) -> bool:
        return self.defense_type == "weak_dp"

    def apply(self, stacked_locals: Tree, global_: Tree,
              noise: Optional[Tree] = None) -> Tree:
        """Defend an ``[S, ...]``-stacked tree of local models; ``noise``
        (weak_dp) is the round's ``[S, ...]`` standard-normal draw."""
        if self.defense_type == "none":
            return stacked_locals
        clipped = norm_diff_clipping(stacked_locals, global_,
                                     self.norm_bound)
        if self.defense_type == "norm_diff_clipping":
            return clipped
        if noise is None:
            raise ValueError("weak_dp needs the round's noise draw")
        return add_gaussian_noise(clipped, noise, self.stddev)
