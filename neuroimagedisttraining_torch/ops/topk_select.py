"""Exact k-th largest value by a search over float bit patterns (counterpart
of ``neuroimagedisttraining_tpu/ops/topk_select.py``).

Non-negative IEEE floats compare like their bit patterns read as int32, so
the k-th largest value of a row is the largest bit pattern ``b`` with
``count(bits >= b) >= k``. Thirty-one count passes binary-search that ``b``
over ``[0, 0x7F800001)``; the result is a unique integer, the same float
``torch.topk(x, k).values[..., -1]`` gives, so ``x >= thr`` keeps every
value tying the threshold.
"""
from __future__ import annotations

import torch

#: one past the +inf bit pattern: the search's exclusive upper bound
BITS_HI = 0x7F800001

#: halvings until the search interval is one wide
SEARCH_ITERS = 31


def exact_threshold(av: torch.Tensor, k: int) -> torch.Tensor:
    """The plain search: exact k-th largest of each row of a non-negative
    f32 ``[..., n]`` tensor, as ``[..., 1]`` f32. Invariant: ``lo`` always
    has ``count >= k`` (true at 0 since ``k <= n``), ``hi`` never does."""
    bits = av.to(torch.float32).contiguous().view(torch.int32)
    lead = av.shape[:-1] + (1,)
    lo = torch.zeros(lead, dtype=torch.int32, device=av.device)
    hi = torch.full(lead, BITS_HI, dtype=torch.int32, device=av.device)
    for _ in range(SEARCH_ITERS):
        mid = lo + (hi - lo) // 2
        ok = (bits >= mid).sum(dim=-1, keepdim=True) >= k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo.view(torch.float32)


def select_threshold(av: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row threshold for ``av >= thr`` top-k selection of a ``[C, n]``
    matrix: the CUDA kernel for CUDA tensors (any ``n``), the plain search
    on the CPU."""
    from .kernels import threshold_topk

    return threshold_topk(av, k)
