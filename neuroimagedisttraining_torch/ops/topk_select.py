"""Exact k-th largest value by a search over float bit patterns (counterpart
of ``neuroimagedisttraining_tpu/ops/topk_select.py``).

Non-negative IEEE floats compare like their bit patterns read as int32, so
the k-th largest value of a row is the largest bit pattern ``b`` with
``count(bits >= b) >= k``. Thirty-one count passes binary-search that ``b``
over ``[0, 0x7F800001)``; the result is a unique integer, the same float
``torch.topk(x, k).values[..., -1]`` gives, so ``x >= thr`` keeps every
value tying the threshold. The CUDA kernel reaches the same integer by a
radix select over the clamped bit pattern in three digit passes
(:func:`radix_threshold` spells its algorithm in plain PyTorch).
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


#: the widths of the radix select's digits over the 31 key bits, top first
#: (``csrc/threshold.cu``: one pass each)
RADIX_DIGITS = (11, 10, 10)
#: the +inf bit pattern: keys are bit patterns clamped to [0, KEY_MAX]
KEY_MAX = 0x7F800000


def radix_threshold(av: torch.Tensor, k: int) -> torch.Tensor:
    """The CUDA threshold kernel's algorithm in plain PyTorch, on no path:
    the same value as :func:`exact_threshold`, by a radix select.

    The key of an element is its bit pattern clamped to ``[0, KEY_MAX]``
    (negative patterns count as 0, NaN as +inf, as the plain search's
    ``count(bits >= mid)`` treats them). Per digit, top first: a histogram
    of the digit over the elements whose higher digits equal the prefix
    chosen so far, then, from the top bin down, the bin where the running
    count reaches ``k_remaining``; the prefix takes that bin and
    ``k_remaining`` drops by the count above it. The final prefix is the
    k-th largest key."""
    n = av.shape[-1]
    lead = av.shape[:-1]
    key = av.to(torch.float32).contiguous().view(torch.int32).reshape(-1, n)
    key = key.clamp(0, KEY_MAX).to(torch.int64)
    rows = key.shape[0]
    prefix = torch.zeros((rows, 1), dtype=torch.int64, device=av.device)
    k_rem = torch.full((rows, 1), int(k), dtype=torch.int64, device=av.device)
    row_id = torch.arange(rows, device=av.device)[:, None].expand_as(key)
    low = 31
    for width in RADIX_DIGITS:
        low -= width
        bins = 1 << width
        hit = (key >> (low + width)) == prefix
        digit = (key >> low) & (bins - 1)
        hist = torch.bincount((row_id * bins + digit)[hit],
                              minlength=rows * bins).reshape(rows, bins)
        at_or_above = hist.flip(-1).cumsum(-1).flip(-1)
        chosen = (at_or_above >= k_rem).sum(-1, keepdim=True) - 1
        above = at_or_above.gather(-1, chosen) - hist.gather(-1, chosen)
        prefix = (prefix << width) | chosen
        k_rem = k_rem - above
    return prefix.to(torch.int32).view(torch.float32).reshape(lead + (1,))


def sampled_threshold(av: torch.Tensor, k: int, sample: int) -> torch.Tensor:
    """The ``agg_topk_sample`` estimator (Deep Gradient Compression's
    sampling): a fixed-stride ~``sample``-element subsample of each row,
    the exact top-k of the candidates with k scaled by the stride
    (``torch.topk``, where the reference takes ``lax.top_k``). The shipped
    count is only about k; the error-feedback residual absorbs the rest."""
    n = av.shape[-1]
    stride = max(1, n // int(sample))
    cand = av[..., ::stride]
    ks = min(cand.shape[-1], max(1, int(round(k / stride))))
    return torch.topk(cand, ks, dim=-1).values[..., -1:]


def select_threshold(av: torch.Tensor, k: int,
                     sample: int = 0) -> torch.Tensor:
    """Per-row threshold for ``av >= thr`` top-k selection of a ``[C, n]``
    matrix: the strided estimator when ``0 < sample < n``, else the exact
    search — the CUDA kernel for CUDA tensors (any ``n``), the plain search
    on the CPU.

    The port has no backend switch. The reference's round body reaches the
    XLA search even under ``agg_kernels="pallas"`` (``_topk_aggregate``
    passes no ``kernels=``), but every backend converges to the same unique
    bit pattern, so taking the kernel here changes no bit."""
    from .kernels import threshold_topk

    n = av.shape[-1]
    if sample and n > sample:
        return sampled_threshold(av, k, sample)
    return threshold_topk(av.contiguous(), k)


def host_topk_indices(mag, k: int):
    """Exactly-k flat indices of the largest magnitudes, on the host, under
    the wire tie-break contract of the reference's
    ``ops/topk_select.host_topk_indices``: all ``mag > T`` plus the ties at
    ``T`` by ascending index, returned ascending int32 (byte-identical to
    ``np.sort(np.argsort(-mag, kind='stable')[:k])`` without the full sort;
    ``np.argpartition`` is O(n) expected). NaNs order last, as in the
    stable-argsort spelling."""
    import numpy as np

    mag = np.asarray(mag).ravel()
    n = mag.size
    k = int(k)
    if k >= n:
        return np.arange(n, dtype=np.int32)
    part = np.argpartition(-mag, k - 1)[:k]
    vals = mag[part]
    if np.isnan(vals).any():
        # >= k non-finites in play: the reference spelling (outside the
        # contract; correctness over speed)
        order = np.argsort(-mag, kind="stable")[:k]
        return np.sort(order).astype(np.int32)
    thr = vals.min()
    above = np.flatnonzero(mag > thr)
    ties = np.flatnonzero(mag == thr)
    idx = np.concatenate([above, ties[: k - above.size]])
    return np.sort(idx).astype(np.int32)
