"""Non-IID partitioners: sample-index assignment per client (a copy of
``neuroimagedisttraining_tpu/data/partition.py``, which is numpy only).

The rebuild of the reference's two partitioner families:

* the LDA/Dirichlet partitioner of
  ``fedml_core/non_iid_partition/noniid_partition.py:6-103``
  (``non_iid_partition_with_dirichlet_distribution`` +
  ``partition_class_samples_with_dirichlet_distribution`` +
  ``record_data_stats``), and
* the class-prior samplers of
  ``fedml_api/data_preprocessing/cifar10/data_loader.py:75-195``
  (``partition == 'n_cls' | 'dir' | 'my_part'`` — lognormal client sizes,
  per-client class priors, sequential draw with class depletion), plus the
  per-client proportional *test* resampling of
  ``load_partition_data_cifar10`` (``data_loader.py:208-250``).

Everything here is pure numpy on host (partitioning is a one-time setup cost,
negligible next to training); outputs are index arrays that feed
``FederatedData`` stacking so the actual tensors ship to the device once.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# LDA / Dirichlet partition (noniid_partition.py parity)
# ---------------------------------------------------------------------------

def dirichlet_partition(
    labels: np.ndarray,
    n_clients: int,
    n_classes: int,
    alpha: float,
    min_size: int = 10,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[int, np.ndarray]:
    """Latent-Dirichlet-Allocation non-IID split (arXiv:1909.06335).

    For each class k, draw client proportions ~ Dir(alpha) and split class-k
    indices accordingly; retry whole assignments until every client holds at
    least ``min_size`` samples — the semantics of
    ``non_iid_partition_with_dirichlet_distribution``
    (``noniid_partition.py:42-73``), including the balancing rule that zeroes
    a client's proportion once it already holds >= N/n_clients samples
    (``noniid_partition.py:84-86``).
    """
    labels = np.asarray(labels).ravel()
    n = labels.shape[0]
    rng = rng or np.random.RandomState()
    current_min = 0
    batches: List[List[int]] = []
    while current_min < min_size:
        batches = [[] for _ in range(n_clients)]
        for k in range(n_classes):
            idx_k = np.where(labels == k)[0]
            rng.shuffle(idx_k)
            props = rng.dirichlet(np.repeat(alpha, n_clients))
            # cap already-full clients (reference's load-balancing trick)
            full = np.array([len(b) >= n / n_clients for b in batches])
            props = np.where(full, 0.0, props)
            props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_k)).astype(int)[:-1]
            for b, chunk in zip(batches, np.split(idx_k, cuts)):
                b.extend(chunk.tolist())
        current_min = min(len(b) for b in batches)
    out = {}
    for i, b in enumerate(batches):
        arr = np.array(b, dtype=np.int64)
        rng.shuffle(arr)
        out[i] = arr
    return out


def record_data_stats(
    labels: np.ndarray, mapping: Dict[int, np.ndarray]
) -> Dict[int, Dict[int, int]]:
    """Per-client class histogram (``record_data_stats``,
    ``noniid_partition.py:94-103``)."""
    labels = np.asarray(labels).ravel()
    stats = {}
    for client, idx in mapping.items():
        unq, cnt = np.unique(labels[np.asarray(idx, dtype=np.int64)],
                             return_counts=True)
        stats[client] = {int(u): int(c) for u, c in zip(unq, cnt)}
    logger.debug("Data statistics: %s", stats)
    return stats


# ---------------------------------------------------------------------------
# Class-prior partitions ('n_cls' / 'dir' / 'my_part' modes)
# ---------------------------------------------------------------------------

def _draw_with_priors(
    labels: np.ndarray,
    n_clients: int,
    n_classes: int,
    cls_priors: np.ndarray,
    rng: np.random.RandomState,
) -> Dict[int, np.ndarray]:
    """Assign every training index to a client according to per-client class
    priors, with class depletion.

    Vectorized equivalent of the reference's one-sample-at-a-time
    draw-until-valid loop (``cifar10/data_loader.py:97-115`` et al.): instead
    of N sequential coin flips we (1) give every client an equal target size
    (the reference's lognormal(sigma=0) collapses to exactly that,
    ``data_loader.py:83-85``), (2) draw each client's class counts from a
    multinomial over its prior, then (3) repair overflow against the true
    per-class availability by redistributing excess to clients whose priors
    still want those classes. Same marginal behavior, O(C*K) instead of O(N).
    """
    labels = np.asarray(labels).ravel()
    n = labels.shape[0]
    class_avail = np.bincount(labels, minlength=n_classes).astype(np.int64)
    sizes = np.full(n_clients, n // n_clients, dtype=np.int64)
    sizes[: n % n_clients] += 1

    # target per-(client, class) counts from the priors
    want = np.zeros((n_clients, n_classes), dtype=np.int64)
    for c in range(n_clients):
        want[c] = rng.multinomial(sizes[c], cls_priors[c] / cls_priors[c].sum())

    # repair: scale down classes that are over-subscribed, topping up from
    # under-subscribed classes the client's prior allows
    for _ in range(n_classes + 2):
        total = want.sum(axis=0)
        over = total - class_avail
        changed = False
        for k in np.where(over > 0)[0]:
            # remove `over[k]` draws from class k, proportionally to holdings
            holders = np.where(want[:, k] > 0)[0]
            take = _proportional_take(want[holders, k], int(over[k]))
            want[holders, k] -= take
            changed = True
        if not changed:
            break
        # top-up clients back to their size from classes with spare capacity
        total = want.sum(axis=0)
        spare = class_avail - total
        for c in range(n_clients):
            deficit = int(sizes[c] - want[c].sum())
            if deficit <= 0:
                continue
            # top up only from classes the client's prior allows — clients
            # whose allowed classes are exhausted stay short rather than
            # receive off-prior samples (the reference instead re-draws
            # already-assigned indices, data_loader.py:109-111, i.e.
            # duplicates samples across clients; we keep shards disjoint)
            prefs = cls_priors[c] * (spare > 0)
            if prefs.sum() <= 0:
                continue
            add = rng.multinomial(deficit, prefs / prefs.sum())
            add = np.minimum(add, spare)
            want[c] += add
            spare -= add

    # materialize index assignment per class
    mapping: Dict[int, List[int]] = {c: [] for c in range(n_clients)}
    for k in range(n_classes):
        idx_k = np.where(labels == k)[0]
        rng.shuffle(idx_k)
        cursor = 0
        for c in range(n_clients):
            take = int(min(want[c, k], len(idx_k) - cursor))
            mapping[c].extend(idx_k[cursor: cursor + take].tolist())
            cursor += take
    out = {}
    for c in range(n_clients):
        arr = np.array(mapping[c], dtype=np.int64)
        rng.shuffle(arr)
        out[c] = arr
    return out


def _proportional_take(holdings: np.ndarray, amount: int) -> np.ndarray:
    """Remove ``amount`` units across ``holdings`` proportionally (largest
    remainders), never below zero."""
    if holdings.sum() <= amount:
        return holdings.copy()
    frac = holdings / holdings.sum() * amount
    take = np.floor(frac).astype(np.int64)
    rem = amount - take.sum()
    order = np.argsort(-(frac - take))
    for i in order[:rem]:
        if take[i] < holdings[i]:
            take[i] += 1
    return np.minimum(take, holdings)


def class_prior_partition(
    labels: np.ndarray,
    n_clients: int,
    n_classes: int,
    partition: str = "dir",
    alpha: float = 0.3,
    seed: Optional[int] = None,
) -> Dict[int, np.ndarray]:
    """The cifar-loader partition modes (``cifar10/data_loader.py:79-195``):

    * ``'n_cls'`` — each client uniform over ``int(alpha)`` randomly chosen
      classes (``data_loader.py:86-88``)
    * ``'dir'``   — per-client class prior ~ Dir(alpha)
      (``data_loader.py:124``)
    * ``'my_part'`` — ``int(alpha)`` shard groups; clients in a group share a
      Dir(0.3) prior (``data_loader.py:158-165``)
    * ``'homo'``  — IID equal random split
    """
    labels = np.asarray(labels).ravel()
    rng = np.random.RandomState(seed)
    if partition == "homo":
        idx = rng.permutation(labels.shape[0])
        return {c: np.sort(chunk).astype(np.int64)
                for c, chunk in enumerate(np.array_split(idx, n_clients))}
    if partition == "n_cls":
        k = max(1, int(alpha))
        priors = np.zeros((n_clients, n_classes))
        for c in range(n_clients):
            chosen = rng.choice(n_classes, size=k, replace=False)
            priors[c, chosen] = 1.0 / k
    elif partition == "dir":
        priors = rng.dirichlet([alpha] * n_classes, size=n_clients)
    elif partition == "my_part":
        n_shards = max(1, int(alpha))
        group_priors = rng.dirichlet([0.3] * n_classes, size=n_shards)
        group_of = (np.arange(n_clients) //
                    max(1, n_clients // n_shards)) % n_shards
        priors = group_priors[group_of]
    else:
        raise ValueError(f"unknown partition mode {partition!r}")
    return _draw_with_priors(labels, n_clients, n_classes, priors, rng)


# ---------------------------------------------------------------------------
# Proportional per-client test resampling
# ---------------------------------------------------------------------------

def proportional_test_indices(
    y_test: np.ndarray,
    train_cls_counts: Dict[int, Dict[int, int]],
    n_clients: int,
    n_classes: int,
    rng: Optional[np.random.RandomState] = None,
) -> Dict[int, np.ndarray]:
    """Give each client a test set whose label mix mirrors its *train* label
    histogram — the eval protocol of ``load_partition_data_cifar10``
    (``cifar10/data_loader.py:224-243``): per client, per label, draw
    ``ceil(train_frac_of_label * (n_test/n_clients))`` random test indices of
    that label (with replacement across clients, as in the reference)."""
    y_test = np.asarray(y_test).ravel()
    rng = rng or np.random.RandomState()
    idx_by_label = [np.where(y_test == k)[0] for k in range(n_classes)]
    per_client = int(np.ceil(len(y_test) / n_clients))
    out = {}
    for c in range(n_clients):
        counts = train_cls_counts.get(c, {})
        total = max(1, sum(counts.values()))
        picked = []
        for k in range(n_classes):
            frac = counts.get(k, 0) / total
            m = int(np.ceil(frac * per_client))
            if m == 0 or len(idx_by_label[k]) == 0:
                continue
            perm = rng.permutation(len(idx_by_label[k]))[:m]
            picked.append(idx_by_label[k][perm])
        out[c] = (np.concatenate(picked) if picked
                  else np.array([], dtype=np.int64))
    return out


# ---------------------------------------------------------------------------
# Site + contiguous partitions (ABCD semantics)
# ---------------------------------------------------------------------------

def site_partition(site: np.ndarray) -> Dict[int, np.ndarray]:
    """One client per unique acquisition site (the ABCD cross-silo mapping,
    ``ABCD/data_loader.py:183`` — the reference hardcodes 21 sites; here the
    client count follows the data)."""
    site = np.asarray(site).ravel()
    return {i: np.where(site == s)[0]
            for i, s in enumerate(np.unique(site))}


def contiguous_reshard(n_total: int, n_clients: int) -> Dict[int, np.ndarray]:
    """Equal contiguous shards of the merged cohort — the ``_rescale`` entry's
    resharding (``ABCD/data_loader.py:286-296``): client i gets
    ``[i*s, (i+1)*s)`` with ``s = n_total // n_clients`` (the remainder tail
    is dropped, as in the reference)."""
    s = n_total // n_clients
    return {i: np.arange(i * s, (i + 1) * s, dtype=np.int64)
            for i in range(n_clients)}
