"""Partition and pad-stack packing for the image classification datasets
(counterpart of ``neuroimagedisttraining_tpu/data/packing.py``): the
class-prior partition of the train indices, per-client test sets resampled
proportional to each client's train label histogram, the optional
validation split, and the pad-stacked per-client arrays."""
from __future__ import annotations

from typing import Optional

import numpy as np

from .partition import (
    class_prior_partition,
    proportional_test_indices,
    record_data_stats,
)
from .types import FederatedData, pad_stack


def partition_and_pack(
    X_train: np.ndarray,
    y_train: np.ndarray,
    X_test: np.ndarray,
    y_test: np.ndarray,
    n_classes: int,
    client_number: int,
    partition_method: str = "dir",
    partition_alpha: float = 0.3,
    val_fraction: float = 0.0,
    seed: Optional[int] = None,
    aug_pad_value: Optional[tuple] = None,
) -> FederatedData:
    """The federated dataset of the given train and test arrays: the
    ``partition_method`` partition of the train rows over
    ``client_number`` clients, each client's test rows drawn proportional
    to its train labels, and with ``val_fraction`` > 0 a validation split
    carved from each client's train rows (a seeded permutation)."""
    mapping = class_prior_partition(
        y_train, client_number, n_classes, partition_method,
        partition_alpha, seed=seed,
    )
    cls_counts = record_data_stats(y_train, mapping)
    rng = np.random.RandomState(seed)
    test_map = proportional_test_indices(
        y_test, cls_counts, client_number, n_classes, rng=rng,
    )

    xs_tr = [X_train[mapping[c]] for c in range(client_number)]
    ys_tr = [y_train[mapping[c]] for c in range(client_number)]
    xs_te = [X_test[test_map[c]] for c in range(client_number)]
    ys_te = [y_test[test_map[c]] for c in range(client_number)]

    xs_va, ys_va = [], []
    if val_fraction > 0:
        new_x, new_y = [], []
        for x, y in zip(xs_tr, ys_tr):
            n_val = int(len(y) * val_fraction)
            perm = rng.permutation(len(y))
            new_x.append(x[perm[n_val:]])
            new_y.append(y[perm[n_val:]])
            xs_va.append(x[perm[:n_val]])
            ys_va.append(y[perm[:n_val]])
        xs_tr, ys_tr = new_x, new_y

    x_train, n_train = pad_stack(xs_tr)
    y_tr, _ = pad_stack([y.astype(np.int32) for y in ys_tr])
    x_test, n_test = pad_stack(xs_te)
    y_te, _ = pad_stack([y.astype(np.int32) for y in ys_te])
    kwargs = {}
    if val_fraction > 0:
        x_val, n_val = pad_stack(xs_va)
        y_va, _ = pad_stack([y.astype(np.int32) for y in ys_va])
        kwargs = dict(x_val=x_val, y_val=y_va, n_val=n_val)
    return FederatedData(
        x_train=x_train, y_train=y_tr, n_train=n_train,
        x_test=x_test, y_test=y_te, n_test=n_test,
        class_num=n_classes, aug_pad_value=aug_pad_value, **kwargs,
    )
