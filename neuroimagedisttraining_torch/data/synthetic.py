"""Synthetic ABCD-like federated data (counterpart of
``neuroimagedisttraining_tpu/data/synthetic.py``).

:func:`make_synthetic_federated` draws the same numpy stream as the
reference, so both packages build identical cohorts from one seed.
:func:`device_synthetic_federated` builds a full-width cohort directly on the
device, with the benchmark's planted mean shift (labels shift every voxel by
±0.75).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .types import FederatedData, pad_stack


def make_synthetic_federated(
    seed: int = 42,
    n_clients: int = 8,
    samples_per_client: int = 24,
    test_per_client: int = 8,
    val_per_client: int = 0,
    sample_shape: Tuple[int, ...] = (8, 8, 8, 1),
    class_num: int = 2,
    site_shift: float = 0.3,
    signal: float = 1.5,
    uneven: bool = True,
) -> FederatedData:
    """Site-partitioned volumes with a class signal planted along a smooth
    probe and a per-site intensity shift; CPU tensors. ``val_per_client``
    rows per client after the test rows form the validation split."""
    rng = np.random.RandomState(seed)
    probe = 1.0 + 0.5 * np.abs(rng.randn(*sample_shape)).astype(np.float32)
    probe /= np.sqrt(np.mean(probe**2))

    xs_tr, ys_tr, xs_te, ys_te, xs_va, ys_va = [], [], [], [], [], []
    for _ in range(n_clients):
        n_tr = samples_per_client + (rng.randint(0, samples_per_client // 2 + 1)
                                     if uneven else 0)
        n_te = test_per_client
        n = n_tr + n_te + val_per_client
        y = rng.randint(0, class_num, size=n)
        x = rng.randn(n, *sample_shape).astype(np.float32)
        x += site_shift * rng.randn()
        coef = (y - (class_num - 1) / 2.0).astype(np.float32)
        x += signal * coef[(...,) + (None,) * len(sample_shape)] * probe
        xs_tr.append(x[:n_tr])
        ys_tr.append(y[:n_tr])
        xs_te.append(x[n_tr:n_tr + n_te])
        ys_te.append(y[n_tr:n_tr + n_te])
        xs_va.append(x[n_tr + n_te:])
        ys_va.append(y[n_tr + n_te:])

    x_train, n_train = pad_stack(xs_tr)
    y_train, _ = pad_stack([y.astype(np.int32) for y in ys_tr])
    x_test, n_test = pad_stack(xs_te)
    y_test, _ = pad_stack([y.astype(np.int32) for y in ys_te])
    kwargs = {}
    if val_per_client:
        x_val, n_val = pad_stack(xs_va)
        y_val, _ = pad_stack([y.astype(np.int32) for y in ys_va])
        kwargs = dict(x_val=x_val, y_val=y_val, n_val=n_val)
    return FederatedData(x_train=x_train, y_train=y_train, n_train=n_train,
                         x_test=x_test, y_test=y_test, n_test=n_test,
                         class_num=class_num, **kwargs)


def device_synthetic_federated(
    n_clients: int, n: int, sample_shape: Tuple[int, ...],
    generator: torch.Generator, *, test_per_client: Optional[int] = None,
    dtype: torch.dtype = torch.bfloat16, uneven: bool = False,
) -> FederatedData:
    """A full-width cohort made on ``generator``'s device: standard-normal
    volumes (stored in ``dtype``, the compute type), Bernoulli(0.5) labels,
    and a ±0.75 mean shift by label. ``test_per_client`` defaults to
    ``max(4, n // 4)``. Every client stores ``n`` training rows and holds
    ``n`` samples, or with ``uneven`` a count in ``[n // 2, n]`` drawn as
    ``bench.py`` draws it (``np.random.RandomState(0).randint(n // 2, n + 1,
    n_clients)``): the rows past a client's count are stored but never
    read, and the training runs the masked epoch path."""
    dev = generator.device
    m = test_per_client or max(4, n // 4)

    def planted(rows):
        y = (torch.rand((n_clients, rows), generator=generator, device=dev)
             < 0.5).to(torch.int32)
        x = torch.randn((n_clients, rows) + tuple(sample_shape),
                        generator=generator, device=dev, dtype=dtype)
        shift = (y.to(dtype) * 2 - 1) * 0.75
        x += shift.reshape(shift.shape + (1,) * len(sample_shape))
        return x, y

    x, y = planted(n)
    xt, yt = planted(m)
    if uneven:
        counts = torch.from_numpy(np.random.RandomState(0).randint(
            n // 2, n + 1, n_clients).astype(np.int32))
    else:
        counts = torch.full((n_clients,), n, dtype=torch.int32)
    return FederatedData(
        x_train=x, y_train=y, n_train=counts,
        x_test=xt, y_test=yt,
        n_test=torch.full((n_clients,), m, dtype=torch.int32), class_num=2)
