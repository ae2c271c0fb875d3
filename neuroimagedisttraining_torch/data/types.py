"""Federated dataset container (counterpart of
``neuroimagedisttraining_tpu/data/types.py``): per-client shards padded to a
common length, with valid-count vectors."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch


@dataclasses.dataclass
class FederatedData:
    """Stacked per-client shards.

    x_train: [C, n_max, *sample_shape]   y_train: [C, n_max]
    x_test:  [C, m_max, *sample_shape]   y_test:  [C, m_max]
    n_train, n_test: [C] int32 valid counts
    x_val/y_val/n_val: the optional per-client validation split, carved
    from train when a loader is given ``val_fraction`` (the JAX CLI's
    unified ``--algo`` parser always passes fedfomo's 0.1). No ported
    algorithm reads it, so it stays on the CPU.

    On a client mesh (``parallel.mesh.shard_federated``) the arrays hold
    this rank's block of clients and ``mesh`` the rank's ``ClientMesh``;
    the counts stay whole, for every client of the cohort, and
    ``y_train_host`` holds every client's train labels on the host
    (stratified SNIP reads them all); None off the mesh.

    ``aug_pad_value``: set by the image loaders, the per-channel value of a
    black padding pixel in the dataset's normalized space, ``(0 - mean) /
    std``. Set, it marks the dataset as augmented in training with the
    reference's RandomCrop(H, padding=4) and horizontal flip, whose padded
    ring is that value (torchvision pads the raw image with 0 before
    normalizing); the algorithms read it (``augment="auto"``).
    """

    x_train: torch.Tensor
    y_train: torch.Tensor
    n_train: torch.Tensor
    x_test: torch.Tensor
    y_test: torch.Tensor
    n_test: torch.Tensor
    class_num: int = 2
    x_val: Optional[torch.Tensor] = None
    y_val: Optional[torch.Tensor] = None
    n_val: Optional[torch.Tensor] = None
    mesh: Optional[Any] = None
    y_train_host: Optional[torch.Tensor] = None
    aug_pad_value: Optional[tuple] = None

    @property
    def num_clients(self) -> int:
        """The cohort's client count (on a mesh, not the rank's block)."""
        return int(self.n_train.shape[0])

    @property
    def sample_shape(self):
        return tuple(self.x_train.shape[2:])

    def to(self, device) -> "FederatedData":
        """The same shards on ``device``; the valid counts stay on the CPU,
        where the round loop reads them."""
        return dataclasses.replace(
            self, x_train=self.x_train.to(device),
            y_train=self.y_train.to(device), x_test=self.x_test.to(device),
            y_test=self.y_test.to(device))


def pad_stack(arrays, pad_to=None, dtype=None):
    """Stack variable-length per-client arrays into ``[C, n_max, ...]`` plus
    int32 counts (CPU tensors)."""
    n = [len(a) for a in arrays]
    n_max = pad_to or max(n)
    first = np.asarray(arrays[0])
    out = np.zeros((len(arrays), n_max) + first.shape[1:],
                   dtype or first.dtype)
    for i, a in enumerate(arrays):
        a = np.asarray(a)
        out[i, : len(a)] = a
    return torch.from_numpy(out), torch.from_numpy(np.array(n, np.int32))
