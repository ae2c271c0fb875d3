"""CIFAR-10/100 federated loaders and the training-time crop and flip
(counterpart of ``neuroimagedisttraining_tpu/data/cifar.py``).

* raw loading reads the standard python-pickled batch files
  (``cifar-10-batches-py``, ``cifar-100-python``) into NHWC uint8 images
  and int32 labels;
* the partition modes "homo" / "n_cls" / "dir" / "my_part", the
  per-client test sets resampled proportional to each client's train
  labels, the validation split of ``val_fraction``
  (:func:`.packing.partition_and_pack`);
* the images are normalized once into the stacked arrays with the
  torchvision constants, and the dataset carries the black pad value
  (:func:`black_pad_value`) as ``FederatedData.aug_pad_value``;
* :func:`random_crop_flip` is the reference's RandomCrop(H, padding=4) and
  RandomHorizontalFlip over a whole gathered batch on its device, one
  gather: the algorithms apply it to every training and SNIP batch.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .packing import partition_and_pack
from .types import FederatedData

# the torchvision normalization constants of the original's loaders
CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _images(data) -> np.ndarray:
    """Rows of 3072 channel-planar bytes -> NHWC."""
    return np.asarray(data).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def load_cifar10_raw(data_dir: str):
    """The ``cifar-10-batches-py`` layout (in ``data_dir`` or under it):
    ``(X_train, y_train, X_test, y_test)``, NHWC uint8 and int32."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(base):
        base = data_dir
    xs, ys = [], []
    for i in range(1, 6):
        d = _unpickle(os.path.join(base, f"data_batch_{i}"))
        xs.append(d["data"])
        ys.extend(d["labels"])
    X_train = _images(np.concatenate(xs))
    y_train = np.asarray(ys, np.int32)
    d = _unpickle(os.path.join(base, "test_batch"))
    return X_train, y_train, _images(d["data"]), np.asarray(d["labels"],
                                                            np.int32)


def load_cifar100_raw(data_dir: str):
    """The ``cifar-100-python`` layout, fine labels."""
    base = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(base):
        base = data_dir
    d = _unpickle(os.path.join(base, "train"))
    X_train = _images(d["data"])
    y_train = np.asarray(d["fine_labels"], np.int32)
    d = _unpickle(os.path.join(base, "test"))
    return X_train, y_train, _images(d["data"]), np.asarray(
        d["fine_labels"], np.int32)


def _normalize(x: np.ndarray, mean: np.ndarray, std: np.ndarray) -> np.ndarray:
    return ((x.astype(np.float32) / 255.0) - mean) / std


def black_pad_value(mean: np.ndarray, std: np.ndarray) -> tuple:
    """The per-channel value of a black padding pixel in normalized space,
    ``(0 - mean) / std``: torchvision's RandomCrop pads the raw image with
    0 before ToTensor and Normalize."""
    return tuple(((0.0 - np.asarray(mean)) / np.asarray(std)).tolist())


def load_partition_data_cifar(
    data_dir: str,
    dataset: str = "cifar10",
    partition_method: str = "dir",
    partition_alpha: float = 0.3,
    client_number: int = 100,
    val_fraction: float = 0.0,
    seed: Optional[int] = None,
) -> FederatedData:
    """Federated CIFAR-10 or CIFAR-100 with the original's partition and
    eval protocol, as CPU tensors."""
    if dataset == "cifar10":
        X_train, y_train, X_test, y_test = load_cifar10_raw(data_dir)
        mean, std, n_classes = CIFAR10_MEAN, CIFAR10_STD, 10
    elif dataset == "cifar100":
        X_train, y_train, X_test, y_test = load_cifar100_raw(data_dir)
        mean, std, n_classes = CIFAR100_MEAN, CIFAR100_STD, 100
    else:
        raise ValueError(f"unknown cifar dataset {dataset!r}")
    return partition_and_pack(
        _normalize(X_train, mean, std), y_train,
        _normalize(X_test, mean, std), y_test,
        n_classes, client_number, partition_method, partition_alpha,
        val_fraction, seed,
        aug_pad_value=black_pad_value(mean, std),
    )


#: a batch's crop and flip draws: ``[3, B]`` int64, the rows the crop's top
#: offset, its left offset (each in ``[0, 2 * padding]``) and the flip (0/1)
DRAW_ROWS = 3


def crop_flip_draws(generator: torch.Generator, batch: int,
                    padding: int = 4) -> torch.Tensor:
    """One batch's :data:`DRAW_ROWS` draws from ``generator`` on its
    device: the top offsets, the left offsets, the flips."""
    dev = generator.device
    hi = 2 * padding + 1
    return torch.stack([
        torch.randint(0, hi, (batch,), generator=generator, device=dev),
        torch.randint(0, hi, (batch,), generator=generator, device=dev),
        torch.randint(0, 2, (batch,), generator=generator, device=dev)])


def random_crop_flip(batch: torch.Tensor, draws: Optional[torch.Tensor] = None,
                     *, generator: Optional[torch.Generator] = None,
                     padding: int = 4,
                     pad_value: Union[None, Sequence[float],
                                      torch.Tensor] = None) -> torch.Tensor:
    """RandomCrop(H, padding) and RandomHorizontalFlip of an NHWC batch:
    each image padded by ``padding`` on every side with ``pad_value`` per
    channel (0 when None), cropped back to ``H x W`` at its offsets and
    mirrored left-right where its flip is set. ``draws`` (``[3, B]``:
    top offsets, left offsets, flips; :func:`crop_flip_draws`) are the
    random seam, else drawn from ``generator``. The interior pixels pass
    bit for bit (the whole op is one gather); the ring holds ``pad_value``
    in the batch's dtype. Nothing here reads the host, so a CUDA graph
    can hold it when ``pad_value`` is a tensor on the batch's device."""
    b, h, w, c = batch.shape
    if draws is None:
        draws = crop_flip_draws(generator, b, padding)
    dev = batch.device
    draws = draws.to(dev)
    padded = batch.new_zeros((b, h + 2 * padding, w + 2 * padding, c))
    if pad_value is not None:
        pv = torch.as_tensor(pad_value, dtype=torch.float32).to(
            dev, batch.dtype)
        padded.copy_(pv.expand_as(padded))
    padded[:, padding:padding + h, padding:padding + w] = batch
    rows = draws[0][:, None] + torch.arange(h, device=dev)
    ar = torch.arange(w, device=dev)
    cols = draws[1][:, None] + torch.where(draws[2][:, None].bool(),
                                           (w - 1) - ar, ar)
    bi = torch.arange(b, device=dev)[:, None, None]
    return padded[bi, rows[:, :, None], cols[:, None, :]]


class CropFlip:
    """The algorithms' augmentation, ``(batch, draws) -> batch``:
    :func:`random_crop_flip` with the dataset's pad value held on each
    device it meets (placed there once, outside any graph capture)."""

    def __init__(self, pad_value: Optional[Sequence[float]],
                 padding: int = 4):
        self.pad_value = (None if pad_value is None else
                          torch.as_tensor(np.asarray(pad_value,
                                                     np.float32)))
        self.padding = padding
        self._on = {}

    def place(self, device) -> None:
        """The pad value copied to ``device`` (before any capture)."""
        device = torch.device(device)
        if self.pad_value is not None and device not in self._on:
            self._on[device] = self.pad_value.to(device)

    def __call__(self, batch: torch.Tensor, draws: torch.Tensor):
        self.place(batch.device)
        return random_crop_flip(batch, draws, padding=self.padding,
                                pad_value=self._on.get(batch.device))
