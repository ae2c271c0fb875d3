"""Tiny-ImageNet-200 federated loader (counterpart of
``neuroimagedisttraining_tpu/data/tiny_imagenet.py``): walks the on-disk
layout
  train/<wnid>/images/*.JPEG        (500 per class)
  val/images/*.JPEG + val_annotations.txt
and partitions it as CIFAR is partitioned. Images load once into a host
array (64x64x3, channels-last, per-channel normalized) and pack into
client-stacked shards; PIL is imported only when an image is read.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .packing import partition_and_pack
from .types import FederatedData

# torchvision's commonly used tiny-imagenet stats
TIN_MEAN = np.array([0.4802, 0.4481, 0.3975], np.float32)
TIN_STD = np.array([0.2770, 0.2691, 0.2821], np.float32)


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _wnid_index(root: str) -> Dict[str, int]:
    """Class ids from ``wnids.txt``, else from the sorted train-dir
    wnids (the same mapping)."""
    wnids_file = os.path.join(root, "wnids.txt")
    if os.path.exists(wnids_file):
        with open(wnids_file) as f:
            wnids = [line.strip() for line in f if line.strip()]
    else:
        wnids = sorted(os.listdir(os.path.join(root, "train")))
    return {w: i for i, w in enumerate(wnids)}


def load_tiny_imagenet_raw(
    root: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Read the full train + val splits into host arrays (uint8 HWC)."""
    wnid_to_cls = _wnid_index(root)
    xs: List[np.ndarray] = []
    ys: List[int] = []
    train_dir = os.path.join(root, "train")
    for wnid in sorted(os.listdir(train_dir)):
        if wnid not in wnid_to_cls:
            continue
        img_dir = os.path.join(train_dir, wnid, "images")
        if not os.path.isdir(img_dir):
            continue
        for name in sorted(os.listdir(img_dir)):
            xs.append(_load_image(os.path.join(img_dir, name)))
            ys.append(wnid_to_cls[wnid])
    X_train = np.stack(xs)
    y_train = np.asarray(ys, np.int64)

    # the val split doubles as the test set (labels from
    # val_annotations.txt)
    val_dir = os.path.join(root, "val")
    ann = os.path.join(val_dir, "val_annotations.txt")
    xs2: List[np.ndarray] = []
    ys2: List[int] = []
    with open(ann) as f:
        for line in f:
            parts = line.split("\t")
            if len(parts) < 2 or parts[1] not in wnid_to_cls:
                continue
            xs2.append(_load_image(os.path.join(val_dir, "images", parts[0])))
            ys2.append(wnid_to_cls[parts[1]])
    X_test = np.stack(xs2)
    y_test = np.asarray(ys2, np.int64)
    return X_train, y_train, X_test, y_test


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x.astype(np.float32) / 255.0 - TIN_MEAN) / TIN_STD


def load_partition_data_tiny_imagenet(
    data_dir: str,
    partition_method: str = "dir",
    partition_alpha: float = 0.3,
    client_number: int = 100,
    val_fraction: float = 0.0,
    seed: Optional[int] = None,
) -> FederatedData:
    X_train, y_train, X_test, y_test = load_tiny_imagenet_raw(data_dir)
    # class count from the wnid table, not max observed label — a partial
    # checkout missing the last classes' images must not shrink the head
    n_classes = len(_wnid_index(data_dir))
    # the RandomCrop(64, padding=4) and flip pipeline, as CIFAR's
    from .cifar import black_pad_value

    return partition_and_pack(
        _normalize(X_train), y_train, _normalize(X_test), y_test,
        n_classes, client_number, partition_method, partition_alpha,
        val_fraction, seed,
        aug_pad_value=black_pad_value(TIN_MEAN, TIN_STD),
    )
