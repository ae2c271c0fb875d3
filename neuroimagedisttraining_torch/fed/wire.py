"""Delta wire codecs: a tree -> Message tensors in the ``agg_impl`` formats
(dense / bf16 / int8 / topk), on the host and deterministic (counterpart of
``neuroimagedisttraining_tpu/fed/wire.py``).

The in-mesh wires (``parallel/collectives.py``) compress transfers between
ranks on the device; a federation ships the same formats over a real wire
between processes. The codecs here are host numpy, pure functions of the
input tree (no RNG, no device state), so an encoded payload is reproducible
and a recorded buffered run replays bit for bit. Each gives the
reference's payload byte for byte on the same tree.

Transport is bit-transparent: ``decode(wire(encode(tree)))`` equals
``decode(encode(tree))`` exactly over every backend. The lossy codecs
(bf16, int8, topk) lose precision once, at encode time.

bf16 without ``ml_dtypes``: numpy names no bfloat16, so the cast runs in
torch (round to nearest even) and ships as a ``uint16`` view, a NaN as the
quiet NaN of its sign (``0x7FC0`` / ``0xFFC0``, where torch's CPU cast
writes ``0xFFFF``), as the reference's ``ml_dtypes`` cast does.

Top-k: per leaf, the magnitude selection of ``ops.topk_select.
host_topk_indices`` (every coordinate above the k-th largest magnitude,
then the ties at it by ascending position, shipped in ascending order),
sized by ``parallel.collectives.topk_count``, the count the wire-cost
model (``obs/comm.py``) prices.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..comm.message import (
    Message,
    to_numpy,
    tree_flatten,
    tree_map,
    tree_unflatten,
)
from ..ops.topk_select import host_topk_indices
from ..parallel.collectives import topk_count

WIRE_IMPLS = ("dense", "bf16", "int8", "topk")


def bf16_bits(a) -> np.ndarray:
    """``a`` cast to bfloat16 (round to nearest even), as its ``uint16``
    bits."""
    import torch

    # np.array, not np.ascontiguousarray: that one makes a 0-d leaf 1-d
    a = np.array(a, np.float32, order="C")
    bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16) \
        .numpy().view(np.uint16)
    nan = np.isnan(a)
    if nan.any():
        bits = np.where(nan, np.where(np.signbit(a), np.uint16(0xFFC0),
                                      np.uint16(0x7FC0)), bits)
    return bits


def bf16_float(bits) -> np.ndarray:
    """bfloat16 ``uint16`` bits as float32 (exact)."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(
        np.float32)


def _q_int8(a: np.ndarray):
    """Per-leaf symmetric int8 quantization: scale = max|a|/127 (1.0 for
    an all-zero leaf so decode is exact zeros), round-half-even like the
    in-mesh int8 wire's deterministic mode."""
    a = np.asarray(a, np.float32)
    m = np.float32(np.max(np.abs(a))) if a.size else np.float32(0.0)
    scale = np.float32(m / np.float32(127.0)) if m > 0 else np.float32(1.0)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return q, np.asarray(scale, np.float32)


def _topk_leaf(a: np.ndarray, density: float):
    a = np.asarray(a, np.float32)
    flat = a.ravel()
    k = topk_count(flat.size, density)
    idx = host_topk_indices(np.abs(flat), k)
    return idx, flat[idx], np.asarray(a.shape, np.int64)


def encode_update(msg: Message, tree: Any, impl: str, *,
                  key: str = "delta", density: float = 0.1) -> None:
    """Attach ``tree`` to ``msg`` under ``key`` in wire format ``impl``.

    ``dense`` ships the raw leaves (dtype-preserving: the sync barrier's
    bit-parity path); the compressed impls cast, quantize or sparsify to
    f32-decodable payloads. ``density`` is the topk fraction
    (``--agg_topk_density``)."""
    if impl not in WIRE_IMPLS:
        raise ValueError(
            f"unknown wire impl {impl!r} (one of {WIRE_IMPLS})")
    msg.add(key + "_wire", impl)
    tree = tree_map(to_numpy, tree)
    if impl == "dense":
        msg.add_tensor(key, tree)
    elif impl == "bf16":
        msg.add_tensor(key, tree_map(bf16_bits, tree))
    elif impl == "int8":
        q = tree_map(lambda x: _q_int8(x)[0], tree)
        s = tree_map(lambda x: _q_int8(x)[1], tree)
        msg.add_tensor(key, {"q": q, "scale": s})
    else:  # topk
        leaves, structure = tree_flatten(tree)
        parts = [_topk_leaf(x, density) for x in leaves]
        msg.add_tensor(key, {
            name: tree_unflatten(structure, [p[i] for p in parts])
            for i, name in enumerate(("idx", "val", "shape"))})


def _scatter_leaf(idx: np.ndarray, val: np.ndarray,
                  shape: np.ndarray) -> np.ndarray:
    shape = tuple(int(d) for d in np.asarray(shape).ravel())
    size = int(np.prod(shape)) if shape else 1
    out = np.zeros(size, np.float32)
    out[np.asarray(idx)] = np.asarray(val, np.float32)
    return out.reshape(shape)


def decode_update(msg: Message, *, key: str = "delta") -> Any:
    """The (post-compression) tree shipped by :func:`encode_update`, as
    float32 numpy leaves (``dense`` keeps the encoder's dtypes)."""
    impl = msg.get(key + "_wire")
    payload = msg.get_tensor(key)
    if impl == "dense":
        return tree_map(np.asarray, payload)
    if impl == "bf16":
        return tree_map(bf16_float, payload)
    if impl == "int8":
        return tree_map(lambda q, s: q.astype(np.float32) * np.float32(s),
                        payload["q"], payload["scale"])
    if impl == "topk":
        return tree_map(_scatter_leaf, payload["idx"], payload["val"],
                        payload["shape"])
    raise ValueError(f"message carries unknown wire impl {impl!r}")
