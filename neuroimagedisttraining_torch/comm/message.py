"""Typed key-value Message with JSON and binary-pytree codecs (counterpart
of ``neuroimagedisttraining_tpu/comm/message.py``).

A message is a JSON header (the ``params`` key-value namespace, and per
tensor entry the tree's structure and a dtype/shape table of its leaves)
followed by the raw leaf bytes. Trees of torch tensors or numpy arrays go
in; decoding returns numpy leaves. The framing is the reference's byte for
byte: the same numpy tree gives the same :meth:`Message.to_bytes`, and
each package decodes the other's frames.

**Leaf order.** The reference flattens a tree with ``jax.tree_util``,
which visits a dict's children by *sorted* key (an ``OrderedDict``'s in
insertion order), lists and tuples in order, and ``None`` as a node with
no leaves. :func:`tree_flatten` here is that walk, written out, so the
leaf table and the structure string come out in the reference's order
(``torch.utils._pytree`` keeps a dict's insertion order instead).

**bf16.** numpy has no bfloat16, and the frame names a leaf's dtype by its
numpy dtype string, so a bf16 torch leaf is refused: cast it, or ship its
bits as a ``uint16`` view (what ``fed/wire.py``'s ``bf16`` codec does).

**The in-band header contract** (what the telemetry planes ride on):
``params`` is an open namespace: a decoder reads the keys it knows and
ignores the rest, so optional control-plane headers travel on existing
frames without a protocol version bump. Two families use it, both gated
the same way (inject only when the feature's object is non-None, so a
feature that is off adds no byte to any wire): the ``xt_*`` trace-context
headers (``obs/xtrace.py``) and the ``hb_*`` heartbeat gauges
(``obs/live.py``).
"""
from __future__ import annotations

import collections
import json
import logging
import struct as _struct
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

MAGIC = b"NIDT"

#: serialized-size accounting hooks: every ``to_bytes`` / ``to_json`` call
#: invokes each with ``(msg_type, nbytes)``. Hooks never kill a send:
#: their exceptions are logged and dropped.
_NBYTES_HOOKS: List[Callable[[str, int], None]] = []


def add_nbytes_hook(hook: Callable[[str, int], None]
                    ) -> Callable[[str, int], None]:
    _NBYTES_HOOKS.append(hook)
    return hook


def remove_nbytes_hook(hook: Callable[[str, int], None]) -> None:
    try:
        _NBYTES_HOOKS.remove(hook)
    except ValueError:
        pass  # already removed (idempotent teardown)


def _note_nbytes(msg_type: str, nbytes: int) -> None:
    for hook in list(_NBYTES_HOOKS):
        try:
            hook(msg_type, nbytes)
        except Exception:
            logger.debug("message nbytes hook failed", exc_info=True)


# -- trees ------------------------------------------------------------------

def _children(node) -> Optional[List[Tuple[Any, Any]]]:
    """``[(key, child)]`` of a tree node in the reference's flatten order
    (key None for sequences), or None for a leaf."""
    if isinstance(node, collections.OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(None, v) for v in node]
    return None


def tree_flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                 ) -> Tuple[List[Any], Any]:
    """``(leaves, structure)`` of ``tree`` in the reference's order: the
    structure is the JSON-able nest of the frame's ``treedef`` (dicts as
    ``{"__d": [[key, child], ...]}``, lists ``{"__l": ...}``, tuples
    ``{"__t": ...}``, None ``{"__n": true}``, a leaf its flatten index)."""
    leaves: List[Any] = []

    def walk(node):
        if node is None:
            return {"__n": True}
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            leaves.append(node)
            return len(leaves) - 1
        if isinstance(node, dict):
            # keys ride as [key, value] pairs with the key's type kept: a
            # bare JSON object would coerce int keys to str
            return {"__d": [[_encode_key(k), walk(v)] for k, v in kids]}
        tag = "__l" if isinstance(node, list) else "__t"
        return {tag: [walk(v) for _, v in kids]}

    structure = walk(tree)
    return leaves, structure


def tree_unflatten(structure: Any, leaves: List[Any]) -> Any:
    """The tree of ``structure`` (:func:`tree_flatten`'s) with ``leaves``
    in its leaf slots."""
    return _decode_structure(structure, leaves)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees ``rest``, of the same structure), as the same structure."""
    leaves, structure = tree_flatten(tree, is_leaf)
    others = [tree_flatten(t, is_leaf)[0] for t in rest]
    return tree_unflatten(structure, [fn(*xs) for xs in zip(leaves,
                                                            *others)])


def tree_leaves(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
                ) -> List[Any]:
    return tree_flatten(tree, is_leaf)[0]


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the numpy array the frame ships: a torch tensor's host
    copy (a bf16 one refused), anything else through ``np.asarray``."""
    if hasattr(leaf, "detach"):
        import torch

        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                "a bfloat16 tensor has no numpy dtype to frame: cast it, or "
                "ship its bits as a uint16 view (fed/wire.py's bf16 codec)")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class _SparseLeaf:
    """Mask-sparse array: nonzero values + a packed 1-bit/element bitmap."""

    __slots__ = ("values", "bitmap", "shape", "dtype")

    def __init__(self, values: np.ndarray, bitmap: np.ndarray,
                 shape: Tuple[int, ...], dtype):
        self.values = values
        self.bitmap = bitmap
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    @classmethod
    def from_dense(cls, leaf, mask) -> "_SparseLeaf":
        arr = to_numpy(leaf)
        m = to_numpy(mask).reshape(-1) != 0
        values = np.ascontiguousarray(arr.reshape(-1)[m])
        return cls(values, np.packbits(m), arr.shape, arr.dtype)

    def to_dense(self) -> np.ndarray:
        n = int(np.prod(self.shape)) if self.shape else 1
        m = np.unpackbits(self.bitmap, count=n).astype(bool)
        out = np.zeros(n, self.dtype)
        out[m] = self.values
        return out.reshape(self.shape)


def _is_msg_leaf(x) -> bool:
    return isinstance(x, _SparseLeaf)


class Message:
    # op-type constants (message.py:12-15 of the reference's origin)
    MSG_OP_SEND = "send"
    MSG_OP_RECEIVE = "receive"
    MSG_OP_BROADCAST = "broadcast"
    MSG_OP_REDUCE = "reduce"

    # framework message types (the cross-silo FedAvg protocol)
    MSG_TYPE_INIT = "init_global_model"
    MSG_TYPE_LOCAL_UPDATE = "client_local_update"
    MSG_TYPE_GLOBAL_MODEL = "server_global_model"
    MSG_TYPE_FINISH = "finish"

    ARG_TYPE = "msg_type"
    ARG_SENDER = "sender"
    ARG_RECEIVER = "receiver"

    def __init__(self, msg_type: str = "default", sender_id: int = 0,
                 receiver_id: int = 0):
        self.params: Dict[str, Any] = {
            self.ARG_TYPE: msg_type,
            self.ARG_SENDER: sender_id,
            self.ARG_RECEIVER: receiver_id,
        }
        self.tensors: Dict[str, Any] = {}  # name -> tree of tensors/arrays
        #: serialized size of the last ``to_bytes`` call (None until one)
        self.nbytes: Optional[int] = None

    # -- kv interface ----------------------------------------------------------
    def add(self, key: str, value: Any) -> None:
        self.params[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self.params.get(key, default)

    def add_tensor(self, key: str, tree: Any) -> None:
        self.tensors[key] = tree

    def add_masked_tensor(self, key: str, tree: Any, mask: Any) -> None:
        """Attach a sparse tree: only values where ``mask != 0`` ride the
        wire, plus a 1-bit/element bitmap; :meth:`get_tensor` densifies
        (zeros off the mask)."""
        self.tensors[key] = tree_map(_SparseLeaf.from_dense, tree, mask)

    def get_tensor(self, key: str) -> Any:
        return tree_map(
            lambda leaf: leaf.to_dense()
            if isinstance(leaf, _SparseLeaf) else leaf,
            self.tensors[key], is_leaf=_is_msg_leaf)

    def get_tensor_mask(self, key: str) -> Any:
        """0/1 float mask tree of a (sparse) tensor entry: the bitmap rides
        with every sparse payload, so a receiver recovers the sparsity
        pattern without a mask message. Dense leaves yield all-ones."""
        def leaf_mask(leaf):
            if isinstance(leaf, _SparseLeaf):
                n = int(np.prod(leaf.shape)) if leaf.shape else 1
                return np.unpackbits(leaf.bitmap, count=n).astype(
                    np.float32).reshape(leaf.shape)
            return np.ones(to_numpy(leaf).shape, np.float32)

        return tree_map(leaf_mask, self.tensors[key], is_leaf=_is_msg_leaf)

    @property
    def type(self) -> str:
        return self.params[self.ARG_TYPE]

    @property
    def sender_id(self) -> int:
        return self.params[self.ARG_SENDER]

    @property
    def receiver_id(self) -> int:
        return self.params[self.ARG_RECEIVER]

    # -- JSON codec (control plane only) ----------------------------------
    def to_json(self) -> str:
        if self.tensors:
            raise ValueError("tensor payloads need to_bytes(), not JSON")
        payload = json.dumps(self.params)
        # control-plane messages are wire bytes too
        self.nbytes = len(payload.encode())
        _note_nbytes(self.type, self.nbytes)
        return payload

    @classmethod
    def from_json(cls, payload: str) -> "Message":
        m = cls()
        m.params = json.loads(payload)
        return m

    # -- binary codec (data plane) ----------------------------------------
    def to_bytes(self) -> bytes:
        leaves_blob: List[bytes] = []
        tensor_index: Dict[str, Any] = {}
        offset = 0
        for key, tree in self.tensors.items():
            leaves, structure = tree_flatten(tree, is_leaf=_is_msg_leaf)
            entries = []
            for leaf in leaves:
                if isinstance(leaf, _SparseLeaf):
                    vraw = leaf.values.tobytes()
                    braw = leaf.bitmap.tobytes()
                    entries.append({
                        "kind": "sparse",
                        "dtype": leaf.dtype.str,
                        "shape": list(leaf.shape),
                        "offset": offset,
                        "nbytes": len(vraw),
                        "bitmap_nbytes": len(braw),
                    })
                    leaves_blob.append(vraw)
                    leaves_blob.append(braw)
                    offset += len(vraw) + len(braw)
                    continue
                arr = to_numpy(leaf)
                raw = np.ascontiguousarray(arr).tobytes()
                entries.append({
                    "dtype": arr.dtype.str,
                    "shape": list(arr.shape),
                    "offset": offset,
                    "nbytes": len(raw),
                })
                leaves_blob.append(raw)
                offset += len(raw)
            tensor_index[key] = {"treedef": json.dumps(structure),
                                 "leaves": entries}
        header = json.dumps(
            {"params": self.params, "tensors": tensor_index}).encode()
        out = b"".join([MAGIC, _struct.pack("<I", len(header)), header,
                        *leaves_blob])
        # the exact bytes a backend ships (obs/comm.py's measured side)
        self.nbytes = len(out)
        _note_nbytes(self.type, self.nbytes)
        return out

    @classmethod
    def from_bytes(cls, payload: bytes) -> "Message":
        if payload[:4] != MAGIC:
            raise ValueError("bad message framing")
        (hlen,) = _struct.unpack("<I", payload[4:8])
        header = json.loads(payload[8:8 + hlen].decode())
        m = cls()
        m.params = header["params"]
        base = 8 + hlen
        for key, spec in header["tensors"].items():
            leaves = []
            for e in spec["leaves"]:
                start = base + e["offset"]
                dtype = np.dtype(e["dtype"])
                if e.get("kind") == "sparse":
                    nnz = e["nbytes"] // dtype.itemsize
                    values = np.frombuffer(
                        payload, dtype=dtype, count=nnz, offset=start)
                    bitmap = np.frombuffer(
                        payload, dtype=np.uint8, count=e["bitmap_nbytes"],
                        offset=start + e["nbytes"])
                    leaves.append(_SparseLeaf(
                        values, bitmap, tuple(e["shape"]), dtype))
                    continue
                arr = np.frombuffer(
                    payload, dtype=dtype,
                    count=int(np.prod(e["shape"])) if e["shape"] else 1,
                    offset=start,
                ).reshape(e["shape"])
                leaves.append(arr)
            m.tensors[key] = tree_unflatten(json.loads(spec["treedef"]),
                                            leaves)
        return m


def _encode_key(k) -> Any:
    if isinstance(k, str):
        return k
    if isinstance(k, bool) or not isinstance(k, int):
        raise TypeError(f"unsupported pytree dict key type: {type(k)!r}")
    return {"__i": k}


def _decode_key(k) -> Any:
    return k["__i"] if isinstance(k, dict) else k


def _decode_structure(node, leaves: List[Any]) -> Any:
    if isinstance(node, dict):
        if "__d" in node:
            return {_decode_key(k): _decode_structure(v, leaves)
                    for k, v in node["__d"]}
        if "__l" in node:
            return [_decode_structure(v, leaves) for v in node["__l"]]
        if "__t" in node:
            return tuple(_decode_structure(v, leaves) for v in node["__t"])
        if "__n" in node:
            return None
    return leaves[int(node)]
