"""Population-scale client store: per-client rows in host memory or on disk
(counterpart of ``neuroimagedisttraining_tpu/core/client_store.py``).

A resident run keeps every per-client row (the ``[C, model]`` personal
stack, the top-k ``agg_residual``) on the card, so the population is capped
by device memory. With a store the card holds only the round's cohort: host
memory holds a hot-client LRU, and a memory-mapped file per leaf holds the
whole population, keyed by client id, behind one gather / stage / commit
interface.

A streamed run is bitwise the resident run: the store never computes, it
moves rows byte for byte, and a row never written is a byte copy of its
field's registered default (no storage until a row trains).

The staging protocol (how the watchdog's rollback composes):

* ``stage(name, ids, slab)`` parks a round's output rows without touching
  storage; the slab may still be a tensor on the card, copied to the host
  only at commit;
* ``commit()`` writes staged slabs into storage (one copy to the host per
  leaf); ``gather`` / ``gather_all`` commit first, so a read sees the newest
  adopted rows;
* ``discard()`` drops staged slabs unread: a rolled-back round's rows never
  reach host memory or disk.

``prefetch`` warms a host row cache for the next cohort off the gather's
clock; ``stats`` holds the store's counters (``mem_store_*``, the host
cache's and the disk's bytes, the cumulative ``store_gather_ms``).

Trees are this package's dicts of tensors. Rows are kept as numpy arrays
(a bfloat16 leaf as its 16-bit pattern); a gather stacks them into a pinned
host buffer and moves it to the card with ``non_blocking=True``.

On a client mesh (``mesh``: one process a device, ``parallel/mesh.py``)
each rank's store holds the rows of its own block of clients, ``[lo, hi)``,
the block ``shard_federated`` gives it: ids in and out are population ids,
the rows inside are the block's (a disk store's memmaps are the block's
size, under a directory of the rank's own). A snapshot is the single
process's file whatever the width that writes it: every rank's written rows
are gathered to rank 0, which writes them; a rank loading one keeps its
block's rows.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["ClientStore", "STORE_MODES", "write_snapshot"]

#: residency modes below "device" (device = no store at all)
STORE_MODES = ("host", "disk")

#: torch dtypes numpy has no type for, kept as their bit patterns
_BITS = {torch.bfloat16: np.int16}


def _to_np(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype in _BITS:
        t = t.view(torch.int16)
    return t.numpy()


class _Field:
    """One registered per-client field: a default row plus the rows
    written (a host dict in ``host`` mode; an LRU-capped hot dict over one
    ``np.memmap`` per leaf in ``disk`` mode)."""

    def __init__(self, name: str, template: Dict[str, torch.Tensor],
                 num_clients: int, mode: str, hot_clients: int,
                 root: Optional[str]):
        self.name = name
        self.keys = list(template)
        self.dtypes = [template[k].dtype for k in self.keys]
        self.leaf_templates = [_to_np(template[k]) for k in self.keys]
        self.num_clients = num_clients
        self.mode = mode
        self.hot_clients = max(1, int(hot_clients))
        #: host rows: every written one (host mode) or the hot LRU (disk
        #: mode), id -> list of numpy leaves
        self.rows: "OrderedDict[int, List[np.ndarray]]" = OrderedDict()
        self.materialized = np.zeros(num_clients, dtype=bool)
        self.mmaps: List[np.memmap] = []
        if mode == "disk":
            if root is None:
                raise ValueError(
                    "ClientStore(mode='disk') needs a root directory "
                    "for the per-leaf memmap files")
            os.makedirs(root, exist_ok=True)
            for i, leaf in enumerate(self.leaf_templates):
                self.mmaps.append(np.memmap(
                    os.path.join(root, f"{name}_leaf{i}.mmap"),
                    dtype=leaf.dtype, mode="w+",
                    shape=(num_clients,) + leaf.shape))

    def default_row(self) -> List[np.ndarray]:
        # a fresh copy per synthesis: callers may mutate rows in place
        return [t.copy() for t in self.leaf_templates]

    def read_row(self, cid: int) -> Tuple[List[np.ndarray], bool]:
        """(leaves, host_hit); a row never written is a copy of the
        default, which stores nothing."""
        row = self.rows.get(cid)
        if row is not None:
            if self.mode == "disk":  # LRU touch
                self.rows.move_to_end(cid)
            return row, True
        if self.mode == "disk" and self.materialized[cid]:
            return [np.array(mm[cid]) for mm in self.mmaps], False
        return self.default_row(), False

    def write_row(self, cid: int, leaves: List[np.ndarray]) -> None:
        self.materialized[cid] = True
        self.rows[cid] = leaves
        if self.mode == "host":
            return
        self.rows.move_to_end(cid)
        while len(self.rows) > self.hot_clients:
            old_id, old_leaves = self.rows.popitem(last=False)
            for mm, leaf in zip(self.mmaps, old_leaves):
                mm[old_id] = leaf

    def flush_hot(self) -> None:
        """Disk mode: every hot row spilled to its memmap (a snapshot reads
        the bytes from one place)."""
        for cid, leaves in self.rows.items():
            for mm, leaf in zip(self.mmaps, leaves):
                mm[cid] = leaf

    def row_bytes(self) -> int:
        return sum(int(t.nbytes) for t in self.leaf_templates)

    def disk_bytes(self) -> int:
        return sum(int(mm.nbytes) for mm in self.mmaps)


class ClientStore:
    """Per-client state in host memory or on disk, keyed by client id.

    One store serves every registered field (``personal_params``,
    ``agg_residual``) alike: rows move card -> host through stage / commit
    and host -> card through ``gather``."""

    def __init__(self, num_clients: int, mode: str = "host",
                 hot_clients: int = 64, root: Optional[str] = None,
                 mesh=None):
        if mode not in STORE_MODES:
            raise ValueError(
                f"client store mode {mode!r} not in {STORE_MODES} "
                "(mode 'device' means: no store)")
        if num_clients < 1:
            raise ValueError("ClientStore needs num_clients >= 1")
        #: the population's size; this store holds the rows of the clients
        #: ``[lo, hi)`` (all of them off a mesh)
        self.num_clients = int(num_clients)
        self.mesh = mesh
        self.lo, self.hi = ((0, self.num_clients) if mesh is None
                            else mesh.block(self.num_clients))
        self.mode = mode
        self.hot_clients = int(hot_clients)
        self._root = root
        if mode == "disk" and root is None:
            self._root = tempfile.mkdtemp(prefix="client_store_")
        elif mode == "disk" and mesh is not None:
            # a directory of the rank's own: the block's memmaps
            self._root = os.path.join(root, f"rank{mesh.rank}")
        self._fields: Dict[str, _Field] = {}
        #: staged (uncommitted) round outputs: (name, ids, slab), the slab's
        #: tensors possibly still on the card
        self._staged: List[Tuple[str, np.ndarray, Dict[str, Any]]] = []
        #: prefetched committed rows: name -> {id: leaves}
        self._prefetched: Dict[str, Dict[int, List[np.ndarray]]] = {}
        self.hits = 0
        self.misses = 0
        self.prefetched_rows = 0
        self.gather_ms = 0.0

    # -- registration -------------------------------------------------------
    def register(self, name: str, template: Dict[str, torch.Tensor]) -> None:
        """Field ``name`` with its default row ``template`` (the initial
        parameters for the personal stack, zeros for the top-k residual): a
        row never written reads as a byte copy of it and stores nothing.
        Registering again resets the field (a fresh ``init_state``)."""
        self._fields[name] = _Field(
            name, template, self.hi - self.lo, self.mode,
            self.hot_clients, self._root)
        self._prefetched.pop(name, None)
        self._staged = [s for s in self._staged if s[0] != name]

    def has_field(self, name: str) -> bool:
        return name in self._fields

    def field_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._fields))

    def _field(self, name: str) -> _Field:
        f = self._fields.get(name)
        if f is None:
            raise KeyError(
                f"client store has no field {name!r} (registered: "
                f"{self.field_names()}) — init_state registers fields "
                "before the first round")
        return f

    def _local(self, cid) -> int:
        """Population id ``cid``'s row in this store's block."""
        cid = int(cid)
        if not self.lo <= cid < self.hi:
            raise ValueError(
                f"client {cid} is not in this store's block "
                f"[{self.lo}, {self.hi}) of the population")
        return cid - self.lo

    # -- the staging protocol -----------------------------------------------
    def stage(self, name: str, ids: Sequence[int],
              slab: Dict[str, torch.Tensor]) -> None:
        """Park a round's output rows (``slab``: a tree whose leaves lead
        with ``len(ids)`` rows) unread: :meth:`commit` writes them,
        :meth:`discard` (the watchdog's rollback) drops them."""
        self._field(name)  # fail fast on an unknown field
        for cid in ids:  # ... and on another rank's client
            self._local(cid)
        self._staged.append((name, np.asarray(ids), slab))

    def commit(self) -> None:
        """Staged slabs written into storage (one copy to the host per
        leaf; a later stage of the same id wins, in round order)."""
        staged, self._staged = self._staged, []
        for name, ids, slab in staged:
            field = self._field(name)
            host = [_to_np(slab[k]) for k in field.keys]
            pre = self._prefetched.get(name)
            for pos, cid in enumerate(ids):
                cid = int(cid)
                if pre is not None:  # a staged row outdates a prefetch
                    pre.pop(cid, None)
                field.write_row(self._local(cid),
                                [np.array(h[pos]) for h in host])

    def discard(self) -> None:
        """Staged slabs dropped unread (the watchdog's RETRY and SKIP: a
        rolled-back round's rows never reach host memory or disk)."""
        self._staged = []

    def dirty_ids(self) -> np.ndarray:
        """Ids with staged (uncommitted) rows."""
        if not self._staged:
            return np.zeros((0,), np.int64)
        return np.unique(np.concatenate(
            [np.asarray(ids, np.int64) for _, ids, _ in self._staged]))

    # -- reads --------------------------------------------------------------
    def gather(self, name: str, ids: Sequence[int],
               device=None) -> Dict[str, torch.Tensor]:
        """The rows ``ids`` stacked, ``[len(ids), ...]`` a leaf (staged rows
        committed first, so a read sees the newest adopted rows): CPU
        tensors, or on ``device`` through a pinned host buffer and a copy
        that does not wait on the card."""
        t0 = time.perf_counter()
        self.commit()
        field = self._field(name)
        pre = self._prefetched.get(name)
        dev = torch.device(device) if device is not None else None
        pin = dev is not None and dev.type == "cuda"
        out = [torch.empty((len(ids),) + t.shape, dtype=dt, pin_memory=pin)
               for t, dt in zip(field.leaf_templates, field.dtypes)]
        views = [o.view(torch.int16).numpy() if dt in _BITS else o.numpy()
                 for o, dt in zip(out, field.dtypes)]
        for pos, cid in enumerate(ids):
            cid = int(cid)
            row = pre.pop(cid, None) if pre is not None else None
            if row is not None:
                self.hits += 1
            else:
                row, host_hit = field.read_row(self._local(cid))
                if host_hit:
                    self.hits += 1
                else:
                    self.misses += 1
            for v, leaf in zip(views, row):
                v[pos] = leaf
        if dev is not None:
            out = [o.to(dev, non_blocking=pin) for o in out]
        self.gather_ms += (time.perf_counter() - t0) * 1e3
        return dict(zip(field.keys, out))

    def gather_all(self, name: str, device=None) -> Dict[str, torch.Tensor]:
        """The whole ``[C, ...]`` stack (a test's check); on a mesh the
        rank's block, ``[hi - lo, ...]``."""
        return self.gather(name, np.arange(self.lo, self.hi), device)

    def prefetch(self, name: str, ids: Sequence[int]) -> None:
        """Warm the host row cache for ``ids`` off the gather's clock (the
        next cohort's rows, read while the card runs this round). Only
        committed rows are prefetched; a newer staged row outdates its
        entry at commit."""
        if not self.has_field(name):
            return
        field = self._field(name)
        staged_ids = set(int(i) for i in self.dirty_ids())
        pre = self._prefetched.setdefault(name, {})
        for cid in ids:
            cid = int(cid)
            if cid in pre or cid in staged_ids:
                continue
            row, _ = field.read_row(self._local(cid))
            pre[cid] = row
            self.prefetched_rows += 1

    # -- counters -----------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        """The store's counters: the host cache's bytes (hot rows and
        prefetched ones), the disk files' bytes, hits, misses, prefetched
        rows and the cumulative ``store_gather_ms``."""
        host_bytes = sum(f.row_bytes() * len(f.rows)
                         for f in self._fields.values())
        pre_bytes = sum(self._fields[n].row_bytes() * len(rows)
                        for n, rows in self._prefetched.items()
                        if n in self._fields)
        return {
            "mem_host_cache_bytes": float(host_bytes + pre_bytes),
            "mem_store_disk_bytes": float(sum(
                f.disk_bytes() for f in self._fields.values())),
            "mem_store_hits": float(self.hits),
            "mem_store_misses": float(self.misses),
            "mem_store_prefetched": float(self.prefetched_rows),
            "store_gather_ms": float(self.gather_ms),
        }

    # -- checkpoint lineage -------------------------------------------------
    def snapshot(self) -> Optional[Dict[str, np.ndarray]]:
        """The arrays of a snapshot (:meth:`snapshot_save`): every written
        row of every field, by population id, and a manifest (the
        population size, the fields' layouts). Rows never written are not
        stored: the restoring side makes them from its own registered
        defaults, which ``init_state`` reproduces bit for bit. Staged rows
        are committed first. On a mesh every rank calls it (one gather of
        the ids and one of each leaf's rows, as bytes); rank 0 receives the
        population's arrays, in the layout a single process writes, and the
        other ranks None."""
        self.commit()
        arrays: Dict[str, np.ndarray] = {}
        manifest: Dict[str, Any] = {"num_clients": self.num_clients,
                                    "fields": {}}
        for name, field in self._fields.items():
            field.flush_hot()
            ids = np.nonzero(field.materialized)[0]
            leaves = []
            for li, t in enumerate(field.leaf_templates):
                if not ids.size:
                    rows = np.empty((0,) + t.shape, t.dtype)
                elif field.mode == "disk":
                    rows = np.asarray(field.mmaps[li][ids])
                else:
                    rows = np.stack([field.rows[int(i)][li] for i in ids])
                leaves.append(rows)
            ids = ids.astype(np.int64) + self.lo
            if self.mesh is not None:
                ids, leaves = self._gather_written(ids, leaves)
                if ids is None:
                    continue
            manifest["fields"][name] = {"n_leaves": len(field.keys),
                                        "n_rows": int(ids.size)}
            arrays[f"{name}::ids"] = ids
            for li, rows in enumerate(leaves):
                arrays[f"{name}::leaf{li}"] = rows
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        arrays["__manifest__"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        return arrays

    def _gather_written(self, ids: np.ndarray, leaves: List[np.ndarray]):
        """One field's written rows of every rank (``ids`` and ``leaves``
        here this rank's), in rank order, which is population order: on
        rank 0 ``(ids, leaves)``, elsewhere ``(None, None)``. Each rank's
        rows travel padded to the largest count (``mesh.gather_rows``)."""
        from ..parallel.mesh import gather_index, gather_rows

        mesh = self.mesh
        dev = mesh.device
        counts = [int(n) for n in mesh.all_gather(torch.tensor(
            [ids.size], dtype=torch.int64, device=dev)).reshape(-1)]
        order = [(d, r) for d, n in enumerate(counts) for r in range(n)]
        idx = gather_index(counts, order).to(dev)

        def gather(a: np.ndarray) -> np.ndarray:
            # as bytes: every dtype (a bfloat16 leaf's int16 pattern too)
            # on every backend
            b = np.ascontiguousarray(a).reshape(
                a.shape[0], int(np.prod(a.shape[1:], dtype=np.int64))
            ).view(np.uint8)
            out = gather_rows(mesh, torch.from_numpy(b).to(dev), counts, idx)
            return out.cpu().numpy().view(a.dtype).reshape(
                (-1,) + a.shape[1:])

        if not sum(counts):
            return ((ids, leaves) if mesh.rank == 0 else (None, None))
        ids_all = gather(ids)
        leaves_all = [gather(a) for a in leaves]
        if mesh.rank != 0:
            return None, None
        return ids_all, leaves_all

    def snapshot_save(self, path: str) -> None:
        """One npz file of :meth:`snapshot`'s arrays, written to a
        temporary name, then moved into place. On a mesh every rank calls
        it and rank 0 writes."""
        arrays = self.snapshot()
        if arrays is not None:
            write_snapshot(path, arrays)

    def snapshot_load(self, path: str) -> None:
        """This store's rows replaced by a snapshot's (on a mesh, the
        snapshot's rows of the rank's block, whatever the width that wrote
        it). The fields must be registered already (``init_state`` ran):
        the snapshot carries rows, not layouts, and another field set, or
        another population size, is refused."""
        with np.load(path) as z:
            manifest = json.loads(bytes(z["__manifest__"]).decode())
            snap_fields = set(manifest["fields"])
            if snap_fields != set(self._fields):
                raise RuntimeError(
                    f"client-store snapshot {path} carries fields "
                    f"{sorted(snap_fields)} but this run registered "
                    f"{list(self.field_names())} — the lineage was "
                    "written under different flags (track_personal / "
                    "agg_impl)")
            if int(manifest["num_clients"]) != self.num_clients:
                raise RuntimeError(
                    f"client-store snapshot {path} was written for "
                    f"C={manifest['num_clients']}, this run has "
                    f"C={self.num_clients}")
            self._staged = []
            self._prefetched = {}
            for name, field in self._fields.items():
                # reset to all-default, then write the snapshot's rows
                field.rows = OrderedDict()
                field.materialized[:] = False
                ids = z[f"{name}::ids"]
                mine = np.nonzero((ids >= self.lo) & (ids < self.hi))[0]
                leaves = [z[f"{name}::leaf{li}"]
                          for li in range(len(field.keys))]
                for pos in mine:
                    field.write_row(int(ids[pos]) - self.lo,
                                    [np.array(lf[pos]) for lf in leaves])


def write_snapshot(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """A snapshot's arrays (:meth:`ClientStore.snapshot`) as one npz file,
    written to a temporary name, then moved into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
