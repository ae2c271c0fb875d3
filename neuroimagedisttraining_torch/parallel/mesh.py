"""The client mesh: one process per device in a ``torch.distributed``
process group (counterpart of ``neuroimagedisttraining_tpu/parallel/
mesh.py``).

The reference lays per-client values out over a ``clients`` mesh axis and
lets XLA lower the aggregate to collectives. Here each rank is a process
that holds its contiguous block of the client axis, the layout of the
reference's ``P("clients")``: rank ``d`` of ``D`` holds clients ``[d*C/D,
(d+1)*C/D)``. The collectives of ``parallel/collectives.py`` run over the
mesh's process group: NCCL on the card, gloo on the CPU.

Only the ``clients`` axis is ported; the ``space`` axis and the multi-host
substrate (``parallel/multihost.py``) are not.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS = "clients"


@dataclasses.dataclass(eq=False)
class ClientMesh:
    """This rank's view of the client mesh: the process group, its ``rank``
    among ``size`` ranks, the device its tensors live on and the axis name.
    The hierarchical reduce's sub-groups are made once per slice width and
    kept here (:meth:`hier_groups`)."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_names: Tuple[str, ...] = (AXIS,)
    _hier: Dict[int, Tuple[Any, Any]] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def shape(self) -> Dict[str, int]:
        return {AXIS: self.size}

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def block(self, n: int) -> Tuple[int, int]:
        """``[lo, hi)``: this rank's rows of an ``n``-row client axis."""
        if n % self.size:
            raise ValueError(
                f"a client axis of {n} rows does not divide over the "
                f"{self.size}-rank mesh")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    def all_reduce(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``x`` summed over the ranks of ``group`` (the mesh by default),
        in place. Every rank receives the same bits."""
        dist.all_reduce(x, group=self.group if group is None else group)
        return x

    def all_gather(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """``[n, *x.shape]``: ``x`` of each of the ``n`` ranks of ``group``
        (the mesh by default) in rank order. A bf16 payload travels as its
        bytes, bit for bit on every backend. NCCL gathers into one
        contiguous buffer; gloo, whose CUDA path takes only the list form,
        into one tensor a rank."""
        group = self.group if group is None else group
        n = dist.get_world_size(group)
        x = x.contiguous()
        wire = x.view(torch.uint8) if x.dtype == torch.bfloat16 else x
        if dist.get_backend(group) == "nccl":
            out = torch.empty((n,) + tuple(wire.shape), dtype=wire.dtype,
                              device=wire.device)
            dist.all_gather_into_tensor(out, wire, group=group)
        else:
            parts = [torch.empty_like(wire) for _ in range(n)]
            dist.all_gather(parts, wire, group=group)
            out = torch.stack(parts)
        return out.view(x.dtype) if wire is not x else out

    def hier_groups(self, inner: int) -> Tuple[Any, Any]:
        """This rank's (intra-slice, inter-slice) groups of the hierarchical
        reduce with ``inner`` ranks a slice (``collectives.
        _hier_index_groups``). Every rank makes every group, in one order,
        on the first use of each ``inner``; later uses reuse them."""
        if inner not in self._hier:
            from .collectives import _hier_index_groups

            intra, inter = _hier_index_groups(self.size, inner)
            mine = {}
            for kind, groups in (("intra", intra), ("inter", inter)):
                for ranks in groups:
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine[kind] = g
            self._hier[inner] = (mine["intra"], mine["inter"])
        return self._hier[inner]

    def destroy(self) -> None:
        """Tear down the process group (every rank, at the end of a run)."""
        self._hier.clear()
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_client_devices: int, *, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              device=None, timeout=None) -> ClientMesh:
    """Join (or adopt) the ``n_client_devices``-rank process group and
    return this rank's :class:`ClientMesh`.

    ``device`` defaults to ``cuda:<rank mod card count>`` where CUDA is
    present, else the CPU; ``backend`` to NCCL for a CUDA device and gloo
    for the CPU (gloo also runs CUDA tensors, staged through the host).
    ``init_method`` is the rendezvous (``tcp://localhost:<port>`` or
    ``file://<path>``; the default reads ``MASTER_ADDR``/``MASTER_PORT``),
    ``rank`` this process's rank (default: ``RANK`` from the environment),
    ``timeout`` (a ``timedelta``) how long a collective may wait (default:
    the backend's). A process whose default group is already initialized
    adopts it."""
    def device_of(r):
        if device is not None:
            return torch.device(device)
        return torch.device(f"cuda:{r % torch.cuda.device_count()}"
                            if torch.cuda.is_available() else "cpu")

    if not dist.is_initialized():
        rank = int(os.environ["RANK"]) if rank is None else rank
        if backend is None:
            backend = "nccl" if device_of(rank).type == "cuda" else "gloo"
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=n_client_devices, **kw)
    group = dist.group.WORLD
    size = dist.get_world_size(group)
    if size != n_client_devices:
        raise ValueError(f"the process group has {size} ranks, the mesh "
                         f"asks for {n_client_devices}")
    rank = dist.get_rank(group)
    return ClientMesh(group, rank, size, device_of(rank))


def fit_client_devices(n_clients: int, available: int) -> int:
    """Largest device count <= available that divides ``n_clients`` (the
    clients mesh axis must divide the client count)."""
    n = min(max(1, available), max(1, n_clients))
    while n_clients % n:
        n -= 1
    return n


def mesh_of(obj: Any) -> Optional[ClientMesh]:
    """The :class:`ClientMesh` a sharded object records
    (:func:`shard_federated`), None when it is not sharded."""
    mesh = getattr(obj, "mesh", None)
    return mesh if isinstance(mesh, ClientMesh) else None


def shard_over_clients(tree: Dict[str, torch.Tensor], mesh: ClientMesh
                       ) -> Dict[str, torch.Tensor]:
    """This rank's block of a tree whose leaves have a leading client axis,
    as fresh tensors on the mesh's device (nothing of the other blocks is
    kept)."""
    out = {}
    for k, v in tree.items():
        lo, hi = mesh.block(v.shape[0])
        out[k] = v[lo:hi].to(mesh.device).clone()
    return out


def shard_federated(data, mesh: ClientMesh):
    """``data`` (a ``FederatedData``) as this rank holds it: the train,
    test and validation arrays cut to its block of clients and moved to the
    mesh's device, the per-client counts whole (every rank's host loop
    reads every client's count), and the mesh recorded (:func:`mesh_of`)."""
    def cut(x, to_device=True):
        if x is None:
            return None
        lo, hi = mesh.block(x.shape[0])
        x = x[lo:hi]
        return (x.to(mesh.device) if to_device else x).clone()

    return dataclasses.replace(
        data, x_train=cut(data.x_train), y_train=cut(data.y_train),
        x_test=cut(data.x_test), y_test=cut(data.y_test),
        # the validation split stays on the CPU, as unsharded
        x_val=cut(data.x_val, False), y_val=cut(data.y_val, False),
        mesh=mesh)


def replicate(tree: Dict[str, torch.Tensor], mesh: ClientMesh
              ) -> Dict[str, torch.Tensor]:
    """Rank 0's tree on every rank (e.g. the global model), on the mesh's
    device."""
    out = {}
    for k, v in tree.items():
        t = v.to(mesh.device).contiguous().clone()
        dist.broadcast(t, src=0, group=mesh.group)
        out[k] = t
    return out


def gather_rows(mesh: ClientMesh, rows: torch.Tensor, counts: Sequence[int],
                order: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Rows held by different ranks, in one ``all_gather``: rank ``d``
    holds ``counts[d]`` rows (``rows`` here, ``[counts[rank], ...]``),
    padded to the largest count for the gather; ``order`` lists
    ``(rank, row)`` of each output row."""
    width = max(counts)
    pad = torch.zeros((width,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    if rows.shape[0]:
        pad[:rows.shape[0]] = rows
    full = mesh.all_gather(pad)
    idx = torch.tensor([d * width + r for d, r in order], dtype=torch.int64,
                       device=full.device)
    return full.reshape((-1,) + tuple(rows.shape[1:])).index_select(0, idx)


__all__: List[str] = [
    "AXIS", "ClientMesh", "fit_client_devices", "gather_rows", "make_mesh",
    "mesh_of", "replicate", "shard_federated", "shard_over_clients",
]
