"""Aggregation across clients (counterpart of
``neuroimagedisttraining_tpu/parallel/``): the client mesh over
``torch.distributed`` (``mesh.py``), the aggregation wires on and off the
mesh (``collectives.py``), and the decentralized algorithms' per-round
neighbor adjacency (``topology.py``). The multi-host substrate, the spatial
axis and the gossip ring are not ported."""
from .collectives import (
    build_sparse_plan,
    masked_weighted_mean,
    sparse_weighted_mean,
    weighted_mean,
)
from .mesh import make_mesh, mesh_of, replicate, shard_over_clients

__all__ = [
    "build_sparse_plan",
    "masked_weighted_mean",
    "sparse_weighted_mean",
    "weighted_mean",
    "make_mesh",
    "mesh_of",
    "shard_over_clients",
    "replicate",
]
