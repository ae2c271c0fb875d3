"""Aggregation across clients (counterpart of
``neuroimagedisttraining_tpu/parallel/``): the off-mesh halves of
``collectives.py``, and the decentralized algorithms' per-round neighbor
adjacency (``topology.py``). The multi-GPU reduce over NCCL is a later
slice."""
