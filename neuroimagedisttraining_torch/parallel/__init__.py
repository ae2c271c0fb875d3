"""Aggregation across clients (counterpart of
``neuroimagedisttraining_tpu/parallel/``): the off-mesh halves of
``collectives.py``. The multi-GPU reduce over NCCL is a later slice."""
