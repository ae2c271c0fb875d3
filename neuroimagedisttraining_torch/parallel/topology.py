"""Per-round neighbor adjacency of the decentralized algorithms (the part of
``neuroimagedisttraining_tpu/parallel/topology.py`` DisPFL and DPSGD use).

The reference module imports no JAX; this is this package's own copy of
its ``neighbor_adjacency``, host numpy, so the two make the same matrix
bit for bit (tests/test_torch_port_personal.py holds them to it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def neighbor_adjacency(
    round_idx: int,
    n_clients: int,
    n_per_round: int,
    mode: str = "random",
    active: Optional[np.ndarray] = None,
    seed_with_round: bool = True,
) -> np.ndarray:
    """Per-round 0/1 neighbor matrix, ``A[i, j] = 1`` iff client i
    aggregates client j (the original's ``_benefit_choose``):

    * ``random``: each client draws ``n_per_round`` others uniformly
      without replacement, excluding itself, then appends itself;
    * ``ring``: its left and right neighbors and itself;
    * ``full`` (and any mode at full participation): every active client.

    An inactive client (``active[i] == 0``) gets an empty row. The draws
    come from ``np.random.RandomState(round_idx)``."""
    if active is None:
        active = np.ones(n_clients, dtype=np.int64)
    rng = np.random.RandomState(round_idx if seed_with_round else None)
    a = np.zeros((n_clients, n_clients), dtype=np.float32)
    full_participation = n_per_round >= n_clients
    for i in range(n_clients):
        if active[i] == 0:
            continue
        if mode == "full" or full_participation:
            idx = np.where(active == 1)[0]
        elif mode == "ring":
            idx = np.array([(i - 1) % n_clients, (i + 1) % n_clients, i])
        elif mode == "random":
            others = np.delete(np.arange(n_clients), i)
            idx = rng.choice(others, min(n_per_round, n_clients - 1),
                             replace=False)
            idx = np.append(idx, i)
        else:
            raise ValueError(f"unknown neighbor mode {mode!r}")
        a[i, idx] = 1.0
    return a
