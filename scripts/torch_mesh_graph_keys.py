#!/usr/bin/env python3
"""How often a fused block on a client mesh captures a new round graph, for
the PyTorch/CUDA port, at partial participation.

    python3 scripts/torch_mesh_graph_keys.py [--clients 8] [--frac 0.5]
        [--rounds 100] [--block 10] [--ranks 2 4 8]

A round graph of ``FedAlgorithm.run_rounds_fused`` on a client mesh is keyed
by the step counts and by how the ranks hold the round's draw
(``MeshRows.counts`` and ``order``, ``FedAlgorithm._graph_key``); the loop
keeps ``FUSED_MAX_GRAPHS`` of them, the least recently replayed released
first. Every rank computes the same keys from the same host draws. This
script makes those keys for rounds ``0 .. --rounds - 1`` with the port's
own client draw and mesh rows (FedAvg on ``--clients`` clients of equal
shards, ``bench.py``'s 40 rows each, so the step counts never differ), on
a mesh of each width of ``--ranks`` that divides the cohort (rank 0's view:
no process group is made, the draws are host work), replays the graph
cache over blocks of ``--block`` rounds, and prints one JSON line per
width: the distinct keys, the captures (a round whose key is not cached)
and their share of the rounds. Runs on the CPU; it measures no time.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def graph_keys(n_clients: int, frac: float, ranks: int, rounds: int):
    """The round-graph key of each round, on rank 0 of a ``ranks``-rank
    mesh."""
    import torch

    from neuroimagedisttraining_torch.algorithms import FedAvg
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.parallel.mesh import (
        ClientMesh,
        shard_federated,
    )

    data = device_synthetic_federated(
        n_clients, 40, (4, 4, 4, 1), torch.Generator().manual_seed(0),
        dtype=torch.float32)
    mesh = ClientMesh(None, 0, ranks, torch.device("cpu"))
    hp = HyperParams(lr=1e-3, local_epochs=1, steps_per_epoch=5,
                     batch_size=8)
    algo = FedAvg(create_model("small3dcnn", num_classes=1),
                  shard_federated(data, mesh), hp, loss_type="bce",
                  frac=frac, seed=0, device="cpu")
    keys = []
    for r in range(rounds):
        sel = algo._selected_client_indexes(r)
        mr = algo._mesh_rows(sel, False, r)
        n_valid = [algo._n_train[int(c)] for c in sel]
        # FedAlgorithm._graph_key of the round
        keys.append(algo._step_key(n_valid)
                    + ((tuple(mr.counts), tuple(mr.order)),))
    return keys


def captures(keys, block: int, cached: int) -> int:
    """Rounds whose key is not in the least-recently-used cache of
    ``cached`` graphs, which lives across blocks as the fused loop's
    does."""
    cache, n = [], 0
    for start in range(0, len(keys), block):
        for k in keys[start:start + block]:
            if k in cache:
                cache.remove(k)
            else:
                n += 1
                if len(cache) >= cached:
                    cache.pop(0)
            cache.append(k)
    return n


def main() -> int:
    from neuroimagedisttraining_torch.algorithms.base import FUSED_MAX_GRAPHS

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--frac", type=float, default=0.5)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--block", type=int, default=10)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args()
    for d in args.ranks:
        if args.clients % d:
            continue
        keys = graph_keys(args.clients, args.frac, d, args.rounds)
        n = captures(keys, args.block, FUSED_MAX_GRAPHS)
        print(json.dumps({
            "clients": args.clients, "frac": args.frac, "ranks": d,
            "rounds": args.rounds, "block": args.block,
            "cached_graphs": FUSED_MAX_GRAPHS,
            "distinct_keys": len(set(keys)), "captures": n,
            "capture_share": n / args.rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
