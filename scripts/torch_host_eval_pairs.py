#!/usr/bin/env python3
"""What a host-side incremental personal eval would save in the eager loop,
for the PyTorch/CUDA port, against the full pass it would replace.

    python3 scripts/torch_host_eval_pairs.py [--pairs 10] [--rounds 6]
        [--frac 0.5]

The JAX package's eager ``evaluate`` keeps each client's personal-eval
terms on the host between evals and re-evaluates only the clients trained
since (valid for the personal tree its own rounds produced). The port has
no such cache: ``evaluate`` makes a full pass (or, with ``eval_cache``,
re-reduces the terms the round body keeps in the state). This script
carries that host cache itself (:class:`HostCache`), patched into one
algorithm's personal eval, to measure what it saves.

On ``bench_torch.py``'s workload (SalientGrads on ``3dcnn_s2d``, 8 clients
x 40 phased 121x145x121 bf16 volumes made on the card, test shards of 10,
batch 8, 5 local steps, bf16 compute, dropout 0.5, SNIP 0.5) at ``--frac``
participation: the SNIP mask once, then ``--pairs`` interleaved pairs (the
order alternating), each of two spellings of the same eager rounds from a
clone of that one state, with the eval after every round:

* ``host``: ``evaluate`` with the host cache (:class:`HostCache`);
* ``full``: ``evaluate`` as the port has it, the full personal pass.

Each spelling runs one warm round and eval (the host spelling's full pass
that seeds its cache), then ``--rounds`` timed rounds, each eval's metrics
fetched one round late as ``bench_torch.timed_rounds`` does. The two
spellings' eval values must be equal bit for bit. Prints one JSON line:
rounds/s of each spelling per pair, the per-pair ratio host over full, the
medians, the stem forwards per timed eval of each spelling (the personal
forwards the cache skips), and the card's name and power limit. Needs one
GPU; without CUDA it exits 2 before printing a result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class HostCache:
    """The host-side incremental personal eval, for one algorithm: the
    per-client terms ``(correct, loss_sum, total)`` of the last personal
    tree evaluated, and the clients trained since (:meth:`note`). The eval
    of that tree's successor re-evaluates those clients only and writes
    their terms into the kept ones; any other tree gets a full pass. Each
    client's terms come from the same ``eval_client`` call as in the full
    pass, so the result is the same bit for bit."""

    def __init__(self, algo):
        self.algo, self.terms, self.tree, self.dirty = algo, None, None, set()

    def note(self, old, new, round_idx: int) -> None:
        """``new`` is a round's output from ``old``."""
        if self.tree is not old:
            self.terms = None
        self.dirty |= {int(c) for c in
                       self.algo._selected_client_indexes(round_idx)}
        self.tree = new

    def personal(self, state):
        from neuroimagedisttraining_torch.algorithms.base import (
            _personal_metrics,
            _to_device,
        )

        algo, pers = self.algo, state.personal_params
        if self.terms is None or pers is not self.tree:
            ev = algo._eval_personal(pers)
        else:
            rows = sorted(self.dirty)
            c_s, l_s = algo._eval_terms(
                rows, lambda c: {k: v[c] for k, v in pers.items()})
            idx = _to_device(np.asarray(rows, np.int64), algo.device)
            correct, loss_sum, total = self.terms
            ev = _personal_metrics(correct.index_copy(0, idx, c_s),
                                   loss_sum.index_copy(0, idx, l_s), total)
        self.terms = (ev["correct"], ev["loss_sum"], ev["total"])
        self.tree, self.dirty = pers, set()
        return ev


def _values(ev):
    return {k: float(v) for k, v in ev.items() if not k.startswith("acc_per")}


def spelling(algo, state, cache, rounds: int):
    """Rounds/s of ``rounds`` eager rounds with ``algo.evaluate`` after each
    (after one warm round and eval), each eval fetched one round late,
    through ``cache`` (a :class:`HostCache` patched in) or the full pass
    (None); the evals' values and the stem forwards of the timed evals."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    if cache is None:
        algo.__dict__.pop("_eval_personal_state", None)
    else:
        algo._eval_personal_state = cache.personal

    def round_(state, r):
        new, _ = algo.run_round(state, r)
        if cache is not None:
            cache.note(state.personal_params, new.personal_params, r)
        return new

    state = round_(state, 0)
    _values(algo.evaluate(state))
    torch.cuda.synchronize()
    evals, fwd, prev = [], 0, None
    t0 = time.perf_counter()
    for r in range(1, rounds + 1):
        state = round_(state, r)
        if prev is not None:
            evals.append(_values(prev))
        before = kernels.LAUNCHES["stem_fwd"]
        prev = algo.evaluate(state)
        fwd += kernels.LAUNCHES["stem_fwd"] - before
    evals.append(_values(prev))
    torch.cuda.synchronize()
    return rounds / (time.perf_counter() - t0), evals, fwd / rounds


def main() -> int:
    import torch

    from bench_torch import (
        BATCH,
        N_CLIENTS,
        SAMPLES_PER_CLIENT,
        STEPS,
        VOLUME,
        card_name_and_power_limit,
    )
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--frac", type=float, default=0.5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_host_eval_pairs: CUDA is not available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kernels.build()
    ss = phased_sample_shape(VOLUME)
    data = device_synthetic_federated(
        N_CLIENTS, SAMPLES_PER_CLIENT, ss,
        torch.Generator(device=dev).manual_seed(0), test_per_client=10)
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    algo = SalientGrads(
        create_model("3dcnn_s2d", num_classes=1, sample_shape=ss), data, hp,
        loss_type="bce", frac=args.frac, seed=0, dense_ratio=0.5,
        itersnip_iterations=1, compute_dtype="bfloat16")
    state = algo.init_state()
    pairs, fwd, evals = [], {}, {}
    for i in range(args.pairs):
        order = ("host", "full") if i % 2 == 0 else ("full", "host")
        rates = {}
        for name in order:
            cache = HostCache(algo) if name == "host" else None
            rates[name], evals[name], fwd[name] = spelling(
                algo, algo.clone_state(state), cache, args.rounds)
        if evals["host"] != evals["full"]:
            print(f"torch_host_eval_pairs: pair {i}: the host cache's eval "
                  f"{evals['host']} differs from the full pass's "
                  f"{evals['full']}", file=sys.stderr)
            return 1
        pairs.append(rates)
    ratios = [p["host"] / p["full"] for p in pairs]
    print(json.dumps({
        "frac": args.frac, "clients": N_CLIENTS,
        "clients_per_round": algo.clients_per_round,
        "rounds_per_spelling": args.rounds, "pairs": pairs,
        "ratio_host_over_full": ratios,
        "median_rounds_per_sec": {k: statistics.median(
            p[k] for p in pairs) for k in ("host", "full")},
        "median_ratio": statistics.median(ratios),
        "pairs_host_faster": sum(r > 1 for r in ratios),
        "stem_fwd_per_eval": fwd,
        "device": card_name_and_power_limit(),
        "torch": torch.__version__, "cuda": torch.version.cuda}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
