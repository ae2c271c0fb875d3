#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: federated rounds/s on the headline
workload, on one NVIDIA GPU.

    python3 bench_torch.py

The port of ``bench.py``'s main workload, at its constants: SalientGrads on
``3dcnn_s2d`` (AlexNet3D over phase-decomposed volumes), 8 clients x 40
phased 121x145x121 bf16 volumes made on the card, batch 8, 5 local steps,
``dense_ratio`` 0.5, bf16 compute, SGD with momentum 0.9, weight decay 5e-4
and clip 10. The SNIP mask is built once; then, each from a clone of that
one state (``FedAlgorithm.clone_state``):

* the Python loop: one warm round and 10 timed rounds with no eval
  (``extra.rounds_per_sec_python_loop``); one warm round and eval, then 8
  timed rounds with the full eval protocol (global and personal models on
  every client's test shard) after every round, each eval's metric fetched
  one round late (``extra.rounds_per_sec_eval_every_1_python_loop``);
* the fused spelling (``FedAlgorithm.run_rounds_fused``: each round one
  replay of a captured CUDA graph, the block's metrics fetched once): a
  block of rounds 10..19 with no eval (``extra.rounds_per_sec_fused``) and
  of rounds 8..15 with the eval every round
  (``extra.rounds_per_sec_eval_every_1_fused``), each timed after
  FUSED_WARM_CALLS runs of the same call (the first captures the graphs).

Then ``bench.py``'s two other eval cells, each the better of the same two
spellings with the eval every round (8 rounds; the loop after a warm round
and eval, the fused block after its warm calls), each on an algorithm of
its own from its own ``init_state``:

* ``extra.rounds_per_sec_eval_every_1_eval_cache``: ``eval_cache=True``,
  the personal eval's per-client terms refreshed inside each round (at
  full participation every client's personal forward moves from the eval
  into the round) and the eval a re-reduce of them;
* ``extra.rounds_per_sec_eval_every_1_global_only``:
  ``track_personal=False``, no personal stack, the global half alone.

As in ``bench.py``, ``value`` is the better of the two spellings without
eval and ``extra.rounds_per_sec_eval_every_1`` the better with it; every
spelling stays recorded. Prints one JSON line in ``bench.py``'s shape:
``metric``, ``value``, ``unit``, ``vs_baseline`` (value over the 10
rounds/s target) and ``extra`` (the rates, client-rounds/s per card, the
SNIP init seconds, peak device memory, the card's name and power limit). It
imports nothing of JAX. Without CUDA it exits 2 before printing a result.

    BENCH_CONFIG=byzantine python3 bench_torch.py

runs ``bench.py``'s tracked Byzantine configuration instead (its
``tracked_config("byzantine")``): FedAvg, 64 clients x 40 volumes of
61x73x61x1 bf16 (about 1.4 GB, made on the card), ``small3dcnn``, batch 8,
5 local steps, bf16 compute, the weak-DP defense (clip at 5.0, noise
0.025), the personal stack kept; one warm round, then 10 timed rounds
(:func:`byzantine`). Its line has ``bench.py``'s metric name,
``byzantine_robust_fedavg_rounds_per_sec_64clients``, and ``vs_baseline``
0 (the reference publishes no number for it).

    BENCH_CONFIG=resnet3d [BENCH_DENSE=1] | uneven | clients32 python3 bench_torch.py

run ``bench.py``'s other tracked configurations of the same workload, each
through :func:`main` with the default's ``extra`` keys (:func:`bench_config`
names them): ``resnet3d`` the 3D-ResNet twin ``3dresnet_s2d`` on volumes
phased for its k3/p3 stem (``3dresnet`` on the raw volumes with
``BENCH_DENSE=1``), ``uneven`` shards of ``[20, 40]`` samples drawn as
``bench.py`` draws them (the masked epoch path), ``clients32`` 32 clients
with test shards of 4.

    BENCH_CONFIG=agg python3 bench_torch.py

runs ``bench.py``'s aggregation term (:func:`agg`): one weighted mean per
``agg_impl`` (``parallel.collectives.agg_microbench``) over the AlexNet3D
tree of ``3dcnn_s2d`` (2,576,065 values) stacked over 32 clients, the
locals honoring a 0.5-density mask, on the one card (no mesh, as
``bench.py`` passes none on one device), each timed with CUDA events over 8
aggregations after a warm-up, the weights rolled each time. Its line has
``bench.py``'s metric, ``weighted_sum_aggregation_ms_alexnet3d_32clients``;
``value`` is the dense impl's ms (``bench.py`` takes it from its GSPMD probe
in ``__graft_entry__``, which has no counterpart here) and ``extra`` holds
``agg_ms_<impl>`` for every impl and the workload's descriptors. Any other
``BENCH_CONFIG`` is refused.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Optional

N_CLIENTS = 8
SAMPLES_PER_CLIENT = 40  # = STEPS * BATCH: 5 full batches per client
VOLUME = (121, 145, 121)  # the ABCD volume, stored phase-decomposed
BATCH = 8
STEPS = 5
TARGET_ROUNDS_PER_SEC = 10.0
#: runs of the timed fused call before it is timed
FUSED_WARM_CALLS = 2
MODEL_KEY = "3dcnn_s2d"
METRIC = f"salientgrads_rounds_per_sec_abcd_alexnet3d_{N_CLIENTS}clients"
#: the BENCH_CONFIG values :func:`main` runs ("" is the default workload)
MAIN_CONFIGS = ("", "resnet3d", "uneven", "clients32")
#: bench.py's tracked Byzantine configuration
BYZANTINE_CLIENTS = 64
BYZANTINE_VOLUME = (61, 73, 61)
BYZANTINE_METRIC = "byzantine_robust_fedavg_rounds_per_sec_64clients"
AGG_CLIENTS = 32
AGG_METRIC = "weighted_sum_aggregation_ms_alexnet3d_32clients"


def _acc(ev):
    return ev["global_acc"] if "global_acc" in ev else ev["personal_acc"]


def timed_rounds(algo, state, n_rounds: int = 10,
                 eval_every_round: bool = False) -> float:
    """Rounds/s over ``n_rounds`` rounds after one warm round (and, with
    ``eval_every_round``, one warm eval). With the eval, each round's
    accuracy is fetched after the next round is queued, so the host waits
    on the card once per round at most, as ``FedAlgorithm.run`` does."""
    import torch

    state, _ = algo.run_round(state, 0)
    if eval_every_round:
        float(_acc(algo.evaluate(state)))
    torch.cuda.synchronize()
    prev = None
    t0 = time.perf_counter()
    for r in range(1, n_rounds + 1):
        state, _ = algo.run_round(state, r)
        if eval_every_round:
            if prev is not None:
                float(_acc(prev))
            prev = algo.evaluate(state)
    if prev is not None:
        float(_acc(prev))
    torch.cuda.synchronize()
    return n_rounds / (time.perf_counter() - t0)


def timed_rounds_fused(algo, state, n_rounds: int = 10,
                       eval_every: int = 0) -> float:
    """Rounds/s of one fused block, rounds ``n_rounds .. 2 n_rounds - 1``
    from ``state`` (``run_rounds_fused`` leaves it as it was), timed after
    FUSED_WARM_CALLS runs of the same call: the host clock around the
    dispatch and the one fetch of the block's metrics, which waits for the
    block to finish."""
    import torch

    for _ in range(FUSED_WARM_CALLS):
        algo.run_rounds_fused(state, n_rounds, n_rounds,
                              eval_every=eval_every)[1].materialize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ys = algo.run_rounds_fused(state, n_rounds, n_rounds,
                                  eval_every=eval_every)
    ys.materialize()
    return n_rounds / (time.perf_counter() - t0)


def bench_config(name: str = "", dense: bool = False) -> dict:
    """The workload of ``BENCH_CONFIG=name`` at ``bench.py``'s constants
    and under its metric name: ``model_key``, ``n_clients``, ``uneven``,
    ``test_per_client`` (None: ``max(4, n // 4)``) and ``metric``.
    ``dense`` is ``BENCH_DENSE``: the reference-layout ``3dresnet``."""
    if name not in MAIN_CONFIGS:
        raise ValueError(f"unknown BENCH_CONFIG {name!r}")
    model_key, n_clients, uneven, test = MODEL_KEY, N_CLIENTS, False, None
    if name == "resnet3d":
        model_key = "3dresnet" if dense else "3dresnet_s2d"
    elif name == "uneven":
        uneven = True
    elif name == "clients32":
        n_clients, test = 32, 4
    metric = (f"salientgrads_rounds_per_sec_abcd_alexnet3d_{n_clients}clients"
              if model_key == MODEL_KEY else
              f"salientgrads_rounds_per_sec_abcd_{model_key}_{n_clients}"
              "clients") + ("_uneven" if uneven else "")
    return dict(model_key=model_key, n_clients=n_clients, uneven=uneven,
                test_per_client=test, metric=metric)


def sample_shape_of(model_key: str) -> tuple:
    """The stored per-sample shape of ``VOLUME`` for ``model_key``: phased
    for its stem (the CLI's ``S2D_SPECS``), else ``VOLUME + (1,)``."""
    from neuroimagedisttraining_torch.experiments.runner import S2D_SPECS
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    spec = S2D_SPECS.get(model_key)
    return (phased_sample_shape(VOLUME, *spec) if spec is not None
            else VOLUME + (1,))


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(emit: bool = True, config: str = "",
         dense: bool = False) -> Optional[dict]:
    """Measure the workload of ``BENCH_CONFIG=config``
    (:func:`bench_config`) and (with ``emit``) print the one JSON line;
    returns the record, or None without CUDA."""
    import torch

    cfg = bench_config(config, dense)
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels

    dev = torch.device("cuda")
    kernels.build()
    torch.cuda.reset_peak_memory_stats(dev)
    n_clients = cfg["n_clients"]
    sample_shape = sample_shape_of(cfg["model_key"])
    data = device_synthetic_federated(
        n_clients, SAMPLES_PER_CLIENT, sample_shape,
        torch.Generator(device=dev).manual_seed(0),
        test_per_client=cfg["test_per_client"], uneven=cfg["uneven"])
    model = create_model(cfg["model_key"], num_classes=1,
                         sample_shape=sample_shape)
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    kw = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
              itersnip_iterations=1, compute_dtype="bfloat16")
    algo = SalientGrads(model, data, hp, **kw)
    t0 = time.perf_counter()
    state = algo.init_state()  # includes the SNIP pass
    torch.cuda.synchronize()
    snip_s = time.perf_counter() - t0

    rps_loop = timed_rounds(algo, algo.clone_state(state))
    rps_eval_loop = timed_rounds(algo, algo.clone_state(state), n_rounds=8,
                                 eval_every_round=True)
    rps_fused = timed_rounds_fused(algo, state)
    rps_eval_fused = timed_rounds_fused(algo, state, n_rounds=8,
                                        eval_every=1)
    rps, rps_eval = max(rps_loop, rps_fused), max(rps_eval_loop,
                                                  rps_eval_fused)
    # bench.py's eval-cache and global-only cells: the eval every round,
    # the better of the two spellings, each algorithm from its own init
    cells = {}
    for cell, cell_kw in (("eval_cache", dict(eval_cache=True)),
                          ("global_only", dict(track_personal=False))):
        a = SalientGrads(model, data, hp, **kw, **cell_kw)
        s = a.init_state()
        cells[cell] = {
            "python_loop": timed_rounds(a, a.clone_state(s), n_rounds=8,
                                        eval_every_round=True),
            "fused": timed_rounds_fused(a, s, n_rounds=8, eval_every=1)}
        del a, s
    n_cards = 1  # the whole cohort trains on one card
    counts = [int(n) for n in data.n_train]
    result = {
        "metric": cfg["metric"],
        "value": round(rps, 4),
        "unit": "rounds/sec",
        "vs_baseline": round(rps / TARGET_ROUNDS_PER_SEC, 4),
        "extra": {
            "rounds_per_sec_eval_every_1": round(rps_eval, 4),
            "rounds_per_sec_python_loop": round(rps_loop, 4),
            "rounds_per_sec_fused": round(rps_fused, 4),
            "rounds_per_sec_eval_every_1_python_loop": round(
                rps_eval_loop, 4),
            "rounds_per_sec_eval_every_1_fused": round(rps_eval_fused, 4),
            **{f"rounds_per_sec_eval_every_1_{cell}": round(max(
                rates.values()), 4) for cell, rates in cells.items()},
            **{f"rounds_per_sec_eval_every_1_{cell}_{spelling}": round(r, 4)
               for cell, rates in cells.items()
               for spelling, r in rates.items()},
            "client_rounds_per_sec_per_chip": round(
                rps * n_clients / n_cards, 2),
            "client_samples_per_sec": round(
                rps * n_clients * STEPS * BATCH, 2),
            "snip_init_s": snip_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "device": card_name_and_power_limit(),
            "n_devices": n_cards,
            # one process on one card: no client mesh
            "client_mesh_devices": 1,
            "volume": list(VOLUME),
            "sample_shape": list(sample_shape),
            "clients": n_clients,
            # per client where the shards are uneven
            "samples_per_client": (counts if cfg["uneven"]
                                   else SAMPLES_PER_CLIENT),
            "local_steps": STEPS,
            "batch_size": BATCH,
            "compute_dtype": "bfloat16",
            "timed_rounds": 10,
            "timed_rounds_eval_every_1": 8,
            "fused_warm_calls": FUSED_WARM_CALLS,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        },
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


def byzantine(emit: bool = True) -> Optional[dict]:
    """``bench.py``'s Byzantine configuration (see the module docstring):
    rounds/s over 10 rounds after a warm one, through ``run_round``. Returns
    the record (printed with ``emit``), or None without CUDA."""
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    from neuroimagedisttraining_torch.algorithms import FedAvg
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.robust import RobustAggregator

    dev = torch.device("cuda")
    kernels.build()
    torch.cuda.reset_peak_memory_stats(dev)
    data = device_synthetic_federated(
        BYZANTINE_CLIENTS, STEPS * BATCH, BYZANTINE_VOLUME + (1,),
        torch.Generator(device=dev).manual_seed(0))
    model = create_model("small3dcnn", num_classes=1)
    hp = HyperParams(lr=1e-3, momentum=0.9, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    algo = FedAvg(model, data, hp, loss_type="bce", frac=1.0, seed=0,
                  compute_dtype="bfloat16",
                  defense=RobustAggregator("weak_dp", norm_bound=5.0,
                                           stddev=0.025))
    rps = timed_rounds(algo, algo.init_state())
    result = {
        "metric": BYZANTINE_METRIC,
        "value": round(rps, 4),
        "unit": "rounds/sec",
        "vs_baseline": 0.0,  # no published number; a tracked configuration
        "extra": {
            "clients": BYZANTINE_CLIENTS,
            "samples_per_client": STEPS * BATCH,
            "volume": list(BYZANTINE_VOLUME),
            "model": "small3dcnn",
            "defense": "weak_dp",
            "cohort_bytes": data.x_train.numel()
            * data.x_train.element_size(),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "timed_rounds": 10,
            "device": card_name_and_power_limit(),
        },
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


def agg(emit: bool = True, iters: int = 8) -> Optional[dict]:
    """``bench.py``'s ``agg`` configuration (see the module docstring).
    Returns the record (printed with ``emit``), or None without CUDA."""
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.collectives import (
        agg_microbench,
    )

    kernels.build()
    d = agg_microbench(None, n_clients=AGG_CLIENTS, iters=iters,
                       model_key=MODEL_KEY,
                       sample_shape=sample_shape_of(MODEL_KEY),
                       device="cuda")
    result = {
        "metric": AGG_METRIC,
        "value": d["agg_ms_dense"],
        "unit": "ms/aggregation",
        "vs_baseline": 0.0,  # a term measurement, not a rate
        "extra": {**d, "device": card_name_and_power_limit()},
    }
    if emit:
        print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    config = os.environ.get("BENCH_CONFIG", "")
    if config not in MAIN_CONFIGS + ("byzantine", "agg"):
        sys.exit(f"unknown BENCH_CONFIG {config!r}")
    if config == "byzantine":
        rec = byzantine()
    elif config == "agg":
        rec = agg()
    else:
        rec = main(config=config, dense=bool(os.environ.get("BENCH_DENSE")))
    sys.exit(0 if rec is not None else 2)
