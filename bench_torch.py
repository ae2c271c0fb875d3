#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: federated rounds/s on the headline
workload, on the NVIDIA GPUs present.

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

On more than one card the main configurations (the default, ``resnet3d``,
``uneven``, ``clients32``) shard the cohort as ``bench.py`` does: over
``fit_client_devices(n_clients, cards)`` ranks, one process a card over
NCCL (a ``file://`` rendezvous in a temporary directory). Each rank builds
the whole cohort from seed 0 on its card and keeps its block, runs the same
cells, and times each spelling as the slowest rank's (a barrier, then the
synchronised host clock, then an ``all_reduce(MAX)``); rank 0 prints the
line, ``n_devices`` the cards present, ``client_mesh_devices`` the ranks
and ``client_rounds_per_sec_per_chip`` the rate times the clients over all
cards. :func:`rank_main` is one rank's body (the config, the device and the
backend are its arguments), :func:`run_sharded` spawns them. On one card
the line is the one process's.

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

    BENCH_CONFIG=cifar python3 bench_torch.py

runs ``bench.py``'s tracked CIFAR configuration (its
``tracked_config("cifar")``, :func:`bench_config` ``("cifar")`` holds its
constants): SalientGrads on ``resnet18`` (ResNet-18 with GroupNorm,
11,173,962 parameters), 10 classes, CE; 100 clients of 500 CIFAR-shaped
32x32x3 bf16 images (standard normal, uniform labels, made on the card)
and 100 test images each; ``frac`` 0.1 (10 clients a round); batch 16, 5
local epochs of 32 steps (the last batch of each epoch 4 images); lr 0.1,
decay 0.998, momentum 0.9, weight decay 5e-4, clip 10; ``dense_ratio``
0.3, one SNIP batch a client; bf16 compute; every training and SNIP batch
through the crop and flip with CIFAR-10's black pad value
(:func:`cifar`). The SNIP mask is built once; then from a clone of that
state one warm round and 3 timed rounds of the Python loop, no eval
(``extra.rounds_per_sec_python_loop``), and from the state itself the
fused spelling, a block of rounds 3..5 timed after FUSED_WARM_CALLS runs
of it (``extra.rounds_per_sec_fused``; its round graph, 1600 local steps,
is a chain of graphs, ``core/capture.py``, whose node counts are
``extra.round_graph_nodes``); ``value`` is the faster of the two, as in
the main configurations. The line has ``bench.py``'s metric,
``salientgrads_rounds_per_sec_cifar_resnet18gn_100clients_frac0.1``, and
``vs_baseline`` 0 (no published number). On more than one card the
cohort is sharded over ``fit_client_devices(100, cards)`` ranks, one
process a card over NCCL, as the main configurations are.

    BENCH_CONFIG=agg python3 bench_torch.py

runs ``bench.py``'s aggregation term (:func:`agg`): one weighted mean per
``agg_impl`` (``parallel.collectives.agg_microbench``) over the AlexNet3D
tree of ``3dcnn_s2d`` (2,576,065 values) stacked over 32 clients, the
locals honoring a 0.5-density mask, on the one card (no mesh, as
``bench.py`` passes none on one device; on several cards a client mesh of
the largest of 8, 4 and 2 ranks there are cards for, one process a card
over NCCL, as ``bench.py`` shards it), each timed with CUDA events over 8
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
#: bench.py's tracked CIFAR configuration (bench_config("cifar"))
CIFAR_METRIC = ("salientgrads_rounds_per_sec_cifar_resnet18gn_100clients_"
                "frac0.1")


def _acc(ev):
    return ev["global_acc"] if "global_acc" in ev else ev["personal_acc"]


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _start_clock(device, mesh=None) -> float:
    """The host clock at a timed span's start, once the device is idle and,
    on a client mesh, every rank has reached this point."""
    _sync(device)
    if mesh is not None:
        mesh.barrier()
        _sync(device)
    return time.perf_counter()


def _stop_clock(t0: float, device, mesh=None) -> float:
    """Seconds since ``t0`` once the device is idle: on a client mesh the
    slowest rank's (an ``all_reduce(MAX)``)."""
    import torch
    import torch.distributed as dist

    _sync(device)
    seconds = time.perf_counter() - t0
    if mesh is not None:
        t = torch.tensor([seconds], dtype=torch.float64, device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        seconds = float(t)
    return seconds


def timed_rounds(algo, state, n_rounds: int = 10,
                 eval_every_round: bool = False, mesh=None) -> float:
    """Rounds/s over ``n_rounds`` rounds after one warm round (and, with
    ``eval_every_round``, one warm eval). With the eval, each round's
    accuracy is fetched after the next round is queued, so the host waits
    on the card once per round at most, as ``FedAlgorithm.run`` does. On a
    client ``mesh`` every rank runs it and the time is the slowest
    rank's."""
    dev = algo.device
    state, _ = algo.run_round(state, 0)
    if eval_every_round:
        float(_acc(algo.evaluate(state)))
    prev = None
    t0 = _start_clock(dev, mesh)
    for r in range(1, n_rounds + 1):
        state, _ = algo.run_round(state, r)
        if eval_every_round:
            if prev is not None:
                float(_acc(prev))
            prev = algo.evaluate(state)
    if prev is not None:
        float(_acc(prev))
    return n_rounds / _stop_clock(t0, dev, mesh)


def timed_rounds_fused(algo, state, n_rounds: int = 10,
                       eval_every: int = 0, mesh=None,
                       warm_calls: int = FUSED_WARM_CALLS) -> float:
    """Rounds/s of one fused block, rounds ``n_rounds .. 2 n_rounds - 1``
    from ``state`` (``run_rounds_fused`` leaves it as it was), timed after
    ``warm_calls`` runs of the same call: the host clock around the
    dispatch and the one fetch of the block's metrics, which waits for the
    block to finish (on a client ``mesh``, the slowest rank's)."""
    for _ in range(warm_calls):
        algo.run_rounds_fused(state, n_rounds, n_rounds,
                              eval_every=eval_every)[1].materialize()
    t0 = _start_clock(algo.device, mesh)
    _, ys = algo.run_rounds_fused(state, n_rounds, n_rounds,
                                  eval_every=eval_every)
    ys.materialize()
    return n_rounds / _stop_clock(t0, algo.device, mesh)


def bench_config(name: str = "", dense: bool = False) -> dict:
    """The workload of ``BENCH_CONFIG=name`` at ``bench.py``'s constants
    and under its metric name: ``model_key``, ``n_clients``, ``uneven``,
    ``test_per_client`` (None: ``max(4, n // 4)``) and ``metric``; the
    shard, the step count, the batch, the timed rounds (without and with
    the eval), the fused spelling's warm calls and ``sample_shape`` (None:
    the volume as ``model_key`` stores it, :func:`sample_shape_of`).
    ``dense`` is ``BENCH_DENSE``: the reference-layout ``3dresnet``.
    ``"cifar"`` returns the CIFAR configuration's constants instead
    (:func:`cifar`)."""
    if name == "cifar":
        n_per, bs = 500, 16
        return dict(model_key="resnet18", n_clients=100,
                    samples_per_client=n_per, test_per_client=100,
                    sample_shape=(32, 32, 3), num_classes=10, batch=bs,
                    local_epochs=5, steps_per_epoch=-(-n_per // bs),
                    lr=0.1, lr_decay=0.998, momentum=0.9,
                    weight_decay=5e-4, grad_clip=10.0, frac=0.1,
                    dense_ratio=0.3, itersnip_iterations=1,
                    compute_dtype="bfloat16", loss_type="ce",
                    timed_rounds=3, warm_calls=FUSED_WARM_CALLS,
                    metric=CIFAR_METRIC)
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
                test_per_client=test, metric=metric,
                samples_per_client=SAMPLES_PER_CLIENT, steps=STEPS,
                batch=BATCH, timed_rounds=10, timed_rounds_eval=8,
                warm_calls=FUSED_WARM_CALLS, sample_shape=None)


def sample_shape_of(model_key: str) -> tuple:
    """The stored per-sample shape of ``VOLUME`` for ``model_key``: phased
    for its stem (the CLI's ``S2D_SPECS``), else ``VOLUME + (1,)``."""
    from neuroimagedisttraining_torch.experiments.runner import S2D_SPECS
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    spec = S2D_SPECS.get(model_key)
    return (phased_sample_shape(VOLUME, *spec) if spec is not None
            else VOLUME + (1,))


def card_name_and_power_limit() -> str:
    """The cards' name and power limit as ``nvidia-smi`` gives them, each
    distinct line once (one line for a machine of like cards)."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return "; ".join(dict.fromkeys(x.strip() for x in lines))


def main(emit: bool = True, config: str = "",
         dense: bool = False) -> Optional[dict]:
    """Measure the workload of ``BENCH_CONFIG=config``
    (:func:`bench_config`) and (with ``emit``) print the one JSON line;
    returns the record, or None without CUDA. With more than one card the
    cohort is sharded over ``fit_client_devices(n_clients, cards)`` ranks,
    one process a card over NCCL (:func:`run_sharded`), as ``bench.py``
    shards it over its devices; rank 0's record is the run's."""
    import torch

    cfg = bench_config(config, dense)
    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    from neuroimagedisttraining_torch.parallel.mesh import fit_client_devices

    rows = fit_client_devices(cfg["n_clients"], torch.cuda.device_count())
    if rows > 1:
        result = run_sharded(rank_main, rows, "cuda", "nccl", cfg)
    else:
        result = measure(cfg, "cuda")
    if emit:
        print(json.dumps(result), flush=True)
    return result


def run_sharded(body, world: int, device: str, backend: str, *args):
    """``body(rank, world, directory, *args, device, backend)`` on ``world``
    spawned ranks joined over a ``file://`` rendezvous in a temporary
    directory (:func:`rank_main`, :func:`rank_agg`); returns the record
    rank 0 leaves there. On the card the kernels are built here first, so
    the ranks only load them; a rank that raises fails the run."""
    import tempfile

    import torch.multiprocessing as mp

    if device == "cuda":
        from neuroimagedisttraining_torch.ops import kernels

        kernels.build()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(body, args=(world, d) + tuple(args) + (device, backend),
                 nprocs=world, join=True)
        with open(os.path.join(d, "result.json")) as f:
            return json.load(f)


def _rank_mesh(rank: int, world: int, directory: str, device: str,
               backend: str):
    """This rank's device (``cuda:<rank>``, made current, or the CPU on one
    thread) and its :class:`ClientMesh` of ``world`` ranks."""
    import torch

    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    if device == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
        torch.set_num_threads(1)
    return dev, make_mesh(world, backend=backend, rank=rank, device=dev,
                          init_method="file://" + os.path.join(
                              directory, "rendezvous"))


def _leave_record(rank: int, directory: str, record: dict) -> None:
    if rank == 0:
        with open(os.path.join(directory, "result.json"), "w") as f:
            json.dump(record, f)


def rank_main(rank: int, world: int, directory: str, cfg: dict,
              device: str, backend: str) -> None:
    """One rank of a sharded :func:`main`: the workload ``cfg`` on its
    device (``"cuda"``: card ``rank``) in a ``backend`` client mesh of
    ``world`` ranks (:func:`measure`); rank 0 leaves the record in
    ``directory``."""
    dev, mesh = _rank_mesh(rank, world, directory, device, backend)
    try:
        _leave_record(rank, directory, measure(cfg, dev, mesh))
        mesh.barrier()
    finally:
        mesh.destroy()


def measure(cfg: dict, device, mesh=None) -> dict:
    """The cells of the workload ``cfg`` (:func:`bench_config`) on
    ``device``, the record :func:`main` prints. On a client ``mesh`` every
    rank calls it: each builds the whole cohort from seed 0 on its device
    and keeps its block of clients (``shard_federated``), every spelling is
    timed as the slowest rank's, and the record (the same on every rank)
    counts the cards present in ``n_devices``, the ranks in
    ``client_mesh_devices`` and the largest rank's peak memory (each rank's
    from after it dropped the other blocks)."""
    import torch
    import torch.distributed as dist

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        kernels.build()
        torch.cuda.reset_peak_memory_stats(dev)
    n_clients, steps = cfg["n_clients"], cfg["steps"]
    n_timed, n_timed_eval = cfg["timed_rounds"], cfg["timed_rounds_eval"]
    warm = cfg["warm_calls"]
    sample_shape = tuple(cfg.get("sample_shape")
                         or sample_shape_of(cfg["model_key"]))
    data = device_synthetic_federated(
        n_clients, cfg["samples_per_client"], sample_shape,
        torch.Generator(device=dev).manual_seed(0),
        test_per_client=cfg["test_per_client"], uneven=cfg["uneven"])
    counts = [int(n) for n in data.n_train]
    if mesh is not None:
        data = shard_federated(data, mesh)  # the other blocks are dropped
        if cuda:
            # the rank's own footprint: the whole cohort it was cut from is
            # freed before the peak starts
            torch.cuda.reset_peak_memory_stats(dev)
    # the 3D models size their first dense layer by the sample shape
    model = create_model(cfg["model_key"], num_classes=1, **(
        {"sample_shape": sample_shape}
        if cfg["model_key"].startswith("3d") else {}))
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=steps, batch_size=cfg["batch"])
    kw = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
              itersnip_iterations=1, compute_dtype="bfloat16", device=dev)
    # the algorithms whose graphs a failure releases: a mesh's group is not
    # torn down while a graph that holds its collectives lives, and the
    # traceback keeps them reachable
    live = []
    try:
        algo = SalientGrads(model, data, hp, **kw)
        live.append(algo)
        t0 = _start_clock(dev, mesh)
        state = algo.init_state()  # includes the SNIP pass
        snip_s = _stop_clock(t0, dev, mesh)

        rps_loop = timed_rounds(algo, algo.clone_state(state), n_timed,
                                mesh=mesh)
        rps_eval_loop = timed_rounds(algo, algo.clone_state(state),
                                     n_timed_eval, eval_every_round=True,
                                     mesh=mesh)
        rps_fused = timed_rounds_fused(algo, state, n_timed, mesh=mesh,
                                       warm_calls=warm)
        rps_eval_fused = timed_rounds_fused(algo, state, n_timed_eval,
                                            eval_every=1, mesh=mesh,
                                            warm_calls=warm)
        rps, rps_eval = max(rps_loop, rps_fused), max(rps_eval_loop,
                                                      rps_eval_fused)
        # bench.py's eval-cache and global-only cells: the eval every round,
        # the better of the two spellings, each algorithm from its own init
        cells = {}
        for cell, cell_kw in (("eval_cache", dict(eval_cache=True)),
                              ("global_only", dict(track_personal=False))):
            a = SalientGrads(model, data, hp, **kw, **cell_kw)
            live.append(a)
            s = a.init_state()
            cells[cell] = {
                "python_loop": timed_rounds(
                    a, a.clone_state(s), n_timed_eval, eval_every_round=True,
                    mesh=mesh),
                "fused": timed_rounds_fused(
                    a, s, n_timed_eval, eval_every=1, mesh=mesh,
                    warm_calls=warm)}
            live.remove(a)
            del a, s
    except BaseException:
        for x in live:
            x.release_graphs()
        raise
    # the cards present: the per-card rate divides by all of them, as
    # bench.py divides by its chips
    n_devices = (torch.cuda.device_count() if cuda
                 else 1 if mesh is None else mesh.size)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if mesh is not None:
        t = torch.tensor([peak], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
        peak = int(t)
    return {
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
                rps * n_clients / n_devices, 2),
            "client_samples_per_sec": round(
                rps * n_clients * steps * cfg["batch"], 2),
            "snip_init_s": snip_s,
            "peak_mem_bytes": peak,
            "device": card_name_and_power_limit() if cuda else str(dev),
            "n_devices": n_devices,
            # the ranks the clients are sharded over (1: one process)
            "client_mesh_devices": 1 if mesh is None else mesh.size,
            "volume": list(VOLUME),
            "sample_shape": list(sample_shape),
            "clients": n_clients,
            # per client where the shards are uneven
            "samples_per_client": (counts if cfg["uneven"]
                                   else cfg["samples_per_client"]),
            "local_steps": steps,
            "batch_size": cfg["batch"],
            "compute_dtype": "bfloat16",
            "timed_rounds": n_timed,
            "timed_rounds_eval_every_1": n_timed_eval,
            "fused_warm_calls": warm,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        },
    }


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


def cifar_data(cfg: dict, generator):
    """The CIFAR configuration's cohort on ``generator``'s device:
    standard-normal bf16 images, uniform labels over the classes, the
    first ``test_per_client`` images of each client its test shard, and
    CIFAR-10's black pad value (the loaders' ``aug_pad_value``), so every
    training and SNIP batch is cropped and flipped."""
    import torch

    from neuroimagedisttraining_torch.data.cifar import (
        CIFAR10_MEAN,
        CIFAR10_STD,
        black_pad_value,
    )
    from neuroimagedisttraining_torch.data.types import FederatedData

    dev = generator.device
    c, n, m = cfg["n_clients"], cfg["samples_per_client"], cfg[
        "test_per_client"]
    x = torch.randn((c, n) + tuple(cfg["sample_shape"]), generator=generator,
                    device=dev, dtype=torch.bfloat16)
    y = torch.randint(0, cfg["num_classes"], (c, n), generator=generator,
                      device=dev, dtype=torch.int32)
    return FederatedData(
        x_train=x, y_train=y, n_train=torch.full((c,), n, dtype=torch.int32),
        x_test=x[:, :m].clone(), y_test=y[:, :m].clone(),
        n_test=torch.full((c,), m, dtype=torch.int32),
        class_num=cfg["num_classes"],
        aug_pad_value=black_pad_value(CIFAR10_MEAN, CIFAR10_STD))


def cifar_algo(cfg: dict, data, device, **kw):
    """SalientGrads on the CIFAR configuration ``cfg``
    (:func:`bench_config` ``("cifar")``) over ``data``."""
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.models import create_model

    model = create_model(cfg["model_key"], num_classes=cfg["num_classes"],
                         sample_shape=cfg["sample_shape"])
    hp = HyperParams(lr=cfg["lr"], lr_decay=cfg["lr_decay"],
                     momentum=cfg["momentum"],
                     weight_decay=cfg["weight_decay"],
                     grad_clip=cfg["grad_clip"],
                     local_epochs=cfg["local_epochs"],
                     steps_per_epoch=cfg["steps_per_epoch"],
                     batch_size=cfg["batch"])
    return SalientGrads(model, data, hp, loss_type=cfg["loss_type"],
                        frac=cfg["frac"], seed=0,
                        dense_ratio=cfg["dense_ratio"],
                        itersnip_iterations=cfg["itersnip_iterations"],
                        compute_dtype=cfg["compute_dtype"], device=device,
                        **kw)


def cifar(emit: bool = True) -> Optional[dict]:
    """``bench.py``'s CIFAR configuration (see the module docstring).
    Returns the record (printed with ``emit``), or None without CUDA."""
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    from neuroimagedisttraining_torch.parallel.mesh import fit_client_devices

    cfg = bench_config("cifar")
    rows = fit_client_devices(cfg["n_clients"], torch.cuda.device_count())
    if rows > 1:
        result = run_sharded(rank_cifar, rows, "cuda", "nccl", cfg)
    else:
        result = cifar_record(cfg, "cuda")
    if emit:
        print(json.dumps(result), flush=True)
    return result


def rank_cifar(rank: int, world: int, directory: str, cfg: dict,
               device: str, backend: str) -> None:
    """One rank of a sharded :func:`cifar` (as :func:`rank_main`)."""
    dev, mesh = _rank_mesh(rank, world, directory, device, backend)
    try:
        _leave_record(rank, directory, cifar_record(cfg, dev, mesh))
        mesh.barrier()
    finally:
        mesh.destroy()


def cifar_record(cfg: dict, device, mesh=None) -> dict:
    """The CIFAR configuration's cells on ``device`` (on a client ``mesh``
    every rank's, each holding its block; the times the slowest rank's)."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.mesh import shard_federated

    dev = torch.device(device)
    kernels.build()
    torch.cuda.reset_peak_memory_stats(dev)
    data = cifar_data(cfg, torch.Generator(device=dev).manual_seed(0))
    if mesh is not None:
        data = shard_federated(data, mesh)
        torch.cuda.reset_peak_memory_stats(dev)
    n = cfg["timed_rounds"]
    trained = int(round(cfg["n_clients"] * cfg["frac"]))
    algo = cifar_algo(cfg, data, dev)
    try:
        t0 = _start_clock(dev, mesh)
        state = algo.init_state()  # includes the SNIP pass
        snip_s = _stop_clock(t0, dev, mesh)
        rps_loop = timed_rounds(algo, algo.clone_state(state), n, mesh=mesh)
        rps_fused = timed_rounds_fused(algo, state, n, mesh=mesh,
                                       warm_calls=cfg["warm_calls"])
        # the round graph's chain (core/capture.py): each graph's nodes
        graph_nodes = [g.graph.nodes for g in algo._fused.rounds.values()]
    finally:
        algo.release_graphs()
    rps = max(rps_loop, rps_fused)
    n_devices = torch.cuda.device_count()
    per_round = trained * cfg["local_epochs"] * cfg["steps_per_epoch"]
    return {
        "metric": cfg["metric"],
        "value": round(rps, 4),
        "unit": "rounds/sec",
        "vs_baseline": 0.0,  # no published number; a tracked configuration
        "extra": {
            "rounds_per_sec_python_loop": round(rps_loop, 4),
            "rounds_per_sec_fused": round(rps_fused, 4),
            "round_graph_nodes": graph_nodes,
            "client_steps_per_sec": round(rps * per_round, 2),
            "snip_init_s": snip_s,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
            "device": card_name_and_power_limit(),
            "n_devices": n_devices,
            "client_mesh_devices": 1 if mesh is None else mesh.size,
            "clients": cfg["n_clients"],
            "trained_per_round": int(round(cfg["n_clients"] * cfg["frac"])),
            "samples_per_client": cfg["samples_per_client"],
            "local_epochs": cfg["local_epochs"],
            "steps_per_epoch": cfg["steps_per_epoch"],
            "batch": cfg["batch"],
            "augment": "crop_flip",
            "compute_dtype": cfg["compute_dtype"],
            "timed_rounds": n,
            "fused_warm_calls": cfg["warm_calls"],
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
        },
    }


def agg(emit: bool = True, iters: int = 8) -> Optional[dict]:
    """``bench.py``'s ``agg`` configuration (see the module docstring).
    Returns the record (printed with ``emit``), or None without CUDA. With
    more than one card it runs on a client mesh of the largest of 8, 4, 2
    ranks the cards hold, one process a card over NCCL, each holding its
    block of the 32 clients, as ``bench.py`` shards it; rank 0's timings
    are the record's."""
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: CUDA is not available", file=sys.stderr)
        return None
    n = max(d for d in (8, 4, 2, 1) if d <= torch.cuda.device_count())
    if n > 1:
        result = run_sharded(rank_agg, n, "cuda", "nccl", iters)
    else:
        result = agg_record("cuda", iters)
    if emit:
        print(json.dumps(result), flush=True)
    return result


def agg_record(device, iters: int, mesh=None) -> dict:
    """The ``agg`` record on ``device``, sharded over ``mesh`` when given
    (``agg_microbench``; its ``n_devices`` is the mesh's ranks)."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.collectives import (
        agg_microbench,
    )

    cuda = torch.device(device).type == "cuda"
    if cuda:
        kernels.build()
    d = agg_microbench(mesh, n_clients=AGG_CLIENTS, iters=iters,
                       model_key=MODEL_KEY,
                       sample_shape=sample_shape_of(MODEL_KEY),
                       device=device)
    return {
        "metric": AGG_METRIC,
        "value": d["agg_ms_dense"],
        "unit": "ms/aggregation",
        "vs_baseline": 0.0,  # a term measurement, not a rate
        "extra": {**d, "device": (card_name_and_power_limit() if cuda
                                  else str(device))},
    }


def rank_agg(rank: int, world: int, directory: str, iters: int,
             device: str, backend: str) -> None:
    """One rank of a sharded :func:`agg` (:func:`agg_record` on a
    ``backend`` client mesh of ``world`` ranks); rank 0 leaves the record
    in ``directory``."""
    dev, mesh = _rank_mesh(rank, world, directory, device, backend)
    try:
        _leave_record(rank, directory, agg_record(dev, iters, mesh))
        mesh.barrier()
    finally:
        mesh.destroy()


if __name__ == "__main__":
    config = os.environ.get("BENCH_CONFIG", "")
    if config not in MAIN_CONFIGS + ("byzantine", "agg", "cifar"):
        sys.exit(f"unknown BENCH_CONFIG {config!r}")
    if config == "byzantine":
        rec = byzantine()
    elif config == "cifar":
        rec = cifar()
    elif config == "agg":
        rec = agg()
    else:
        rec = main(config=config, dense=bool(os.environ.get("BENCH_DENSE")))
    sys.exit(0 if rec is not None else 2)
