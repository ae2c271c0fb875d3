#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. build   — compile every CUDA kernel from ``neuroimagedisttraining_torch/csrc``
   (eight sources, one ``nvcc`` each, all started together).
2. kernels — hold each kernel against its plain PyTorch version at the
   shapes the training paths give it (full-width AlexNet3DS2D), and time
   both (CUDA events, median of 30 after warmup, each launch queued behind a
   device-side sleep so host enqueue time is not counted); also the f32
   aggregate with TF32 on against TF32 off. Bit for bit, except the stem
   forward, whose conv sums 216 products in another order than cuDNN: the
   conv within one ulp of the working type or, where it cancels to near
   zero, within 1e-5 of the sum of its terms' magnitudes (f32 case: within
   that everywhere, TF32 off); ``zs`` bitwise that conv plus the bias in the
   working type; the pool bitwise the max-pool of its own ``zs``, the sums
   within 1e-5 of the sums of its own ``zs``. The stem backward is bitwise
   under both tie rules, with and without its fused bias gradient, which is
   held within one bf16 ulp of the plain per-channel sum of ``dzs`` (or
   1e-5 of its magnitude where it cancels) and timed against ``dzs.sum``;
   its record also holds its persistent launch. The four stem entry points
   (``ops/experimental``) run once each at full width against their plain
   counterparts. The threshold (a radix select in three digit passes) is
   also held bitwise on its edge cases at full width (+inf, NaN and -0.0 in
   the row, k = 1, k = n, all zeros, ties, a [8, n_group] view off a
   16-byte boundary),
   and the weighted sum on edge leaves (n odd, bases 4 and 16 bytes off)
   for 1, 3, 8 and 16 clients; the int8 quantize-reduce at b = 1000 and
   b = 1001 (the scalar path) and for 17 clients (two launches), its record
   naming the path and tile its wrapper chose and ptxas's registers for the
   8-client kernel. The stem forward's record also holds its
   persistent launch (grid, tiles, threads, shared memory, registers) and
   a second launch on the same inputs, bitwise equal to the first, and the
   same rule and timings at the serving worker's one volume (B = 1). A
   ``bound_share`` line follows: each kernel's bound over its measured
   time.
3. parity  — a narrow model, one SalientGrads round on the CPU (plain
   versions) and on the GPU (kernels, the stem's included) from the same
   parameters, mask, batch order and int8 uniforms, for the dense, bf16,
   int8 and top-k wires: the card's aggregate equals the CPU's on the card's
   own inputs bit for bit, and parameters and metrics agree (see
   ``small_parity``).
4. main    — the training path at full width through the library entry
   points: SalientGrads on AlexNet3DS2D, 8 clients x 40 phased 121x145x121
   volumes, batch 8, 5 local steps, bf16 compute, dropout 0.5, SNIP mask
   init, 3 rounds, then the global and personal eval. The launch counters
   are zeroed just before and read just after.
5. wires   — the same configuration: SalientGrads, SNIP once, then 2 rounds
   on each aggregation wire (dense, bucketed, bf16, int8, sparse, topk,
   hier), each from ``clone_state`` of the same state; then FedAvg, 2
   rounds each on dense, int8 and topk from one init, and the final
   fine-tune. First it times a round's out-of-place personal update (the
   full-width stack) against the in-place row write it replaced. Counters
   are zeroed before each and read after; every
   aggregate is timed (CUDA events) and, for dense, bucketed, sparse and
   hier, held against the plain dense aggregate of the same locals bit for
   bit.
6. fused   — the fused round loop (``run_rounds_fused``: each round one
   replay of a captured CUDA graph) on the same configuration: SalientGrads
   and FedAvg on every wire of the wires phase, then the five
   personalized and decentralized baselines at the personal phase's
   configurations (DisPFL ERK at ``frac`` 0.5, with ``active`` 0.5,
   static; SubAvg over two epochs; Ditto, Local, DPSGD at ``frac`` 0.5),
   2 rounds with the eval after every round, each gated bitwise against
   2 eager rounds from the same state (or within the spread of two eager
   runs, printed, if that is not zero); every configuration must capture,
   or the phase fails. Launches per replay, the first block's seconds,
   peak memory of both spellings and, on the dense wires, DisPFL static
   and Ditto, their rounds/s in interleaved pairs (see ``fused_path``).
7. evalcache — the eval protocol on the same configuration: SalientGrads
   and FedAvg with ``eval_cache=True``, 2 rounds with the eval after each,
   eager and fused, against the same rounds with the cache off from one
   state (accuracies bitwise, losses within 4e-7 relative; fused bitwise
   eager, the cache included); the cached eval runs no personal forward,
   the round one per client; launches per replay and peak memory of both
   spellings (and of the cache-off graph), rounds/s in interleaved pairs.
   Then SalientGrads with ``eval_clients=4``, 2 rounds, fused bitwise
   eager, its subset printed (see ``evalcache_path``).
8. dense   — the dense-stem AlexNet3D (``3dcnn``, its stem conv on cuDNN)
   at full width: SalientGrads, 8 clients x 40 volumes of 121x145x121x1
   bf16, batch 8, 5 steps, dropout 0.5, SNIP 0.5, the dense wire: SNIP, 2
   rounds and the eval (finite losses, mask density, launches); masked
   SGD, the SNIP threshold, the score mask and the weighted sum at this
   model's leaves and SNIP row, bitwise against their plain versions; one round
   of the same state stored channel-less (``channel_inject``, the
   ``--layout flat`` path) bitwise the first; round seconds, peak memory,
   the stem conv's forward, input- and weight-gradient ms at the step's
   shape in both memory formats; ``3dcnn_deeper`` and ``3dcnn_regression``
   one forward and backward each (see ``dense_path``).
9. robust  — the robustness tier on the main configuration: SalientGrads
   (SNIP once) and FedAvg, 2 rounds eager, the same 2 fused and a timed
   fused block per configuration: unguarded, guarded clean (bitwise the
   unguarded), and under ``drop=0.125,nan=0.125,scale=0.125:100x`` with the
   guard: the plain mean on dense and int8, each ``robust_agg`` on the
   dense wire, the median on int8, the weak-DP defense (its re-mask
   through ``fused_mask_apply``, held bitwise against ``p * m`` and
   counted), top-k under the guard with a NaN client, FedAvg with the
   defense; the quarantine counters equal to the host replay of the fault
   draws, fused bitwise eager (see ``robust_path``).
10. train_opts — ``remat_local`` against remat off (bitwise, peak memory,
   the stem forward launched twice a step), remat fused, replacement
   batching eager and fused, and exact stratified SNIP on 50 volumes a
   client with 25 of each class (seconds, launches, density 0.5; see
   ``train_opts_path``).
11. personal — the personalized and decentralized baselines at full width
   on the main configuration: DisPFL (ERK, ``frac`` 0.5, random
   neighbors; with ``active`` 0.5; static masks), SubAvg, Ditto, Local and
   DPSGD, 2 eager rounds (each timed) and an eval each; finite losses,
   DisPFL's and SubAvg's client weights zero off their masks, SubAvg's new
   masks inside the old, DisPFL's live counts moved by regrow ties alone
   (each evolution checked against the reference's rules), the masked SGD
   kernel's ``mask_grads`` branch launched once a step
   exactly on the DisPFL and SubAvg paths, every path's stem launches; the
   steady round seconds and peak memory; then a narrow run of each
   algorithm on the card against the CPU (see ``personal_path``).
12. fomo    — FedFomo (its validation rows the last 10% of each shard)
   and TurboAggregate at full width on the main configuration, 2 eager
   rounds each, timed (TurboAggregate's host secure sum apart), and an
   eval; finite losses, FedFomo's ``p_choose`` moved only at the pairs its
   neighbor choice visited, each TurboAggregate global model within half
   a quantum per client of the plain f64 weighted mean of its locals, the
   launches, the peak memory, and a narrow run of each against the CPU
   (see ``fomo_path``).
13. state   — the state tier at full width on the main configuration over a
   population of 32 clients at ``frac`` 0.25 (8 a round; 5.6 GB of bf16
   volumes kept on the host): 3 eager rounds streamed from a disk client
   store with 8 hot clients, bitwise the resident run (global parameters,
   metrics, every client's row, the eval), the streamed fused spelling
   (blocks of 2 and 1) bitwise as well; a checkpoint after round 2 with
   its store sidecar, resumed by a fresh algorithm and store into round 3,
   bitwise the resident round 3; the watchdog's rollback from that
   checkpoint bitwise; the streamed run's own peak device memory within 5%
   of a resident 8-client run's at full participation, its round within
   2x of the resident round; save and restore seconds, the checkpoint's
   bytes, the store's gather ms (see ``state_path``).
14. resnet3d — the 3D-ResNet twin at full width: SalientGrads on
   ``3dresnet_s2d``, 8 clients x 40 volumes of 121x145x121 phased for its
   k3/p3 stem, bf16, cuDNN deterministic: SNIP, 2 eager rounds with the
   eval, the same rounds fused, bitwise; masked SGD and the weighted sum
   launched twice a call at its 49 leaves, the score mask once, no stem
   kernel (its stem is plain torch); round seconds and peak memory; then
   ``3dresnet`` on 2 raw volumes against the twin on their phased form,
   from converted weights, within 2e-4 (see ``resnet3d_path``).
15. uneven  — the main configuration with shards of 20-40 samples drawn
   as ``bench.py`` draws them: SNIP, 2 eager rounds and the same rounds
   fused, bitwise, one graph key of step counts; every kernel's launches,
   the stem's included, follow the 31 steps a round (see
   ``uneven_path``).
16. determinism — the main configuration's fused rate with cuDNN's
   deterministic mode (the CLI's) against its default, in three
   interleaved pairs of 10-round blocks, and the stem's weight gradient
   alone in each mode (see ``determinism_path``).
17. mesh    — the client mesh (``parallel/mesh.py``): two gloo ranks
   sharing the card, each holding four clients of the main configuration
   at full width (SNIP, then 2 rounds on dense, bucketed, bf16, int8 and
   hier), every round replayed by a single process from the mesh's state:
   the mask, each client's trained model, the losses, the evals and their
   per-client sums bitwise, the global model within ``MESH_GLOBAL_BOUND``;
   the ranks' launches counted, and each rank's fused block refused (a
   gloo group cannot be captured); then a one-rank NCCL group through the
   wire reduces on full-width payloads (each equal to the rank's own
   payload), each reduce also captured in a CUDA graph and replayed on new
   payloads and uniforms, bitwise the eager reduce; then a one-rank NCCL
   mesh of the main configuration whose fused block (2 rounds, the eval
   every round) is bitwise its eager rounds and the single-process block,
   with no collective called from Python while it replays; and
   ``runner.main --mesh_devices 2`` fitted to the one card. The robust and
   the state tiers on the mesh (path ``mesh/robust``): (e) the gloo ranks
   run three robust cases (faults, the guard, a defense, ``robust_agg``),
   each round replayed by a single process (rows, counters and evals
   bitwise, the global model bitwise under ``robust_agg``); (f) a one-rank
   NCCL mesh's fused block of each, bitwise its eager rounds and the
   single-process block, no Python collective in a replay; (g) the ranks'
   checkpoint resumed by a fresh spawn (bitwise the uninterrupted round)
   and by one process. The seven other algorithms on the mesh (path
   ``mesh/baselines``): (h) Local, Ditto, SubAvg, DPSGD, DisPFL, FedFomo
   and TurboAggregate, 2 eager rounds each on the gloo ranks, each round
   replayed by a single process (every client row, mask, ``p_choose``
   row, metric and eval bitwise; the global model bitwise where every rank
   reduces the gathered rows, within 1e-6 for Ditto's split sum), each
   rank's round seconds and TurboAggregate's secure sum timed; (i) a
   one-rank NCCL mesh's fused block of Local, Ditto, DPSGD and static
   DisPFL, bitwise its eager rounds and the single-process block, no
   Python collective in a replay, both rates; (j) DisPFL's checkpoint,
   saved by the ranks, resumed bitwise by the fresh spawn of (g). The
   client store on the mesh (path ``mesh/store``): (k1) two gloo ranks over
   the state phase's 32-client population, each holding its block of the
   volumes on the host and of the rows in a disk store, 2 eager streamed
   rounds each of SalientGrads on the top-k wire, FedAvg and Ditto, each
   round replayed by a single process (every stored row, metric and eval
   bitwise, the global model within 1e-6), each rank's round seconds,
   store gather ms and peak; (k2) the ranks' store-backed checkpoint
   resumed by a fresh spawn (bitwise the uninterrupted round) and by one
   process; (k3) a one-rank NCCL mesh's fused store block of 3 rounds,
   bitwise its eager rounds and the single-process streamed block, no
   Python collective in a replay, its captures and both rates (see
   ``mesh_path``).
18. cifar   — the 2D image side at full width (``bench_torch.bench_config
   ("cifar")``: SalientGrads on ``resnet18``, ResNet-18 with GroupNorm,
   62 leaves, 11,173,962 parameters; 100 clients of 500 32x32x3 bf16 images
   made on the card, batch 16, ``dense_ratio`` 0.3, the crop and flip on
   every training and SNIP batch, 10 clients a round, 100 test images a
   client; cut here to 1 local epoch of 16 steps and an eval of 10 of the
   clients): (a) masked SGD over the
   62 leaves, the threshold over the 11,164,352-entry SNIP row, the score
   mask over the 21 kernel leaves and the weighted sum over [10, leaf] x
   62 (the configuration's 10 clients a round), each bitwise its plain
   version, timed (median of
   30) with its bound and share; (b) SNIP, 1 eager round with the eval and
   the same round as a fused block, bitwise, cuDNN deterministic, the
   launches on path ``cifar`` exact, SNIP seconds, both loops' rounds/s,
   the round graph's chain, peak memory; (c) every 2D registry key one
   training step against the CPU in cuDNN's deterministic mode (the
   logits within 1e-4 norm-wise in f32 and f64; the whole gradient within
   1e-4 in f64, and in f32 with cuDNN on and off but for five keys held at
   limits set from their readings) and a finite bf16 step; (d)
   ``runner.main --dataset cifar10 --model cnn_cifar10`` twice on pickled
   CIFAR-layout batches the phase writes, 2 rounds, the twins bitwise
   (see ``cifar_path``).
19. cli     — the command-line entry point in-process on the card
   (``experiments.runner.main``): SalientGrads and FedAvg, ``--dataset
   synthetic --model small3dcnn --comm_round 2`` (no stem stage on this
   model), and SalientGrads with ``--fuse_rounds 2``, whose history must
   equal the unfused run's; each with its counters zeroed just before and
   read just after; then the training options, the robustness flags,
   each of the five personalized and decentralized algorithms, ``dispfl
   --static``, ``--fuse_rounds 2`` for ditto, local, dpsgd and ``dispfl
   --static`` (each history equal to its unfused run's), FedFomo and
   TurboAggregate; the cohort and the parameters on CUDA, the losses
   finite, ``stat_info`` (pickle and ``.json``) written under a temporary
   ``--results_dir``; then ``--checkpoint_dir`` with a run cut after round
   2 and ``--resume``'d to round 4, a ``--fuse_rounds 2`` lineage (saved
   at block boundaries) resumed unfused, and ``--client_store disk`` over
   16 clients at ``frac`` 0.25, each bitwise its uninterrupted twin (the
   CLI's seeding puts cuDNN in its deterministic mode; the script restores
   the two flags after the phase). The ABCD cohort-file step is not here:
   the loaders need ``h5py``, which the card's machine does not have.
20. fed    — the distributed federation (``neuroimagedisttraining_torch/
   fed`` over ``comm/``), FedAvg at the main configuration's width through
   the CLI's ``--dataset synthetic_volume`` (8 clients x 40 phased bf16
   volumes, batch 8, 5 steps), one aggregator and 2 sites of 4 clients:
   (a) the loopback sync federation, 2 rounds, ``--xtrace`` on, its
   counters zeroed just before and read just after (masked SGD, the stem
   kernels and the weighted sum, exactly), bitwise the in-process eager
   ``run`` (global parameters, every round's loss, the final eval), each
   round's wall ms split into site training, wire and aggregate; (b)
   ``scripts/torch_run_federation.py --sites 2``: three processes on the
   card over the native TCP transport, built first from the port's own
   source, every exit code 0, the parameters and eval bitwise (a), each
   process's peak memory; (c) the loopback buffered federation at K = 1
   with site 2 straggling: 3 flushes without site 2, the ``--fed_replay``
   of its trace bitwise, one flush each on the bf16, int8 and top-k
   codecs; (d) the four codecs on a full-width delta: frame bytes against
   the wire-cost model, encode and decode ms (see ``fed_path``). At most
   ``FED_PHASE_LIMIT_S``.
21. serve  — the serving plane (``neuroimagedisttraining_torch/serve``) on
   the fed phase's FedAvg configuration with int8 pushes, a disk
   population of personal deltas with 4 hot clients and micro-batches of
   16 (see ``serve_path``): (a) the loopback run, the publisher training 2
   rounds in the calling thread and pushing v0-v2 while the worker answers
   256 Zipf requests at 200 rps in its own threads: every request served,
   every push adopted and acked, the served model bitwise its checkpoint,
   the tick lines' gauges and SLO health, the drain record, ``/metrics``
   scraped, every ``adopt`` span under a ``publish`` span, launches exact
   (the publisher's steps and probe, the worker's forwards); (b) 16
   requests' answers at the final version: a micro-batch bitwise one
   request at a time, the card within ``SERVE_CPU_RTOL`` of the CPU's plain
   versions; the 256 requests again with no training beside them; a B = 1
   answer's wall and device ms; (c) the publisher and the worker as two
   processes over TCP: exit codes 0, the gate bitwise, the push frames
   equal to (a)'s, each process's peak memory; (d) ``--serve_workers 2``:
   both workers' models bitwise at every version, equal ack watermarks. At
   most ``SERVE_PHASE_LIMIT_S``. The kernels phase also holds ``stem_fwd``
   at the worker's B = 1 (``at_serve_b1``).
22. obs    — the in-process observability tier on the main configuration
   (see ``obs_path``): (a) SNIP and 2 eager rounds with the session and
   the round numerics on, bitwise obs off; (b) a fused block of the same
   rounds, its numerics bitwise the eager rounds', no more host syncs in
   its dispatch than obs off's, its graph's nodes and the fused rounds/s
   with obs on and off; (c) ``obs.comm.probe_aggregate`` on the dense and
   int8 wires; (d) ``utils.profiling.trace_one_round`` and
   ``obs.devtrace``: the stem's, masked SGD's and the weighted sum's
   kernels on the device lane, its busy seconds beside the round's
   CUDA-event ms; (e) ``obs.memory.device_memory()``'s peak against
   ``torch.cuda.max_memory_allocated()``; (f) a one-rank NCCL mesh round
   with the session on, profiled, its collectives' NCCL ops in the trace
   (one rank's communicator launches no kernel:
   ``scripts/torch_obs_mesh_trace.py`` holds the collectives' device share
   on several cards); (g) the CLI on ``small3dcnn`` with every lifted obs
   flag: every artifact written, the run bitwise its obs-off twin.
23. offline — the offline observability tier (``python -m
   neuroimagedisttraining_torch.obs``, see ``offline_path``) on the
   artifacts of full-width runs: SalientGrads on AlexNet3DS2D through the
   CLI (8 clients x 40 phased bf16 volumes, batch 8, 5 steps, bf16, 4
   rounds in fused blocks of 2 with the eval after each, stragglers
   injected, every in-process obs artifact and one profiled round), its
   launches exact; its twin; a 2-round loopback federation with the
   cross-process trace, heartbeats and site 2 straggling; then the nine
   subcommands as processes, each exit code and output checked (the
   analysis's stragglers the port's fault replay, its compile section the
   port's kinds, the SLO replay the run's events, the rebuilt catalog the
   live line, the twin identical, the report byte-identical twice, the
   gate on a card history, site 2 the federation's straggler, a lane a
   site), each one's seconds and the phase's beside the card's name and
   power limit. At most ``OFFLINE_PHASE_LIMIT_S``.
24. bench  — ``bench_torch.main()``, the port's bench of the headline
   workload (SNIP; the Python loop: 1 + 10 rounds without eval, 1 + 8 with
   the eval every round, each from a clone of one state; the fused
   spelling: blocks of 10 and of 8 rounds with the eval, each after its
   warm calls; then the eval-cache and global-only cells, 1 + 8 rounds and
   a fused block of 8, each with the eval every round), its record printed
   (every spelling's rates); its launch counts asserted. Then
   ``bench_torch.byzantine()``, ``bench.py``'s tracked Byzantine
   configuration (FedAvg, 64 clients of 61x73x61 volumes, small3dcnn, the
   weak-DP defense; 1 + 10 rounds), measured once, its launches asserted.

Every training step, SNIP batch and eval forward of the phased model's
paths runs the stem kernels (one forward, and in training one backward);
the launch counts asserted per path include them. The dense model's stem
is cuDNN's conv: its path launches none of them.

After each phase from 3 on, a line ``{"phase": "seconds", "of": ...,
"seconds": ...}`` with its wall time. Then a ``kernels`` JSON line (one
entry per kernel; ``replaces`` names the Pallas call site, or the list of
sites when one kernel replaces several), the card's name and power limit, and as the last line ``{"ok": true,
"device": {...}}``. Any failure raises and the script exits non-zero;
without CUDA it exits 2 before printing a result.
"""
from __future__ import annotations

import dataclasses
import datetime
import functools
import json
import math
import statistics
import subprocess
import sys
import time

#: published H100 SXM peaks (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12  # f32 (and, as the CUDA-core rate, int32) ops
TENSOR_CORE_BF16_OPS_PER_S = 989e12  # dense bf16, 2 ops per multiply-add

_EXP = "neuroimagedisttraining_tpu/ops/experimental/"
#: the JAX package's Pallas kernels these replace (file:line of pallas_call;
#: a list where one kernel replaces several)
REPLACES = {
    "masked_sgd": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:98",
    "threshold": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:258",
    "score_mask": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:424",
    "mask_apply": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:385",
    "weighted_sum": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:165",
    "quantize_reduce": "neuroimagedisttraining_tpu/ops/pallas_kernels.py:349",
    "stem_fwd": [_EXP + "pallas_stem_fused.py:126", _EXP + "pallas_stem_v3.py:166",
                 _EXP + "pallas_stem.py:102"],
    "stem_bwd": _EXP + "pallas_stem_bwd.py:146",
}

#: the threshold kernel's digit passes (csrc/threshold.cu), each a compare
#: and count per element
THRESHOLD_PASSES = 3.0

N_CLIENTS, SAMPLES, TEST, BATCH, STEPS, ROUNDS = 8, 40, 10, 8, 5, 3
VOLUME = (121, 145, 121)
#: the wires phase: SalientGrads' wires, FedAvg's, the wires held bitwise
#: against the plain dense aggregate of the same locals, rounds per wire,
#: the top-k density
WIRES = ("dense", "bucketed", "bf16", "int8", "sparse", "topk", "hier")
FEDAVG_WIRES = ("dense", "int8", "topk")
TWINS = ("dense", "bucketed", "sparse", "hier")
WIRE_ROUNDS, TOPK_DENSITY = 2, 0.1
#: the fused phase: rounds per wire, the eval after each
FUSED_ROUNDS = 2
#: the evalcache phase: rounds per algorithm (the eval after each), the
#: sampled eval's subset size and rounds, the losses' bound against the
#: cache-off rounds (the reference's subset-width reassociation)
EVALCACHE_ROUNDS, EVAL_CLIENTS, EVAL_CLIENTS_ROUNDS = 2, 4, 2
EVALCACHE_LOSS_RTOL = 4e-7
#: the dense phase: rounds of the dense-stem AlexNet3D
DENSE_ROUNDS = 2
#: the robust phase: the fault spec (run seed 0), rounds per
#: configuration (eager, then the same rounds fused, then a timed fused
#: block), and the configurations: (name, algorithm, agg_impl, robust_agg,
#: defense, fault spec or None for the clean guarded round)
ROBUST_SPEC = "drop=0.125,nan=0.125,scale=0.125:100x"
ROBUST_ROUNDS = 2
ROBUST_CONFIGS = (
    ("plain", "salientgrads", "dense", "none", None, ""),
    ("guard_clean", "salientgrads", "dense", "none", None, None),
    ("guard", "salientgrads", "dense", "none", None, ROBUST_SPEC),
    ("guard_int8", "salientgrads", "int8", "none", None, ROBUST_SPEC),
    ("median", "salientgrads", "dense", "median", None, ROBUST_SPEC),
    ("trimmed_mean", "salientgrads", "dense", "trimmed_mean", None,
     ROBUST_SPEC),
    ("krum", "salientgrads", "dense", "krum", None, ROBUST_SPEC),
    ("multikrum", "salientgrads", "dense", "multikrum", None, ROBUST_SPEC),
    ("norm_krum", "salientgrads", "dense", "norm_krum", None, ROBUST_SPEC),
    ("int8_median", "salientgrads", "int8", "median", None, ROBUST_SPEC),
    ("weak_dp", "salientgrads", "dense", "none", "weak_dp", ROBUST_SPEC),
    ("topk_guarded", "salientgrads", "topk", "none", None, "nan=0.25"),
    ("fedavg_weak_dp", "fedavg", "dense", "none", "weak_dp", ROBUST_SPEC),
)
#: the train_opts phase: rounds per spelling; the exact stratified SNIP's
#: shard (25 of each class per client, which the 25-fold splitter accepts)
TRAIN_OPTS_ROUNDS = 2
STRATIFIED_SAMPLES = 50


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms: each call is queued behind a
    ~10 ms device-side sleep, so the events bracket only its kernels."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float, ops_per_s: float = CUDA_CORE_OPS_PER_S):
    """The least time (ms) for moving ``nbytes`` and doing ``ops`` operations
    at the card's peak rate for their type, and which of the two bounds
    it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev):
    """Each kernel vs its plain version at main-path shapes; returns the
    per-kernel measurements."""
    import torch

    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.topk_select import exact_threshold

    g = torch.Generator(device=dev).manual_seed(1234)
    model = create_model("3dcnn_s2d").to(dev)
    params = init_params(model, g)
    shapes = [tuple(p.shape) for p in params.values()]
    n_params = sum(math.prod(s) for s in shapes)
    kernel_shapes = [tuple(v.shape) for k, v in params.items()
                     if k.endswith(".kernel")]
    n_kernel = sum(math.prod(s) for s in kernel_shapes)
    out = {}

    # -- masked SGD: all 24 leaves, both modes -------------------------------
    lr, mom, wd = 1e-3 * 0.998 ** 2, 0.9, 5e-4
    leaves = {}
    for mode in (False, True):
        ps = [p.clone() for p in params.values()]
        ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
        gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ks = [(torch.rand(s, generator=g, device=dev) < 0.5).float()
              for s in shapes]
        want = [kernels.masked_sgd_plain(p, m, gg, k, lr, mom, wd, mode)
                for p, m, gg, k in zip(ps, ms, gs, ks)]
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, lr, momentum=mom,
                                      wd=wd, mask_grads=mode)
        torch.cuda.synchronize()
        err = max(max(float((a - p).abs().max()), float((b - m).abs().max()))
                  for (a, b), p, m in zip(want, ps, ms))
        same = all(torch.equal(a, p) and torch.equal(b, m)
                   for (a, b), p, m in zip(want, ps, ms))
        if not same:
            raise AssertionError(f"masked_sgd (mask_grads={mode}) differs "
                                 f"from its plain version: max err {err}")
        leaves[mode] = (ps, ms, gs, ks, err)
    ps, ms, gs, ks, _ = leaves[False]
    ms_kernel = device_ms(lambda: kernels.fused_masked_sgd_step(
        ps, ms, gs, ks, lr, momentum=mom, wd=wd))
    ms_plain = device_ms(lambda: [kernels.masked_sgd_plain(
        p, m, gg, k, lr, mom, wd, False) for p, m, gg, k in zip(ps, ms, gs,
                                                                ks)])
    b_ms, b_by = bound(24.0 * n_params, 7.0 * n_params)
    out["masked_sgd"] = dict(
        max_abs_err=max(leaves[m][4] for m in leaves), ms=ms_kernel,
        plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{len(shapes)} leaves, {n_params} f32")

    # -- threshold: the SNIP row (n = all kernel entries, k = n/2) -----------
    n = n_kernel
    k = int(n * 0.5)
    row = torch.randn((1, n), generator=g, device=dev).abs()
    ties = torch.randint(0, 50, (1, n), generator=g, device=dev).float() / 7
    zeros = torch.zeros((1, n), device=dev)
    # +inf, NaN (counted as +inf) and -0.0 (counted as 0) in the row
    r = torch.rand((1, n), generator=g, device=dev)
    special = torch.where(r < 0.01, float("inf"), row)
    special = torch.where((r >= 0.01) & (r < 0.02), float("nan"), special)
    special = torch.where((r >= 0.02) & (r < 0.1), -0.0, special)
    cases = [("random", row, k), ("ties", ties, k), ("zeros", zeros, k),
             ("inf_nan_negzero", special, k), ("inf_nan_negzero k=1",
                                               special, 1),
             ("inf_nan_negzero k=n", special, n), ("random k=1", row, 1),
             ("random k=n", row, n)]
    err = 0.0
    for name, av, kk in cases:
        got = kernels.threshold_topk(av, kk)
        want = exact_threshold(av, kk)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"threshold ({name}) {got} != {want}")
        if name.startswith("random"):
            err = max(err, float((got - want).abs().max()))
    ms_kernel = device_ms(lambda: kernels.threshold_topk(row, k))
    ms_plain = device_ms(lambda: exact_threshold(row, k), reps=20)
    ms_lib = device_ms(lambda: torch.topk(row, k).values[..., -1], reps=20)
    b_ms, b_by = bound(4.0 * n + 4.0, THRESHOLD_PASSES * n)
    out["threshold"] = dict(
        max_abs_err=err, ms=ms_kernel, plain_ms=ms_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=ms_lib, shape=f"[1, {n}] f32, k={k}",
        bitwise_cases=[c[0] for c in cases],
        # tie-heavy rows: every element of the zero row hits one bin
        ties_ms=device_ms(lambda: kernels.threshold_topk(ties, k)),
        zeros_ms=device_ms(lambda: kernels.threshold_topk(zeros, k)))

    # -- score mask: the seven kernel leaves ----------------------------------
    scores = [torch.rand(s, generator=g, device=dev) for s in kernel_shapes]
    norm = torch.cat([s.reshape(-1) for s in scores]).sum()
    flat = torch.cat([s.reshape(-1) for s in scores]) / norm
    thr = exact_threshold(flat[None], k).reshape(())
    got = kernels.fused_score_mask(scores, norm, thr)
    want = [kernels.score_mask_plain(s, norm, thr) for s in scores]
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("score_mask differs from its plain version")
    density = sum(float(m.sum()) for m in got) / n
    if abs(density - 0.5) > 1e-3:
        raise AssertionError(f"score_mask density {density}")
    ms_kernel = device_ms(lambda: kernels.fused_score_mask(scores, norm, thr))
    ms_plain = device_ms(lambda: [kernels.score_mask_plain(s, norm, thr)
                                  for s in scores])
    b_ms, b_by = bound(8.0 * n + 8.0, 2.0 * n)
    out["score_mask"] = dict(
        max_abs_err=max(float((a - b).abs().max()) for a, b in zip(got, want)),
        ms=ms_kernel, plain_ms=ms_plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=f"{len(scores)} leaves, {n} f32")
    out.update(check_agg_kernels(dev, g, params))
    out.update(check_stem_kernels(dev, g, model))
    return out


def _bitwise_or_raise(name, got, want):
    import torch

    torch.cuda.synchronize()
    pairs = list(zip(got, want))
    if not all(torch.equal(a, b) for a, b in pairs):
        err = max(float((a - b).abs().max()) for a, b in pairs)
        raise AssertionError(f"{name} differs from its plain version: max "
                             f"err {err}")
    return max(float((a - b).abs().max()) for a, b in pairs)


def check_agg_kernels(dev, g, params):
    """The aggregation wires' kernels at full-width shapes: mask apply over
    the 24 leaves, the weighted sum over [8, leaf] for every leaf, the int8
    quantize-reduce at [8, 10, 262144] (and at b = 1000 and b = 1001, and
    for 17 clients, with an all-zero bucket), the threshold at [8, n] for
    the largest top-k leaf group."""
    import torch

    from neuroimagedisttraining_torch.core.state import weighted_sum
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.sparsity import kernel_flags
    from neuroimagedisttraining_torch.ops.topk_select import exact_threshold
    from neuroimagedisttraining_torch.parallel import collectives as tc

    out = {}
    names = list(params)
    n_params = sum(v.numel() for v in params.values())
    flags = kernel_flags(params)
    mask = {k: (torch.rand(v.shape, generator=g, device=dev) < 0.5).float()
            if flags[k] else torch.ones_like(v) for k, v in params.items()}
    # client trees: the params plus per-client noise, masked
    stacked = {k: (v[None] + 0.01 * torch.randn((N_CLIENTS,) + v.shape,
                                                generator=g, device=dev))
               * mask[k][None] for k, v in params.items()}
    w = torch.rand(N_CLIENTS, generator=g, device=dev)
    w = w / w.sum()

    # -- mask apply: the SalientGrads re-mask over the 24 leaves -------------
    tree = {k: stacked[k][0].contiguous() + 0.5 for k in names}
    got = kernels.fused_mask_apply(tree, mask)
    err = _bitwise_or_raise("mask_apply", [got[k] for k in names],
                            [kernels.mask_apply_plain(tree[k], mask[k])
                             for k in names])
    ps, ks = [tree[k] for k in names], [mask[k] for k in names]
    b_ms, b_by = bound(12.0 * n_params, 1.0 * n_params)
    out["mask_apply"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: kernels.fused_mask_apply(tree, mask)),
        plain_ms=device_ms(lambda: [kernels.mask_apply_plain(p, m)
                                    for p, m in zip(ps, ks)]),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: torch._foreach_mul(ps, ks)),
        shape=f"{len(names)} leaves, {n_params} f32")

    # -- weighted sum: [8, leaf] for every leaf -------------------------------
    got = kernels.fused_weighted_sum(stacked, w)
    err = _bitwise_or_raise("weighted_sum", [got[k] for k in names],
                            [weighted_sum(stacked[k], w) for k in names])
    vec = sum(kernels.weighted_sum_vector_leaf(v) for v in stacked.values())
    flat = torch.cat([stacked[k].reshape(N_CLIENTS, -1) for k in names], 1)
    b_ms, b_by = bound(4.0 * (N_CLIENTS + 1) * n_params + 4.0 * N_CLIENTS,
                       2.0 * N_CLIENTS * n_params)
    out["weighted_sum"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: kernels.fused_weighted_sum(stacked, w)),
        plain_ms=device_ms(lambda: [weighted_sum(stacked[k], w)
                                    for k in names]),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: torch.tensordot(w, flat, dims=1)),
        shape=f"[{N_CLIENTS}, leaf] x {len(names)} leaves, f32 "
              f"({vec} on the 16-byte path)",
        edge_leaves=check_weighted_sum_edges(dev, g, n_params))

    # -- int8 quantize-reduce: the int8 wire's [8, 10, 262144] buckets --------
    mat = tc.stacked_to_mat(stacked)
    buckets = tc._buckets(mat, tc.DEFAULT_BUCKET_SIZE)
    buckets[0, 3] = 0.0  # an all-zero bucket: scale 1.0
    # 17 clients (two launches, the second resuming from the first's sums)
    # and b = 1001 (the scalar path)
    cases = {"main": buckets,
             "b1000": tc._buckets(mat, 1000),
             "b1001": tc._buckets(mat, 1001),
             "c17": torch.cat([buckets, 0.5 * buckets, 3.0 * buckets[:1]])}
    w17 = torch.rand(17, generator=g, device=dev)
    w17 = w17 / w17.sum()
    errs, plans = [], {}
    for label, x in cases.items():
        u = torch.rand(x.shape, generator=g, device=dev)
        sc = tc._int8_scale(x)[..., 0].contiguous()
        ww = w17 if label == "c17" else w
        got = kernels.fused_quantize_reduce(x, ww, u, sc)
        errs.append(_bitwise_or_raise(
            f"quantize_reduce ({label}, {tuple(x.shape)})", [got],
            [kernels.quantize_reduce_plain(x, ww, u, sc)]))
        plan = kernels.quantize_reduce_plan(
            *x.shape, [x.data_ptr(), u.data_ptr(), got.data_ptr()])
        plans[label] = dict(shape=list(x.shape),
                            path="16-byte" if plan["vec"] else "scalar",
                            tile=plan["tile"], grid=list(plan["grid"]),
                            launches=len(plan["chunks"]))
        if label == "main":
            args = (x, w, u, sc)
    if float(args[3][0, 3]) != 1.0:
        raise AssertionError("the all-zero bucket's scale is not 1.0")
    c, nb, b = buckets.shape
    n = c * nb * b
    b_ms, b_by = bound(8.0 * n + 4.0 * (c * nb + c) + 4.0 * nb * b, 11.0 * n)
    out["quantize_reduce"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: kernels.fused_quantize_reduce(*args)),
        plain_ms=device_ms(lambda: kernels.quantize_reduce_plain(*args),
                           reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        path=plans["main"]["path"], tile=plans["main"]["tile"],
        registers=_ptxas_registers(kernels.BUILD_LOG.get(
            "quantize_reduce", ""), f"quantize_reduce_kernelILi{c}E"),
        plans=plans,
        shape=f"[{c}, {nb}, {b}] f32, and b = 1000, b = 1001, 17 clients")

    # -- threshold at [8, n] for the largest top-k leaf group ----------------
    plan = tc.build_sparse_plan(mask)
    comp = tc._compress(stacked, plan)
    start, end = max(tc.topk_groups(stacked, tc.DEFAULT_BUCKET_SIZE, plan),
                     key=lambda se: se[1] - se[0])
    av = comp[:, start:end].abs()
    k = tc.topk_count(end - start, TOPK_DENSITY)
    # the same rows as a contiguous view whose base is off a 16-byte boundary
    big = torch.empty(av.numel() + 1, device=dev)
    shifted = big[1:].view(av.shape)
    shifted.copy_(av)
    err = _bitwise_or_raise("threshold ([8, n_group])",
                            [kernels.threshold_topk(x, k).view(torch.int32)
                             for x in (av, shifted)],
                            [exact_threshold(av, k).view(torch.int32)] * 2)
    nn = av.numel()
    b_ms, b_by = bound(4.0 * nn + 4.0 * c, THRESHOLD_PASSES * nn)
    out["threshold_topk_group"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: kernels.threshold_topk(av, k)),
        plain_ms=device_ms(lambda: exact_threshold(av, k), reps=20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: torch.topk(av, k).values[..., -1],
                             reps=20),
        shape=f"{list(av.shape)} f32, k={k}")

    # -- the f32 aggregate does not move with TF32 ----------------------------
    off = tc.weighted_mean(stacked, w)
    torch.backends.cuda.matmul.allow_tf32 = True
    on = tc.weighted_mean(stacked, w)
    torch.backends.cuda.matmul.allow_tf32 = False
    if not all(torch.equal(on[k], off[k]) for k in names):
        raise AssertionError("the f32 aggregate moved with TF32")
    out["aggregate_tf32_inert"] = True
    return out


def check_weighted_sum_edges(dev, g, n_params):
    """The weighted sum's edge leaves at full width, bitwise against the
    plain version, for 1, 3, 8 and 16 clients: the flat model (n odd, the
    scalar path), the same values less one at a 4-byte offset (scalar) and
    at a 16-byte offset (the 16-byte path), in one launch. Returns the
    8-client launch's time and the leaves' paths."""
    import torch

    from neuroimagedisttraining_torch.core.state import weighted_sum
    from neuroimagedisttraining_torch.ops import kernels

    res = {}
    for c in (1, 3, 8, 16):
        m = n_params - 1
        big = torch.randn(c * m + 4, generator=g, device=dev)
        xs = {"odd_n": torch.randn((c, n_params), generator=g, device=dev),
              "offset_4": big[1:1 + c * m].view(c, m),
              "offset_16": big[4:4 + c * m].view(c, m)}
        w = torch.rand(c, generator=g, device=dev)
        w = w / w.sum()
        got = kernels.fused_weighted_sum(xs, w)
        _bitwise_or_raise(f"weighted_sum edge leaves (C={c})",
                          list(got.values()),
                          [weighted_sum(x, w) for x in xs.values()])
        if c == 8:
            res["paths"] = {k: "16-byte" if kernels.weighted_sum_vector_leaf(
                x) else "scalar" for k, x in xs.items()}
            res["ms_c8"] = device_ms(lambda: kernels.fused_weighted_sum(xs, w))
            res["bound_ms_c8"] = bound(4.0 * (c + 1) * (n_params + 2 * m), 0)[0]
        del big, xs, got
    res["clients_checked"] = [1, 3, 8, 16]
    return res


def _zs_agreement(name, zs, want, scale):
    """The stem conv output ``zs`` against its plain version ``want``: every
    element within one ulp of the working type, or, where the conv cancels
    to near zero, within 1e-5 of ``scale``, the sum of its terms'
    magnitudes (two f32 sums of 216 products in different orders differ by
    round-off of that size). Returns the counts, raises past them."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    torch.cuda.synchronize()
    ulp = kernels.ulp_distance(zs, want)
    err = (zs.float() - want.float()).abs()
    over = ulp > 1
    rel = err / scale.float().clamp(min=1e-30)
    res = {"elements": zs.numel(), "differing": int((ulp > 0).sum()),
           "over_one_ulp": int(over.sum()),
           "max_abs_err": float(err.max()),
           "max_err_over_terms": float(rel.max()),
           "max_err_over_terms_past_one_ulp":
               float(rel[over].max()) if bool(over.any()) else 0.0}
    if bool((over & (rel > 1e-5)).any()):
        raise AssertionError(f"{name}: zs disagrees with its plain version: "
                             f"{res}")
    return res


def _ptxas_registers(log: str, kernel: str):
    """The registers per thread that ptxas reported for the entry function
    whose name holds ``kernel`` (from ``nvcc -Xptxas -v``), or None."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            for nxt in lines[i + 1:i + 6]:
                if "Used" in nxt and "registers" in nxt:
                    return int(nxt.split("Used")[1].split("registers")[0])
    return None


def check_stem_kernels(dev, g, model):
    """The stem kernels at the main path's shapes: a batch of 8 phased
    121x145x121 bf16 volumes (standard normal plus the label shift of
    +-0.75, as the main path's data), the main model's init stem kernel,
    masked and sign-folded, and a bias of 0.1 * N(0, 1) (the init bias is
    zero; the trained one is not). Plus the narrow f32 model's stem (F = 8,
    phased 69^3, TF32 off), and each of the four stem entry points once."""
    import torch
    import torch.nn.functional as F

    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.experimental import (
        pallas_stem,
        pallas_stem_bwd,
        pallas_stem_fused,
        pallas_stem_v3,
    )
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    bf16 = torch.bfloat16
    out = {}
    stem = model.S2DStemStage_0
    with torch.no_grad():
        sign = torch.where(stem.scale >= 0, 1.0, -1.0)
        w = (stem.masked() * sign.reshape(-1, 1, 1, 1, 1)).to(bf16)
        f = w.shape[0]
        bias = (0.1 * torch.randn(f, generator=g, device=dev)).to(bf16)
    ss = phased_sample_shape(VOLUME)
    x = torch.randn((BATCH,) + ss, generator=g, device=dev, dtype=bf16)
    shift = (torch.rand(BATCH, generator=g, device=dev) < 0.5).to(bf16) \
        * 1.5 - 0.75
    x += shift.reshape(-1, 1, 1, 1, 1)

    # -- stem forward: bf16 at full width ------------------------------------
    # the conv (no bias) against cuDNN's; then the bias epilogue bitwise: the
    # kernel's zs is its own rounded conv plus the bias, rounded, in bf16
    conv, _, _, _ = kernels.stem_fwd(x, w, None, pool=False, stats=False)
    want, _, _, _ = kernels.stem_fwd_plain(x, w, None, pool=False,
                                           stats=False)
    terms, _, _, _ = kernels.stem_fwd_plain(x.abs(), w.abs(), None,
                                            pool=False, stats=False)
    agree = _zs_agreement("stem_fwd", conv, want, terms)
    zs, pooled, s1, s2 = kernels.stem_fwd(x, w, bias)
    _bitwise_or_raise("stem_fwd bias epilogue", [zs], [conv + bias])
    agree["with_bias_max_abs_err"] = float(
        (zs.float() - (want + bias).float()).abs().max())
    del conv, want
    own_pool = F.max_pool3d(zs.permute(0, 4, 1, 2, 3), 3, 3).permute(
        0, 2, 3, 4, 1)
    _bitwise_or_raise("stem_fwd pooled (max-pool of its own zs)", [pooled],
                      [own_pool])
    p1, p2 = kernels.stem_stats_plain(zs)
    mag = zs.double().abs().sum((1, 2, 3))
    s1_rel = float(((s1.double() - p1.double()).abs() / mag).max())
    s2_rel = float(((s2.double() - p2.double()).abs() / p2.double()).max())
    if s1_rel > 1e-5 or s2_rel > 1e-5:
        raise AssertionError(f"stem_fwd sums: s1 {s1_rel}, s2 {s2_rel}")
    # a second launch on the same inputs: the same bits (one writer per
    # output, fixed-order statistics)
    again = kernels.stem_fwd(x, w, bias)
    _bitwise_or_raise("stem_fwd repeat launch", list(again),
                      [zs, pooled, s1, s2])
    del again
    b, d, h, wd, _ = zs.shape
    macs = b * d * h * wd * f * 216
    nbytes = 2.0 * (x.numel() + zs.numel() + pooled.numel() + w.numel() + f) \
        + 8.0 * b * f
    b_ms, b_by = bound(nbytes, 2.0 * macs, TENSOR_CORE_BF16_OPS_PER_S)
    out["stem_fwd"] = dict(
        max_abs_err=agree["max_abs_err"],
        ms=device_ms(lambda: kernels.stem_fwd(x, w, bias)),
        plain_ms=device_ms(lambda: kernels.stem_fwd_plain(x, w, bias),
                           reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        zs_agreement=agree, s1_rel_err_over_terms=s1_rel, s2_rel_err=s2_rel,
        repeat_launch_bitwise=True,
        launch=dict(kernels.stem_fwd_config(b, d + 2, h + 2, wd + 2, f),
                    registers=_ptxas_registers(kernels.BUILD_LOG.get(
                        "stem_fwd", ""), "stem_fwd_mma_kernel")),
        bound_at_cuda_core_ms=2.0 * macs / CUDA_CORE_OPS_PER_S * 1e3,
        shape=f"x {list(x.shape)} bf16, F={f}, {macs} multiply-adds")

    # -- the serving worker's shape: one volume (B = 1), the same rule -------
    x1 = x[:1]
    conv1, _, _, _ = kernels.stem_fwd(x1, w, None, pool=False, stats=False)
    want1, _, _, _ = kernels.stem_fwd_plain(x1, w, None, pool=False,
                                            stats=False)
    terms1, _, _, _ = kernels.stem_fwd_plain(x1.abs(), w.abs(), None,
                                             pool=False, stats=False)
    agree1 = _zs_agreement("stem_fwd B=1", conv1, want1, terms1)
    z1, pool1, s11, s21 = kernels.stem_fwd(x1, w, bias)
    _bitwise_or_raise("stem_fwd B=1 bias epilogue", [z1], [conv1 + bias])
    _bitwise_or_raise("stem_fwd B=1 pooled", [pool1], [F.max_pool3d(
        z1.permute(0, 4, 1, 2, 3), 3, 3).permute(0, 2, 3, 4, 1)])
    t1, t2 = kernels.stem_stats_plain(z1)
    s11_rel = float(((s11.double() - t1.double()).abs()
                     / z1.double().abs().sum((1, 2, 3))).max())
    s21_rel = float(((s21.double() - t2.double()).abs()
                     / t2.double()).max())
    if s11_rel > 1e-5 or s21_rel > 1e-5:
        raise AssertionError(f"stem_fwd B=1 sums: s1 {s11_rel}, s2 {s21_rel}")
    _bitwise_or_raise("stem_fwd B=1 repeat launch",
                      list(kernels.stem_fwd(x1, w, bias)),
                      [z1, pool1, s11, s21])
    _, d1, h1, w1, _ = z1.shape
    macs1 = d1 * h1 * w1 * f * 216
    b_ms, b_by = bound(2.0 * (x1.numel() + z1.numel() + pool1.numel()
                              + w.numel() + f) + 8.0 * f, 2.0 * macs1,
                       TENSOR_CORE_BF16_OPS_PER_S)
    out["stem_fwd"]["at_serve_b1"] = dict(
        max_abs_err=agree1["max_abs_err"],
        ms=device_ms(lambda: kernels.stem_fwd(x1, w, bias)),
        plain_ms=device_ms(lambda: kernels.stem_fwd_plain(x1, w, bias),
                           reps=10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None, zs_agreement=agree1,
        s1_rel_err_over_terms=s11_rel, s2_rel_err=s21_rel,
        repeat_launch_bitwise=True,
        launch=kernels.stem_fwd_config(1, d1 + 2, h1 + 2, w1 + 2, f),
        shape=f"x {list(x1.shape)} bf16, F={f}, {macs1} multiply-adds")
    del conv1, want1, terms1, z1, pool1

    # -- the narrow f32 model's stem (TF32 off) -------------------------------
    nss = phased_sample_shape((69, 69, 69))
    narrow = create_model("3dcnn_s2d", num_classes=1,
                          widths=(8, 16, 16, 16, 16), dropout_rate=0.0,
                          sample_shape=nss).to(dev)
    init_params(narrow, g)
    with torch.no_grad():
        w32 = narrow.S2DStemStage_0.masked().contiguous()
    b32 = 0.1 * torch.randn(w32.shape[0], generator=g, device=dev)
    x32 = torch.randn((4,) + nss, generator=g, device=dev) + 0.75
    z32, p32, s132, s232 = kernels.stem_fwd(x32, w32, b32)
    want32, _, _, _ = kernels.stem_fwd_plain(x32, w32, b32, pool=False,
                                             stats=False)
    terms32, _, _, _ = kernels.stem_fwd_plain(x32.abs(), w32.abs(),
                                              b32.abs(), pool=False,
                                              stats=False)
    rel32 = float(((z32 - want32).abs() / terms32).max())
    if rel32 > 1e-5:
        raise AssertionError(f"stem_fwd f32: zs {rel32} of its terms")
    ulp32 = kernels.ulp_distance(z32, want32)
    _bitwise_or_raise("stem_fwd f32 pooled", [p32], [F.max_pool3d(
        z32.permute(0, 4, 1, 2, 3), 3, 3).permute(0, 2, 3, 4, 1)])
    q1, q2 = kernels.stem_stats_plain(z32)
    if not (torch.allclose(s132, q1, rtol=1e-5, atol=1e-5 * float(
            z32.abs().sum((1, 2, 3)).max())) and
            torch.allclose(s232, q2, rtol=1e-5)):
        raise AssertionError("stem_fwd f32 sums")
    out["stem_fwd"]["f32_narrow"] = dict(
        shape=list(x32.shape), zs_err_over_terms=rel32,
        differing=int((ulp32 > 0).sum()), over_one_ulp=int((ulp32 > 1).sum()),
        max_abs_err=float((z32 - want32).abs().max()))

    # -- stem backward: both tie rules on the kernel's own bf16 zs ------------
    # dzs bitwise; the fused bias gradient's dzs bitwise the same, its dbias
    # within one bf16 ulp of the plain per-channel sum of dzs or, where that
    # sum cancels, within 1e-5 of the channel's sum of magnitudes (another
    # order of the sum); a second launch bitwise the first
    gp = torch.randn(pooled.shape, generator=g, device=dev).to(bf16)
    g1 = torch.randn(s1.shape, generator=g, device=dev)
    g2 = 1e-3 * torch.randn(s1.shape, generator=g, device=dev)
    args = (zs, pooled, gp, g1, g2)
    errs, dbias_ulp, dbias_rel = [], 0, 0.0
    for ties in kernels.STEM_TIES:
        want = kernels.stem_bwd_plain(*args, ties=ties)
        got = kernels.stem_bwd(*args, ties=ties)
        fused, dbias = kernels.stem_bwd(*args, ties=ties, bias_grad=True)
        again, dbias2 = kernels.stem_bwd(*args, ties=ties, bias_grad=True)
        errs.append(_bitwise_or_raise(f"stem_bwd ({ties})", [got], [want]))
        _bitwise_or_raise(f"stem_bwd ({ties}) bias_grad dzs and repeat",
                          [fused, again, dbias2], [got, got, dbias])
        torch.cuda.synchronize()
        ulp, rel = kernels.dbias_agreement(dbias, want)
        if rel > 1e-5:
            raise AssertionError(f"stem_bwd ({ties}): dbias {dbias.tolist()}"
                                 f" against the plain sum of dzs")
        dbias_ulp, dbias_rel = max(dbias_ulp, ulp), max(dbias_rel, rel)
        del want, got, fused, again
    pd, ph, pw = pooled.shape[1:4]
    core = zs[:, :3 * pd, :3 * ph, :3 * pw].reshape(b, pd, 3, ph, 3, pw, 3, f)
    count = (core == pooled[:, :, None, :, None, :, None, :]).sum((2, 4, 6))
    nbytes = 2.0 * (2 * zs.numel() + 2 * pooled.numel()) + 8.0 * b * f
    b_ms, b_by = bound(nbytes, 4.0 * zs.numel())
    dzs = kernels.stem_bwd(*args, ties="first")
    out["stem_bwd"] = dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: kernels.stem_bwd(*args, ties="first")),
        plain_ms=device_ms(lambda: kernels.stem_bwd_plain(
            *args, ties="first"), reps=10),
        split_ms=device_ms(lambda: kernels.stem_bwd(*args, ties="split")),
        bias_grad_ms=device_ms(lambda: kernels.stem_bwd(
            *args, ties="first", bias_grad=True)),
        sum_ms=device_ms(lambda: dzs.sum(dim=(0, 1, 2, 3))),
        dbias_max_ulp=dbias_ulp, dbias_err_over_magnitude=dbias_rel,
        repeat_launch_bitwise=True,
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tied_window_fraction=float((count > 1).float().mean()),
        launch=dict(kernels.stem_bwd_config(b, d, h, wd, f, bf16),
                    registers=_ptxas_registers(
                        kernels.BUILD_LOG.get("stem_bwd", ""),
                        "stem_bwd_kernelI13__nv_bfloat16Li64E")),
        shape=f"zs {list(zs.shape)} bf16")
    del dzs

    # -- the four entry points, once each at full width -----------------------
    wt = w.permute(0, 2, 3, 4, 1).reshape(f, 216)   # k = ((dz*3+dy)*3+dx)*8+p
    w_dhwio = w.permute(2, 3, 4, 1, 0)
    xin = x.permute(0, 3, 1, 2, 4)
    conv = pallas_stem.stem_conv_pallas(x, wt)
    want0, _, _, _ = kernels.stem_fwd_plain(x, w, None, pool=False,
                                            stats=False)
    b_ms, b_by = bound(2.0 * (x.numel() + conv.numel() + w.numel()),
                       2.0 * macs, TENSOR_CORE_BF16_OPS_PER_S)
    entries = {"stem_conv_pallas": dict(
        zs_agreement=_zs_agreement("stem_conv_pallas", conv, want0, terms),
        ms=device_ms(lambda: pallas_stem.stem_conv_pallas(x, wt)),
        plain_ms=device_ms(lambda: kernels.stem_fwd_plain(
            x, w, None, pool=False, stats=False)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: F.conv3d(xin, w)))}
    for label, got, ref_out in (
            ("fused_stem_fwd", pallas_stem_fused.fused_stem_fwd(x, wt),
             pallas_stem_fused.ref(x, w_dhwio)),
            ("fused_stem_fwd_v3", pallas_stem_v3.fused_stem_fwd_v3(
                x, pallas_stem_v3.make_stem_lhs(w_dhwio), bias.float()),
             pallas_stem_v3.ref(x, w_dhwio, bias.float()))):
        gz, gpool, gst = got
        rz, _, (rs1, rs2) = ref_out
        if label == "fused_stem_fwd":
            res = dict(zs_agreement=_zs_agreement(label, gz, rz.contiguous(),
                                                  terms))
        else:  # the conv is stem_conv_pallas's; the bias epilogue bitwise
            _bitwise_or_raise(f"{label} zs", [gz], [conv + bias])
            res = dict(with_bias_max_abs_err=float(
                (gz.float() - rz.float()).abs().max()))
        _bitwise_or_raise(f"{label} pooled", [gpool], [F.max_pool3d(
            gz.permute(0, 4, 1, 2, 3), 3, 3).permute(0, 2, 3, 4, 1)])
        tot = gst.sum(1)
        zmag = gz.double().abs().sum((1, 2, 3))
        res["s1_rel_err_over_terms"] = float(
            ((tot[:, 0].double() - rs1.double()).abs() / zmag).max())
        res["s2_rel_err"] = float(
            ((tot[:, 1] - rs2).abs() / rs2.abs()).max())
        if res["s1_rel_err_over_terms"] > 1e-5 or res["s2_rel_err"] > 1e-5:
            raise AssertionError(f"{label}: statistics {res}")
        entries[label] = res
    zr = zs.detach().clone().requires_grad_(True)
    m, r1, r2 = pallas_stem_bwd.pool_sum_sumsq(zr)
    (dz,) = torch.autograd.grad([m, r1, r2], [zr], [gp, g1, g2])
    _bitwise_or_raise("pool_sum_sumsq pooled", [m.detach()], [own_pool])
    entries["pool_sum_sumsq"] = dict(max_abs_err=_bitwise_or_raise(
        "pool_sum_sumsq backward (split)", [dz],
        [kernels.stem_bwd_plain(zs, pooled, gp, g1, g2, ties="split")]))
    out["stem_fwd"]["entry_points"] = entries
    return out


def _to_cpu(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_cpu(v) for v in x)
    return x


def _tensors(x):
    """The tensors of a tree, a tuple of trees or a tensor, in order."""
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, tuple):
        return [t for v in x for t in _tensors(v)]
    return [x]


class AggCapture:
    """Keeps the inputs and the output of a round's one aggregate (the
    algorithm's ``_aggregate``, or ``_topk_aggregate`` under top-k)."""

    def __init__(self, algo):
        self.name = ("_topk_aggregate" if algo.agg_impl == "topk"
                     else "_aggregate")
        fn = getattr(algo, self.name)

        def call(*args):
            out = fn(*args)
            self.args, self.out = args, out
            return out

        setattr(algo, self.name, call)


def _wire_images(algo, args, out, bucket):
    """Each client's row as the wire delivers it to the reduce, ``[C, N]``
    in the reference's flat layout, and the wire's decisions on it (the
    int8 payload, the bf16 casts, the top-k selection) — from one side's
    captured aggregate, on the CPU."""
    import torch

    from neuroimagedisttraining_torch.parallel import collectives as tc

    impl = algo.agg_impl
    if impl == "topk":
        locals_, global_params, res_in, _, w = args[:5]
        comp = {k: (locals_[k] - global_params[k][None]) + res_in[k]
                for k in locals_}
        comp = tc.plan_dead_select(comp, algo._agg_sparse_plan)
        img = tc.stacked_to_mat({k: comp[k] - out[1][k] for k in comp})
        return img, img != 0, w
    stacked, w, u = args[:3]
    mat = tc.stacked_to_mat(stacked)
    if impl == "dense":
        return mat, torch.zeros(0), w
    if impl == "bf16":
        img = tc.wire_roundtrip_mat(mat, "bf16")
        return img, img, w
    q, _ = tc._quantize_int8(tc._buckets(mat, bucket), u)
    return tc.wire_roundtrip_mat(mat, "int8", bucket_size=bucket,
                                 uniforms=u), q, w


def small_parity(dev):
    """One narrow SalientGrads round on the CPU and on the GPU from the
    same parameters, mask, batch order and int8 uniforms, per wire (dense,
    bf16, int8, topk). For each wire:

    * the card's aggregate equals, bit for bit, the CPU's aggregate of the
      very inputs the card's got (its locals, weights, uniforms, residual):
      the card's wire routing (the reference layout, the uniforms seam, the
      per-bucket scales, the top-k groups, the re-mask's input) against the
      CPU's;
    * the locals agree norm-wise within 1e-5 (local training, CPU vs GPU);
    * the wire's decisions (int8 quanta, bf16 casts, top-k selections) that
      differ between the two sides' locals are counted and bounded: a value
      within round-off of a decision edge may flip, each flip worth a whole
      quantum of one client's value;
    * the global models differ by those flips and round-off only: after
      removing the weighted difference of the two sides' wire images, what
      remains is within 1e-5 of the model's norm; with no flip the models
      agree within 1e-5 norm-wise per kernel leaf outright."""
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.core.trainer import epoch_permutations
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel import collectives as tc

    ss = phased_sample_shape((69, 69, 69))
    mk = dict(num_classes=1, widths=(8, 16, 16, 16, 16), dropout_rate=0.0,
              sample_shape=ss)
    data = make_synthetic_federated(seed=4, n_clients=3, samples_per_client=6,
                                    test_per_client=5, sample_shape=ss)
    hp = HyperParams(lr=0.01, momentum=0.9, weight_decay=5e-4,
                     grad_clip=10.0, local_epochs=1, steps_per_epoch=3,
                     batch_size=4)
    g = torch.Generator().manual_seed(0)
    params = init_params(create_model("3dcnn_s2d", **mk), g)
    nvals = [int(n) for n in data.n_train]
    perms = [epoch_permutations(g, n, 1, 12, n_rows=data.x_train.shape[1])
             for n in nvals]
    snip_idx = [torch.randint(0, n, (1, 4), generator=g) for n in nvals]
    bucket = 4096
    n_params = sum(v.numel() for v in params.values())
    uniforms = torch.rand((3,) + tc.bucket_shape(n_params, bucket),
                          generator=g)
    #: the most wire decisions, as a share of the C x N wire values, that
    #: may flip between the two sides' locals
    flip_cap = {"dense": 0.0, "bf16": 1e-2, "int8": 1e-3, "topk": 1e-3}
    results = {}
    for impl in ("dense", "bf16", "int8", "topk"):
        runs = {}
        for label, device in (("cpu", "cpu"), ("gpu", dev)):
            algo = SalientGrads(create_model("3dcnn_s2d", **mk), data, hp,
                                loss_type="bce", dense_ratio=0.5,
                                agg_impl=impl, agg_bucket_size=bucket,
                                agg_topk_density=TOPK_DENSITY, device=device)
            state = algo.init_state(
                generator=torch.Generator(device=device).manual_seed(1),
                params=params, snip_idx=snip_idx)
            own_mask = {k: v.cpu() for k, v in state.mask.items()}
            if label == "gpu":  # train from the CPU run's mask
                state.mask = {k: v.to(device)
                              for k, v in runs["cpu"]["mask"].items()}
            cap = AggCapture(algo)
            kernels.reset_launches()
            state, met = algo.run_round(state, 0, perms=perms,
                                        agg_uniforms=uniforms)
            launches = dict(kernels.LAUNCHES)
            ev = algo.evaluate(state)
            runs[label] = dict(
                algo=algo, cap=cap, mask=own_mask,
                params={k: v.cpu() for k, v in state.global_params.items()},
                loss=float(met["train_loss"]),
                ev={k: float(v) for k, v in ev.items()
                    if not k.startswith("acc_per")}, launches=launches)
        cpu, gpu = runs["cpu"], runs["gpu"]
        # the card's wire against the CPU's, on the card's own inputs
        gpu_args = _to_cpu(gpu["cap"].args)
        again = getattr(type(cpu["algo"]), cpu["cap"].name)(cpu["algo"],
                                                            *gpu_args)
        routed = [a.equal(b) for a, b in zip(_tensors(again),
                                             _tensors(_to_cpu(gpu["cap"].out)))]
        # the wire's decisions and images on each side's inputs
        img_c, dec_c, w = _wire_images(cpu["algo"], cpu["cap"].args,
                                       cpu["cap"].out, bucket)
        img_g, dec_g, _ = _wire_images(cpu["algo"], gpu_args,
                                       _to_cpu(gpu["cap"].out), bucket)
        flips = int((dec_c != dec_g).sum())
        n_values = img_c.numel()
        locals_c = tc.stacked_to_mat(cpu["cap"].args[0])
        locals_g = tc.stacked_to_mat(gpu_args[0])
        locals_rel = float((locals_g - locals_c).norm() / locals_c.norm())
        pc, pg = cpu["params"], gpu["params"]
        delta = (w[:, None] * (img_g - img_c)).sum(0)
        vc, vg = tc.tree_to_vec(pc), tc.tree_to_vec(pg)
        unexplained = float(((vg - vc) - delta).norm() / vc.norm())
        agree = sum(int((cpu["mask"][k] == gpu["mask"][k]).sum())
                    for k in pc) / sum(v.numel() for v in pc.values())
        rel = max(float((pg[k] - pc[k]).norm() / pc[k].norm())
                  for k in pc if k.endswith(".kernel"))
        lau = gpu["launches"]
        res = {"phase": "parity", "agg_impl": impl, "mask_agreement": agree,
               "wire_equals_cpu_on_card_inputs": all(routed),
               "locals_rel_err": locals_rel, "wire_flips": flips,
               "wire_values": n_values, "unexplained_rel_err": unexplained,
               "max_kernel_rel_err": rel, "train_loss_cpu": cpu["loss"],
               "train_loss_gpu": gpu["loss"], "eval_cpu": cpu["ev"],
               "eval_gpu": gpu["ev"], "gpu_launches": lau}
        emit(res)
        ec, eg = cpu["ev"], gpu["ev"]
        tol = 1e-4 if impl == "dense" else 1e-2
        if agree < 0.999 or (impl == "dense" and rel > tol) or \
                abs(cpu["loss"] - gpu["loss"]) > 1e-4 * abs(cpu["loss"]) or \
                abs(ec["global_loss"] - eg["global_loss"]) > \
                tol * abs(ec["global_loss"]):
            raise AssertionError(f"GPU round disagrees with the CPU round: "
                                 f"{res}")
        if not all(routed):
            raise AssertionError(f"parity {impl}: the card's aggregate "
                                 "differs from the CPU's on the same inputs")
        if locals_rel > 1e-5 or flips > flip_cap[impl] * n_values or \
                unexplained > 1e-5 or (flips == 0 and rel > 1e-5):
            raise AssertionError(f"parity {impl}: {res}")
        groups = len(tc.topk_groups(gpu_args[0], bucket,
                                    gpu["algo"]._agg_sparse_plan))
        want = {"dense": {"weighted_sum": 1, "quantize_reduce": 0},
                "bf16": {"weighted_sum": 1, "quantize_reduce": 0},
                "int8": {"quantize_reduce": 1, "weighted_sum": 0},
                "topk": {"mask_apply": 1, "weighted_sum": 1,
                         "threshold": groups}}[impl]
        # one stem forward and backward per active local step, and the
        # dropout probe's forward at a new algorithm's first round
        want["stem_fwd"] = want["stem_bwd"] = sum(
            min(hp.steps_per_epoch, -(-n // hp.batch_size)) for n in nvals)
        want["stem_fwd"] += 1
        if any(lau[k] != v for k, v in want.items()):
            raise AssertionError(f"parity {impl}: launches {lau}, want {want}")
        results[impl] = res
    return results


def _eval_chunks() -> int:
    """Forwards per client and eval of a TEST-row shard (eval batch 32)."""
    return -(-TEST // min(32, TEST))


def main_path(dev):
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    t0 = time.perf_counter()
    data = device_synthetic_federated(
        N_CLIENTS, SAMPLES, phased_sample_shape(VOLUME),
        torch.Generator(device=dev).manual_seed(0), test_per_client=TEST)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    model = create_model("3dcnn_s2d", num_classes=1,
                         sample_shape=phased_sample_shape(VOLUME))
    algo = SalientGrads(model, data, hp,
                        loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
                        itersnip_iterations=1, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    state = algo.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, history = algo.run(ROUNDS, eval_every=0, state=state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)

    rounds = [h for h in history if h["round"] >= 0]
    final = history[-1]
    round_s = [h["round_time_s"] for h in rounds]
    res = {
        "phase": "main", "model": "3dcnn_s2d", "clients": N_CLIENTS,
        "samples_per_client": SAMPLES, "sample_shape":
            list(phased_sample_shape(VOLUME)), "batch": BATCH,
        "steps": STEPS, "rounds": ROUNDS, "compute_dtype": "bfloat16",
        # run() fetches each round's record one round late and stamps its
        # time at that flush: the sum is the rounds' wall time, a round's
        # share is right to within one round. The steady rate is the
        # bench phase's.
        "data_s": data_s, "init_snip_s": init_s, "round_s": round_s,
        "rounds_per_sec_with_first": len(round_s) / sum(round_s),
        "run_with_final_eval_s": run_s,
        "train_loss": [h["train_loss"] for h in rounds],
        "final_eval": final, "peak_mem_bytes": peak, "launches": launches,
    }
    emit(res)
    losses = res["train_loss"] + [final["global_loss"],
                                  final["personal_loss"]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(final["mask_density"] - 0.5) > 1e-3:
        raise AssertionError(f"mask density {final['mask_density']}")
    want_sgd = ROUNDS * N_CLIENTS * STEPS * 1  # one launch per step
    # the stem: one forward and one backward per training step and SNIP
    # batch, one forward per eval chunk (global and personal, every client)
    # and the dropout probe's (FedAlgorithm._dropout_calls, once)
    want = {"masked_sgd": want_sgd, "threshold": 1, "score_mask": 1,
            "weighted_sum": ROUNDS,
            "stem_fwd": (want_sgd + N_CLIENTS + 2 * N_CLIENTS * _eval_chunks()
                         + 1),
            "stem_bwd": want_sgd + N_CLIENTS}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    for p in state.global_params.values():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("non-finite global parameters")
    return launches


class AggProbe:
    """Times every aggregate of ``algo`` with CUDA events (its
    ``_aggregate``, and ``_topk_aggregate`` under top-k) and, with
    ``twin``, holds each ``_aggregate`` against the plain dense aggregate
    of the same locals (``weighted_tree_sum``: multi-tensor ops, no kernel
    launch)."""

    def __init__(self, algo, twin: bool):
        import torch

        from neuroimagedisttraining_torch.core.state import weighted_tree_sum

        self.events, self.twin_equal = [], True

        def timed(fn):
            def call(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                self.events.append((start, end))
                return out
            return call

        def aggregate(stacked, weights, uniforms=None, mesh_rows=None):
            out = timed(agg)(stacked, weights, uniforms, mesh_rows)
            if twin:
                dense = weighted_tree_sum(stacked, weights)
                self.twin_equal &= all(torch.equal(out[k], dense[k])
                                       for k in dense)
            return out

        agg = algo._aggregate
        algo._aggregate = aggregate
        algo._topk_aggregate = timed(algo._topk_aggregate)

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def _drive_wire(algo, state, phase, impl, want, twin):
    """WIRE_ROUNDS rounds of ``algo`` from ``state``, the launch counters
    zeroed just before and read just after; every aggregate timed (CUDA
    events) and, with ``twin``, held against the plain dense aggregate of
    the same locals. Checks finite losses and parameters and the launches
    ``want``; returns (state, result line)."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    probe = AggProbe(algo, twin=twin)
    torch.cuda.synchronize()
    kernels.reset_launches()
    round_s, losses = [], []
    for r in range(WIRE_ROUNDS):
        t0 = time.perf_counter()
        state, met = algo.run_round(state, r)
        losses.append(float(met["train_loss"]))
        round_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res = {"phase": phase, "agg_impl": impl, "rounds": WIRE_ROUNDS,
           "round_s": round_s, "rounds_per_sec_last": 1 / round_s[-1],
           "agg_device_ms": probe.ms(), "train_loss": losses,
           "launches": launches}
    if twin:
        res["equals_dense_twin"] = probe.twin_equal
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{phase} {impl}: non-finite loss {losses}")
    for p in state.global_params.values():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError(f"{phase} {impl}: non-finite global "
                                 "parameters")
    want = {**{k: 0 for k in kernels.LAUNCHES}, **want}
    if launches != want:
        emit(res)
        raise AssertionError(f"{phase} {impl}: launches {launches}, want "
                             f"{want}")
    if not probe.twin_equal:
        emit(res)
        raise AssertionError(f"{phase} {impl}: aggregate differs from the "
                             "dense aggregate of the same locals")
    return state, res


def wires_path(dev):
    """The main configuration's cohort, at full width.

    * SalientGrads: SNIP once, then WIRE_ROUNDS rounds per ``agg_impl``,
      each from ``clone_state`` of the same state (generator included).
    * FedAvg (the dense twin, every weight trained, a personal stack of the
      last locals): WIRE_ROUNDS rounds on "dense", "int8" and "topk" (top-k
      over the whole flat model: no plan), each from the same init, then
      the final fine-tune of every client after the dense rounds.

    Returns the launches per path."""
    import torch

    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.core.state import (
        HyperParams,
        clone_tree,
        tree_scatter_update,
        zeros_like_tree,
    )
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.ops.sparsity import mask_density
    from neuroimagedisttraining_torch.parallel import collectives as tc

    data = device_synthetic_federated(
        N_CLIENTS, SAMPLES, phased_sample_shape(VOLUME),
        torch.Generator(device=dev).manual_seed(0), test_per_client=TEST)
    hp = HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                     weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                     steps_per_epoch=STEPS, batch_size=BATCH)
    model = create_model("3dcnn_s2d", num_classes=1,
                         sample_shape=phased_sample_shape(VOLUME))
    kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16",
              agg_topk_density=TOPK_DENSITY)
    sg_kw = dict(dense_ratio=0.5, itersnip_iterations=1, **kw)
    state0 = SalientGrads(model, data, hp, **sg_kw).init_state()
    sgd = WIRE_ROUNDS * N_CLIENTS * STEPS
    out = {}
    # the out-of-place personal update of a round (run_round leaves its
    # input state as it was) against the in-place row write it replaced, on
    # the full-width [C, ...] stack
    idx = torch.arange(N_CLIENTS, device=dev)
    rows = clone_tree(state0.personal_params)
    copy_ms = device_ms(lambda: tree_scatter_update(
        state0.personal_params, idx, rows))
    inplace = clone_tree(state0.personal_params)

    def write_rows():
        for k in inplace:
            inplace[k][idx] = rows[k]

    emit({"phase": "wires", "step": "personal_update",
          "out_of_place_ms": copy_ms, "in_place_ms": device_ms(write_rows),
          "bytes": sum(v.numel() * v.element_size()
                       for v in rows.values())})
    del rows, inplace
    for impl in WIRES:
        algo = SalientGrads(model, data, hp, agg_impl=impl, **sg_kw)
        state = dataclasses.replace(
            algo.clone_state(state0),
            agg_residual=(zeros_like_tree(state0.personal_params)
                          if impl == "topk" else None))
        algo._ensure_agg_plan(state)
        # a new algorithm: its first round runs the dropout probe's forward
        want = {"masked_sgd": sgd, "stem_fwd": sgd + 1, "stem_bwd": sgd,
                "weighted_sum": 0 if impl == "int8" else WIRE_ROUNDS,
                "quantize_reduce": WIRE_ROUNDS if impl == "int8" else 0,
                "mask_apply": WIRE_ROUNDS if impl == "topk" else 0}
        if impl == "topk":
            want["threshold"] = WIRE_ROUNDS * len(tc.topk_groups(
                state.personal_params, algo.agg_bucket_size,
                algo._agg_sparse_plan))
        state, res = _drive_wire(algo, state, "wires", impl, want,
                                 twin=impl in TWINS)
        res["global_kernel_density"] = mask_density(state.global_params)
        emit(res)
        if impl == "topk" and abs(res["global_kernel_density"] - 0.5) > 1e-3:
            raise AssertionError("topk: the re-mask did not hold, global "
                                 f"density {res['global_kernel_density']}")
        if abs(mask_density(state.mask) - 0.5) > 1e-3:
            raise AssertionError(f"mask density {mask_density(state.mask)}")
        out[f"wires/{impl}"] = res["launches"]
    del state0, state

    for impl in FEDAVG_WIRES:
        algo = FedAvg(model, data, hp, agg_impl=impl, **kw)
        state = algo.init_state()
        want = {"masked_sgd": sgd, "stem_fwd": sgd + 1, "stem_bwd": sgd,
                "weighted_sum": 0 if impl == "int8" else WIRE_ROUNDS,
                "quantize_reduce": WIRE_ROUNDS if impl == "int8" else 0}
        if impl == "topk":
            # no plan: the groups cut the whole flat model
            want["threshold"] = WIRE_ROUNDS * len(tc.topk_groups(
                state.personal_params, algo.agg_bucket_size))
        state, res = _drive_wire(algo, state, "fedavg", impl, want,
                                 twin=impl in TWINS)
        emit(res)
        out[f"fedavg/{impl}"] = res["launches"]
        if impl != "dense":
            continue
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, rec = algo.finalize(state)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        fin = {"phase": "fedavg", "step": "finalize",
               "seconds": time.perf_counter() - t0, "launches": launches,
               **{k: float(v) for k, v in rec.items()}}
        emit(fin)
        want = {**{k: 0 for k in launches},
                "masked_sgd": N_CLIENTS * STEPS,
                "stem_fwd": N_CLIENTS * STEPS
                + 2 * N_CLIENTS * _eval_chunks(),
                "stem_bwd": N_CLIENTS * STEPS}
        if launches != want:
            raise AssertionError(f"fedavg finalize: launches {launches}, "
                                 f"want {want}")
        if not all(math.isfinite(fin[k]) for k in
                   ("global_loss", "personal_loss", "global_acc",
                    "personal_acc")):
            raise AssertionError(f"fedavg finalize: {fin}")
        for p in state.personal_params.values():
            if not bool(torch.isfinite(p).all()):
                raise AssertionError("fedavg finalize: non-finite personal "
                                     "parameters")
        out["fedavg/finalize"] = launches
    return out


def _eager_rounds(algo, state, rounds):
    """``rounds`` rounds of ``algo`` from ``state`` through ``run_round``,
    the full eval after each: (state, round metric rows, eval rows,
    launches of the rounds, launches of the evals), the counters zeroed
    just before."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    mets, evals = [], []
    ev_launches = {k: 0 for k in kernels.snapshot_launches()}
    for r in range(rounds):
        state, met = algo.run_round(state, r)
        mets.append(met)
        before = kernels.snapshot_launches()
        ev = algo.evaluate(state)
        after = kernels.snapshot_launches()
        for k in ev_launches:
            ev_launches[k] += after[k] - before[k]
        evals.append({k: v for k, v in ev.items()
                      if not k.startswith("acc_per")})
    torch.cuda.synchronize()
    total = kernels.snapshot_launches()
    round_launches = {k: total[k] - ev_launches[k] for k in ev_launches}
    return (state, [{k: float(v) for k, v in m.items()} for m in mets],
            [{k: float(v) for k, v in ev.items()} for ev in evals],
            round_launches, ev_launches)


def _tensor_trees(state):
    """The state's fields that hold a tree of tensors (parameters, masks,
    residuals), by name."""
    return {f.name: getattr(state, f.name)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), dict)}


def _spread(a_state, a_mets, a_evals, b_state, b_mets, b_evals):
    """The largest absolute difference between two runs: round metrics,
    eval rows and every tree of tensors of the states (parameters, masks,
    residuals)."""
    diffs = [abs(x[k] - y[k]) for x, y in zip(a_mets, b_mets) for k in x]
    diffs += [abs(x[k] - y[k]) for x, y in zip(a_evals, b_evals) for k in x]
    b_trees = _tensor_trees(b_state)
    for name, a in _tensor_trees(a_state).items():
        b = b_trees[name]
        diffs += [float((a[k].float() - b[k].float()).abs().max())
                  for k in a]
    return max(diffs)


def _rates_in_pairs(algo, state, rounds):
    """Rounds/s of ``rounds`` rounds with the eval after each, through
    ``run_round`` + ``evaluate`` (no host fetch until the end) and through
    ``run_rounds_fused`` (its metrics fetched once), in the order eager,
    fused, fused, eager; each ends in a synchronize."""
    import torch

    def eager():
        s = state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for r in range(rounds):
            s, _ = algo.run_round(s, r)
            algo.evaluate(s)
        torch.cuda.synchronize()
        return rounds / (time.perf_counter() - t0)

    def fused():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.run_rounds_fused(state, 0, rounds, eval_every=1)[1].materialize()
        torch.cuda.synchronize()
        return rounds / (time.perf_counter() - t0)

    out = {"eager": [], "fused": []}
    for kind in ("eager", "fused", "fused", "eager"):
        out[kind].append(eager() if kind == "eager" else fused())
    return out


#: the fused phase's baselines: (path, class, options) at the personal
#: phase's configurations, SubAvg over two epochs (its second leg runs);
#: the paths whose eager and fused rates are also taken in interleaved
#: pairs
FUSED_BASELINES = (
    ("dispfl", "DisPFL", dict(frac=0.5, neighbor_mode="random")),
    ("dispfl_active", "DisPFL", dict(frac=0.5, active=0.5)),
    ("dispfl_static", "DisPFL", dict(frac=0.5, static_masks=True)),
    ("subavg", "SubAvg", dict(epochs=2)),
    ("ditto", "Ditto", dict()),
    ("local", "LocalOnly", dict()),
    ("dpsgd", "DPSGD", dict(frac=0.5)),
)
FUSED_PAIRS = ("dispfl_static", "ditto")


def _personal_algo(cls_name, opts, model, data, hp):
    """A baseline of the personal and fused phases on the main
    configuration: bf16 compute, ``dense_ratio`` 0.5 for the masked ones,
    DisPFL's schedule over 10 rounds; ``epochs`` sets the local epochs."""
    from neuroimagedisttraining_torch import algorithms

    kw = dict(loss_type="bce", seed=0, compute_dtype="bfloat16")
    kw.update({k: v for k, v in opts.items() if k != "epochs"})
    if cls_name in ("DisPFL", "SubAvg"):
        kw["dense_ratio"] = 0.5
    if cls_name == "DisPFL":
        kw["total_rounds"] = 10
    if "epochs" in opts:
        hp = dataclasses.replace(hp, local_epochs=opts["epochs"])
    return getattr(algorithms, cls_name)(model, data, hp, **kw)


def fused_path(dev):
    """The fused round loop (``FedAlgorithm.run_rounds_fused``) on the main
    configuration at full width: SalientGrads (SNIP once) and FedAvg, each
    on every wire of the wires phase, then the five personalized and
    decentralized baselines (FUSED_BASELINES), FUSED_ROUNDS rounds with the
    eval after every round, from the same state as FUSED_ROUNDS eager
    rounds (``run_round`` + ``evaluate``; SalientGrads' state a
    ``clone_state`` copy of one post-SNIP state, the others' a fresh
    ``init_state``). Each round is one replay of a captured CUDA graph,
    each eval one replay of the eval's graph.

    Gates: round metrics (DisPFL's mask change and local-test series too),
    eval rows and every tree of tensors of the final state (masks
    included) bitwise equal to eager's, or, if not, within the spread of
    two eager runs of the same configuration (cuDNN's own), printed; the
    graphs' launches per replay equal eager's per round and per eval (the
    masked SGD kernel's ``mask_grads`` branch counted apart), and the run's
    launches are (FUSED_WARMUPS + FUSED_ROUNDS) rounds and evals. Every
    configuration must capture: a capture error (``ValueError``) or any
    other error fails the phase. Recorded: the first block's seconds (the
    baselines' second block's too, its graphs captured), the peak memory
    of both spellings and, on the dense wires and FUSED_PAIRS, the eager
    and fused rates in interleaved pairs. Returns the launches per path
    (the first block's; the second block and the pairs launch outside
    them)."""
    import gc

    import torch

    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.core.state import zeros_like_tree
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    data, hp = _main_config(dev, phased_sample_shape(VOLUME))
    model = create_model("3dcnn_s2d", num_classes=1,
                         sample_shape=phased_sample_shape(VOLUME))
    kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16",
              agg_topk_density=TOPK_DENSITY)
    sg_kw = dict(dense_ratio=0.5, itersnip_iterations=1, **kw)
    sg0 = SalientGrads(model, data, hp, **sg_kw).init_state()

    def central(name, impl):
        if name == "salientgrads":
            algo = SalientGrads(model, data, hp, agg_impl=impl, **sg_kw)
            return algo, dataclasses.replace(
                algo.clone_state(sg0),
                agg_residual=(zeros_like_tree(sg0.personal_params)
                              if impl == "topk" else None))
        algo = FedAvg(model, data, hp, agg_impl=impl, **kw)
        return algo, algo.init_state()

    def baseline(cls_name, opts):
        algo = _personal_algo(cls_name, opts, model, data, hp)
        return algo, algo.init_state()

    wires = [("salientgrads", w) for w in WIRES] + \
        [("fedavg", w) for w in FEDAVG_WIRES]
    wires.sort(key=lambda c: c[1] != "dense")  # both dense wires first
    configs = [(f"{name}/{impl}", {"algo": name, "agg_impl": impl},
                lambda n=name, i=impl: central(n, i), impl == "dense")
               for name, impl in wires]
    configs += [(path, {"algo": path, "options": opts},
                 lambda c=cls_name, o=opts: baseline(c, o),
                 path in FUSED_PAIRS)
                for path, cls_name, opts in FUSED_BASELINES]
    out, spread = {}, None
    n = FUSED_ROUNDS
    for path, label, make, pairs in configs:
        algo, state = make()
        torch.cuda.reset_peak_memory_stats(dev)
        ea = _eager_rounds(algo, algo.clone_state(state), n)
        peak_eager = torch.cuda.max_memory_allocated(dev)
        res = {"phase": "fused", **label, "rounds": n, "eval_every": 1,
               "train_loss": [m["train_loss"] for m in ea[1]]}
        if label.get("agg_impl") == "dense":
            eb = _eager_rounds(algo, algo.clone_state(state), n)
            s = _spread(*ea[:3], *eb[:3])
            res["eager_vs_eager_spread"] = s
            spread = s if spread is None else max(spread, s)
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sf, ys = algo.run_rounds_fused(algo.clone_state(state), 0, n,
                                       eval_every=1)
        host = ys.materialize()
        torch.cuda.synchronize()
        res["first_block_s"] = time.perf_counter() - t0
        launches = kernels.snapshot_launches()
        res["peak_mem_bytes_eager"] = peak_eager
        res["peak_mem_bytes_fused"] = torch.cuda.max_memory_allocated(dev)
        fz = algo._fused
        (graph,) = fz.rounds.values()
        res["launches"] = launches
        res["launches_per_replay"] = graph.launches
        res["eval_launches_per_replay"] = fz.eval.launches
        names = list(algo._round_metric_names)
        diffs = _spread(ea[0], ea[1], ea[2], sf,
                        [{k: float(host[k][i]) for k in names}
                         for i in range(n)],
                        [{k: float(v[i]) for k, v in host["eval"].items()}
                         for i in range(n)])
        res["fused_vs_eager_max_abs"] = diffs
        trees = _tensor_trees(sf)
        res["bitwise"] = diffs == 0.0 and all(
            torch.equal(t[k], trees[f][k])
            for f, t in _tensor_trees(ea[0]).items() for k in t)
        if not res["bitwise"] and "agg_impl" not in label:
            # this configuration's own eager-against-eager spread
            eb = _eager_rounds(algo, algo.clone_state(state), n)
            res["eager_vs_eager_spread"] = _spread(*ea[:3], *eb[:3])
        if "options" in label:
            # a second block, captured already: the steady fused rate
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            algo.run_rounds_fused(algo.clone_state(state), 0, n,
                                  eval_every=1)[1].materialize()
            torch.cuda.synchronize()
            res["second_block_s"] = time.perf_counter() - t0
        if pairs:
            torch.cuda.reset_peak_memory_stats(dev)
            res["rounds_per_sec_pairs"] = _rates_in_pairs(algo, state, n)
        emit(res)
        bound = res.get("eager_vs_eager_spread", spread)
        if not (res["bitwise"] or diffs <= bound):
            raise AssertionError(
                f"fused {path}: differs from eager by {diffs} (eager vs "
                f"eager: {bound})")
        # the first eager round of the new algorithm ran the dropout
        # probe's forward (FedAlgorithm._dropout_calls, once per algorithm)
        eager_rounds = {**ea[3], "stem_fwd": ea[3]["stem_fwd"] - 1}
        per_round = {k: v // n for k, v in eager_rounds.items() if v}
        per_eval = {k: v // n for k, v in ea[4].items() if v}
        want = {k: (per_round.get(k, 0) + per_eval.get(k, 0))
                * (FUSED_WARMUPS + n) for k in launches}
        if graph.launches != per_round or fz.eval.launches != per_eval \
                or launches != want:
            raise AssertionError(
                f"fused {path}: launches {launches} (per replay "
                f"{graph.launches}, eval {fz.eval.launches}), want {want} "
                f"(per round {per_round}, per eval {per_eval})")
        out[f"fused/{path}"] = {k: launches[k] for k in kernels.LAUNCHES}
        del algo, graph, fz
        ea = eb = sf = ys = host = None  # free the states before the next
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "fused", "step": "summary",
          "eager_vs_eager_spread": spread})
    return out


def _main_hp():
    """The main configuration's hyperparameters."""
    from neuroimagedisttraining_torch.core.state import HyperParams

    return HyperParams(lr=1e-3, lr_decay=0.998, momentum=0.9,
                       weight_decay=5e-4, grad_clip=10.0, local_epochs=1,
                       steps_per_epoch=STEPS, batch_size=BATCH)


def _main_config(dev, sample_shape, uneven=False):
    """The main configuration's cohort (8 clients x 40 volumes, or with
    ``uneven`` ``bench.py``'s counts in [20, 40], 10 test rows each, bf16,
    made on the card) at ``sample_shape``, and its hyperparameters."""
    import torch

    from neuroimagedisttraining_torch.data import device_synthetic_federated

    data = device_synthetic_federated(
        N_CLIENTS, SAMPLES, sample_shape,
        torch.Generator(device=dev).manual_seed(0), test_per_client=TEST,
        uneven=uneven)
    return data, _main_hp()


def _eval_rows_agree(what, on, off):
    """Eval rows of the cached eval against the full one: accuracies and
    every other value bitwise, losses within EVALCACHE_LOSS_RTOL."""
    for r, (a, b) in enumerate(zip(on, off)):
        for k in b:
            if k.endswith("loss"):
                ok = abs(a[k] - b[k]) <= EVALCACHE_LOSS_RTOL * abs(b[k])
            else:
                ok = a[k] == b[k]
            if not ok:
                raise AssertionError(f"evalcache {what}: round {r} {k} "
                                     f"{a[k]} against {b[k]}")


def _trees_equal(a, b, fields) -> bool:
    """The trees ``fields`` of two states bitwise (None on both equal)."""
    import torch

    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if (x is None) != (y is None):
            return False
        if x is not None and not all(torch.equal(x[k], y[k]) for k in x):
            return False
    return True


def evalcache_path(dev):
    """The eval protocol on the main configuration at full width.

    * SalientGrads (SNIP once) and FedAvg, each with ``eval_cache=True``:
      EVALCACHE_ROUNDS rounds with the eval after each through
      ``run_round`` + ``evaluate`` and through ``run_rounds_fused``, from
      ``clone_state`` of one state, against the same eager rounds with the
      cache off. Gates: train losses bitwise; eval accuracies bitwise and
      losses within EVALCACHE_LOSS_RTOL of the cache-off eval's; fused
      bitwise eager (losses, eval rows, global, personal and cache); the
      input state's cache untouched; launches: the cached eval only the
      global model's forwards, the round one personal forward per client
      more, the graphs' per replay equal eager's. Peak memory of eager, of
      the fused cache-on and of the fused cache-off block; rounds/s of
      eager and fused in interleaved pairs.
    * SalientGrads with ``eval_clients=EVAL_CLIENTS``: EVAL_CLIENTS_ROUNDS
      rounds, fused bitwise eager, the eval's launches over the subset
      only.

    Returns the launches per path."""
    import gc

    import torch

    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ss = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, ss)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=ss)
    kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16")
    sg_kw = dict(dense_ratio=0.5, itersnip_iterations=1, **kw)
    n, steps = EVALCACHE_ROUNDS, N_CLIENTS * STEPS
    per_model = N_CLIENTS * _eval_chunks()  # one model's eval forwards
    fields = ("global_params", "personal_params", "eval_cache")
    out, sg_state = {}, None
    for name in ("salientgrads", "fedavg"):
        cls, ckw = ((SalientGrads, sg_kw) if name == "salientgrads"
                    else (FedAvg, kw))
        on = cls(model, data, hp, eval_cache=True, **ckw)
        off = cls(model, data, hp, **ckw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s0 = on.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        keep = {k: v.clone() for k, v in s0.eval_cache.items()}
        torch.cuda.reset_peak_memory_stats(dev)
        ea = _eager_rounds(on, on.clone_state(s0), n)
        peak_eager = torch.cuda.max_memory_allocated(dev)
        eb = _eager_rounds(off, dataclasses.replace(off.clone_state(s0),
                                                    eval_cache=None), n)
        if ea[1] != eb[1]:
            raise AssertionError(f"evalcache {name}: train losses {ea[1]} "
                                 f"against the cache-off {eb[1]}")
        _eval_rows_agree(name, ea[2], eb[2])
        torch.cuda.synchronize()
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        sf, ys = on.run_rounds_fused(on.clone_state(s0), 0, n, eval_every=1)
        host = ys.materialize()
        torch.cuda.synchronize()
        first_block_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_fused = torch.cuda.max_memory_allocated(dev)
        fz = on._fused
        (graph,) = fz.rounds.values()
        diffs = _spread(ea[0], ea[1], ea[2], sf,
                        [{"train_loss": float(v)}
                         for v in host["train_loss"]],
                        [{k: float(v[i]) for k, v in host["eval"].items()}
                         for i in range(n)])
        bitwise = diffs == 0.0 and _trees_equal(ea[0], sf, fields)
        torch.cuda.reset_peak_memory_stats(dev)
        off.run_rounds_fused(dataclasses.replace(
            off.clone_state(s0), eval_cache=None), 0, n,
            eval_every=1)[1].materialize()
        peak_fused_off = torch.cuda.max_memory_allocated(dev)
        rates = _rates_in_pairs(on, s0, n)
        res = {"phase": "evalcache", "algo": name, "rounds": n,
               "eval_every": 1, "init_s": init_s,
               "train_loss": [m["train_loss"] for m in ea[1]],
               "eval_cache_on": ea[2], "eval_cache_off": eb[2],
               "fused_vs_eager_max_abs": diffs, "bitwise": bitwise,
               "first_block_s": first_block_s, "launches": launches,
               "launches_per_replay": graph.launches,
               "eval_launches_per_replay": fz.eval.launches,
               "eager_eval_launches": ea[4], "cache_off_eval_launches": eb[4],
               "peak_mem_bytes_eager": peak_eager,
               "peak_mem_bytes_fused": peak_fused,
               "peak_mem_bytes_fused_cache_off": peak_fused_off,
               "rounds_per_sec_pairs": rates}
        emit(res)
        if not bitwise:
            raise AssertionError(f"evalcache {name}: fused differs from "
                                 f"eager by {diffs}")
        if not all(torch.equal(keep[k], s0.eval_cache[k]) for k in keep):
            raise AssertionError(f"evalcache {name}: a round wrote into its "
                                 "input state's cache")
        # the cached eval: the global model's forwards only; the round:
        # one personal forward per client more (the dropout probe's
        # forward at the algorithm's first round aside)
        per_round = {"masked_sgd": steps, "stem_fwd": steps + per_model,
                     "stem_bwd": steps, "weighted_sum": 1}
        per_eval = {"stem_fwd": per_model}
        eager_rounds = {**ea[3], "stem_fwd": ea[3]["stem_fwd"] - 1}
        want = {k: (per_round.get(k, 0) + per_eval.get(k, 0))
                * (FUSED_WARMUPS + n) for k in kernels.LAUNCHES}
        nonzero = (lambda d: {k: v for k, v in d.items() if v})
        if nonzero(eager_rounds) != {k: v * n for k, v in per_round.items()} \
                or nonzero(ea[4]) != {"stem_fwd": n * per_model} \
                or nonzero(eb[4]) != {"stem_fwd": n * 2 * per_model} \
                or graph.launches != per_round \
                or fz.eval.launches != per_eval or launches != want:
            raise AssertionError(
                f"evalcache {name}: launches eager {ea[3]} + evals {ea[4]} "
                f"(cache off {eb[4]}), fused {launches} (per replay "
                f"{graph.launches}, eval {fz.eval.launches}), want per "
                f"round {per_round}, per eval {per_eval}, fused {want}")
        out[f"evalcache/{name}"] = launches
        out[f"evalcache/{name}/eager"] = {
            k: ea[3][k] + ea[4][k] for k in kernels.LAUNCHES}
        if name == "salientgrads":
            sg_state = dataclasses.replace(s0, eval_cache=None)
        del on, off, graph, fz
        ea = eb = sf = ys = host = None
        gc.collect()
        torch.cuda.empty_cache()

    algo = SalientGrads(model, data, hp, eval_clients=EVAL_CLIENTS, **sg_kw)
    m = EVAL_CLIENTS_ROUNDS
    ea = _eager_rounds(algo, algo.clone_state(sg_state), m)
    kernels.reset_launches()
    sf, ys = algo.run_rounds_fused(algo.clone_state(sg_state), 0, m,
                                   eval_every=1)
    host = ys.materialize()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    diffs = _spread(ea[0], ea[1], ea[2], sf,
                    [{"train_loss": float(v)} for v in host["train_loss"]],
                    [{k: float(v[i]) for k, v in host["eval"].items()}
                     for i in range(m)])
    bitwise = diffs == 0.0 and _trees_equal(ea[0], sf, fields[:2])
    per_eval = {"stem_fwd": 2 * EVAL_CLIENTS * _eval_chunks()}
    emit({"phase": "evalcache", "algo": "salientgrads",
          "eval_clients": EVAL_CLIENTS, "subset": algo._eval_rows,
          "rounds": m, "train_loss": [r["train_loss"] for r in ea[1]],
          "eval": ea[2],
          "fused_vs_eager_max_abs": diffs, "bitwise": bitwise,
          "eval_launches_per_replay": algo._fused.eval.launches,
          "launches": launches})
    if not bitwise:
        raise AssertionError(f"evalcache eval_clients: fused differs from "
                             f"eager by {diffs}")
    if {k: v for k, v in ea[4].items() if v} != \
            {"stem_fwd": m * per_eval["stem_fwd"]} or \
            algo._fused.eval.launches != per_eval:
        raise AssertionError(f"evalcache eval_clients: eval launches "
                             f"{ea[4]}, per replay "
                             f"{algo._fused.eval.launches}, want {per_eval}")
    out["evalcache/eval_clients"] = launches
    return out


def hold_path_kernels(dev, g, params):
    """The kernels a SalientGrads round on the dense wire launches, each
    held bitwise against its plain version at the leaf table of
    ``params``: masked SGD over every leaf in both modes (the rate a 0-d
    tensor on the card, as the round passes it), the SNIP threshold over
    the kernel leaves' row at k = n/2 (random and tie-heavy scores), the
    score mask over the kernel leaves, the weighted sum over an
    [N_CLIENTS, leaf] stack of every leaf. Returns each kernel's max abs
    error and shape."""
    import torch

    from neuroimagedisttraining_torch.core.state import weighted_sum
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.sparsity import kernel_flags
    from neuroimagedisttraining_torch.ops.topk_select import exact_threshold

    names = list(params)
    shapes = [tuple(params[k].shape) for k in names]
    flags = kernel_flags(params)
    kernel_names = [k for k in names if flags[k]]
    n_params = sum(math.prod(s) for s in shapes)
    out = {}

    lr = torch.tensor(1e-3 * 0.998 ** 2, device=dev)
    errs = []
    for mode in (False, True):
        ps = [params[k].detach().clone() for k in names]
        ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
        gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
        ks = [(torch.rand(s, generator=g, device=dev) < 0.5).float()
              if flags[k] else torch.ones(s, device=dev)
              for k, s in zip(names, shapes)]
        want = [kernels.masked_sgd_plain(p, m, gg, k, lr, 0.9, 5e-4, mode)
                for p, m, gg, k in zip(ps, ms, gs, ks)]
        kernels.fused_masked_sgd_step(ps, ms, gs, ks, lr, momentum=0.9,
                                      wd=5e-4, mask_grads=mode)
        errs.append(_bitwise_or_raise(
            f"masked_sgd (mask_grads={mode})", ps + ms,
            [a for a, _ in want] + [b for _, b in want]))
    out["masked_sgd"] = dict(max_abs_err=max(errs),
                             shape=f"{len(names)} leaves, {n_params} f32")

    scores = [torch.rand(tuple(params[k].shape), generator=g, device=dev)
              for k in kernel_names]
    n = sum(s.numel() for s in scores)
    k = int(n * 0.5)
    norm = torch.cat([s.reshape(-1) for s in scores]).sum()
    row = (torch.cat([s.reshape(-1) for s in scores]) / norm)[None]
    ties = torch.randint(0, 50, (1, n), generator=g, device=dev).float() / 7
    err = _bitwise_or_raise(
        "threshold (the SNIP row)",
        [kernels.threshold_topk(x, k).view(torch.int32) for x in (row, ties)],
        [exact_threshold(x, k).view(torch.int32) for x in (row, ties)])
    out["threshold"] = dict(max_abs_err=err, shape=f"[1, {n}] f32, k={k}")

    thr = exact_threshold(row, k).reshape(())
    got = kernels.fused_score_mask(scores, norm, thr)
    out["score_mask"] = dict(
        max_abs_err=_bitwise_or_raise(
            "score_mask", got,
            [kernels.score_mask_plain(s, norm, thr) for s in scores]),
        shape=f"{len(scores)} leaves, {n} f32")

    stacked = {k: params[k].detach()[None] + 0.01 * torch.randn(
        (N_CLIENTS,) + tuple(params[k].shape), generator=g, device=dev)
        for k in names}
    w = torch.rand(N_CLIENTS, generator=g, device=dev)
    w = w / w.sum()
    got = kernels.fused_weighted_sum(stacked, w)
    out["weighted_sum"] = dict(
        max_abs_err=_bitwise_or_raise(
            "weighted_sum", [got[k] for k in names],
            [weighted_sum(stacked[k], w) for k in names]),
        shape=f"[{N_CLIENTS}, leaf] x {len(names)} leaves, f32")
    return out


def dense_path(dev):
    """The dense-stem AlexNet3D at full width through the library entry
    points: SalientGrads, SNIP, DENSE_ROUNDS rounds and the eval on the
    main configuration's cohort stored ``(121, 145, 121, 1)``; the kernels
    that run launched at this model's shapes, each bitwise against its
    plain version (:func:`hold_path_kernels`); the same
    first round from the same state over the cohort stored channel-less
    with ``channel_inject`` (``--layout flat``), bitwise; the stem conv
    alone (cuDNN) at the step's shape; the deeper and regression models
    one forward and backward each. Returns the launches per path."""
    import torch
    import torch.nn.functional as F

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.core.losses import \
        bce_with_logits_per_example
    from neuroimagedisttraining_torch.models import (
        create_model,
        init_params,
        make_apply_fn,
    )
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.sparsity import mask_density

    vol = VOLUME + (1,)
    t0 = time.perf_counter()
    data, hp = _main_config(dev, vol)
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    model = create_model("3dcnn", num_classes=1, sample_shape=vol)
    sg_kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16",
                 dense_ratio=0.5, itersnip_iterations=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    algo = SalientGrads(model, data, hp, **sg_kw)
    t0 = time.perf_counter()
    s0 = algo.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state, round_s, losses, first = s0, [], [], None
    for r in range(DENSE_ROUNDS):
        t0 = time.perf_counter()
        state, met = algo.run_round(state, r)
        losses.append(float(met["train_loss"]))
        round_s.append(time.perf_counter() - t0)
        if r == 0:
            first = state
    final = {k: float(v) for k, v in algo.evaluate(state).items()
             if not k.startswith("acc_per")}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"phase": "dense", "model": "3dcnn", "clients": N_CLIENTS,
           "samples_per_client": SAMPLES, "sample_shape": list(vol),
           "batch": BATCH, "steps": STEPS, "rounds": DENSE_ROUNDS,
           "compute_dtype": "bfloat16", "data_s": data_s,
           "init_snip_s": init_s, "round_s": round_s, "train_loss": losses,
           "final_eval": final, "peak_mem_bytes": peak,
           "launches": launches}

    # the path's kernels at this model's leaf table and SNIP row, bitwise
    # against their plain versions (after the counters were read)
    res["kernels_at_path_shapes"] = hold_path_kernels(
        dev, torch.Generator(device=dev).manual_seed(4321), s0.global_params)

    # the same first round over channel-less storage (--layout flat)
    flat = dataclasses.replace(data, x_train=data.x_train[..., 0],
                               x_test=data.x_test[..., 0])
    algo_f = SalientGrads(model, flat, hp, channel_inject=True, **sg_kw)
    sf, met_f = algo_f.run_round(s0, 0)
    res["flat_bitwise"] = float(met_f["train_loss"]) == losses[0] and \
        _trees_equal(first, sf, ("global_params", "personal_params"))

    # the stem conv alone (cuDNN) at the step's shape, in both formats
    x = data.x_train[0, :BATCH].permute(0, 4, 1, 2, 3)
    w = s0.global_params["_Features_0.Conv3d_0.kernel"].to(torch.bfloat16)
    b = s0.global_params["_Features_0.Conv3d_0.bias"].to(torch.bfloat16)
    gz = torch.randn_like(F.conv3d(x, w, b, stride=2))
    stem = {"x": list(x.shape), "z": list(gz.shape),
            "multiply_adds": gz.numel() * w[0].numel()}
    for fmt_name, fmt in (("ncdhw", torch.contiguous_format),
                          ("channels_last_3d", torch.channels_last_3d)):
        xx, ww = x.contiguous(memory_format=fmt), w.contiguous(
            memory_format=fmt)
        gg = gz.contiguous(memory_format=fmt)
        stem[fmt_name] = {
            "fwd_ms": device_ms(lambda: F.conv3d(xx, ww, b, stride=2)),
            "dgrad_ms": device_ms(lambda: torch.nn.grad.conv3d_input(
                xx.shape, ww, gg, stride=2)),
            "wgrad_ms": device_ms(lambda: torch.nn.grad.conv3d_weight(
                xx, ww.shape, gg, stride=2))}
    res["stem_conv"] = stem

    # the deeper and regression models: one forward and backward each
    others = {}
    xb, yb = data.x_train[0, :BATCH], data.y_train[0, :BATCH]
    for key in ("3dcnn_deeper", "3dcnn_regression"):
        m = create_model(key, num_classes=1, sample_shape=vol).to(dev)
        params = {k: v.requires_grad_(True) for k, v in init_params(
            m, torch.Generator(device=dev).manual_seed(1)).items()}
        outs = make_apply_fn(m, torch.bfloat16)(
            params, xb, train=True,
            rng=torch.Generator(device=dev).manual_seed(2))
        loss = bce_with_logits_per_example(outs, yb).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        others[key] = {
            "outputs": [list(o.shape) for o in outs],
            "loss": float(loss.detach()),
            "finite": bool(torch.isfinite(loss)) and all(
                bool(torch.isfinite(g).all()) for g in grads)
            and all(bool(torch.isfinite(o).all()) for o in outs)}
    res["others"] = others
    emit(res)

    if not all(math.isfinite(v) for v in losses + list(final.values())):
        raise AssertionError(f"dense: non-finite {losses} {final}")
    if abs(final["mask_density"] - 0.5) > 1e-3:
        raise AssertionError(f"dense: mask density {final['mask_density']}")
    if not res["flat_bitwise"]:
        raise AssertionError("dense: the channel-less (flat) round differs "
                             "from the channels round")
    if not all(o["finite"] for o in others.values()):
        raise AssertionError(f"dense: {others}")
    # the phased stem's kernels are not on this path: its stem is cuDNN's
    want = {**{k: 0 for k in launches},
            "masked_sgd": DENSE_ROUNDS * N_CLIENTS * STEPS, "threshold": 1,
            "score_mask": 1, "weighted_sum": DENSE_ROUNDS}
    if launches != want:
        raise AssertionError(f"dense: launches {launches}, want {want}")
    for p in state.global_params.values():
        if not bool(torch.isfinite(p).all()):
            raise AssertionError("dense: non-finite global parameters")
    return {"dense": launches}


def _states_equal(a, b) -> bool:
    """Two states' parameter trees (and residuals) bitwise."""
    return _trees_equal(a, b, ("global_params", "personal_params",
                               "agg_residual"))


class _MaskApplyProbe:
    """Holds every ``kernels.fused_mask_apply`` call of an eager round
    against the plain ``p * m`` of its own inputs, bit for bit (the plain
    version launches nothing)."""

    def __init__(self):
        from neuroimagedisttraining_torch.ops import kernels

        self.kernels, self.calls, self.max_abs_err = kernels, 0, 0.0
        self.fn = kernels.fused_mask_apply

    def __enter__(self):
        import torch

        def probe(tree, mask):
            out = self.fn(tree, mask)
            for k in tree:
                want = tree[k] * mask[k]
                self.max_abs_err = max(self.max_abs_err, float(
                    (out[k] - want).abs().max()))
                if not torch.equal(out[k], want):
                    raise AssertionError(f"mask_apply on the path: {k} "
                                         "differs from p * m")
            self.calls += 1
            return out

        self.kernels.fused_mask_apply = probe
        return self

    def __exit__(self, *exc):
        self.kernels.fused_mask_apply = self.fn


def robust_path(dev):
    """The robustness tier at full width on the main configuration
    (SalientGrads, SNIP once; FedAvg from its own init), run seed 0, each
    configuration of ROBUST_CONFIGS for ROBUST_ROUNDS eager rounds, the
    same rounds fused (each one graph replay) and a timed fused block:

    * "plain": no guard; "guard_clean": the guard on, no fault: bitwise
      "plain"; the others under ROBUST_SPEC with the guard: the plain
      weighted mean on the dense and the int8 wire (the weighted-sum and
      quantize-reduce kernels on the renormalized weights), each
      ``robust_agg`` on the dense wire and the median on int8 (the
      statistic of the wire-decoded deltas), the weak-DP
      defense (SalientGrads re-masks through ``fused_mask_apply``), top-k
      under the guard with a NaN client, FedAvg with the defense.
    * Gates: finite losses and global parameters; ``clients_dropped`` and
      ``clients_quarantined`` of every round equal to the host replay of
      the fault draws (``robust.fault_trace_round``: dropped, and NaN-
      poisoned among those that reported); fused bitwise eager (metrics,
      global, personal and residual trees); every ``fused_mask_apply`` of
      an eager round bitwise its plain ``p * m``, and its launches one per
      round (eager, warm-up, replay) on the defense and top-k paths; the
      weighted sum (int8: the quantize-reduce) once per round where no
      robust statistic replaces it.
    Returns the launches per path (eager and fused runs)."""
    import gc

    import torch

    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.core.state import zeros_like_tree
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.robust import (
        RobustAggregator,
        fault_trace_round,
        parse_fault_spec,
    )

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16",
              agg_topk_density=TOPK_DENSITY)
    sg_kw = dict(dense_ratio=0.5, itersnip_iterations=1, **kw)
    sg0 = SalientGrads(model, data, hp, **sg_kw).init_state()
    n = ROBUST_ROUNDS
    out, plain = {}, None
    for name, algo_name, impl, robust, defense, spec in ROBUST_CONFIGS:
        akw = dict(agg_impl=impl, robust_agg=robust,
                   fault_spec=spec or "", guard=spec != "",
                   defense=(RobustAggregator(defense, 5.0, 0.025)
                            if defense else None))
        if algo_name == "salientgrads":
            algo = SalientGrads(model, data, hp, **sg_kw, **akw)
            state = dataclasses.replace(
                algo.clone_state(sg0),
                agg_residual=(zeros_like_tree(sg0.personal_params)
                              if impl == "topk" else None))
        else:
            algo = FedAvg(model, data, hp, **kw, **akw)
            state = algo.init_state()
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        e, mets = algo.clone_state(state), []
        with _MaskApplyProbe() as probe:
            for r in range(n):
                e, met = algo.run_round(e, r)
                mets.append({k: float(v) for k, v in met.items()})
        torch.cuda.synchronize()
        eager_s = time.perf_counter() - t0
        eager_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        f, ys = algo.run_rounds_fused(algo.clone_state(state), 0, n)
        host = ys.materialize()
        torch.cuda.synchronize()
        fused_launches = dict(kernels.LAUNCHES)
        kernels.reset_launches()
        t0 = time.perf_counter()
        algo.run_rounds_fused(state, 0, n)[1].materialize()
        torch.cuda.synchronize()
        fused_rps = n / (time.perf_counter() - t0)
        timed_launches = dict(kernels.LAUNCHES)
        fused_mets = [{k: float(host[k][i]) for k in host} for i in range(n)]
        res = {"phase": "robust", "config": name, "algo": algo_name,
               "agg_impl": impl, "robust_agg": robust, "defense": defense,
               "fault_spec": spec, "rounds": n, "metrics": mets,
               "eager_s_with_first_round": eager_s,
               "fused_rounds_per_sec": fused_rps,
               "fused_bitwise_eager": mets == fused_mets
               and _states_equal(e, f),
               "mask_apply_calls_held": probe.calls,
               "mask_apply_max_abs_err": probe.max_abs_err,
               "launches_eager": eager_launches,
               "launches_fused": fused_launches}
        if name == "guard_clean":
            res["bitwise_plain"] = _states_equal(e, plain[0]) and [
                m["train_loss"] for m in mets] == plain[1]
        emit(res)
        losses = [m["train_loss"] for m in mets]
        if not all(math.isfinite(v) for v in losses) or not all(
                bool(torch.isfinite(p).all())
                for p in e.global_params.values()):
            raise AssertionError(f"robust {name}: non-finite {losses}")
        if not res["fused_bitwise_eager"]:
            raise AssertionError(f"robust {name}: fused differs from eager")
        if name == "guard_clean" and not res["bitwise_plain"]:
            raise AssertionError("robust: the clean guarded round differs "
                                 "from the unguarded one")
        if spec:
            fspec = parse_fault_spec(spec)
            for r, m in enumerate(mets):
                t = fault_trace_round(fspec, 0, r, range(N_CLIENTS))
                want = (float(t["dropped"].sum()),
                        float((t["poisoned"] & ~t["dropped"]).sum()))
                if (m["clients_dropped"], m["clients_quarantined"]) != want:
                    raise AssertionError(
                        f"robust {name} round {r}: counters {m}, the "
                        f"host replay {want}")
        remask = algo_name == "salientgrads" and (defense or impl == "topk")
        plain_mean = robust == "none" and impl in ("dense", "topk")
        want = {"mask_apply": n if remask else 0,
                "weighted_sum": n if plain_mean else 0,
                "quantize_reduce": (n if robust == "none" and impl == "int8"
                                    else 0)}
        for k, v in want.items():
            if eager_launches[k] != v or \
                    fused_launches[k] != v // n * (FUSED_WARMUPS + n):
                raise AssertionError(
                    f"robust {name}: {k} launched {eager_launches[k]} "
                    f"eager, {fused_launches[k]} fused; want {v} a run")
        if remask and probe.calls != n:
            raise AssertionError(f"robust {name}: mask_apply held "
                                 f"{probe.calls} times, want {n}")
        if name == "plain":
            plain = (e, losses)
        out[f"robust/{name}"] = {
            k: eager_launches[k] + fused_launches[k] + timed_launches[k]
            for k in eager_launches}
        algo._fused.release()
        del algo
        e = f = ys = host = None
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_opts_path(dev):
    """The training options at full width on the main configuration:

    * ``remat_local``: TRAIN_OPTS_ROUNDS eager rounds (each timed) with
      and without it from one post-SNIP state, bitwise; the stem forward
      launched twice a step with it (once without); for each, the same
      rounds fused bitwise its eager rounds, then a timed fused block;
      the peak device memory of each eager and fused run;
    * ``batching="replacement"``: the rounds eager and fused, bitwise,
      finite;
    * exact stratified SNIP (``stratified_sampling``, "exact") on a cohort
      of STRATIFIED_SAMPLES volumes per client with 25 of each class: its
      seconds, its launches (one stem forward and backward per fold batch)
      and the mask density at 0.5 within 1e-3.
    Returns the launches per path."""
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.data import device_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.ops.sparsity import mask_density

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    sg_kw = dict(loss_type="bce", frac=1.0, seed=0, compute_dtype="bfloat16",
                 dense_ratio=0.5, itersnip_iterations=1)
    s0 = SalientGrads(model, data, hp, **sg_kw).init_state()
    n = TRAIN_OPTS_ROUNDS
    out, runs = {}, {}
    steps = n * N_CLIENTS * STEPS
    for remat in (False, True):
        algo = SalientGrads(model, data, hp, remat_local=remat, **sg_kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        e, losses, round_s = algo.clone_state(s0), [], []
        for r in range(n):
            t0 = time.perf_counter()
            e, met = algo.run_round(e, r)
            losses.append(float(met["train_loss"]))
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
        run = dict(state=e, losses=losses, round_s=round_s,
                   peak=torch.cuda.max_memory_allocated(dev),
                   launches=dict(kernels.LAUNCHES))
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        f, ys = algo.run_rounds_fused(algo.clone_state(s0), 0, n)
        run["fused_bitwise_eager"] = (
            [float(v) for v in ys["train_loss"]] == losses
            and _states_equal(e, f))
        run["peak_fused"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.run_rounds_fused(s0, 0, n)[1].materialize()
        torch.cuda.synchronize()
        run["fused_rounds_per_sec"] = n / (time.perf_counter() - t0)
        run["launches_fused"] = dict(kernels.LAUNCHES)
        algo._fused.release()
        runs[remat] = run
        del algo, f, ys
    off, on = runs[False], runs[True]
    res = {"phase": "train_opts", "step": "remat", "rounds": n,
           "train_loss": on["losses"],
           "bitwise_remat_off": on["losses"] == off["losses"]
           and _states_equal(on["state"], off["state"]),
           "fused_bitwise_eager": on["fused_bitwise_eager"]
           and off["fused_bitwise_eager"],
           **{key: {"off": off[f], "on": on[f]} for key, f in (
               ("eager_round_s", "round_s"), ("peak_mem_bytes", "peak"),
               ("peak_mem_bytes_fused", "peak_fused"),
               ("fused_rounds_per_sec", "fused_rounds_per_sec"),
               ("launches", "launches"),
               ("launches_fused", "launches_fused"))}}
    emit(res)
    # the dropout probe runs one forward at each algorithm's first round
    if not res["bitwise_remat_off"] or not res["fused_bitwise_eager"] or \
            off["launches"]["stem_fwd"] != steps + 1 or \
            on["launches"]["stem_fwd"] != 2 * steps + 1 or \
            on["launches"]["stem_bwd"] != off["launches"]["stem_bwd"]:
        raise AssertionError(f"train_opts remat: {res}")
    for name, run in (("remat", on), ("remat_off", off)):
        out[f"train_opts/{name}"] = {
            k: run["launches"][k] + run["launches_fused"][k]
            for k in kernels.LAUNCHES}
    runs = None

    algo = SalientGrads(model, data,
                        dataclasses.replace(hp, batching="replacement"),
                        **sg_kw)
    kernels.reset_launches()
    e, losses = algo.clone_state(s0), []
    for r in range(n):
        e, met = algo.run_round(e, r)
        losses.append(float(met["train_loss"]))
    f, ys = algo.run_rounds_fused(algo.clone_state(s0), 0, n)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    res = {"phase": "train_opts", "step": "replacement", "rounds": n,
           "train_loss": losses,
           "fused_bitwise_eager": [float(v) for v in ys["train_loss"]]
           == losses and _states_equal(e, f), "launches": launches}
    emit(res)
    if not res["fused_bitwise_eager"] or not all(
            math.isfinite(v) for v in losses):
        raise AssertionError(f"train_opts replacement: {res}")
    out["train_opts/replacement"] = launches
    algo._fused.release()
    del algo, e, f, s0

    # 25 of each class on every client, drawn apart from the volumes: the
    # splitter's 25 folds accept it
    gen = torch.Generator(device=dev).manual_seed(1)
    sdata = device_synthetic_federated(
        N_CLIENTS, STRATIFIED_SAMPLES, shape, gen, test_per_client=TEST)
    half = STRATIFIED_SAMPLES // 2
    labels = torch.stack([
        torch.randperm(STRATIFIED_SAMPLES, generator=gen, device=dev)
        < half for _ in range(N_CLIENTS)]).to(sdata.y_train.dtype)
    sdata = dataclasses.replace(sdata, y_train=labels)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    algo = SalientGrads(model, sdata, hp, stratified_sampling=True,
                        stratified_mode="exact", **sg_kw)
    state = algo.init_state()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    density = mask_density(state.mask)
    fold_batches = N_CLIENTS * 25
    res = {"phase": "train_opts", "step": "stratified_exact",
           "samples_per_client": STRATIFIED_SAMPLES,
           "fold_rows": int(algo._fold_sched[0].shape[-1]),
           "snip_s": seconds, "mask_density": density,
           "launches": launches}
    emit(res)
    if abs(density - 0.5) > 1e-3 or launches["threshold"] != 1 or \
            launches["stem_fwd"] != fold_batches or \
            launches["stem_bwd"] != fold_batches:
        raise AssertionError(f"train_opts stratified: {res}")
    out["train_opts/stratified_exact"] = launches
    return out


#: the personal phase's full-width runs: (path name, algorithm class,
#: options); each runs PERSONAL_ROUNDS eager rounds and an eval
PERSONAL_CONFIGS = (
    ("dispfl", "DisPFL", dict(frac=0.5, neighbor_mode="random")),
    ("dispfl_active", "DisPFL", dict(frac=0.5, active=0.5)),
    ("dispfl_static", "DisPFL", dict(frac=0.5, static_masks=True)),
    ("subavg", "SubAvg", dict()),
    ("ditto", "Ditto", dict()),
    ("local", "LocalOnly", dict()),
    ("dpsgd", "DPSGD", dict(frac=0.5)),
)
PERSONAL_ROUNDS = 2
#: the narrow CPU-against-card runs' data seeds (default 5). Ditto, Local
#: and DPSGD train every weight, and a max-pool or relu decision within
#: float32 round-off of its tie can go one way on the card and the other on
#: the CPU (a discrete flip, ~1e-3 of a kernel leaf, the same in every
#: repeat): on the H100 Ditto flips on data seeds 3 and 5, Local on 9,
#: DPSGD on 8; seed 4 flips none of them
NARROW_SEEDS = {"ditto": 4, "local": 4, "dpsgd": 4}


def _narrow_personal_parity(dev, cls_name, opts, seed):
    """Two narrow rounds of one algorithm on the CPU and on the card from
    the same parameters, masks and draws (epoch permutations of both legs,
    DisPFL's screening rows), two epochs a round (SubAvg's second leg,
    Ditto's personal leg of two): losses, kernel leaves and masks held at
    the tolerances the ``parity`` phase holds the dense wire to."""
    import torch

    from neuroimagedisttraining_torch import algorithms
    from neuroimagedisttraining_torch.core.state import HyperParams
    from neuroimagedisttraining_torch.core.trainer import epoch_permutations
    from neuroimagedisttraining_torch.data import make_synthetic_federated
    from neuroimagedisttraining_torch.models import create_model, init_params
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    ss = phased_sample_shape((69, 69, 69))
    mk = dict(num_classes=1, widths=(8, 16, 16, 16, 16), dropout_rate=0.0,
              sample_shape=ss)
    data = make_synthetic_federated(
        seed=seed, n_clients=3, samples_per_client=6, test_per_client=5,
        val_per_client=3 if cls_name == "FedFomo" else 0, sample_shape=ss)
    hp = HyperParams(lr=0.01, momentum=0.9, weight_decay=5e-4,
                     grad_clip=10.0, local_epochs=2, steps_per_epoch=2,
                     batch_size=4)
    g = torch.Generator().manual_seed(0)
    params = init_params(create_model("3dcnn_s2d", **mk), g)
    nvals = [int(n) for n in data.n_train]
    n_rows = data.x_train.shape[1]

    def perms(epochs):
        return [epoch_permutations(g, n, epochs, 8, n_rows=n_rows)
                for n in nvals]

    seams = [dict(perms=perms(2), perms_2=perms(1 if cls_name == "SubAvg"
                                                else 2),
                  screen_idx=[torch.randint(0, n, (4,), generator=g)
                              for n in nvals]) for _ in range(2)]
    kw = dict(opts, frac=1.0)
    if cls_name == "Ditto":
        kw["personal_hp"] = hp
    masks = None
    runs = {}
    for label, device in (("cpu", "cpu"), ("gpu", dev)):
        algo = getattr(algorithms, cls_name)(
            create_model("3dcnn_s2d", **mk), data, hp, loss_type="bce",
            device=device, **kw)
        init = dict(generator=torch.Generator(device=device).manual_seed(1),
                    params=params)
        if cls_name == "DisPFL":
            init["masks"] = masks
        state = algo.init_state(**init)
        if cls_name == "DisPFL" and masks is None:
            masks = {k: v.cpu() for k, v in state.masks.items()}
        losses = []
        for r in range(2):
            draws = {"perms": True,
                     "perms_2": algo._second_leg_hp() is not None,
                     "screen_idx": algo._draws_screen}
            state, met = algo.run_round(
                state, r, **{k: v for k, v in seams[r].items() if draws[k]})
            losses.append(float(met["train_loss"]))
        runs[label] = (losses, {f: {k: v.cpu() for k, v in
                                    getattr(state, f).items()}
                                for f in ("global_params", "personal_params",
                                          "masks") if hasattr(state, f)})
    (lc, sc), (lg, sg) = runs["cpu"], runs["gpu"]
    # a weight whose mask differs between the sides (a fire or regrow
    # decision within round-off of its threshold) is counted, not compared
    same = {k: (sg["masks"][k] == sc["masks"][k]) if "masks" in sc
            else torch.ones_like(v, dtype=torch.bool)
            for k, v in sc.get("masks", sc.get("personal_params",
                                                sc.get("global_params"))
                               ).items()}
    rel, worst = 0.0, None
    for f in ("global_params", "personal_params"):
        for k, c in sc.get(f, {}).items():
            if not k.endswith(".kernel"):
                continue
            w = same[k] if f == "personal_params" or same[k].dim() == \
                c.dim() else same[k].all(dim=0)
            err = float(((sg[f][k] - c) * w).norm() / (c * w).norm())
            if err > rel:
                rel, worst = err, f"{f}.{k}"
    agree = sum(int(v.sum()) for v in same.values()) / sum(
        v.numel() for v in same.values())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    return {"data_seed": seed, "max_kernel_rel_err": rel,
            "worst_leaf": worst, "mask_agreement": agree,
            "loss_rel_err": loss_rel, "ok": rel <= 1e-4 and agree >= 0.999
            and loss_rel <= 1e-4}


def _regrow_ties(rec) -> int:
    """One captured DisPFL mask evolution ``(masks, trained, rate, scores,
    new masks)``, checked against the reference's rules: per client and
    kernel leaf, fire left ``n`` fewer live weights (its own ties
    included), and regrow grew exactly the dead weights whose score is at
    least its threshold, which fewer than ``n`` dead scores exceed and at
    least ``n`` reach. Returns the grown weights beyond ``n``: those tied at
    the threshold (bf16 gradients tie often), by which alone the live
    count, and so the mask density, moves."""
    from neuroimagedisttraining_torch.ops.sparsity import (
        fire_mask,
        kernel_flags,
    )

    masks, trained, rate, scores, new = rec
    fired = fire_mask(masks, trained, rate, lead=1)
    flags = kernel_flags(masks)
    excess = 0
    for k, m in masks.items():
        if not flags[k]:
            continue
        for c in range(m.shape[0]):
            dead = fired[k][c] == 0
            grown = (new[k][c] != 0) & dead
            n = int((m[c] != 0).sum()) - int((fired[k][c] != 0).sum())
            if not grown.any():
                if n:
                    raise AssertionError(f"regrow {k} client {c}: none of "
                                         f"{n} grown")
                continue
            a = scores[k][c].abs()
            thr = a[grown].min()
            above = int((dead & (a > thr)).sum())
            reach = dead & (a >= thr)
            if not bool((reach == grown).all()) or not above < n <= int(
                    reach.sum()):
                raise AssertionError(
                    f"regrow {k} client {c}: n {n}, above {above}, "
                    f"reach {int(reach.sum())}, grown {int(grown.sum())}")
            excess += int(reach.sum()) - n
    return excess


def personal_path(dev):
    """The personalized and decentralized baselines at full width on the
    main configuration (AlexNet3DS2D, 8 clients x 40 phased volumes, bf16,
    5 steps of batch 8, dropout 0.5): for each of PERSONAL_CONFIGS
    PERSONAL_ROUNDS eager rounds, each timed, then an eval; the counters
    zeroed just before and read just after. Checks: finite losses; DisPFL's
    and SubAvg's client weights zero off their masks (SubAvg's trained
    clients as its rounds return them), SubAvg's new masks inside the old
    ones; every DisPFL mask evolution against the reference's fire and
    regrow rules, and its live counts moved by the regrow ties alone
    (:func:`_regrow_ties`: fire and regrow keep a live count but for
    weights tied at the regrow threshold, which bf16 gradients make
    common, so the density drifts by them); the
    masked SGD kernel's ``mask_grads`` branch launched once a step (steps x
    clients) on the DisPFL and SubAvg paths and never elsewhere; the stem
    launches of every path; a narrow run of each algorithm on the card
    against the CPU (:func:`_narrow_personal_parity`). Returns the launches
    per path."""
    import torch

    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.ops.sparsity import mean_mask_density

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    out, parity = {}, {}
    chunks = _eval_chunks()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    for path, cls_name, opts in PERSONAL_CONFIGS:
        algo = _personal_algo(cls_name, opts, model, data, hp)
        trained, evolved = [], []
        if cls_name == "DisPFL" and not algo.static_masks:
            screen, evolve = algo._screen_gradients, algo._evolve_masks

            def capture_screen(*args, _fn=screen):
                evolved.append(_fn(*args))
                return evolved[-1]

            def capture_evolve(masks, trained_, inp, _fn=evolve):
                new_masks = _fn(masks, trained_, inp)
                evolved[-1] = (masks, trained_, inp.anneal_rate,
                               evolved[-1], new_masks)
                return new_masks

            algo._screen_gradients = capture_screen
            algo._evolve_masks = capture_evolve
        if cls_name == "SubAvg":
            client_round = algo._client_round

            def capture(*args, _fn=client_round):
                res = _fn(*args)
                trained.append((res[0], res[1]))
                return res

            algo._client_round = capture
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        state = algo.init_state()
        masks0 = getattr(state, "masks", None)
        dens0 = (float(mean_mask_density(masks0)) if masks0 is not None
                 else None)
        losses, round_s, subset = [], [], True
        for r in range(PERSONAL_ROUNDS):
            t0 = time.perf_counter()
            new, met = algo.run_round(state, r)
            losses.append(float(met["train_loss"]))
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if cls_name == "SubAvg":
                subset &= all(bool((new.masks[k] <= state.masks[k]).all())
                              for k in state.masks)
            state = new
        ev = {k: float(v) for k, v in algo.evaluate(state).items()
              if not k.startswith("acc_per")}
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        branch = kernels.BRANCH_LAUNCHES["masked_sgd_mask_grads"]
        peak = torch.cuda.max_memory_allocated(dev)
        off_mask = 0
        if cls_name == "DisPFL":
            off_mask = sum(int((state.personal_params[k][state.masks[k] == 0]
                                != 0).sum()) for k in state.masks)
        elif cls_name == "SubAvg":
            off_mask = sum(int((p[k][m[k] == 0] != 0).sum())
                           for p, m in trained for k in m)
        # the local steps of the run (Ditto's clients train two legs)
        steps = PERSONAL_ROUNDS * algo.cost_trained_clients_per_round() \
            * STEPS
        screens = (PERSONAL_ROUNDS * N_CLIENTS
                   if algo._draws_screen else 0)
        # every step one stem forward and backward, every screening batch
        # the same; DisPFL's two local tests per round, SubAvg's gate on
        # each client's train shard (40 rows, one chunk of 32 and one of
        # 8) and the eval (Ditto and DPSGD: global and personal), each
        # forward chunk a stem forward; the dropout probe's one forward
        evals = N_CLIENTS * chunks * (2 if cls_name in ("Ditto", "DPSGD")
                                      else 1)
        local_tests = (2 * PERSONAL_ROUNDS * N_CLIENTS * chunks
                       if cls_name == "DisPFL" else 0)
        gates = (PERSONAL_ROUNDS * N_CLIENTS * -(-SAMPLES // 32)
                 if cls_name == "SubAvg" else 0)
        want = {"masked_sgd": steps,
                "stem_fwd": steps + screens + local_tests + gates + evals
                + 1,
                "stem_bwd": steps + screens,
                "weighted_sum": PERSONAL_ROUNDS if cls_name == "Ditto"
                else 0,
                "threshold": 0, "score_mask": 0, "mask_apply": 0,
                "quantize_reduce": 0}
        want_branch = steps if cls_name in ("DisPFL", "SubAvg") else 0
        dens = ties = None
        if cls_name == "DisPFL":
            dens = float(mean_mask_density(state.masks))
            grew = sum(int((state.masks[k] != 0).sum())
                       - int((masks0[k] != 0).sum()) for k in masks0)
            ties = sum(_regrow_ties(rec) for rec in evolved)
            if grew != ties:
                raise AssertionError(
                    f"personal {path}: {grew} more live weights after the "
                    f"rounds, {ties} regrow ties")
        res = {"phase": "personal", "path": path, "algo": algo.name,
               "card": card, "options": opts, "rounds": PERSONAL_ROUNDS,
               "train_loss": losses, "round_s": round_s,
               "steady_round_s": round_s[-1], "eval": ev,
               "peak_mem_bytes": peak, "launches": launches,
               "mask_grads_launches": branch,
               "weights_off_mask": off_mask,
               "mask_density_initial": dens0, "mask_density_final": dens,
               "regrow_ties": ties,
               "subavg_masks_shrink": subset if cls_name == "SubAvg"
               else None}
        if path in ("dispfl", "subavg", "ditto", "local", "dpsgd"):
            parity[path] = res["narrow_cpu_vs_card"] = \
                _narrow_personal_parity(dev, cls_name, {
                    k: v for k, v in opts.items() if k != "frac"},
                    NARROW_SEEDS.get(path, 5))
        emit(res)
        vals = losses + [v for v in ev.values()]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"personal {path}: non-finite {res}")
        if off_mask or not subset or branch != want_branch:
            raise AssertionError(f"personal {path}: {res}")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"personal {path}: launches {launches}, "
                                 f"want {want}")
        if path in parity and not parity[path]["ok"]:
            raise AssertionError(f"personal {path}: the card's narrow run "
                                 f"disagrees with the CPU's: {parity[path]}")
        out[f"personal/{path}"] = launches
        del algo, state
    return out


#: the fomo phase: eager rounds of FedFomo and TurboAggregate (an eval
#: after the last), FedFomo's validation split (the CLI's --val_fraction
#: default, carved from each client's training rows)
FOMO_ROUNDS, FOMO_VAL_FRACTION = 2, 0.1


def _fomo_data(data):
    """The main configuration's cohort with FedFomo's validation split: the
    last FOMO_VAL_FRACTION of each client's rows (views of the one cohort:
    a client's rows stay contiguous), and the validation rows a client."""
    import torch

    nv = max(1, int(FOMO_VAL_FRACTION * SAMPLES))
    keep = SAMPLES - nv
    return dataclasses.replace(
        data, x_train=data.x_train[:, :keep], y_train=data.y_train[:, :keep],
        n_train=torch.full((N_CLIENTS,), keep, dtype=torch.int32),
        x_val=data.x_train[:, keep:], y_val=data.y_train[:, keep:],
        n_val=torch.full((N_CLIENTS,), nv, dtype=torch.int32)), nv


def fomo_path(dev):
    """FedFomo and TurboAggregate at full width on the main configuration
    (AlexNet3DS2D, 8 clients x 40 phased volumes, bf16, 5 steps of batch 8,
    dropout 0.5; FedFomo's last FOMO_VAL_FRACTION of each shard its
    validation rows): FOMO_ROUNDS eager rounds each, timed, then an eval;
    the counters zeroed just before and read just after. TurboAggregate's
    host secure sum is timed apart (CUDA synchronized around it).

    Gates: finite losses and eval; FedFomo's ``p_choose`` moved only at the
    (client, neighbor) pairs its host neighbor choice visited; each
    TurboAggregate global model within ``S * 0.5 / quant_scale`` per entry
    of the plain float64 weighted mean of the same locals (plus the f32
    cast's half-ulp: each client's quantization rounds by at most half a
    quantum); the launches (FedFomo: every step, its ``C + C * (K + 1)``
    validation forwards a round, the eval; TurboAggregate: every step and
    the eval; no weighted sum, the sum is the host's); a narrow run of
    each on the card against the CPU (:func:`_narrow_personal_parity`).
    Returns the launches per path."""
    import gc

    import torch

    from neuroimagedisttraining_torch.algorithms import (
        FedFomo,
        TurboAggregate,
    )
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    gc.collect()  # the earlier phases' algorithms and cohorts
    torch.cuda.empty_cache()
    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", seed=0, compute_dtype="bfloat16")
    fomo_data, nv = _fomo_data(data)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    chunks = _eval_chunks()
    out = {}
    for path in ("fedfomo", "turboaggregate"):
        if path == "fedfomo":
            algo = FedFomo(model, fomo_data, hp, **kw)
        else:
            algo = TurboAggregate(model, data, hp, **kw)
        sums, secure_s = [], []
        if path == "turboaggregate":
            secure = algo._secure_weighted_sum

            def timed_sum(stacked, weights, _fn=secure):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                new = _fn(stacked, weights)
                torch.cuda.synchronize()
                secure_s.append(time.perf_counter() - t0)
                sums.append((stacked, weights, new))
                return new

            algo._secure_weighted_sum = timed_sum
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        state = algo.init_state()
        losses, round_s, stray, visited_n = [], [], 0, 0
        for r in range(FOMO_ROUNDS):
            t0 = time.perf_counter()
            new, met = algo.run_round(state, r)
            losses.append(float(met["train_loss"]))
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if path == "fedfomo":
                before = state.p_choose.cpu().numpy()
                nei = algo._choose_neighbors(r, before)
                visited = torch.zeros((N_CLIENTS, N_CLIENTS),
                                      dtype=torch.bool)
                visited[torch.arange(N_CLIENTS)[:, None],
                        torch.as_tensor(nei, dtype=torch.int64)] = True
                moved = (new.p_choose != state.p_choose).cpu()
                stray += int((moved & ~visited).sum())
                visited_n += int(visited.sum())
            state = new
        ev = {k: float(v) for k, v in algo.evaluate(state).items()
              if not k.startswith("acc_per")}
        torch.cuda.synchronize()
        launches = kernels.snapshot_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        excess = 0.0
        for stacked, weights, new in sums:
            w = torch.as_tensor(weights, dtype=torch.float64, device=dev)
            bound = len(weights) * 0.5 / algo.quant_scale
            for k, v in new.items():
                mean = torch.tensordot(w, stacked[k].double(), dims=1)
                err = (v.double() - mean).abs() - mean.abs() * 2.0 ** -24
                excess = max(excess, float(err.max()) - bound)
        steps = FOMO_ROUNDS * N_CLIENTS * STEPS
        evals = N_CLIENTS * chunks
        if path == "fedfomo":
            k_nei = algo._n_nei
            val_fwd = FOMO_ROUNDS * (N_CLIENTS + N_CLIENTS * (k_nei + 1)) \
                * -(-nv // min(32, nv))
        else:
            val_fwd = 0
        want = {"masked_sgd": steps, "stem_fwd": steps + val_fwd + evals + 1,
                "stem_bwd": steps, "weighted_sum": 0, "threshold": 0,
                "score_mask": 0, "mask_apply": 0, "quantize_reduce": 0,
                "masked_sgd_mask_grads": 0}
        res = {"phase": "fomo", "algo": path, "card": card,
               "rounds": FOMO_ROUNDS, "train_loss": losses,
               "round_s": round_s, "eval": ev, "peak_mem_bytes": peak,
               "launches": launches}
        if path == "fedfomo":
            res.update(neighbors=algo._n_nei, val_rows=nv,
                       p_choose_visited=visited_n, p_choose_stray=stray)
        else:
            res.update(secure_sum_s=secure_s,
                       train_s=[a - b for a, b in zip(round_s, secure_s)],
                       n_groups=algo.n_groups,
                       secure_sum_excess_over_bound=excess)
        res["narrow_cpu_vs_card"] = parity = _narrow_personal_parity(
            dev, "FedFomo" if path == "fedfomo" else "TurboAggregate", {},
            NARROW_SEEDS.get(path, 5))
        emit(res)
        vals = losses + list(ev.values())
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"fomo {path}: non-finite {res}")
        if stray or excess > 0:
            raise AssertionError(f"fomo {path}: p_choose moved off its "
                                 f"visits {stray}, secure sum past its "
                                 f"bound by {excess}")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"fomo {path}: launches {launches}, "
                                 f"want {want}")
        if not parity["ok"]:
            raise AssertionError(f"fomo {path}: the card's narrow run "
                                 f"disagrees with the CPU's: {parity}")
        out[f"fomo/{path}"] = {k: launches[k] for k in kernels.LAUNCHES}
        del algo, state, sums, new
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: the state phase: the population, its sampled fraction (S = 8 a round),
#: the disk store's hot rows, the rounds, and the bounds of the two pins
#: (the streamed run's own peak against the resident 8-client run's, its
#: round seconds against the resident round's)
STATE_CLIENTS, STATE_FRAC, STATE_HOT, STATE_ROUNDS = 32, 0.25, 8, 3
STATE_PEAK_BOUND, STATE_ROUND_BOUND = 1.05, 2.0


def _cpu_tree(t):
    return {k: v.detach().cpu().clone() for k, v in t.items()}


def _state_population(dev, shape):
    """The state phase's population: STATE_CLIENTS clients of the main
    configuration's volumes, made on the card from seed 0 and moved to the
    host (where a client store's run keeps it)."""
    import gc

    import torch

    from neuroimagedisttraining_torch.data import device_synthetic_federated

    cohort = device_synthetic_federated(
        STATE_CLIENTS, SAMPLES, shape,
        torch.Generator(device=dev).manual_seed(0), test_per_client=TEST)
    host = cohort.to("cpu")
    del cohort
    gc.collect()
    torch.cuda.empty_cache()
    return host


def _equal_trees(a, b) -> bool:
    import torch

    return sorted(a) == sorted(b) and all(
        torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _state_launches(launches, want):
    """The streamed eager rounds' kernel launches against their count."""
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"state launch counts {launches}, expected "
                             f"{want}")


def state_path(dev):
    """The state tier at full width on the main configuration (AlexNet3DS2D
    on phased 121x145x121 bf16 volumes, 40 a client, batch 8, 5 steps,
    dropout 0.5, SNIP 0.5) over a population of STATE_CLIENTS clients at
    ``frac`` STATE_FRAC (8 a round), the cohort made on the card and kept
    on the host for the streamed runs:

    1. STATE_ROUNDS eager rounds streamed from a disk client store with
       STATE_HOT hot clients (timed, the store's gather ms, the run's own
       peak device memory; the kernel launches counted exactly), a
       checkpoint after round 2 with its store sidecar (seconds, bytes);
       then the resident 8-client run at full participation (the same S = 8
       round: its peak), then the resident population run: global
       parameters, metrics, every client's row (``gather_all``) and the
       eval bitwise the streamed run's; the streamed fused spelling (a
       block of 2, then 1) bitwise as well.
    2. A fresh algorithm and store resume the checkpoint (seconds) and run
       round 3: bitwise the resident round 3.
    3. ``RoundWatchdog(ckpt_mgr=, template_fn=, store=).rollback(None)``
       returns the round-2 state and rows bitwise.
    4. The streamed run's own peak within STATE_PEAK_BOUND of the resident
       8-client run's; its round within STATE_ROUND_BOUND of the resident
       round.

    Returns the launches of the phase."""
    import gc
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.robust.recovery import RoundWatchdog
    from neuroimagedisttraining_torch.utils.checkpoint import (
        CheckpointManager,
    )

    gc.collect()  # the earlier phases' algorithms and cohorts
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shape = phased_sample_shape(VOLUME)
    hp = _main_hp()
    host = _state_population(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", seed=0, compute_dtype="bfloat16",
              dense_ratio=0.5, itersnip_iterations=1)
    tmp = tempfile.TemporaryDirectory()
    stores = iter(range(100))
    kernels.reset_launches()

    def streamed(frac=STATE_FRAC):
        return SalientGrads(model, host, hp, frac=frac,
                            client_store="disk", store_hot_clients=STATE_HOT,
                            store_dir=os.path.join(tmp.name,
                                                   f"store{next(stores)}"),
                            **kw)

    def timed_rounds(algo, state, rounds, on_round=None):
        mets, secs = [], []
        for r in rounds:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = algo.run_round(state, r)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            mets.append({k: float(v) for k, v in met.items()})
            if on_round is not None:
                on_round(r, state)
        return state, mets, secs

    def own_peak(run):
        """``run()``'s own peak device memory: the peak over what was live
        before it (the earlier phases' leftovers)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = run()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated(dev) - base

    # 1. streamed, with the checkpoint after round 2
    mgr = CheckpointManager(os.path.join(tmp.name, "ck"), "lineage")
    saved = {}

    def checkpoint(r, state):
        if r != 1:
            return
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = mgr.save(2, state, store=algo_s._store)
        saved["save_s"] = time.perf_counter() - t0
        d = os.path.join(mgr.directory, "2")
        saved["bytes"] = (sum(os.path.getsize(os.path.join(d, f))
                              for f in os.listdir(d))
                          + os.path.getsize(mgr._store_path(2)))
        saved["state"] = algo_s.clone_state(state)
        g0 = algo_s._store.gather_ms  # not a round's gather
        saved["rows"] = _cpu_tree(algo_s._store.gather_all(
            "personal_params"))
        saved["gather_ms"] = algo_s._store.gather_ms - g0
        if not ok:
            raise AssertionError("state: the checkpoint save failed")

    staging = []

    def timed_gather(ids, _fn=None):
        """The round's rows and data moved to the card, timed to the end
        of the copies."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = _fn(ids)
        torch.cuda.synchronize()
        staging.append((time.perf_counter() - t0) * 1e3)
        return out

    def run_streamed():
        s = algo_s.init_state()
        algo_s._store_gather_rows = functools.partial(
            timed_gather, _fn=algo_s._store_gather_rows)
        before = dict(kernels.LAUNCHES)
        g0 = algo_s._store.gather_ms
        out = timed_rounds(algo_s, s, range(STATE_ROUNDS), checkpoint)
        launches = {k: kernels.LAUNCHES[k] - n for k, n in before.items()}
        return (out, launches,
                algo_s._store.gather_ms - g0 - saved["gather_ms"])

    algo_s = streamed()
    ((s_state, s_mets, s_secs), s_launch, gather_ms), s_peak = own_peak(
        run_streamed)
    steps = STATE_ROUNDS * N_CLIENTS * STEPS
    # every step one forward and one backward, the first round the dropout
    # probe's forward too; one aggregate a round
    _state_launches(s_launch, {"masked_sgd": steps, "stem_bwd": steps,
                               "stem_fwd": steps + 1, "weighted_sum":
                               STATE_ROUNDS})
    s_eval = {k: float(v) for k, v in algo_s.evaluate(s_state).items()
              if not k.startswith("acc_per")}
    algo_s.store_flush()
    s_rows = _cpu_tree(algo_s._store.gather_all("personal_params"))
    s_global = _cpu_tree(s_state.global_params)
    store_stats = algo_s._store.stats()
    del algo_s, s_state

    # the resident 8-client run at full participation: the same round
    def run_resident8():
        data8 = dataclasses.replace(
            host, x_train=host.x_train[:N_CLIENTS],
            y_train=host.y_train[:N_CLIENTS],
            n_train=host.n_train[:N_CLIENTS], x_test=host.x_test[:N_CLIENTS],
            y_test=host.y_test[:N_CLIENTS], n_test=host.n_test[:N_CLIENTS])
        algo8 = SalientGrads(model, data8, hp, frac=1.0, **kw)
        timed_rounds(algo8, algo8.init_state(), range(STATE_ROUNDS))

    _, r8_peak = own_peak(run_resident8)

    # the resident population: the bitwise twin, its round seconds
    algo_r = SalientGrads(model, host, hp, frac=STATE_FRAC, **kw)
    r_state, r_mets, r_secs = timed_rounds(
        algo_r, algo_r.init_state(), range(STATE_ROUNDS))
    r_eval = {k: float(v) for k, v in algo_r.evaluate(r_state).items()
              if not k.startswith("acc_per")}
    r_global = _cpu_tree(r_state.global_params)
    r_rows = _cpu_tree(r_state.personal_params)
    del algo_r, r_state
    gc.collect()
    torch.cuda.empty_cache()
    checks = {
        "streamed_metrics": s_mets == r_mets,
        "streamed_global": _equal_trees(s_global, r_global),
        "streamed_rows": _equal_trees(s_rows, r_rows),
        "streamed_eval": s_eval == r_eval,
    }

    # the streamed fused spelling: a block of 2, then 1
    algo_f = streamed()
    f_state = algo_f.init_state()
    t0 = time.perf_counter()
    f_state, ys = algo_f.run_rounds_fused(f_state, 0, 2)
    f_mets = [ys[k] for k in ys.materialize()]
    first_block_s = time.perf_counter() - t0
    f_state, ys2 = algo_f.run_rounds_fused(f_state, 2, 1)
    algo_f.store_flush()
    checks["fused_metrics"] = all(
        list(f_mets[i]) + list(ys2[k]) == [m[k] for m in r_mets]
        for i, k in enumerate(ys.materialize()))
    checks["fused_global"] = _equal_trees(
        _cpu_tree(f_state.global_params), r_global)
    checks["fused_rows"] = _equal_trees(
        _cpu_tree(algo_f._store.gather_all("personal_params")), r_rows)
    del algo_f, f_state
    gc.collect()
    torch.cuda.empty_cache()

    # 2. resume from the checkpoint, round 3
    algo_c = streamed()
    template = algo_c.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_state, step = mgr.restore_latest(template, store=algo_c._store)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    c_state, c_mets, _ = timed_rounds(algo_c, c_state, [2])
    algo_c.store_flush()
    checks["resume_step"] = step == 2
    checks["resume_metrics"] = c_mets == r_mets[2:]
    checks["resume_global"] = _equal_trees(
        _cpu_tree(c_state.global_params), r_global)
    checks["resume_rows"] = _equal_trees(
        _cpu_tree(algo_c._store.gather_all("personal_params")), r_rows)

    # 3. the watchdog's rollback from the checkpoint
    wd = RoundWatchdog(ckpt_mgr=mgr, template_fn=algo_c.init_state,
                       store=algo_c._store)
    back = wd.rollback(None)
    want = saved["state"]
    checks["rollback_global"] = _equal_trees(back.global_params,
                                             want.global_params)
    checks["rollback_generator"] = torch.equal(
        back.generator.get_state(), want.generator.get_state())
    checks["rollback_rows"] = _equal_trees(
        _cpu_tree(algo_c._store.gather_all("personal_params")),
        saved["rows"])
    del algo_c, c_state, back, want, saved["state"]
    tmp.cleanup()

    # 4. the pins (the first round of each run builds what later ones
    # reuse: the steady rounds are the later ones)
    s_round = statistics.median(s_secs[1:])
    r_round = statistics.median(r_secs[1:])
    checks["peak_within_bound"] = s_peak <= STATE_PEAK_BOUND * r8_peak
    checks["round_within_bound"] = s_round <= STATE_ROUND_BOUND * r_round
    launches = dict(kernels.LAUNCHES)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    rows = STATE_ROUNDS * N_CLIENTS
    emit({"phase": "state", "card": card, "clients": STATE_CLIENTS,
          "frac": STATE_FRAC, "hot_clients": STATE_HOT,
          "host_cohort_bytes": host.x_train.numel() * 2
          + host.x_test.numel() * 2,
          "streamed_round_s": s_secs, "resident_round_s": r_secs,
          "streamed_over_resident": s_round / r_round,
          "store_gather_ms_per_round": gather_ms / STATE_ROUNDS,
          "gather_ms_rows_and_data": staging,
          "store_stats": store_stats,
          "streamed_peak_bytes": s_peak, "resident8_peak_bytes": r8_peak,
          "peak_ratio": s_peak / r8_peak,
          "checkpoint_save_s": saved["save_s"],
          "checkpoint_restore_s": restore_s,
          "checkpoint_bytes": saved["bytes"],
          "fused_first_block_s": first_block_s, "rows_streamed": rows,
          "metrics": s_mets, "eval": s_eval, "checks": checks,
          "seconds": time.perf_counter() - t_phase, "launches": launches})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"state: failed {failed}")
    for k in ("masked_sgd", "threshold", "score_mask", "weighted_sum",
              "stem_fwd", "stem_bwd"):
        if not launches[k]:
            raise AssertionError(f"state: {k} never launched: {launches}")
    return {"state": launches}


#: the resnet3d phase: rounds eager and in the fused block (the eval after
#: each), the forward check's batch and bound (``tests/test_s2d.py``'s)
RESNET_ROUNDS, RESNET_CHECK_BATCH, RESNET_CHECK_TOL = 2, 2, 2e-4
#: the uneven phase's rounds, eager and fused
UNEVEN_ROUNDS = 2
#: the determinism phase: pairs (deterministic and default cuDNN), the
#: rounds of each timed fused block
DETERMINISM_PAIRS, DETERMINISM_ROUNDS = 3, 10


class _CudnnFlags:
    """Sets ``torch.backends.cudnn.deterministic``, ``benchmark`` and
    ``enabled`` on entry (None leaves a flag as it is) and puts them back
    on exit; the TF32 flags stay as they are."""

    _NAMES = ("deterministic", "benchmark", "enabled")

    def __init__(self, deterministic=None, benchmark=None, enabled=None):
        self.want = (deterministic, benchmark, enabled)

    def __enter__(self):
        import torch

        c = torch.backends.cudnn
        self.saved = tuple(getattr(c, name) for name in self._NAMES)
        for name, v in zip(self._NAMES, self.want):
            if v is not None:
                setattr(c, name, v)
        return self

    def __exit__(self, *exc):
        import torch

        c = torch.backends.cudnn
        for name, v in zip(self._NAMES, self.saved):
            setattr(c, name, v)
        return False


def _fused_against_eager(phase, algo, state, rounds):
    """``rounds`` eager rounds (``run_round`` + ``evaluate``, each round and
    eval timed) and the same rounds as one fused block from the same state:
    the record (per-round seconds, losses, the first block's seconds, the
    fused block's largest difference and bitwise flag, the launches of both
    and of the graph's replay) and the launches of both spellings summed.
    Raises unless the block is bitwise the eager rounds."""
    import torch

    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.ops import kernels

    torch.cuda.synchronize()
    kernels.reset_launches()
    s, mets, evals, round_s = algo.clone_state(state), [], [], []
    for r in range(rounds):
        t0 = time.perf_counter()
        s, met = algo.run_round(s, r)
        mets.append({k: float(v) for k, v in met.items()})
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        evals.append({k: float(v) for k, v in algo.evaluate(s).items()
                      if not k.startswith("acc_per")})
    torch.cuda.synchronize()
    eager = kernels.snapshot_launches()
    kernels.reset_launches()
    t0 = time.perf_counter()
    sf, ys = algo.run_rounds_fused(algo.clone_state(state), 0, rounds,
                                   eval_every=1)
    host = ys.materialize()
    torch.cuda.synchronize()
    first_block_s = time.perf_counter() - t0
    fused = kernels.snapshot_launches()
    names = list(algo._round_metric_names)
    diff = _spread(s, mets, evals, sf,
                   [{k: float(host[k][i]) for k in names}
                    for i in range(rounds)],
                   [{k: float(v[i]) for k, v in host["eval"].items()}
                    for i in range(rounds)])
    trees = _tensor_trees(sf)
    bitwise = diff == 0.0 and all(
        torch.equal(t[k], trees[f][k])
        for f, t in _tensor_trees(s).items() for k in t)
    (graph,) = algo._fused.rounds.values()
    rec = {"rounds": rounds, "round_s": round_s,
           "train_loss": [m["train_loss"] for m in mets],
           "final_eval": evals[-1], "first_block_s": first_block_s,
           "fused_vs_eager_max_abs": diff, "fused_bitwise": bitwise,
           "launches_eager": eager, "launches_fused": fused,
           "launches_per_replay": graph.launches,
           "round_graph_nodes": graph.graph.nodes,
           "fused_warmups": FUSED_WARMUPS}
    if not bitwise:
        emit({"phase": phase, **rec})
        raise AssertionError(f"{phase}: the fused block differs from the "
                             f"eager rounds by {diff}")
    losses = rec["train_loss"] + list(evals[-1].values())
    if not all(math.isfinite(v) for v in losses):
        emit({"phase": phase, **rec})
        raise AssertionError(f"{phase}: non-finite {losses}")
    return rec, {k: eager[k] + fused[k] for k in kernels.LAUNCHES}


def resnet3d_path(dev):
    """The 3D-ResNet twin at full width through the library entry points:
    SalientGrads on ``3dresnet_s2d``, 8 clients x 40 volumes of 121x145x121
    phased for its k3/p3 stem (``(64, 76, 8, 64)``, bf16), batch 8, 5
    steps, SNIP 0.5, the dense aggregate; cuDNN in the CLI's deterministic
    mode. SNIP, RESNET_ROUNDS eager rounds with the eval, the same rounds
    as one fused block, bitwise. Its 49 leaves take two launches of masked
    SGD per step and of the weighted sum per aggregate (32 leaves a
    launch); its 17 kernel leaves one launch of the score mask; its stem is
    plain torch, so no stem kernel runs. Then ``3dresnet`` on
    RESNET_CHECK_BATCH raw volumes against the twin on their phased form,
    from converted weights, within RESNET_CHECK_TOL. Returns the launches
    of the path (SNIP, the eager rounds, the fused block)."""
    import gc

    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.models import (
        convert_resnet3d_params,
        create_model,
        init_params,
        make_apply_fn,
    )
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import (
        phase_decompose,
        phased_sample_shape,
    )

    shape = phased_sample_shape(VOLUME, kernel=3, pad=3)
    with _CudnnFlags(deterministic=True, benchmark=False):
        t0 = time.perf_counter()
        data, hp = _main_config(dev, shape)
        torch.cuda.synchronize()
        data_s = time.perf_counter() - t0
        model = create_model("3dresnet_s2d", num_classes=1,
                             sample_shape=shape)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        algo = SalientGrads(model, data, hp, loss_type="bce", frac=1.0,
                            seed=0, dense_ratio=0.5, itersnip_iterations=1,
                            compute_dtype="bfloat16")
        t0 = time.perf_counter()
        state = algo.init_state()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        snip = dict(kernels.LAUNCHES)
        rec, launches = _fused_against_eager("resnet3d", algo, state,
                                             RESNET_ROUNDS)
        peak = torch.cuda.max_memory_allocated(dev)
        leaves = len(state.global_params)
        kernel_leaves = sum(k.endswith(".kernel")
                            for k in state.global_params)
        n_params = sum(v.numel() for v in state.global_params.values())
        density = float(algo.evaluate(state)["mask_density"])
        del algo, state
        gc.collect()
        torch.cuda.empty_cache()

        # the dense model on raw volumes against the twin on their phased
        # form, from converted weights (float32, TF32 off)
        dense = create_model("3dresnet", num_classes=1,
                             sample_shape=VOLUME + (1,)).to(dev)
        params = init_params(dense, torch.Generator(device=dev).manual_seed(3))
        twin = create_model("3dresnet_s2d", num_classes=1,
                            sample_shape=shape).to(dev)
        x = torch.randn((RESNET_CHECK_BATCH,) + VOLUME, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4))
        with torch.no_grad():
            want = make_apply_fn(dense)(params, x[..., None], train=False)
            got = make_apply_fn(twin)(convert_resnet3d_params(params),
                                      phase_decompose(x, kernel=3, pad=3),
                                      train=False)
        check = {name: float(((g - w).abs() - RESNET_CHECK_TOL * (
                     1 + w.abs())).max())
                 for name, g, w in zip(("logits", "features"), got, want)}
    for k in kernels.LAUNCHES:
        launches[k] += snip[k]
    res = {"phase": "resnet3d", "model": "3dresnet_s2d", "clients": N_CLIENTS,
           "samples_per_client": SAMPLES, "sample_shape": list(shape),
           "batch": BATCH, "steps": STEPS, "compute_dtype": "bfloat16",
           "cudnn_deterministic": True, "leaves": leaves,
           "kernel_leaves": kernel_leaves, "params": n_params,
           "mask_density": density, "data_s": data_s, "init_snip_s": init_s,
           **rec, "launches_snip": snip, "launches": launches,
           "peak_mem_bytes": peak,
           "dense_vs_twin_excess": check, "dense_vs_twin_tol":
               RESNET_CHECK_TOL}
    emit(res)
    if abs(density - 0.5) > 1e-3:
        raise AssertionError(f"resnet3d: mask density {density}")
    if any(v > 0 for v in check.values()):
        raise AssertionError(f"resnet3d: the twin differs from the dense "
                             f"model beyond {RESNET_CHECK_TOL}: {check}")
    # masked SGD and the weighted sum launch once per MAX_LEAVES leaves
    per_table = -(-leaves // kernels.MAX_LEAVES)
    # the eager rounds and the fused block's replays (its warm-ups too)
    runs = 2 * RESNET_ROUNDS + FUSED_WARMUPS
    want = {**{k: 0 for k in kernels.LAUNCHES},
            "threshold": 1, "score_mask": -(-kernel_leaves //
                                            kernels.MAX_LEAVES),
            "masked_sgd": per_table * N_CLIENTS * STEPS * runs,
            "weighted_sum": per_table * runs}
    if (leaves, per_table) != (49, 2) or launches != want:
        raise AssertionError(f"resnet3d: {leaves} leaves, launches "
                             f"{launches}, want {want}")
    return {"resnet3d": launches}


def uneven_path(dev):
    """The main configuration with uneven shards: per-client sample counts
    in [20, 40] drawn as ``bench.py`` draws them, so each client runs its
    own ``ceil(n / 8)`` of the 5 steps (the masked epoch path) and the
    round graph's key is those step counts. SNIP, UNEVEN_ROUNDS eager
    rounds with the eval and the same rounds as one fused block, bitwise.
    Every kernel's launches follow the step counts. Returns the launches of
    the path."""
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.core.trainer import active_steps
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape, uneven=True)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    algo = SalientGrads(model, data, hp, loss_type="bce", frac=1.0, seed=0,
                        dense_ratio=0.5, itersnip_iterations=1,
                        compute_dtype="bfloat16")
    state = algo.init_state()
    torch.cuda.synchronize()
    snip = dict(kernels.LAUNCHES)
    rec, launches = _fused_against_eager("uneven", algo, state,
                                         UNEVEN_ROUNDS)
    counts = [int(n) for n in data.n_train]
    key = algo._step_key(counts)
    for k in kernels.LAUNCHES:
        launches[k] += snip[k]
    res = {"phase": "uneven", "model": "3dcnn_s2d", "counts": counts,
           "step_key": list(key), "graphs": len(algo._fused.rounds), **rec,
           "launches_snip": snip, "launches": launches,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    emit(res)
    steps = sum(len(active_steps(hp, n)) for n in counts)
    replays = FUSED_WARMUPS + UNEVEN_ROUNDS
    runs = UNEVEN_ROUNDS + replays  # eager rounds and graph replays
    evals = runs * 2 * N_CLIENTS * _eval_chunks()
    # SNIP: one batch per client; the dropout probe's forward, once
    want = {**{k: 0 for k in kernels.LAUNCHES},
            "masked_sgd": runs * steps, "threshold": 1, "score_mask": 1,
            "weighted_sum": runs,
            "stem_fwd": runs * steps + N_CLIENTS + evals + 1,
            "stem_bwd": runs * steps + N_CLIENTS}
    if steps >= N_CLIENTS * STEPS or len(set(key)) < 2 or launches != want:
        raise AssertionError(f"uneven: {steps} steps a round (key {key}), "
                             f"launches {launches}, want {want}")
    return {"uneven": launches}


def determinism_path(dev):
    """What cuDNN's deterministic mode (the CLI's, ``runner.seed_everything``)
    costs the main configuration: SalientGrads on AlexNet3DS2D, one SNIP
    state, two algorithms whose round graphs were captured one with
    ``cudnn.deterministic`` on and one with it off (``benchmark`` off both
    times); DETERMINISM_PAIRS pairs of fused blocks of DETERMINISM_ROUNDS
    rounds (no eval), interleaved (on, off, off, on, ...); then the stem's
    weight gradient alone (the conv's ``wgrad``, cuDNN) at the step's shape
    in each mode. Prints both rates and both device times; gates nothing
    but finite rates."""
    import torch

    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.models.layers import phased_input
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
              itersnip_iterations=1, compute_dtype="bfloat16")
    algos, state = {}, None
    n = DETERMINISM_ROUNDS
    for mode in ("deterministic", "default"):
        with _CudnnFlags(deterministic=mode == "deterministic",
                         benchmark=False):
            algos[mode] = SalientGrads(model, data, hp, **kw)
            if state is None:
                state = algos[mode].init_state()
            # captures the round graph under this mode (a one-round block
            # has the same key as the timed ones)
            algos[mode].run_rounds_fused(algos[mode].clone_state(state), n,
                                         1)[1].materialize()

    def block(mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algos[mode].run_rounds_fused(state, n, n)[1].materialize()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    rates = {"deterministic": [], "default": []}
    order = []
    for i in range(DETERMINISM_PAIRS):
        pair = (("deterministic", "default") if i % 2 == 0
                else ("default", "deterministic"))
        for mode in pair:
            rates[mode].append(block(mode))
            order.append(mode)
    # the stem's weight gradient at the step's shape, as StemStage.backward
    # calls it: channels-last input and output gradient
    g = torch.Generator(device=dev).manual_seed(5)
    x = data.x_train[0, :BATCH]
    xin = phased_input(x).contiguous(memory_format=torch.channels_last_3d)
    w = torch.randn((64, 8, 3, 3, 3), device=dev, generator=g,
                    dtype=torch.bfloat16)
    dz = torch.randn((BATCH, 64) + tuple(s - 2 for s in xin.shape[2:]),
                     device=dev, generator=g, dtype=torch.bfloat16
                     ).contiguous(memory_format=torch.channels_last_3d)
    wgrad = {}
    for mode in ("deterministic", "default", "deterministic", "default"):
        with _CudnnFlags(deterministic=mode == "deterministic",
                         benchmark=False):
            wgrad.setdefault(mode, []).append(device_ms(
                lambda: torch.nn.grad.conv3d_weight(xin, w.shape, dz)))
    med = {m: statistics.median(r) for m, r in rates.items()}
    res = {"phase": "determinism", "rounds_per_block": n, "order": order,
           "rounds_per_sec": rates, "median_rounds_per_sec": med,
           "deterministic_over_default": med["deterministic"]
           / med["default"],
           "stem_wgrad_device_ms": wgrad,
           "stem_wgrad_shape": {"x": list(xin.shape), "dz": list(dz.shape)},
           "steps_per_round": N_CLIENTS * STEPS}
    emit(res)
    if not all(math.isfinite(v) and v > 0 for r in rates.values()
               for v in r):
        raise AssertionError(f"determinism: {rates}")
    del algos
    return {}


#: the mesh phase: the wires its two gloo ranks run (SNIP once, then
#: MESH_ROUNDS rounds each), the global model's bound against the
#: single-process round on each (of the tree's largest value; bf16 and int8
#: quantize each rank's partial on the mesh, each client's row off it), the
#: reps timing the one-rank NCCL collectives
MESH_WIRES = ("dense", "bucketed", "bf16", "int8", "hier")
MESH_ROUNDS, MESH_RANKS = 2, 2
MESH_GLOBAL_BOUND = {"dense": 1e-6, "bucketed": 1e-6, "hier": 1e-6,
                     "bf16": 1e-2, "int8": 5e-2}
NCCL_REPS = 20
#: a collective that waits longer than this fails the phase (a rank that
#: died leaves the others waiting)
MESH_TIMEOUT_S = 300
#: parts (e)-(g) of the mesh phase, the robust and the state tiers on the
#: mesh: the robust cases of tests/test_torch_port_mesh_robust.py at full
#: width (name, algorithm, agg_impl, robust_agg, defense, fault spec, run
#: seed), the eager rounds of (e), and the case (g) checkpoints after its
#: first round
MESH_ROBUST_CASES = (
    ("salientgrads_krum_weak_dp", "salientgrads", "dense", "krum", "weak_dp",
     "drop=0.3,nan=0.3,scale=0.3:10x,labelflip=0.3", 11),
    ("fedavg_int8_median_clip", "fedavg", "int8", "median",
     "norm_diff_clipping",
     "straggle=0.4,signflip=0.3,collude=0.4:5x,labelflip=0.4,nan=0.2", 0),
    ("salientgrads_topk_nan", "salientgrads", "topk", "none", None,
     "nan=0.34", 0),
)
MESH_ROBUST_ROUNDS = 2
MESH_CKPT_CASE = "salientgrads_topk_nan"
#: parts (h)-(j) of the mesh phase, the seven algorithms besides
#: SalientGrads and FedAvg on the mesh: (name, class, options) at the
#: personal and fomo phases' configurations (Local and SubAvg at ``frac``
#: 0.5, so a rank trains a part of the draw; TurboAggregate at full
#: participation, its secure sum timed apart as in the fomo phase),
#: MESH_BASELINE_ROUNDS eager rounds each on the two gloo ranks; (j)
#: checkpoints MESH_BASELINE_CKPT after its first round
MESH_BASELINES = (
    ("local", "LocalOnly", dict(frac=0.5)),
    ("ditto", "Ditto", dict()),
    ("subavg", "SubAvg", dict(epochs=2, frac=0.5)),
    ("dpsgd", "DPSGD", dict(frac=0.5)),
    ("dispfl", "DisPFL", dict(frac=0.5, neighbor_mode="random")),
    ("fedfomo", "FedFomo", dict()),
    ("turboaggregate", "TurboAggregate", dict()),
)
MESH_BASELINE_ROUNDS = 2
MESH_BASELINE_CKPT = "dispfl"
#: part (i): the baselines the CLI fuses, on a one-rank NCCL mesh
MESH_BASELINES_FUSED = (
    ("local", "LocalOnly", dict(frac=0.5)),
    ("ditto", "Ditto", dict()),
    ("dpsgd", "DPSGD", dict(frac=0.5)),
    ("dispfl_static", "DisPFL", dict(frac=0.5, static_masks=True)),
)
#: the kernels of the baselines' mesh path (and the masked SGD kernel's
#: ``mask_grads`` branch, on DisPFL and SubAvg)
MESH_BASELINE_KERNELS = ("masked_sgd", "stem_fwd", "stem_bwd",
                         "weighted_sum", "masked_sgd_mask_grads")


def _tree_digest(tree) -> str:
    """sha256 of a tree's bytes, leaf by leaf in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(tree[k].detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_algo(data, hp, shape, impl):
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.models import create_model

    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    return SalientGrads(model, data, hp, loss_type="bce", frac=1.0, seed=0,
                        dense_ratio=0.5, itersnip_iterations=1,
                        compute_dtype="bfloat16", agg_impl=impl)


def _mesh_robust_algo(data, hp, shape, case):
    """The algorithm of a MESH_ROBUST_CASES entry on the main
    configuration (``data`` sharded or not): the guard on with the faults,
    the defense at bound 5 and stddev 0.025."""
    from neuroimagedisttraining_torch.algorithms import FedAvg, SalientGrads
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.robust import RobustAggregator

    _, algo_name, impl, robust, defense, spec, seed = case
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", frac=1.0, seed=seed, compute_dtype="bfloat16",
              agg_impl=impl, agg_topk_density=TOPK_DENSITY,
              robust_agg=robust, fault_spec=spec,
              defense=(RobustAggregator(defense, 5.0, 0.025) if defense
                       else None))
    if algo_name == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    return FedAvg(model, data, hp, **kw)


def _mesh_robust_state(algo, case, snip_state):
    """A robust case's initial state: the SNIP state (its residual zeroed
    under top-k) for SalientGrads, FedAvg's own init."""
    import dataclasses

    from neuroimagedisttraining_torch.core.state import zeros_like_tree

    if case[1] != "salientgrads":
        return algo.init_state()
    return dataclasses.replace(
        algo.clone_state(snip_state),
        agg_residual=(zeros_like_tree(snip_state.personal_params)
                      if case[2] == "topk" else None))


def _row_digests(algo, state):
    """Per client this rank holds (population id), the digest of its row of
    each of the state's per-client row fields (``algo.row_fields``: the
    personal model and the top-k residual; the baselines' masks and
    FedFomo's ``p_choose``)."""
    out = {}
    for i in range(algo.num_local_clients):
        rows = []
        for f in algo.row_fields:
            v = getattr(state, f, None)
            if v is not None:
                rows.append(_tree_digest(
                    {k: t[i] for k, t in v.items()} if isinstance(v, dict)
                    else {"": v[i]}))
        out[algo._lo + i] = tuple(rows)
    return out


def _mesh_robust_rounds(algo, state, rounds, rank, on_round=None):
    """Eager rounds of a robust case: per round the metrics, the row
    digests, the global model's digest (and on rank 0 the model), the eval
    after it. ``on_round(r, state)`` after each."""
    import torch

    out = []
    for r in range(rounds):
        state, met = algo.run_round(state, r)
        ev = algo.evaluate(state)
        torch.cuda.synchronize()
        out.append({
            "metrics": {k: float(v) for k, v in met.items()},
            "rows": _row_digests(algo, state),
            "global_digest": _tree_digest(state.global_params),
            "global": ({k: v.cpu() for k, v in state.global_params.items()}
                       if rank == 0 else None),
            "eval": {k: v.cpu() for k, v in ev.items()}})
        if on_round is not None:
            on_round(r, state)
    return out, state


def _mesh_resume_rank(rank, directory, dev, ck_dir, ck_dir_j):
    """Part (g)'s and (j)'s fresh spawn: the ranks restore the checkpoint
    the mesh phase's ranks wrote into ``ck_dir`` after round 0 of
    MESH_CKPT_CASE and run round 1, then the same for MESH_BASELINE_CKPT's
    checkpoint in ``ck_dir_j``; each leaves its record (the rounds'
    digests, the launches of each) in ``directory``."""
    import os

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    dev = torch.device("cuda", dev.index or 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(MESH_RANKS, backend="gloo", rank=rank, device=dev,
                     init_method="file://" + os.path.join(directory, "rdv2"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        shape = phased_sample_shape(VOLUME)
        data, hp = _main_config(dev, shape)
        case = dict((c[0], c) for c in MESH_ROBUST_CASES)[MESH_CKPT_CASE]
        data = shard_federated(data, mesh)
        algo = _mesh_robust_algo(data, hp, shape, case)
        kernels.reset_launches()
        mgr = CheckpointManager(ck_dir, layout=algo)
        t0 = time.perf_counter()
        state, step = mgr.restore_latest(algo.init_state())
        torch.cuda.synchronize()
        rec = {"rank": rank, "step": step,
               "restore_s": time.perf_counter() - t0}
        state, met = algo.run_round(state, step)
        torch.cuda.synchronize()
        rec.update(metrics={k: float(v) for k, v in met.items()},
                   rows=_row_digests(algo, state),
                   global_digest=_tree_digest(state.global_params),
                   launches=dict(kernels.LAUNCHES))
        del algo, state
        # part (j): the baseline's checkpoint
        algo = _mesh_baseline_algo(MESH_BASELINE_CKPT, data, hp, shape)
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, step = CheckpointManager(
            ck_dir_j, layout=algo).restore_latest(algo.init_state())
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        state, met = algo.run_round(state, step)
        torch.cuda.synchronize()
        rec["baseline"] = {"step": step, "restore_s": restore_s,
                           "metrics": {k: float(v) for k, v in met.items()},
                           "rows": _row_digests(algo, state),
                           "launches": kernels.snapshot_launches()}
        torch.save(rec, os.path.join(directory, f"resume{rank}.pt"))
    finally:
        mesh.destroy()


def _mesh_rank(rank, directory, dev, ck_dir, ck_dir_j):
    """One of the mesh phase's gloo ranks on the card (spawned by
    ``mesh_path``): the main configuration sharded over the mesh, SNIP,
    then MESH_ROUNDS rounds per wire from the SNIP state, each timed, each
    trained client's model digested, the eval after each round and its
    per-client sums. Then parts (e) and (g): each of MESH_ROBUST_CASES for
    MESH_ROBUST_ROUNDS eager rounds, MESH_CKPT_CASE checkpointed into
    ``ck_dir`` after its first round (every rank saving, rank 0 writing),
    their launches apart. Then parts (h) and (j): the seven other
    algorithms (:func:`_mesh_baseline_rounds`), MESH_BASELINE_CKPT
    checkpointed into ``ck_dir_j``. Leaves its record in ``directory``."""
    import os

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(MESH_RANKS, backend="gloo", rank=rank, device=dev,
                     init_method="file://" + os.path.join(directory, "rdv"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        shape = phased_sample_shape(VOLUME)
        data, hp = _main_config(dev, shape)
        data = shard_federated(data, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        base = _mesh_algo(data, hp, shape, "dense")
        t0 = time.perf_counter()
        state0 = base.init_state()
        torch.cuda.synchronize()
        rec = {"rank": rank, "block": [base._lo, base._hi],
               "snip_s": time.perf_counter() - t0,
               "mask": _tree_digest(state0.mask), "wires": {}}
        for impl in MESH_WIRES:
            algo = _mesh_algo(data, hp, shape, impl)
            state = algo.clone_state(state0)
            rounds = []
            for r in range(MESH_ROUNDS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = algo.run_round(state, r)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                ev = algo.evaluate(state)
                correct, loss_sum = algo._eval_terms(
                    range(algo.num_clients), lambda c: state.global_params)
                rounds.append({
                    "seconds": seconds,
                    "train_loss": float(met["train_loss"]),
                    "clients": {base._lo + i: _tree_digest(
                        {k: v[i] for k, v in state.personal_params.items()})
                        for i in range(algo.num_local_clients)},
                    "global_digest": _tree_digest(state.global_params),
                    "global": ({k: v.cpu() for k, v in
                                state.global_params.items()}
                               if rank == 0 else None),
                    "eval": {k: v.cpu() for k, v in ev.items()},
                    "terms": (correct.cpu(), loss_sum.cpu())})
            rec["wires"][impl] = rounds
        # part (c): a gloo group's collectives run on the host, so a CUDA
        # graph cannot hold them: the fused block is refused, with no
        # eager fallback
        try:
            algo.run_rounds_fused(algo.clone_state(state0), 0, MESH_ROUNDS)
            rec["fused_refused"] = None
        except ValueError as e:
            rec["fused_refused"] = str(e)
        torch.cuda.synchronize()
        rec["launches"] = dict(kernels.LAUNCHES)
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        # parts (e) and (g): the robust cases, (g)'s checkpoint
        kernels.reset_launches()
        ck = CheckpointManager(ck_dir)
        rec["robust"] = {}
        for case in MESH_ROBUST_CASES:
            algo = _mesh_robust_algo(data, hp, shape, case)
            state = _mesh_robust_state(algo, case, state0)
            save = None
            if case[0] == MESH_CKPT_CASE:
                ck.layout = algo

                def save(r, s):
                    if r == 0:
                        t0 = time.perf_counter()
                        ck.save(1, s)
                        rec["ckpt_save_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rounds, _ = _mesh_robust_rounds(algo, state, MESH_ROBUST_ROUNDS,
                                            rank, save)
            rec["robust"][case[0]] = {
                "rounds": rounds, "seconds": time.perf_counter() - t0}
            del algo, state
        rec["ckpt_save_failures"] = ck.save_failures
        torch.cuda.synchronize()
        rec["launches_robust"] = dict(kernels.LAUNCHES)
        # parts (h) and (j): the seven other algorithms
        rec["baselines"] = _mesh_baseline_rounds(data, hp, shape, rank,
                                                 ck_dir_j)
        torch.save(rec, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        mesh.destroy()


def _mesh_baseline_algo(name, data, hp, shape):
    """A MESH_BASELINES (or MESH_BASELINES_FUSED) entry on the main
    configuration, ``data`` sharded or not (FedFomo on its validation
    split, :func:`_fomo_data`)."""
    from neuroimagedisttraining_torch.models import create_model

    _, cls_name, opts = {c[0]: c for c in
                         MESH_BASELINES + MESH_BASELINES_FUSED}[name]
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    if cls_name == "FedFomo":
        data = _fomo_data(data)[0]
    return _personal_algo(cls_name, opts, model, data, hp)


def _time_secure_sum(algo):
    """TurboAggregate's host secure sum timed apart (the card synchronized
    around it, as in the fomo phase): the list its seconds are appended to,
    empty for the other algorithms."""
    import torch

    secure_s = []
    fn = getattr(algo, "_secure_weighted_sum", None)
    if fn is not None:
        def timed(stacked, weights):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new = fn(stacked, weights)
            torch.cuda.synchronize()
            secure_s.append(time.perf_counter() - t0)
            return new

        algo._secure_weighted_sum = timed
    return secure_s


def _mesh_baseline_rounds(data, hp, shape, rank, ck_dir):
    """Parts (h) and (j) on a gloo rank: each of MESH_BASELINES for
    MESH_BASELINE_ROUNDS eager rounds from its own init, per round the
    seconds, the metrics, the row digests (:func:`_row_digests`), the
    global model's digest and on rank 0 the model, the eval;
    TurboAggregate's secure sum timed apart; MESH_BASELINE_CKPT
    checkpointed into ``ck_dir`` after its first round (every rank saving,
    rank 0 writing). Each algorithm's launches apart."""
    import gc

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    out = {}
    for name, _, _ in MESH_BASELINES:
        algo = _mesh_baseline_algo(name, data, hp, shape)
        secure_s = _time_secure_sum(algo)
        torch.cuda.synchronize()
        kernels.reset_launches()
        state = algo.init_state()
        rounds, save_s = [], None
        for r in range(MESH_BASELINE_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = algo.run_round(state, r)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            ev = algo.evaluate(state)
            glob = getattr(state, "global_params", None)
            rounds.append({
                "seconds": seconds,
                "metrics": {k: float(v) for k, v in met.items()},
                "rows": _row_digests(algo, state),
                "global_digest": None if glob is None else _tree_digest(glob),
                "global": ({k: v.cpu() for k, v in glob.items()}
                           if rank == 0 and glob is not None else None),
                "eval": {k: v.cpu() for k, v in ev.items()}})
            if name == MESH_BASELINE_CKPT and r == 0:
                t0 = time.perf_counter()
                CheckpointManager(ck_dir, layout=algo).save(1, state)
                save_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        out[name] = {"rounds": rounds, "secure_sum_s": secure_s,
                     "ckpt_save_s": save_s,
                     "launches": kernels.snapshot_launches()}
        del algo, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _mesh_baseline_checks(dev, ranks, resumed, data, hp, shape):
    """Parts (h) and (j) on this process's side. (h): each of
    MESH_BASELINES' rounds of the two gloo ranks replayed here in one
    process, each round from the mesh's global model before it where the
    algorithm has one (its per-client rows are the single process's bit
    for bit already): the metrics, every client's rows (the personal
    models, the masks, ``p_choose``) and the evals bitwise; the global
    model the same on both ranks, bitwise the replay's where every rank
    reduces the gathered rows (SubAvg, TurboAggregate), within
    MESH_GLOBAL_BOUND["dense"] where the sum is split by rank (Ditto's
    weighted mean). (j): the fresh spawn's round after the restored
    MESH_BASELINE_CKPT step (``resumed``, each rank's) bitwise the
    uninterrupted ranks' round. One line per algorithm, with its launches
    summed over the ranks. Returns the path's launches (the ranks' and the
    resumed spawn's)."""
    import gc

    import torch

    from neuroimagedisttraining_torch.ops import kernels

    failures = []
    launches = {k: 0 for k in kernels.snapshot_launches()}
    for name, _, _ in MESH_BASELINES:
        algo = _mesh_baseline_algo(name, data, hp, shape)
        state = algo.init_state()
        spread = []
        bound = MESH_GLOBAL_BOUND["dense"] if name == "ditto" else 0.0
        for r in range(MESH_BASELINE_ROUNDS):
            mine = [rk["baselines"][name]["rounds"][r] for rk in ranks]
            has_global = getattr(state, "global_params", None) is not None
            if r and has_global:  # the mesh's global model before the round
                state = dataclasses.replace(state, global_params={
                    k: v.to(dev) for k, v in ranks[0]["baselines"][name]
                    ["rounds"][r - 1]["global"].items()})
            state, met = algo.run_round(state, r)
            met = {k: float(v) for k, v in met.items()}
            rows = _row_digests(algo, state)
            ev_state = state
            if has_global:
                glob = mine[0]["global"]
                scale = max(float(v.abs().max()) for v in glob.values())
                err = max(float((glob[k] - state.global_params[k].cpu())
                                .abs().max()) for k in glob) / scale
                spread.append(err)
                if err > bound:
                    failures.append(f"(h) {name} r{r} global {err}")
                ev_state = dataclasses.replace(state, global_params={
                    k: v.to(dev) for k, v in glob.items()})
            ev = algo.evaluate(ev_state)
            for m in mine:
                if m["metrics"] != met:
                    failures.append(f"(h) {name} r{r} metrics "
                                    f"{m['metrics']} vs {met}")
                if any(dig != rows[c] for c, dig in m["rows"].items()):
                    failures.append(f"(h) {name} r{r} client rows")
                if m["global_digest"] != mine[0]["global_digest"]:
                    failures.append(f"(h) {name} r{r} ranks' globals")
                if any(not torch.equal(m["eval"][k], v.cpu())
                       for k, v in ev.items()):
                    failures.append(f"(h) {name} r{r} eval")
        path = {k: sum(rk["baselines"][name]["launches"][k] for rk in ranks)
                for k in launches}
        for k in launches:
            launches[k] += path[k]
        emit({"phase": "mesh_baselines", "algo": name, "ranks": MESH_RANKS,
              "backend": "gloo", "rounds": MESH_BASELINE_ROUNDS,
              "round_s": {rk["rank"]: [x["seconds"] for x in
                                       rk["baselines"][name]["rounds"]]
                          for rk in ranks},
              "secure_sum_s": {rk["rank"]: rk["baselines"][name]
                               ["secure_sum_s"] for rk in ranks},
              "metrics": [x["metrics"] for x in
                          ranks[0]["baselines"][name]["rounds"]],
              "global_rel_err": spread,
              "launches": {k: path[k] for k in MESH_BASELINE_KERNELS}})
        del algo, state, ev_state
        gc.collect()
        torch.cuda.empty_cache()
    # (j): the fresh spawn resumed the baseline's step
    want = [rk["baselines"][MESH_BASELINE_CKPT]["rounds"][1] for rk in ranks]
    ok = True
    for res, w in zip(resumed, want):
        got = res["baseline"]
        if got["step"] != 1 or got["metrics"] != w["metrics"] or \
                got["rows"] != w["rows"]:
            ok = False
            failures.append(f"(j) rank {res['rank']}: the resumed round is "
                            "not the uninterrupted one")
        for k in launches:
            launches[k] += got["launches"][k]
    emit({"phase": "mesh_baselines_ckpt", "algo": MESH_BASELINE_CKPT,
          "ranks": MESH_RANKS,
          "ckpt_save_s": [rk["baselines"][MESH_BASELINE_CKPT]["ckpt_save_s"]
                          for rk in ranks],
          "ckpt_restore_s": [r["baseline"]["restore_s"] for r in resumed],
          "resumed_bitwise": ok,
          "launches": {k: sum(r["baseline"]["launches"][k] for r in resumed)
                       for k in MESH_BASELINE_KERNELS}})
    if failures:
        raise AssertionError(f"mesh_baselines: {failures}")
    return launches


def _mesh_nccl_baselines(dev):
    """Part (i) of the mesh phase: a one-rank NCCL client mesh of the main
    configuration at full width, each of MESH_BASELINES_FUSED: a fused
    block of MESH_FUSED_ROUNDS rounds (the eval every round) bitwise the
    same rounds run eagerly on the mesh (``_fused_against_eager``) and the
    single-process algorithm's block from the same state; then the block
    once more with the mesh's collectives counted where Python calls them
    (none while it replays: the gathers of the gossip, of the losses and
    of the eval, and Ditto's reduce, run inside the graph); that block and
    the single-process block's replays are timed, and a replay's masked
    SGD launches are every trained client's steps. Returns the mesh
    algorithms' launches (init, eager, warm-ups and replays)."""
    import gc
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    launches = {k: 0 for k in kernels.snapshot_launches()}
    failures = []
    with tempfile.TemporaryDirectory() as d, \
            _CudnnFlags(deterministic=True, benchmark=False):
        mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                         init_method="file://" + os.path.join(d, "rdv"),
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            for name, _, _ in MESH_BASELINES_FUSED:
                algo = _mesh_baseline_algo(name, shard_federated(data, mesh),
                                           hp, shape)
                one = _mesh_baseline_algo(name, data, hp, shape)
                torch.cuda.synchronize()
                kernels.reset_launches()
                state = algo.init_state()
                torch.cuda.synchronize()
                init = kernels.snapshot_launches()
                rec, _ = _fused_against_eager(
                    "mesh_nccl_baselines", algo, state, MESH_FUSED_ROUNDS)
                s_one, _ = one.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                                eval_every=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()  # its replays, to time
                one.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                     eval_every=1)[1].materialize()
                torch.cuda.synchronize()
                one_s = time.perf_counter() - t0
                calls = {"all_gather": 0, "all_reduce": 0}

                def counted(what, fn):
                    def call(*args, **kwargs):
                        calls[what] += 1
                        return fn(*args, **kwargs)
                    return call

                for what in calls:
                    setattr(mesh, what, counted(what, getattr(mesh, what)))
                kernels.reset_launches()
                t0 = time.perf_counter()
                s_mesh, ys = algo.run_rounds_fused(
                    state, 0, MESH_FUSED_ROUNDS, eval_every=1)
                ys.materialize()
                torch.cuda.synchronize()
                replay_s = time.perf_counter() - t0
                replayed = kernels.snapshot_launches()
                for what in calls:
                    delattr(mesh, what)
                one_bitwise = all(
                    torch.equal(a[k], b[k])
                    for f, a in _tensor_trees(s_mesh).items()
                    for b in (_tensor_trees(s_one)[f],) for k in a)
                for k in launches:  # the branch count too
                    launches[k] += (init[k] + rec["launches_eager"][k]
                                    + rec["launches_fused"][k] + replayed[k])
                per = rec["launches_per_replay"]
                trained = (algo.clients_per_round
                           if name in ("local", "ditto") else N_CLIENTS)
                legs = 2 if name == "ditto" else 1
                want = {"masked_sgd": trained * STEPS * legs,
                        "masked_sgd_mask_grads": (
                            trained * STEPS if name.startswith("dispfl")
                            else 0)}
                emit({"phase": "mesh_nccl_baselines", "algo": name,
                      "backend": "nccl", **rec,
                      "single_process_bitwise": one_bitwise,
                      "collective_calls_in_block": dict(calls),
                      "block_s": replay_s,
                      "rounds_per_sec_fused": MESH_FUSED_ROUNDS / replay_s,
                      "rounds_per_sec_single_fused":
                      MESH_FUSED_ROUNDS / one_s,
                      "launches_block": {k: replayed[k]
                                         for k in MESH_BASELINE_KERNELS}})
                if not one_bitwise:
                    failures.append(f"{name}: the single-process block "
                                    "differs")
                if any(calls.values()):
                    failures.append(f"{name}: collectives called from "
                                    f"Python during the replays: {calls}")
                if any(per.get(k, 0) != n for k, n in want.items()) or \
                        (per.get("weighted_sum", 0) > 0) != (name == "ditto"):
                    failures.append(f"{name}: per replay {per}, want {want}")
                # NCCL keeps a communicator while a graph holding its
                # collectives lives
                algo.release_graphs()
                one.release_graphs()
                del algo, one, state, s_one, s_mesh, ys
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            mesh.destroy()
    if failures:
        raise AssertionError(f"mesh_nccl_baselines: {failures}")
    return launches


def _mesh_nccl(dev):
    """Part (b) of the mesh phase: a one-rank NCCL group, the wire reduces
    of ``parallel/collectives.py`` called directly on full-width payloads
    (the AlexNet's leaves in its leaf groups) on every wire, through the
    single-stage and the hierarchical spelling (one slice of one rank).
    This skips the D <= 1 gate that keeps the aggregate off a one-rank mesh
    on purpose: it is the collectives' own path that is under test. Each
    result equals the rank's own payload: bitwise on f32, its bf16 rounding
    on bf16, its int8 quantize and dequantize on int8. Then each reduce is
    captured in a CUDA graph (``base._Graph``: the warm-ups, then the
    capture, as a fused round takes them) over payload buffers and the int8
    wire's uniform buffers (``MeshUniformBuffers``), and replayed twice,
    each time after new payloads and a new round's uniforms were written
    into the buffers: each replay is bitwise the eager reduce of the same
    values (on int8, the eager reduce on the other round's uniforms is
    not). Eager and captured reduces are timed (CUDA events,
    NCCL_REPS)."""
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.algorithms.base import (
        MeshUniformBuffers,
        _Graph,
        mesh_wire_uniforms,
    )
    from neuroimagedisttraining_torch.convert import reference_leaf_order
    from neuroimagedisttraining_torch.models import create_model
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel import collectives as tc
    from neuroimagedisttraining_torch.parallel.mesh import make_mesh

    model = create_model("3dcnn_s2d", num_classes=1,
                         sample_shape=phased_sample_shape(VOLUME))
    params = dict(model.named_parameters())
    sizes = [params[k].numel() for k in reference_leaf_order(params)]
    groups = tc._leaf_groups(sizes, tc.DEFAULT_BUCKET_SIZE)
    g = torch.Generator(device=dev).manual_seed(17)

    def fresh():
        return [torch.randn(n, generator=g, device=dev) * 0.01
                for n in sizes]

    payload = fresh()

    def uniforms(wid, i, shape):
        ug = torch.Generator(device=dev).manual_seed(1000 * wid + i)
        return torch.rand(shape, generator=ug, device=dev)

    def want(wire):
        if wire == "f32":
            return payload
        if wire == "bf16":
            return [v.to(torch.bfloat16).to(torch.float32) for v in payload]
        out = []
        for i, v in enumerate(payload):
            q, s = tc._int8_leaf_payload(v, uniforms(
                0, i, tc.bucket_shape(v.numel())), tc.DEFAULT_BUCKET_SIZE)
            out.append((q.to(torch.float32) * s).reshape(-1)[:v.numel()])
        return out

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(NCCL_REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / NCCL_REPS

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    rec = {"phase": "mesh_nccl", "leaves": len(sizes),
           "values": sum(sizes), "groups": len(groups)}
    with tempfile.TemporaryDirectory() as d:
        mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                         init_method="file://" + os.path.join(d, "rdv"),
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            rec["backend"] = mesh.backend
            for spelling in ("wire", "hier"):
                for wire in ("f32", "bf16", "int8"):
                    def run(vals, u):
                        if spelling == "wire":
                            return tc._wire_reduce_groups(
                                vals, groups, mesh=mesh, wire=wire,
                                uniforms=u)
                        return tc._hier_reduce_groups(
                            vals, groups, mesh=mesh, wire=wire,
                            uniforms=u, n_devices=1, inner=1)

                    got = run(payload, uniforms)
                    torch.cuda.synchronize()
                    for i, (a, b) in enumerate(zip(got, want(wire))):
                        if not torch.equal(a, b):
                            raise AssertionError(
                                f"mesh_nccl {spelling} {wire}: leaf {i} is "
                                "not the rank's own payload")
                    rec[f"{spelling}_{wire}_ms"] = timed(
                        lambda: run(payload, uniforms))
                    # the captured reduce over buffers
                    bufs = [v.clone() for v in payload]
                    ub = MeshUniformBuffers()
                    ub.set_round(mesh_wire_uniforms(17, 0, dev))
                    graph = _Graph(lambda warm: run(bufs, ub), dev,
                                   f"mesh_nccl {spelling} {wire}")
                    for r in (1, 2):
                        for b, v in zip(bufs, fresh()):
                            b.copy_(v)
                        draw = mesh_wire_uniforms(17, r, dev)
                        ub.set_round(draw)
                        out = graph()
                        vals = [b.clone() for b in bufs]
                        if not same(out, run(vals, draw)):
                            raise AssertionError(
                                f"mesh_nccl {spelling} {wire}: replay {r} "
                                "is not the eager reduce of its buffers")
                        if wire == "int8" and same(out, run(
                                vals, mesh_wire_uniforms(17, 3 - r, dev))):
                            raise AssertionError(
                                f"mesh_nccl {spelling} int8: replay {r} "
                                "does not depend on its round's uniforms")
                    rec[f"{spelling}_{wire}_graph_ms"] = timed(graph)
                    graph.release()
        finally:
            mesh.destroy()
    emit(rec)


#: the rounds of part (a) of the mesh phase: a one-rank NCCL mesh's fused
#: block with the eval every round against the same rounds run eagerly
MESH_FUSED_ROUNDS = 2


def _mesh_nccl_fused(dev):
    """Part (a) of the mesh phase: a one-rank NCCL client mesh of the main
    configuration at full width (SalientGrads, SNIP, dense wire, the eval
    after every round). A fused block of MESH_FUSED_ROUNDS rounds is
    bitwise the same rounds run eagerly on the mesh (``_fused_against_
    eager``), its replays' launches counted; the same block of the
    single-process algorithm on the same state is bitwise it too (one rank
    holds every client, the gathers move nothing). Then the block once
    more with the mesh's collectives counted where Python calls them: none
    is called while the block replays, so the round's loss ``all_gather``
    and the eval's ``all_gather`` run inside the graphs. Rounds/s of the
    eager and fused mesh spellings and of the single-process fused block
    in interleaved pairs. Returns the path's launches: the mesh
    algorithm's alone (the single-process algorithm's are reported apart,
    ``launches_single_process``)."""
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    with tempfile.TemporaryDirectory() as d, \
            _CudnnFlags(deterministic=True, benchmark=False):
        mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                         init_method="file://" + os.path.join(d, "rdv"),
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            algo = _mesh_algo(shard_federated(data, mesh), hp, shape,
                              "dense")
            one = _mesh_algo(data, hp, shape, "dense")
            torch.cuda.synchronize()
            kernels.reset_launches()
            state = algo.init_state()
            torch.cuda.synchronize()
            snip = kernels.snapshot_launches()
            rec, launches = _fused_against_eager(
                "mesh_nccl_fused", algo, state, MESH_FUSED_ROUNDS)
            for k in launches:
                launches[k] += snip[k]
            kernels.reset_launches()
            s_mesh, _ = algo.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                              eval_every=1)
            torch.cuda.synchronize()
            blocks = kernels.snapshot_launches()
            # the single-process algorithm's launches are not the mesh's:
            # counted apart
            kernels.reset_launches()
            s_one, _ = one.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                            eval_every=1)
            torch.cuda.synchronize()
            single = kernels.snapshot_launches()
            calls = {"all_gather": 0, "all_reduce": 0}

            def counted(name, fn):
                def call(*args, **kwargs):
                    calls[name] += 1
                    return fn(*args, **kwargs)
                return call

            for name in calls:
                setattr(mesh, name, counted(name, getattr(mesh, name)))
            kernels.reset_launches()
            algo.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                  eval_every=1)[1].materialize()
            torch.cuda.synchronize()
            replayed = dict(kernels.LAUNCHES)
            block_calls = dict(calls)
            for name in calls:
                delattr(mesh, name)
            kernels.reset_launches()
            mesh_rates = _rates_in_pairs(algo, state, MESH_FUSED_ROUNDS)
            torch.cuda.synchronize()
            timing = kernels.snapshot_launches()
            kernels.reset_launches()
            one_rates = _rates_in_pairs(one, state, MESH_FUSED_ROUNDS)
            torch.cuda.synchronize()
            for k, n in kernels.snapshot_launches().items():
                single[k] += n
            for k in launches:
                launches[k] += blocks[k] + replayed[k] + timing[k]
            keys = list(algo._fused.rounds)
            # NCCL keeps a communicator while a graph holding its
            # collectives lives
            algo.release_graphs()
        finally:
            mesh.destroy()
    one_bitwise = all(torch.equal(a[k], b[k])
                      for f, a in _tensor_trees(s_mesh).items()
                      for b in (_tensor_trees(s_one)[f],) for k in a)
    per = {"masked_sgd": N_CLIENTS * STEPS, "weighted_sum": 1,
           "stem_fwd": N_CLIENTS * STEPS, "stem_bwd": N_CLIENTS * STEPS}
    evals = MESH_FUSED_ROUNDS * 2 * N_CLIENTS * _eval_chunks()
    want = {**{k: 0 for k in kernels.LAUNCHES},
            **{k: MESH_FUSED_ROUNDS * n for k, n in per.items()}}
    want["stem_fwd"] += evals
    out = {"phase": "mesh_nccl_fused", "backend": "nccl", **rec,
           "graphs": len(keys),
           "single_process_bitwise": one_bitwise,
           "collective_calls_in_block": block_calls,
           "launches_block": replayed,
           "rounds_per_sec_mesh_eager": mesh_rates["eager"],
           "rounds_per_sec_mesh_fused": mesh_rates["fused"],
           "rounds_per_sec_single_fused": one_rates["fused"],
           "launches_single_process": single,
           "launches": launches}
    emit(out)
    failures = []
    if not one_bitwise:
        failures.append("the single-process block differs")
    if any(block_calls.values()):
        failures.append(f"collectives called from Python during the "
                        f"replays: {block_calls}")
    if {k: rec["launches_per_replay"].get(k, 0) for k in per} != per:
        failures.append(f"per replay {rec['launches_per_replay']}, "
                        f"want {per}")
    if replayed != want:
        failures.append(f"block launches {replayed}, want {want}")
    if failures:
        raise AssertionError(f"mesh_nccl_fused: {failures}")
    return launches


def _mesh_robust_checks(dev, ranks, ck_dir, ck_dir_j, data, hp, shape,
                        state0):
    """Parts (e) and (g) of the mesh phase on this process's side. (e):
    each robust case's rounds of the two gloo ranks replayed here in one
    process, each round from the mesh's global model before it: the
    metrics (train loss and the guard's counters), every client's personal
    and top-k residual rows, the evals bitwise; the global model the same
    on both ranks, bitwise the replay's under ``robust_agg`` (every rank
    computes the statistic of the same gathered rows), else within
    MESH_GLOBAL_BOUND. (g): a fresh spawn of two gloo ranks restores the
    checkpoint the ranks wrote after round 0 of MESH_CKPT_CASE and runs
    round 1, bitwise the uninterrupted ranks' round 1; one process
    restores the same step and runs round 1: the rows and metrics bitwise,
    the global model within MESH_GLOBAL_BOUND. The spawn also resumes part
    (j)'s checkpoint from ``ck_dir_j`` (checked by
    :func:`_mesh_baseline_checks`). Returns the launches of (g) on the
    fresh spawn's ranks and the spawn's records."""
    import dataclasses
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    def rel_err(glob, params):
        scale = max(float(v.abs().max()) for v in glob.values())
        return max(float((glob[k] - params[k].cpu()).abs().max())
                   for k in glob) / scale

    failures, spread = [], {}
    cases = {c[0]: c for c in MESH_ROBUST_CASES}
    for name, case in cases.items():
        algo = _mesh_robust_algo(data, hp, shape, case)
        state = _mesh_robust_state(algo, case, state0)
        bound = 0.0 if case[3] != "none" else MESH_GLOBAL_BOUND["dense"]
        for r in range(MESH_ROBUST_ROUNDS):
            mine = [rk["robust"][name]["rounds"][r] for rk in ranks]
            if r:  # the mesh's global model before the round
                state = dataclasses.replace(state, global_params={
                    k: v.to(dev) for k, v in ranks[0]["robust"][name]
                    ["rounds"][r - 1]["global"].items()})
            state, met = algo.run_round(state, r)
            met = {k: float(v) for k, v in met.items()}
            rows = _row_digests(algo, state)
            glob = mine[0]["global"]
            spread[f"{name}_r{r}"] = err = rel_err(glob, state.global_params)
            if err > bound:
                failures.append(f"(e) {name} r{r} global {err}")
            ev = algo.evaluate(dataclasses.replace(state, global_params={
                k: v.to(dev) for k, v in glob.items()}))
            for m in mine:
                if m["metrics"] != met:
                    failures.append(f"(e) {name} r{r} metrics {m['metrics']}"
                                    f" vs {met}")
                if any(dig != rows[c] for c, dig in m["rows"].items()):
                    failures.append(f"(e) {name} r{r} client rows")
                if m["global_digest"] != mine[0]["global_digest"]:
                    failures.append(f"(e) {name} r{r} ranks' globals")
                if any(not torch.equal(m["eval"][k], v.cpu())
                       for k, v in ev.items()):
                    failures.append(f"(e) {name} r{r} eval")
        del algo, state
    # (g): a fresh spawn and one process resume the ranks' step
    case = cases[MESH_CKPT_CASE]
    want = [rk["robust"][MESH_CKPT_CASE]["rounds"][1] for rk in ranks]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_mesh_resume_rank, args=(d, dev, ck_dir, ck_dir_j),
                 nprocs=MESH_RANKS, join=True)
        resumed = [torch.load(f"{d}/resume{r}.pt", weights_only=False)
                   for r in range(MESH_RANKS)]
    resume_spawn_s = time.perf_counter() - t0
    for res, w in zip(resumed, want):
        if res["step"] != 1 or res["metrics"] != w["metrics"] or \
                res["rows"] != w["rows"] or \
                res["global_digest"] != w["global_digest"]:
            failures.append(f"(g) rank {res['rank']}: the resumed round is "
                            "not the uninterrupted one")
    algo = _mesh_robust_algo(data, hp, shape, case)
    t0 = time.perf_counter()
    st, step = CheckpointManager(ck_dir).restore_latest(algo.init_state())
    torch.cuda.synchronize()
    one_restore_s = time.perf_counter() - t0
    st, met = algo.run_round(st, step)
    rows = _row_digests(algo, st)
    one_err = rel_err(ranks[0]["robust"][MESH_CKPT_CASE]["rounds"][1]
                      ["global"], st.global_params)
    if step != 1 or {k: float(v) for k, v in met.items()} != \
            want[0]["metrics"] or any(
                dig != rows[c] for w in want for c, dig in w["rows"].items()):
        failures.append("(g) one process: the resumed round's rows or "
                        "metrics differ from the mesh's")
    if one_err > MESH_GLOBAL_BOUND["dense"]:
        failures.append(f"(g) one process: global {one_err}")
    launches = {k: sum(r["launches"][k] for r in resumed)
                for k in kernels.LAUNCHES}
    emit({"phase": "mesh_robust", "ranks": MESH_RANKS, "backend": "gloo",
          "cases": [c[0] for c in MESH_ROBUST_CASES],
          "rounds": MESH_ROBUST_ROUNDS,
          "round_s": {r["rank"]: {n: r["robust"][n]["seconds"]
                                  / MESH_ROBUST_ROUNDS for n in cases}
                      for r in ranks},
          "metrics": {n: [x["metrics"] for x in
                          ranks[0]["robust"][n]["rounds"]] for n in cases},
          "global_rel_err": spread,
          "ckpt_case": MESH_CKPT_CASE,
          "ckpt_save_s": [r["ckpt_save_s"] for r in ranks],
          "ckpt_save_failures": [r["ckpt_save_failures"] for r in ranks],
          "ckpt_restore_s_mesh": [r["restore_s"] for r in resumed],
          "ckpt_restore_s_one_process": one_restore_s,
          "resume_spawn_s": resume_spawn_s,
          "resumed_bitwise": not any(f.startswith("(g) rank")
                                     for f in failures),
          "one_process_global_rel_err": one_err,
          "launches_resumed": launches})
    if failures:
        raise AssertionError(f"mesh_robust: {failures}")
    return launches, resumed


def _mesh_nccl_robust(dev):
    """Part (f) of the mesh phase: a one-rank NCCL client mesh of the main
    configuration at full width, each of MESH_ROBUST_CASES: a fused block
    of MESH_FUSED_ROUNDS rounds (the eval every round) bitwise the same
    rounds run eagerly on the mesh (``_fused_against_eager``) and the
    single-process algorithm's block from the same state; then the block
    once more with the mesh's collectives counted where Python calls them:
    none while it replays, so the flag gather, the gathered deltas (or the
    loss and the reduce) run inside the graph; that block and the
    single-process block's replays are timed. Returns the mesh
    algorithms' launches (SNIP, eager, warm-ups and replays)."""
    import gc
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    launches = {k: 0 for k in kernels.LAUNCHES}
    failures = []
    with tempfile.TemporaryDirectory() as d, \
            _CudnnFlags(deterministic=True, benchmark=False):
        mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                         init_method="file://" + os.path.join(d, "rdv"),
                         timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
        try:
            snip = None
            for case in MESH_ROBUST_CASES:
                algo = _mesh_robust_algo(shard_federated(data, mesh), hp,
                                         shape, case)
                one = _mesh_robust_algo(data, hp, shape, case)
                torch.cuda.synchronize()
                kernels.reset_launches()
                if snip is None and case[1] == "salientgrads":
                    snip = algo.init_state()
                state = _mesh_robust_state(algo, case, snip)
                torch.cuda.synchronize()
                init = kernels.snapshot_launches()
                rec, both = _fused_against_eager(
                    "mesh_nccl_robust", algo, state, MESH_FUSED_ROUNDS)
                s_one, _ = one.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                                eval_every=1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()  # its replays, to time
                one.run_rounds_fused(state, 0, MESH_FUSED_ROUNDS,
                                     eval_every=1)[1].materialize()
                torch.cuda.synchronize()
                one_s = time.perf_counter() - t0
                calls = {"all_gather": 0, "all_reduce": 0}

                def counted(name, fn):
                    def call(*args, **kwargs):
                        calls[name] += 1
                        return fn(*args, **kwargs)
                    return call

                for name in calls:
                    setattr(mesh, name, counted(name, getattr(mesh, name)))
                kernels.reset_launches()
                t0 = time.perf_counter()
                s_mesh, ys = algo.run_rounds_fused(
                    state, 0, MESH_FUSED_ROUNDS, eval_every=1)
                ys.materialize()
                torch.cuda.synchronize()
                replay_s = time.perf_counter() - t0
                replayed = kernels.snapshot_launches()
                for name in calls:
                    delattr(mesh, name)
                one_bitwise = all(
                    torch.equal(a[k], b[k])
                    for f, a in _tensor_trees(s_mesh).items()
                    for b in (_tensor_trees(s_one)[f],) for k in a)
                for k in launches:
                    launches[k] += init[k] + both[k] + replayed[k]
                remask = case[1] == "salientgrads" and (
                    case[4] is not None or case[2] == "topk")
                per = rec["launches_per_replay"]
                emit({"phase": "mesh_nccl_robust", "case": case[0],
                      "backend": "nccl", **rec,
                      "single_process_bitwise": one_bitwise,
                      "collective_calls_in_block": dict(calls),
                      "block_s": replay_s,
                      "rounds_per_sec_fused": MESH_FUSED_ROUNDS / replay_s,
                      "rounds_per_sec_single_fused":
                      MESH_FUSED_ROUNDS / one_s,
                      "launches_block": replayed})
                if not one_bitwise:
                    failures.append(f"{case[0]}: the single-process block "
                                    "differs")
                if any(calls.values()):
                    failures.append(f"{case[0]}: collectives called from "
                                    f"Python during the replays: {calls}")
                if per.get("mask_apply", 0) != (1 if remask else 0) or \
                        per.get("masked_sgd", 0) != N_CLIENTS * STEPS:
                    failures.append(f"{case[0]}: per replay {per}")
                # NCCL keeps a communicator while a graph holding its
                # collectives lives
                algo.release_graphs()
                one.release_graphs()
                del algo, one, state, s_one, s_mesh, ys
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            mesh.destroy()
    if failures:
        raise AssertionError(f"mesh_nccl_robust: {failures}")
    return launches


#: part (k) of the mesh phase, the client store on the mesh: the state
#: phase's population and disk store (STATE_CLIENTS at STATE_FRAC, S = 8 a
#: round, STATE_HOT hot rows a rank), each of MESH_STORE_CASES (name,
#: algorithm, agg_impl) for MESH_STORE_ROUNDS eager streamed rounds on the
#: two gloo ranks, MESH_STORE_CKPT checkpointed after its first round;
#: (k3) its fused store block of MESH_STORE_FUSED rounds on a one-rank NCCL
#: mesh; the kernels the path ``mesh/store`` must launch
MESH_STORE_CASES = (("salientgrads_topk", "salientgrads", "topk"),
                    ("fedavg", "fedavg", "dense"),
                    ("ditto", "ditto", "dense"))
MESH_STORE_ROUNDS, MESH_STORE_FUSED = 2, 3
MESH_STORE_CKPT = "salientgrads_topk"
MESH_STORE_KERNELS = ("masked_sgd", "stem_fwd", "stem_bwd", "threshold",
                      "score_mask", "weighted_sum", "mask_apply")


def _mesh_store_algo(name, data, hp, shape, store_dir, device=None):
    """A MESH_STORE_CASES entry on the state phase's configuration with
    its disk store under ``store_dir`` (``data`` sharded or not)."""
    from neuroimagedisttraining_torch.algorithms import (
        Ditto,
        FedAvg,
        SalientGrads,
    )
    from neuroimagedisttraining_torch.models import create_model

    _, algo_name, impl = {c[0]: c for c in MESH_STORE_CASES}[name]
    model = create_model("3dcnn_s2d", num_classes=1, sample_shape=shape)
    kw = dict(loss_type="bce", frac=STATE_FRAC, seed=0,
              compute_dtype="bfloat16", agg_impl=impl,
              agg_topk_density=TOPK_DENSITY, client_store="disk",
              store_hot_clients=STATE_HOT, store_dir=store_dir,
              device=device)
    if algo_name == "salientgrads":
        return SalientGrads(model, data, hp, dense_ratio=0.5,
                            itersnip_iterations=1, **kw)
    if algo_name == "ditto":
        return Ditto(model, data, hp, **kw)
    return FedAvg(model, data, hp, **kw)


def _store_digests(algo):
    """Per client the algorithm's store holds (population id: a mesh
    rank's block, every client off the mesh), the digests of its stored
    rows field by field, read one row at a time on the host (staged rows
    committed first)."""
    algo.store_flush()
    store = algo._store
    out = {c: [] for c in range(store.lo, store.hi)}
    for f in store.field_names():
        for c in out:
            row = store.gather(f, [c])
            out[c].append(_tree_digest({k: v[0] for k, v in row.items()}))
    return {c: tuple(v) for c, v in out.items()}


def _mesh_store_rank(rank, directory, dev, ck_dir):
    """Part (k1)'s gloo ranks on the card: the state phase's population,
    each rank keeping its block on the host, each of MESH_STORE_CASES for
    MESH_STORE_ROUNDS eager streamed rounds (each timed, its store gather
    ms, its metrics, every stored row's digest, the global model, the eval
    after it), MESH_STORE_CKPT checkpointed into ``ck_dir`` after its first
    round (every rank saving, rank 0 writing; part (k2)); the launches and
    the peak. Leaves its record in ``directory``."""
    import os

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    dev = torch.device("cuda", dev.index or 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(MESH_RANKS, backend="gloo", rank=rank, device=dev,
                     init_method="file://" + os.path.join(directory,
                                                          "rdv_store"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        shape = phased_sample_shape(VOLUME)
        hp = _main_hp()
        data = shard_federated(_state_population(dev, shape), mesh,
                               host=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        rec = {"rank": rank, "block": list(mesh.block(STATE_CLIENTS)),
               "algos": {}}
        for name, _, _ in MESH_STORE_CASES:
            algo = _mesh_store_algo(name, data, hp, shape, os.path.join(
                directory, f"store_{name}"))
            ck = (CheckpointManager(ck_dir, layout=algo)
                  if name == MESH_STORE_CKPT else None)
            t0 = time.perf_counter()
            state = algo.init_state()
            torch.cuda.synchronize()
            out = {"init_s": time.perf_counter() - t0, "rounds": []}
            for r in range(MESH_STORE_ROUNDS):
                g0 = algo._store.gather_ms
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = algo.run_round(state, r)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                gather_ms = algo._store.gather_ms - g0
                ev = algo.evaluate(state)
                out["rounds"].append({
                    "seconds": seconds, "store_gather_ms": gather_ms,
                    "metrics": {k: float(v) for k, v in met.items()},
                    "eval": {k: float(v) for k, v in ev.items()
                             if not k.startswith("acc_per")},
                    "rows": _store_digests(algo),
                    "global_digest": _tree_digest(state.global_params),
                    "global": ({k: v.cpu() for k, v in
                                state.global_params.items()}
                               if rank == 0 else None)})
                if ck is not None and r == 0:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ck.save(1, state, store=algo._store)
                    out["ckpt_save_s"] = time.perf_counter() - t0
                    out["ckpt_save_failures"] = ck.save_failures
            out["stats"] = algo._store.stats()
            rec["algos"][name] = out
            del algo, state
        torch.cuda.synchronize()
        rec["launches"] = dict(kernels.LAUNCHES)
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.save(rec, os.path.join(directory, f"store_rank{rank}.pt"))
    finally:
        mesh.destroy()


def _mesh_store_resume_rank(rank, directory, dev, ck_dir):
    """Part (k2)'s fresh spawn: the ranks restore MESH_STORE_CKPT's step
    (the state and each rank's block of the store's rows) and run the
    round after it; each leaves its record (the restore's seconds, the
    round's metrics, digests and launches) in ``directory``."""
    import os

    import torch

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    dev = torch.device("cuda", dev.index or 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = make_mesh(MESH_RANKS, backend="gloo", rank=rank, device=dev,
                     init_method="file://" + os.path.join(directory,
                                                          "rdv_store2"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        shape = phased_sample_shape(VOLUME)
        data = shard_federated(_state_population(dev, shape), mesh,
                               host=True)
        algo = _mesh_store_algo(MESH_STORE_CKPT, data, _main_hp(), shape,
                                os.path.join(directory, "store_resumed"))
        kernels.reset_launches()
        template = algo.init_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, step = CheckpointManager(ck_dir, layout=algo).restore_latest(
            template, store=algo._store)
        torch.cuda.synchronize()
        rec = {"rank": rank, "step": step,
               "restore_s": time.perf_counter() - t0}
        state, met = algo.run_round(state, step)
        torch.cuda.synchronize()
        rec.update(metrics={k: float(v) for k, v in met.items()},
                   rows=_store_digests(algo),
                   global_digest=_tree_digest(state.global_params),
                   launches=dict(kernels.LAUNCHES))
        torch.save(rec, os.path.join(directory, f"store_resume{rank}.pt"))
    finally:
        mesh.destroy()


def _launch_delta(fn):
    """``fn()``'s result and the kernel launches it made (the card
    synchronised after it)."""
    import torch

    from neuroimagedisttraining_torch.ops import kernels

    before = kernels.snapshot_launches()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.snapshot_launches()
    return out, {k: after[k] - n for k, n in before.items()}


def _mesh_nccl_store(dev, host, hp, shape, directory):
    """Part (k3): MESH_STORE_CKPT on a one-rank NCCL mesh over the state
    phase's population (its block, the whole of it, on the host): a fused
    store block of MESH_STORE_FUSED rounds bitwise the same rounds run
    eagerly on the mesh (metrics, global model, every stored row) and the
    single-process streamed block; the block once more from a fresh state
    (its graph captured) with the mesh's collectives counted where Python
    calls them (none: the replays hold them); the captures and evictions;
    the mesh's and the single process's fused rounds/s in interleaved
    pairs on rounds no block ran. Returns the record and the mesh
    algorithms' launches."""
    import os

    import torch

    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )

    k = MESH_STORE_FUSED
    launches = {}

    def mesh_run(fn):
        out, delta = _launch_delta(fn)
        for name, n in delta.items():
            launches[name] = launches.get(name, 0) + n
        return out

    mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                     init_method="file://" + os.path.join(directory,
                                                          "rdv_nccl_store"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        data = shard_federated(host, mesh, host=True)

        def make(tag, d, device=None):
            return _mesh_store_algo(MESH_STORE_CKPT, d, hp, shape,
                                    os.path.join(directory, tag), device)

        def eager():
            a = make("k3_eager", data)
            s, mets = a.init_state(), []
            for r in range(k):
                s, met = a.run_round(s, r)
                mets.append({n: float(v) for n, v in met.items()})
            return mets, _tree_digest(s.global_params), _store_digests(a)

        e_mets, e_glob, e_rows = mesh_run(eager)
        f = make("k3_fused", data)
        f_state = mesh_run(f.init_state)
        t0 = time.perf_counter()
        f_state, ys = mesh_run(lambda: f.run_rounds_fused(f_state, 0, k))
        ys = ys.materialize()
        first_block_s = time.perf_counter() - t0
        captures = f._fused.evicted + len(f._fused.rounds)

        def same(ys, glob, rows):
            return (all([float(x) for x in ys[n]] == [m[n] for m in e_mets]
                        for n in ys) and glob == e_glob and rows == e_rows)

        fused_bitwise = same(ys, _tree_digest(f_state.global_params),
                             _store_digests(f))
        one = make("k3_one", host, dev)
        (o_state, o_ys), single = _launch_delta(
            lambda: one.run_rounds_fused(one.init_state(), 0, k))
        one_bitwise = same(o_ys.materialize(),
                           _tree_digest(o_state.global_params),
                           _store_digests(one))
        calls = {"all_gather": 0, "all_reduce": 0}

        def counted(name, fn):
            def call(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return call

        s2 = mesh_run(f.init_state)  # the store starts over
        for name in calls:
            setattr(mesh, name, counted(name, getattr(mesh, name)))
        s2, ys2 = mesh_run(lambda: f.run_rounds_fused(s2, 0, k))
        block_calls = dict(calls)
        for name in calls:
            delattr(mesh, name)
        again_bitwise = same(ys2.materialize(), _tree_digest(
            s2.global_params), _store_digests(f))
        rates = {"mesh": [], "single": []}
        for who in ("mesh", "single", "single", "mesh"):
            algo, st = (f, f_state) if who == "mesh" else (one, o_state)
            t0 = time.perf_counter()
            run = (lambda a=algo, s=st: a.run_rounds_fused(s, k, k)[1]
                   .materialize())
            if who == "mesh":
                mesh_run(run)
            else:
                _launch_delta(run)
            rates[who].append(k / (time.perf_counter() - t0))
        captures_total = f._fused.evicted + len(f._fused.rounds)
        evicted = f._fused.evicted
        f.release_graphs()
        one.release_graphs()
    finally:
        mesh.destroy()
    rec = {"phase": "mesh_store_nccl", "backend": "nccl", "rounds": k,
           "fused_bitwise_eager": fused_bitwise,
           "single_process_bitwise": one_bitwise,
           "second_block_bitwise": again_bitwise,
           "collective_calls_in_block": block_calls,
           "captures_first_block": captures,
           "captures_total": captures_total, "evictions": evicted,
           "first_block_s": first_block_s,
           "rounds_per_sec_mesh_fused": rates["mesh"],
           "rounds_per_sec_single_fused": rates["single"],
           "launches_single_process": single}
    failures = [n for n in ("fused_bitwise_eager", "single_process_bitwise",
                            "second_block_bitwise") if not rec[n]]
    if any(block_calls.values()):
        failures.append(f"collectives called from Python during the "
                        f"replays: {block_calls}")
    return rec, launches, failures


def _mesh_store(dev):
    """Part (k), the client store on the mesh (the path ``mesh/store``):

    * (k1) two gloo ranks sharing the card (``_mesh_store_rank``), each
      holding its block of the state phase's population on the host and
      its block's rows in a disk store: SalientGrads on the top-k wire
      (both row fields stream), FedAvg dense, then Ditto, each
      MESH_STORE_ROUNDS eager streamed rounds. A single process replays
      them in this call from the mesh's global model before each round
      (its store reaching the same rows): every stored row, every metric
      and every eval bitwise, the global model within 1e-6 of its scale.
      Each rank's round seconds, store gather ms a round and peak.
    * (k2) MESH_STORE_CKPT's step written by the ranks after its first
      round, resumed by a fresh two-rank spawn (the next round bitwise the
      uninterrupted one: metrics, rows, global model) and by one process
      (metrics and rows bitwise, the global model within 1e-6): the save's
      and the restores' seconds, the sidecar's bytes.
    * (k3) ``_mesh_nccl_store``.

    Returns the path's launches: the ranks', the fresh spawn's and the
    one-rank mesh's algorithms' (not the single-process replays')."""
    import dataclasses
    import gc
    import os
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.utils.checkpoint import \
        CheckpointManager

    gc.collect()
    torch.cuda.empty_cache()
    shape = phased_sample_shape(VOLUME)
    hp = _main_hp()
    failures, spread = [], {}
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "ck")
        t0 = time.perf_counter()
        mp.spawn(_mesh_store_rank, args=(d, dev, ck), nprocs=MESH_RANKS,
                 join=True)
        ranks = [torch.load(os.path.join(d, f"store_rank{r}.pt"),
                            weights_only=False) for r in range(MESH_RANKS)]
        k1_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mp.spawn(_mesh_store_resume_rank, args=(d, dev, ck),
                 nprocs=MESH_RANKS, join=True)
        resumed = [torch.load(os.path.join(d, f"store_resume{r}.pt"),
                              weights_only=False)
                   for r in range(MESH_RANKS)]
        k2_s = time.perf_counter() - t0
        sidecar = os.path.join(ck, "run", "store_1.npz")
        sidecar_bytes = os.path.getsize(sidecar)
        host = _state_population(dev, shape)
        with _CudnnFlags(deterministic=True, benchmark=False):
            for name, _, _ in MESH_STORE_CASES:
                algo = _mesh_store_algo(name, host, hp, shape,
                                        os.path.join(d, f"one_{name}"), dev)
                state = algo.init_state()
                for r in range(MESH_STORE_ROUNDS):
                    mine = [rk["algos"][name]["rounds"][r] for rk in ranks]
                    if r:  # the mesh's global model before the round
                        state = dataclasses.replace(state, global_params={
                            n: v.to(dev) for n, v in ranks[0]["algos"][name]
                            ["rounds"][r - 1]["global"].items()})
                    state, met = algo.run_round(state, r)
                    met = {n: float(v) for n, v in met.items()}
                    rows = _store_digests(algo)
                    glob = mine[0]["global"]
                    for m in mine:
                        if m["metrics"] != met:
                            failures.append(f"{name} r{r} metrics")
                        if any(dig != rows[c] for c, dig in m["rows"].items()):
                            failures.append(f"{name} r{r} rows")
                        if m["global_digest"] != mine[0]["global_digest"]:
                            failures.append(f"{name} r{r} ranks' globals")
                    scale = max(float(v.abs().max()) for v in glob.values())
                    err = max(float((glob[n] - state.global_params[n].cpu())
                                    .abs().max()) for n in glob) / scale
                    spread[f"{name}_r{r}"] = err
                    if err > 1e-6:
                        failures.append(f"{name} r{r} global {err}")
                    ev = algo.evaluate(dataclasses.replace(
                        state, global_params={n: v.to(dev) for n, v in
                                              glob.items()}))
                    ev = {n: float(v) for n, v in ev.items()
                          if not n.startswith("acc_per")}
                    if any(m["eval"] != ev for m in mine):
                        failures.append(f"{name} r{r} eval")
                del algo, state
            # (k2): the uninterrupted round 1 against both resumes
            want = [rk["algos"][MESH_STORE_CKPT]["rounds"][1] for rk in ranks]
            for rk, w in zip(resumed, want):
                if (rk["step"], rk["metrics"], rk["rows"],
                        rk["global_digest"]) != (1, w["metrics"], w["rows"],
                                                 w["global_digest"]):
                    failures.append(f"resumed rank {rk['rank']}")
            one = _mesh_store_algo(MESH_STORE_CKPT, host, hp, shape,
                                   os.path.join(d, "one_resumed"), dev)
            template = one.init_state()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, step = CheckpointManager(ck).restore_latest(
                template, store=one._store)
            torch.cuda.synchronize()
            one_restore_s = time.perf_counter() - t0
            state, met = one.run_round(state, step)
            rows = _store_digests(one)
            glob = want[0]["global"]
            one_err = max(float((glob[n] - state.global_params[n].cpu())
                                .abs().max()) for n in glob) / max(
                float(v.abs().max()) for v in glob.values())
            if (step != 1 or {n: float(v) for n, v in met.items()}
                    != want[0]["metrics"] or one_err > 1e-6
                    or any(dig != rows[c] for w in want
                           for c, dig in w["rows"].items())):
                failures.append(f"one-process resume (step {step}, global "
                                f"{one_err})")
            del one, state
            k3, k3_launches, k3_failures = _mesh_nccl_store(dev, host, hp,
                                                            shape, d)
            failures += k3_failures
        del host
    gc.collect()
    torch.cuda.empty_cache()
    launches = {n: sum(r["launches"][n] for r in ranks)
                + sum(r["launches"][n] for r in resumed)
                + k3_launches.get(n, 0) for n in kernels.LAUNCHES}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    emit({"phase": "mesh_store", "part": "k1", "card": card,
          "ranks": MESH_RANKS, "backend": "gloo", "clients": STATE_CLIENTS,
          "frac": STATE_FRAC, "hot_clients": STATE_HOT,
          "rounds": MESH_STORE_ROUNDS,
          "blocks": [r["block"] for r in ranks], "spawn_s": k1_s,
          "init_s": {n: [r["algos"][n]["init_s"] for r in ranks]
                     for n, _, _ in MESH_STORE_CASES},
          "round_s": {n: [[x["seconds"] for x in r["algos"][n]["rounds"]]
                          for r in ranks] for n, _, _ in MESH_STORE_CASES},
          "store_gather_ms": {
              n: [[x["store_gather_ms"] for x in r["algos"][n]["rounds"]]
                  for r in ranks] for n, _, _ in MESH_STORE_CASES},
          "store_stats": {n: [r["algos"][n]["stats"] for r in ranks]
                          for n, _, _ in MESH_STORE_CASES},
          "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
          "global_rel_err": spread})
    emit({"phase": "mesh_store", "part": "k2", "card": card,
          "save_s": ranks[0]["algos"][MESH_STORE_CKPT]["ckpt_save_s"],
          "save_failures": [r["algos"][MESH_STORE_CKPT]["ckpt_save_failures"]
                            for r in ranks],
          "sidecar_bytes": sidecar_bytes, "spawn_s": k2_s,
          "restore_s_ranks": [r["restore_s"] for r in resumed],
          "restore_s_one_process": one_restore_s,
          "one_process_global_rel_err": one_err})
    emit({**k3, "card": card})
    emit({"phase": "mesh_store", "part": "launches", "launches": launches})
    idle = [n for n in MESH_STORE_KERNELS if launches[n] <= 0]
    if idle:
        failures.append(f"never launched: {idle}")
    if failures:
        raise AssertionError(f"mesh/store: {failures}")
    return launches


def mesh_path(dev):
    """The client mesh (``parallel/mesh.py``) on the card:

    * two gloo ranks sharing the one card (NCCL refuses two ranks on one
      GPU), each holding four clients of the main configuration at full
      width: SalientGrads on ``3dcnn_s2d``, SNIP, then MESH_ROUNDS rounds
      on each of MESH_WIRES from the SNIP state. A single process replays
      every round in the same call from the mesh's state before it (the
      generator in step), cuDNN deterministic on both sides: the mask,
      every client's trained model, the train losses, the evals and their
      per-client sums bitwise; the global model within MESH_GLOBAL_BOUND.
      Each rank's round seconds and peak memory are printed; the ranks'
      launches are the path's. Then (c) each gloo rank asks for a fused
      block, which must be refused with the ``ValueError`` that names
      NCCL (a gloo group's collectives cannot be captured).
    * (b) a one-rank NCCL group through the wire reduces, eager and
      captured in a CUDA graph (``_mesh_nccl``).
    * (a) a one-rank NCCL mesh's fused block, bitwise its eager rounds,
      its collectives inside the graphs (``_mesh_nccl_fused``, the path
      ``mesh/nccl_fused``).
    * ``runner.main --mesh_devices 2`` on the card: fitted to the one card,
      as the JAX CLI fits to the devices there are, and saying so.
    * (e)-(g), the robust and the state tiers on the mesh, the path
      ``mesh/robust``: the gloo ranks' robust cases and their checkpoint
      (``_mesh_rank``, ``_mesh_robust_checks``, ``_mesh_resume_rank``) and
      the one-rank NCCL mesh's robust fused blocks (``_mesh_nccl_robust``);
      ``mask_apply`` must launch on it.
    * (h)-(j), the seven other algorithms on the mesh, the path
      ``mesh/baselines``: the gloo ranks' rounds of each against a
      single-process replay and DisPFL's checkpoint resumed by the fresh
      spawn (``_mesh_baseline_rounds``, ``_mesh_baseline_checks``), the
      one-rank NCCL mesh's fused blocks of the four the CLI fuses
      (``_mesh_nccl_baselines``); each of MESH_BASELINE_KERNELS must
      launch on it.
    * (k), the client store on the mesh, the path ``mesh/store``
      (``_mesh_store``): the gloo ranks' streamed rounds of SalientGrads on
      the top-k wire, FedAvg and Ditto against a single-process replay, a
      store-backed checkpoint resumed by a fresh spawn and by one process,
      and a one-rank NCCL mesh's fused store block; each of
      MESH_STORE_KERNELS must launch on it.

    Part (d), ``bench_torch.main`` on one card with today's keys and
    ``client_mesh_devices`` 1, is checked in ``bench_path``. Returns the
    launches of the paths."""
    import dataclasses
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from neuroimagedisttraining_torch.convert import reference_leaf_order
    from neuroimagedisttraining_torch.experiments import runner
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.parallel import collectives as tc

    t0 = time.perf_counter()
    # parts (g)'s and (j)'s checkpoint lineages, written by the ranks, read
    # after them
    ck_tmp = tempfile.TemporaryDirectory()
    ck_tmp_j = tempfile.TemporaryDirectory()
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_mesh_rank, args=(d, dev, ck_tmp.name, ck_tmp_j.name),
                 nprocs=MESH_RANKS, join=True)
        ranks = [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                 for r in range(MESH_RANKS)]
    mesh_s = time.perf_counter() - t0

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    failures = []
    with _CudnnFlags(deterministic=True, benchmark=False):
        base = _mesh_algo(data, hp, shape, "dense")
        state0 = base.init_state()
        if any(r["mask"] != _tree_digest(state0.mask) for r in ranks):
            failures.append("mask")
        spread = {}
        for impl in MESH_WIRES:
            algo = _mesh_algo(data, hp, shape, impl)
            state = algo.clone_state(state0)
            for r in range(MESH_ROUNDS):
                mine = [rk["wires"][impl][r] for rk in ranks]
                if r:  # the mesh's global model before the round
                    state = dataclasses.replace(state, global_params={
                        k: v.to(dev) for k, v in
                        ranks[0]["wires"][impl][r - 1]["global"].items()})
                state, met = algo.run_round(state, r)
                for m in mine:
                    for c, dig in m["clients"].items():
                        if dig != _tree_digest({k: v[c] for k, v in
                                                state.personal_params
                                                .items()}):
                            failures.append(f"{impl} r{r} client {c}")
                    if m["train_loss"] != float(met["train_loss"]):
                        failures.append(f"{impl} r{r} train_loss")
                    if m["global_digest"] != mine[0]["global_digest"]:
                        failures.append(f"{impl} r{r} ranks' globals")
                glob = mine[0]["global"]
                scale = max(float(v.abs().max()) for v in glob.values())
                err = max(float((glob[k] - state.global_params[k].cpu())
                                .abs().max()) for k in glob) / scale
                spread[f"{impl}_r{r}"] = err
                if err > MESH_GLOBAL_BOUND[impl]:
                    failures.append(f"{impl} r{r} global {err}")
                mesh_state = dataclasses.replace(state, global_params={
                    k: v.to(dev) for k, v in glob.items()})
                ev = algo.evaluate(mesh_state)
                correct, loss_sum = algo._eval_terms(
                    range(algo.num_clients),
                    lambda c: mesh_state.global_params)
                for m in mine:
                    if any(not torch.equal(m["eval"][k], v.cpu())
                           for k, v in ev.items()):
                        failures.append(f"{impl} r{r} eval")
                    if not (torch.equal(m["terms"][0], correct.cpu()) and
                            torch.equal(m["terms"][1], loss_sum.cpu())):
                        failures.append(f"{impl} r{r} eval sums")
    params = dict(base.model.named_parameters())
    groups = len(tc._leaf_groups(
        [params[k].numel() for k in reference_leaf_order(params)],
        tc.DEFAULT_BUCKET_SIZE))
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in kernels.LAUNCHES}
    refused = [r["fused_refused"] for r in ranks]
    if not all(m and "NCCL" in m for m in refused):
        failures.append(f"gloo fused block not refused: {refused}")
    per = N_CLIENTS // MESH_RANKS
    runs = len(MESH_WIRES) * MESH_ROUNDS
    steps = runs * per * STEPS
    evals = runs * per * (2 + 1) * _eval_chunks()  # evaluate, the sums
    # per rank: SNIP of its clients, its steps, its evals and each
    # algorithm's dropout probe (the SNIP one's and one per wire); the
    # reduce one weighted sum a leaf group
    probes = 1 + len(MESH_WIRES)
    want = {**{k: 0 for k in kernels.LAUNCHES},
            "masked_sgd": MESH_RANKS * steps,
            "threshold": MESH_RANKS, "score_mask": MESH_RANKS,
            "weighted_sum": MESH_RANKS * runs * groups,
            "stem_fwd": MESH_RANKS * (steps + per + evals + probes),
            "stem_bwd": MESH_RANKS * (steps + per)}
    if launches != want:
        failures.append(f"launches {launches}, want {want}")
    emit({"phase": "mesh", "ranks": MESH_RANKS, "backend": "gloo",
          "wires": list(MESH_WIRES), "rounds": MESH_ROUNDS,
          "blocks": [r["block"] for r in ranks], "mesh_s": mesh_s,
          "snip_s": [r["snip_s"] for r in ranks],
          "round_s": {r["rank"]: {impl: [x["seconds"]
                                         for x in r["wires"][impl]]
                                  for impl in MESH_WIRES} for r in ranks},
          "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks],
          "global_rel_err": spread, "leaf_groups": groups,
          "fused_refused": refused[0], "launches": launches})
    if failures:
        raise AssertionError(f"mesh: {failures}")

    # parts (e) and (g), then (f): the robust and the state tiers
    robust = {k: sum(r["launches_robust"][k] for r in ranks)
              for k in kernels.LAUNCHES}
    try:
        with _CudnnFlags(deterministic=True, benchmark=False):
            resumed, spawn = _mesh_robust_checks(
                dev, ranks, ck_tmp.name, ck_tmp_j.name, data, hp, shape,
                state0)
            del base, state0
            # parts (h) and (j): the seven other algorithms
            baselines = _mesh_baseline_checks(dev, ranks, spawn, data, hp,
                                              shape)
    finally:
        ck_tmp.cleanup()
        ck_tmp_j.cleanup()
    del data
    nccl_robust = _mesh_nccl_robust(dev)
    for k in robust:
        robust[k] += resumed[k] + nccl_robust[k]
    if robust["mask_apply"] <= 0:
        raise AssertionError(f"mesh/robust: mask_apply launched "
                             f"{robust['mask_apply']} times")
    nccl_baselines = _mesh_nccl_baselines(dev)
    for k in baselines:
        baselines[k] += nccl_baselines[k]
    idle = [k for k in MESH_BASELINE_KERNELS if baselines[k] <= 0]
    if idle:
        raise AssertionError(f"mesh/baselines: {idle} never launched "
                             f"({baselines})")

    _mesh_nccl(dev)
    fused_launches = _mesh_nccl_fused(dev)
    store = _mesh_store(dev)

    with _CudnnFlags(), tempfile.TemporaryDirectory() as tmp:
        res = runner.main(_cli_argv("salientgrads", tmp)
                          + ["--mesh_devices", "2"])
    fitted = res["client_mesh_devices"]
    emit({"phase": "mesh_cli", "mesh_devices": 2,
          "cards": torch.cuda.device_count(), "client_mesh_devices": fitted,
          "note": f"--mesh_devices 2 fitted to {fitted} device(s)"})
    if fitted != min(2, torch.cuda.device_count()):
        raise AssertionError(f"mesh_cli: fitted to {fitted} devices")
    return {"mesh": launches, "mesh/nccl_fused": fused_launches,
            "mesh/robust": robust,
            "mesh/baselines": {k: baselines[k] for k in kernels.LAUNCHES},
            "mesh/store": store}


#: the cifar phase: eager rounds (and the fused block of as many), 1 of
#: them, like the depth of the fused, evalcache and mesh (a) parts, cut
#: so the script keeps its time limit; (b)'s
#: cut of the configuration's depth, its widths and cohort kept: 1 local
#: epoch of its 5 (a round of 320 steps, not 1600: the eager rounds and
#: the block's warm-ups run at the Python loop's speed) and an eval of a
#: fixed subset of 10 clients (``eval_clients``; the configuration's
#: benchmark runs no eval); the batch and
#: tolerance of (c)'s one-step check of every 2D registry key, and (d)'s
#: CLI cohort (images per pickled train batch file and in the test file,
#: clients)
CIFAR_ROUNDS = 1
#: the cut: 1 local epoch of 16 steps (256 of a client's 500 images; the
#: round is 160 steps, a chain of 3 round graphs), the eval on 10 clients
CIFAR_CUT = dict(local_epochs=1, steps_per_epoch=16)
CIFAR_EVAL_CLIENTS = 10
CIFAR_STEP_BATCH, CIFAR_STEP_TOL = 2, 1e-4
#: (c)'s float32 gradient limits above CIFAR_STEP_TOL, per key, each about
#: 2.5x its reading (H100, TF32 off, cuDNN deterministic): with cuDNN on
#: (cnn_cifar10 1.2e-4, cnn_cifar10_meta 1.2e-4 and vgg11 3.7e-2 come from
#: cuDNN's convolution algorithms: 6.7e-7, 1.1e-6 and 1.8e-6 with cuDNN
#: off) and with cuDNN off (cnn_cifar100 2.1e-4 and resnet_ip 4.3e-3 with
#: cuDNN on or off; both within 5e-15 in float64)
CIFAR_GRAD_TOL_F32 = {"cnn_cifar10": 5e-4, "cnn_cifar10_meta": 5e-4,
                      "vgg11": 1e-1, "cnn_cifar100": 5e-4, "resnet_ip": 1e-2}
CIFAR_GRAD_TOL_F32_CUDNN_OFF = {"cnn_cifar100": 5e-4, "resnet_ip": 1e-2}
CIFAR_CLI_PER_BATCH, CIFAR_CLI_TEST, CIFAR_CLI_CLIENTS = 40, 60, 4


def cifar_kernels(dev, params, cfg):
    """(a) The four kernels of the ``cifar`` path at ResNet-18-GN's shapes,
    each bitwise its plain version and timed (median of 30 CUDA-event
    timings) with its bound and share: masked SGD over the 62 leaves, the
    threshold over the 11,164,352-entry SNIP row at k = dense_ratio * n,
    the score mask over the 21 kernel leaves, the weighted sum over a
    [clients a round, leaf] stack of every leaf."""
    import torch

    from neuroimagedisttraining_torch.core.state import weighted_sum
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.sparsity import kernel_flags
    from neuroimagedisttraining_torch.ops.topk_select import exact_threshold

    g = torch.Generator(device=dev).manual_seed(22)
    names = list(params)
    shapes = [tuple(params[k].shape) for k in names]
    flags = kernel_flags(params)
    kernel_names = [k for k in names if flags[k]]
    n_params = sum(math.prod(s) for s in shapes)
    s_clients = int(round(cfg["n_clients"] * cfg["frac"]))
    out = {}

    lr = torch.tensor(cfg["lr"] * cfg["lr_decay"] ** 2, device=dev)
    mom, wd = cfg["momentum"], cfg["weight_decay"]
    ps = [params[k].detach().clone() for k in names]
    ms = [torch.randn(s, generator=g, device=dev) for s in shapes]
    gs = [torch.randn(s, generator=g, device=dev) for s in shapes]
    ks = [(torch.rand(s, generator=g, device=dev) < cfg["dense_ratio"])
          .float() if flags[k] else torch.ones(s, device=dev)
          for k, s in zip(names, shapes)]
    want = [kernels.masked_sgd_plain(p, m, gg, k, lr, mom, wd, False)
            for p, m, gg, k in zip(ps, ms, gs, ks)]
    got_p = [p.clone() for p in ps]
    got_m = [m.clone() for m in ms]
    kernels.fused_masked_sgd_step(got_p, got_m, gs, ks, lr, momentum=mom,
                                  wd=wd)
    err = _bitwise_or_raise("cifar masked_sgd", got_p + got_m,
                            [a for a, _ in want] + [b for _, b in want])
    b_ms, b_by = bound(24.0 * n_params, 7.0 * n_params)
    out["masked_sgd"] = dict(
        max_abs_err=err, ms=device_ms(lambda: kernels.fused_masked_sgd_step(
            got_p, got_m, gs, ks, lr, momentum=mom, wd=wd)),
        plain_ms=device_ms(lambda: [kernels.masked_sgd_plain(
            p, m, gg, k, lr, mom, wd, False) for p, m, gg, k in zip(
                got_p, got_m, gs, ks)]),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{len(names)} leaves, {n_params} f32")

    scores = [torch.rand(tuple(params[k].shape), generator=g, device=dev)
              for k in kernel_names]
    n = sum(s.numel() for s in scores)
    k = max(1, int(n * cfg["dense_ratio"]))
    norm = torch.cat([s.reshape(-1) for s in scores]).sum()
    row = (torch.cat([s.reshape(-1) for s in scores]) / norm)[None]
    err = _bitwise_or_raise(
        "cifar threshold", [kernels.threshold_topk(row, k).view(torch.int32)],
        [exact_threshold(row, k).view(torch.int32)])
    b_ms, b_by = bound(4.0 * n + 4.0, THRESHOLD_PASSES * n)
    out["threshold"] = dict(
        max_abs_err=err, ms=device_ms(lambda: kernels.threshold_topk(row, k)),
        plain_ms=device_ms(lambda: exact_threshold(row, k), reps=20),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: torch.topk(row, k).values[..., -1],
                             reps=20),
        shape=f"[1, {n}] f32, k={k}")

    thr = exact_threshold(row, k).reshape(())
    got = kernels.fused_score_mask(scores, norm, thr)
    err = _bitwise_or_raise(
        "cifar score_mask", got,
        [kernels.score_mask_plain(s, norm, thr) for s in scores])
    b_ms, b_by = bound(8.0 * n + 8.0, 2.0 * n)
    out["score_mask"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: kernels.fused_score_mask(scores, norm, thr)),
        plain_ms=device_ms(lambda: [kernels.score_mask_plain(s, norm, thr)
                                    for s in scores]),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"{len(scores)} leaves, {n} f32")

    stacked = {k: params[k].detach()[None] + 0.01 * torch.randn(
        (s_clients,) + tuple(params[k].shape), generator=g, device=dev)
        for k in names}
    w = torch.rand(s_clients, generator=g, device=dev)
    w = w / w.sum()
    got = kernels.fused_weighted_sum(stacked, w)
    err = _bitwise_or_raise("cifar weighted_sum", [got[k] for k in names],
                            [weighted_sum(stacked[k], w) for k in names])
    flat = torch.cat([stacked[k].reshape(s_clients, -1) for k in names], 1)
    b_ms, b_by = bound(4.0 * (s_clients + 1) * n_params + 4.0 * s_clients,
                       2.0 * s_clients * n_params)
    out["weighted_sum"] = dict(
        max_abs_err=err,
        ms=device_ms(lambda: kernels.fused_weighted_sum(stacked, w)),
        plain_ms=device_ms(lambda: [weighted_sum(stacked[k], w)
                                    for k in names]),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=device_ms(lambda: torch.tensordot(w, flat, dims=1)),
        shape=f"[{s_clients}, leaf] x {len(names)} leaves, f32")
    for m in out.values():
        m["bound_share"] = m["bound_ms"] / m["ms"]
    return out


def _cifar_step_sample(key: str) -> tuple:
    """The per-sample shape (c) runs ``key`` at: the MNIST family's own,
    Tiny-ImageNet's for its ResNet, CIFAR's for the rest."""
    if key in ("cnn", "lenet5", "cnn_dropout"):
        return (28, 28, 1)
    return (64, 64, 3) if key == "tiny_resnet18" else (32, 32, 3)


def cifar_model_steps(dev):
    """(c) Every 2D registry key at its full size: one training step (CE
    over 10 classes, batch CIFAR_STEP_BATCH) on the card and on the CPU
    from the same parameters and input, cuDNN in the CLI's deterministic
    mode, TF32 off: the logits within CIFAR_STEP_TOL norm-wise in float32
    (with cuDNN on and off) and float64; the whole gradient (every leaf,
    concatenated) within CIFAR_STEP_TOL in float64 and in float32, with
    cuDNN on and off (PyTorch's own convolutions on the card), but for the
    keys whose float32 readings are held at CIFAR_GRAD_TOL_F32 and
    CIFAR_GRAD_TOL_F32_CUDNN_OFF. Then a bf16 step on the card, finite.
    ``original_resnet18`` runs on its running statistics
    (``apply_with_stats``), CNNDropOut on the same keep masks on both
    sides."""
    import torch
    import torch.nn.functional as F

    from neuroimagedisttraining_torch.models import (
        MODELS_2D,
        create_model,
        init_params,
        make_apply_fn,
    )

    def step(model, params, x, y, dtype=None, keep=None):
        leaves = {k: v.clone().requires_grad_(True) for k, v in
                  params.items()}
        if hasattr(model, "apply_with_stats"):
            stats = {k: v.to(x.device) for k, v in
                     model.init_batch_stats().items()}
            cast = ({k: v.to(dtype) for k, v in leaves.items()}
                    if dtype else leaves)
            logits, _ = model.apply_with_stats(
                cast, stats, x.to(dtype) if dtype else x, train=True)
            logits = logits.to(torch.promote_types(logits.dtype,
                                                   torch.float32))
        else:
            logits = make_apply_fn(model, dtype)(leaves, x, train=True,
                                                 rng=keep)
        loss = F.cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return logits.detach(), dict(zip(leaves, grads)), float(
            loss.detach())

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / max(float(torch.linalg.vector_norm(b.double())),
                           1e-30))

    def flat(grads, keys):
        return torch.cat([grads[k].cpu().reshape(-1) for k in keys])

    out = {}
    for i, key in enumerate(MODELS_2D):
        shape = _cifar_step_sample(key)
        g = torch.Generator().manual_seed(100 + i)
        cpu_model = create_model(key, num_classes=10, sample_shape=shape)
        params = init_params(cpu_model, g)
        x = torch.randn((CIFAR_STEP_BATCH,) + shape, generator=g)
        y = torch.randint(0, 10, (CIFAR_STEP_BATCH,), generator=g)
        keep = None
        if key == "cnn_dropout":
            keep = [torch.rand((CIFAR_STEP_BATCH, 12, 12, 64), generator=g)
                    < 0.75, torch.rand((CIFAR_STEP_BATCH, 128), generator=g)
                    < 0.5]
        model = create_model(key, num_classes=10, sample_shape=shape).to(dev)
        keep_on = None if keep is None else [m.to(dev) for m in keep]
        rec = {"params": sum(v.numel() for v in params.values()),
               "sample_shape": list(shape)}
        for tag, dt, cudnn in (("f32", torch.float32, True),
                               ("f32_cudnn_off", torch.float32, False),
                               ("f64", torch.float64, True)):
            p_cpu = {k: v.to(dt) for k, v in params.items()}
            want_logits, want_grads, _ = step(cpu_model, p_cpu, x.to(dt), y,
                                              keep=keep)
            with _CudnnFlags(deterministic=True, benchmark=False,
                             enabled=cudnn):
                logits, grads, loss = step(
                    model, {k: v.to(dev) for k, v in p_cpu.items()},
                    x.to(dt).to(dev), y.to(dev), keep=keep_on)
                torch.cuda.synchronize()
            keys = list(grads)
            rec.update({
                f"logits_rel_{tag}": rel(logits.cpu(), want_logits),
                f"grad_rel_{tag}": rel(flat(grads, keys),
                                       flat(want_grads, keys)),
                f"grad_rel_worst_leaf_{tag}": max(
                    (rel(grads[k].cpu(), want_grads[k]), k) for k in keys),
                f"loss_{tag}": loss})
        with _CudnnFlags(deterministic=True, benchmark=False):
            _, bgrads, bloss = step(
                model, {k: v.to(dev) for k, v in params.items()},
                x.to(dev), y.to(dev), dtype=torch.bfloat16, keep=keep_on)
        rec["bf16_loss"] = bloss
        rec["bf16_finite"] = math.isfinite(bloss) and all(
            bool(torch.isfinite(v).all()) for v in bgrads.values())
        out[key] = rec
        if not (all(rec[f"logits_rel_{t}"] <= CIFAR_STEP_TOL
                    for t in ("f32", "f32_cudnn_off", "f64"))
                and rec["grad_rel_f64"] <= CIFAR_STEP_TOL
                and rec["grad_rel_f32"] <= CIFAR_GRAD_TOL_F32.get(
                    key, CIFAR_STEP_TOL)
                and rec["grad_rel_f32_cudnn_off"]
                <= CIFAR_GRAD_TOL_F32_CUDNN_OFF.get(key, CIFAR_STEP_TOL)
                and rec["bf16_finite"]):
            emit({"phase": "cifar", "part": "c", "models": out})
            raise AssertionError(f"cifar (c) {key}: {rec}")
    return out


def _write_cifar_batches(root: str, seed: int = 0) -> None:
    """CIFAR-10's pickled batch layout under ``root/cifar-10-batches-py``:
    five train files of CIFAR_CLI_PER_BATCH random images and a test file
    of CIFAR_CLI_TEST, 3072 channel-planar bytes a row, labels 0..9."""
    import os
    import pickle

    import numpy as np

    rng = np.random.RandomState(seed)
    base = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(base)
    files = [(f"data_batch_{i}", CIFAR_CLI_PER_BATCH) for i in range(1, 6)]
    for name, n in files + [("test_batch", CIFAR_CLI_TEST)]:
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump({"data": rng.randint(0, 256, (n, 3072), np.uint8),
                         "labels": rng.randint(0, 10, n).tolist()}, f)


def cifar_cli(dev):
    """(d) ``runner.main`` twice with ``--dataset cifar10 --model
    cnn_cifar10`` on pickled CIFAR-layout batches this part writes, 2
    rounds of SalientGrads: the twins' histories, final evals and global
    parameters bitwise (the CLI's seeding puts cuDNN in its deterministic
    mode), the crop and flip wired, the parameters on the card. Returns
    the first run's launches."""
    import tempfile

    import torch

    from neuroimagedisttraining_torch.experiments import runner
    from neuroimagedisttraining_torch.ops import kernels

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        _write_cifar_batches(tmp)
        for twin in range(2):
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = runner.main([
                "--algo", "salientgrads", "--dataset", "cifar10",
                "--data_dir", tmp, "--model", "cnn_cifar10",
                "--client_num_in_total", str(CIFAR_CLI_CLIENTS),
                "--comm_round", "2", "--batch_size", "16",
                "--results_dir", f"{tmp}/results{twin}",
                "--log_dir", f"{tmp}/log{twin}"])
            torch.cuda.synchronize()
            runs.append((res, time.perf_counter() - t0,
                         dict(kernels.LAUNCHES)))
    (a, a_s, launches), (b, b_s, _) = runs

    def hist(res):
        return [{k: v for k, v in h.items() if k != "round_time_s"}
                for h in res["history"]]

    final = {k: float(v) for k, v in a["final_eval"].items()
             if getattr(v, "ndim", 0) == 0}
    same = hist(a) == hist(b) and all(
        torch.equal(v, b["state"].global_params[k])
        for k, v in a["state"].global_params.items()) and final == {
        k: float(v) for k, v in b["final_eval"].items()
        if getattr(v, "ndim", 0) == 0}
    on_card = all(v.is_cuda for v in a["state"].global_params.values())
    losses = [h["train_loss"] for h in a["history"] if h["round"] >= 0]
    rec = {"identity": a["identity"], "seconds": [a_s, b_s],
           "train_loss": losses, "final_eval": final, "twins_bitwise": same,
           "on_cuda": on_card, "launches": launches}
    if not (same and on_card and len(losses) == 2 and all(
            math.isfinite(v) for v in losses + list(final.values()))):
        emit({"phase": "cifar", "part": "d", **rec})
        raise AssertionError(f"cifar (d): {rec}")
    if not all(launches[k] > 0 for k in ("masked_sgd", "threshold",
                                         "score_mask", "weighted_sum")):
        raise AssertionError(f"cifar (d): launches {launches}")
    return rec


def cifar_path(dev):
    """The 2D image side at full width (``bench_torch.bench_config
    ("cifar")``: SalientGrads on ``resnet18``, 100 clients of 500 32x32x3
    bf16 images, batch 16, epochs of 32 steps, the crop and flip on every
    training and SNIP batch, 10 clients a round; here cut by CIFAR_CUT to 1
    epoch of 16 steps, the eval to CIFAR_EVAL_CLIENTS clients): (a) its four kernels at
    ResNet-18-GN's shapes (:func:`cifar_kernels`); (b) SNIP, CIFAR_ROUNDS
    eager rounds with the eval and the same rounds as one fused block from
    the same state, bitwise, cuDNN in the CLI's deterministic mode, the
    launches counted on path ``cifar`` (the counters zeroed just before
    the SNIP and read after the block); (c) every 2D registry key one step
    against the CPU (:func:`cifar_model_steps`); (d) the CLI twins
    (:func:`cifar_cli`). Returns the launches of paths ``cifar`` and
    ``cifar/cli``."""
    import gc

    import torch

    import bench_torch as b
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.ops import kernels

    cfg = dict(b.bench_config("cifar"), **CIFAR_CUT)
    t_phase = time.perf_counter()
    with _CudnnFlags(deterministic=True, benchmark=False):
        t0 = time.perf_counter()
        data = b.cifar_data(cfg, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        data_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        algo = b.cifar_algo(cfg, data, dev, eval_clients=CIFAR_EVAL_CLIENTS)
        measured = cifar_kernels(dev, algo._fresh_params(
            torch.Generator(device=dev).manual_seed(1), None),
            b.bench_config("cifar"))
        emit({"phase": "cifar", "part": "a", "kernels": measured})
        kernels.reset_launches()
        t0 = time.perf_counter()
        state = algo.init_state()
        torch.cuda.synchronize()
        snip_s = time.perf_counter() - t0
        snip = dict(kernels.LAUNCHES)
        rec, launches = _fused_against_eager("cifar", algo, state,
                                             CIFAR_ROUNDS)
        peak = torch.cuda.max_memory_allocated(dev)
        leaves = len(state.global_params)
        kernel_leaves = sum(k.endswith(".kernel")
                            for k in state.global_params)
        n_params = sum(v.numel() for v in state.global_params.values())
        density = float(algo.evaluate(state)["mask_density"])
        algo.release_graphs()
        del algo, state, data
        gc.collect()
        torch.cuda.empty_cache()
    for k in kernels.LAUNCHES:
        launches[k] += snip[k]
    eager_s = sum(rec["round_s"])
    emit({"phase": "cifar", "part": "b", "model": cfg["model_key"],
          "clients": cfg["n_clients"], "frac": cfg["frac"],
          "samples_per_client": cfg["samples_per_client"],
          "batch": cfg["batch"], "local_epochs": cfg["local_epochs"],
          "steps_per_epoch": cfg["steps_per_epoch"],
          "eval_clients": CIFAR_EVAL_CLIENTS,
          "compute_dtype": cfg["compute_dtype"], "augment": "crop_flip",
          "cudnn_deterministic": True, "leaves": leaves,
          "kernel_leaves": kernel_leaves, "params": n_params,
          "mask_density": density, "data_s": data_s, "snip_s": snip_s,
          "rounds_per_s_eager": CIFAR_ROUNDS / eager_s,
          "rounds_per_s_fused_first_block": (CIFAR_ROUNDS
                                             / rec["first_block_s"]),
          **rec, "launches_snip": snip, "launches": launches,
          "peak_mem_bytes": peak})
    if (leaves, kernel_leaves, n_params) != (62, 21, 11_173_962):
        raise AssertionError(f"cifar: {leaves} leaves, {kernel_leaves} "
                             f"kernels, {n_params} parameters")
    if abs(density - cfg["dense_ratio"]) > 1e-3:
        raise AssertionError(f"cifar: mask density {density}")
    per_table = -(-leaves // kernels.MAX_LEAVES)
    runs = 2 * CIFAR_ROUNDS + FUSED_WARMUPS
    steps = (int(round(cfg["n_clients"] * cfg["frac"]))
             * cfg["local_epochs"] * cfg["steps_per_epoch"])
    want = {**{k: 0 for k in kernels.LAUNCHES}, "threshold": 1,
            "score_mask": -(-kernel_leaves // kernels.MAX_LEAVES),
            "masked_sgd": per_table * steps * runs,
            "weighted_sum": per_table * runs}
    if launches != want:
        raise AssertionError(f"cifar: launches {launches}, want {want}")

    models = cifar_model_steps(dev)
    emit({"phase": "cifar", "part": "c", "models": models})
    with _CudnnFlags():
        cli = cifar_cli(dev)
    emit({"phase": "cifar", "part": "d", **cli,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"cifar": launches, "cifar/cli": cli["launches"]}, measured


def _cli_argv(algo: str, tmp: str):
    return ["--algo", algo, "--dataset", "synthetic", "--model", "small3dcnn",
            "--comm_round", "2", "--results_dir", f"{tmp}/results",
            "--log_dir", f"{tmp}/log"]


_CLI_FAULTS = ["--fault_spec", "drop=0.125,nan=0.125,scale=0.125:100x"]
#: the cli phase's runs: (path name, --algo, extra flags, the weighted-sum
#: launches of its 2 rounds: one an aggregate but where a robust statistic
#: replaces it; a fused run adds its graph's warm-ups)
CLI_RUNS = (
    ("salientgrads", "salientgrads", [], 2), ("fedavg", "fedavg", [], 2),
    ("salientgrads_fused", "salientgrads", ["--fuse_rounds", "2"], 2),
    ("salientgrads_replacement_remat", "salientgrads",
     ["--batching", "replacement", "--remat", "1"], 2),
    ("salientgrads_stratified_balanced", "salientgrads",
     ["--stratified_sampling", "1", "--stratified_mode", "balanced"], 2),
    ("salientgrads_stratified_exact", "salientgrads",
     ["--stratified_sampling", "1", "--batch_size", "50"], 2),
    ("salientgrads_faults_krum_weak_dp", "salientgrads",
     _CLI_FAULTS + ["--guard", "1", "--robust_agg", "krum",
                    "--defense_type", "weak_dp", "--watchdog", "1",
                    "--frac", "0.5"], 0),
    ("salientgrads_trimmed_mean_int8", "salientgrads",
     _CLI_FAULTS + ["--robust_agg", "trimmed_mean", "--agg_impl", "int8"],
     0),
    ("salientgrads_norm_krum_topk", "salientgrads",
     _CLI_FAULTS + ["--robust_agg", "norm_krum", "--agg_impl", "topk"], 0),
    ("fedavg_faults_median_clip", "fedavg",
     _CLI_FAULTS + ["--robust_agg", "median", "--defense_type",
                    "norm_diff_clipping", "--watchdog", "1"], 0),
    ("fedavg_multikrum", "fedavg", ["--robust_agg", "multikrum"], 0),
    # the personalized and decentralized baselines: Ditto's global leg
    # aggregates, the others have no central aggregate
    ("dispfl", "dispfl", [], 0), ("subavg", "subavg", [], 0),
    ("ditto", "ditto", [], 2), ("local", "local", [], 0),
    ("dpsgd", "dpsgd", [], 0), ("dispfl_static", "dispfl", ["--static"], 0),
    # their fused blocks (each history held to its unfused run's)
    ("ditto_fused", "ditto", ["--fuse_rounds", "2"], 2),
    ("local_fused", "local", ["--fuse_rounds", "2"], 0),
    ("dpsgd_fused", "dpsgd", ["--fuse_rounds", "2"], 0),
    ("dispfl_static_fused", "dispfl", ["--static", "--fuse_rounds", "2"], 0),
    # the last two algorithms, eager only
    ("fedfomo", "fedfomo", [], 0), ("turboaggregate", "turboaggregate", [],
                                     0),
)


def cli_path(dev):
    """The CLI's two main algorithms on the card, through the entry point a
    user calls, and SalientGrads again with ``--fuse_rounds 2`` (one fused
    block of both rounds), whose history must equal the unfused run's; then
    the training options (replacement batching, remat, both stratified SNIP
    modes), the robustness flags (faults, the guard, every ``--robust_agg``,
    both defenses, the watchdog), the five personalized and decentralized
    baselines, ``--fuse_rounds 2`` for ditto, local, dpsgd and ``dispfl
    --static`` (each history equal to its unfused run's), and FedFomo and
    TurboAggregate. Returns the launches per path."""
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.algorithms.base import (
        FUSED_WARMUPS,
        FedAlgorithm,
    )
    from neuroimagedisttraining_torch.experiments import runner
    from neuroimagedisttraining_torch.ops import kernels

    built = {}
    build_algorithm = runner.build_algorithm

    def capture(*args, **kwargs):
        built["algo"], built["data"] = build_algorithm(*args, **kwargs)
        return built["algo"], built["data"]

    out, histories = {}, {}
    runner.build_algorithm = capture
    try:
        for path, algo, extra, aggs in CLI_RUNS:
            with tempfile.TemporaryDirectory() as tmp:
                kernels.reset_launches()
                t0 = time.perf_counter()
                res = runner.main(_cli_argv(algo, tmp) + extra)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
                stat = res["stat_path"]
                wrote = (stat is not None and os.path.isfile(stat)
                         and os.path.isfile(stat + ".json"))
            data = built["data"]
            on_card = (data.x_train.is_cuda and data.x_test.is_cuda
                       and all(p.is_cuda for p in FedAlgorithm._template(
                           res["state"]).values()))
            losses = [h["train_loss"] for h in res["history"]
                      if h["round"] >= 0]
            final = {k: float(v) for k, v in res["final_eval"].items()
                     if getattr(v, "ndim", 0) == 0}
            emit({"phase": "cli", "algo": algo, "flags": extra,
                  "seconds": seconds,
                  "identity": res["identity"], "stat_info_written": wrote,
                  "on_cuda": on_card, "train_loss": losses,
                  "final_eval": final, "launches": launches})
            if not (wrote and on_card and len(losses) == 2):
                raise AssertionError(
                    f"cli {path}: stat_info written {wrote}, on cuda "
                    f"{on_card}, rounds {len(losses)}")
            vals = losses + list(final.values())
            if not all(math.isfinite(v) for v in vals):
                raise AssertionError(f"cli {path}: non-finite {vals}")
            want = (("masked_sgd", "threshold", "score_mask")
                    if algo == "salientgrads" else ("masked_sgd",))
            if "--fuse_rounds" in extra:  # the round graph's warm-ups too
                aggs += aggs // 2 * FUSED_WARMUPS
            remask = algo == "salientgrads" and (
                "--defense_type" in extra or "topk" in extra)
            if not all(launches[k] > 0 for k in want) or \
                    launches["weighted_sum"] != aggs or \
                    launches["mask_apply"] != (2 if remask else 0):
                raise AssertionError(f"cli {path}: launches {launches}")
            if "--fault_spec" in extra and not all(
                    "clients_quarantined" in h for h in res["history"]
                    if h["round"] >= 0):
                raise AssertionError(f"cli {path}: no guard counters")
            histories[path] = [h for h in res["history"] if h["round"] >= 0]
            out[f"cli/{path}"] = launches
        for path in histories:
            if path.endswith("_fused") and \
                    histories[path] != histories[path[:-len("_fused")]]:
                raise AssertionError(
                    f"cli {path}: --fuse_rounds 2 history {histories[path]}"
                    f" differs from --fuse_rounds 1's "
                    f"{histories[path[:-len('_fused')]]}")
        out.update(_cli_state_runs(runner, built))
    finally:
        runner.build_algorithm = build_algorithm
    return out


#: the cli phase's state-tier runs: (path name, twin, flags of its first
#: run, flags of the resumed run or None): each history held to its
#: uninterrupted twin's (the twins: 4 rounds; 16 clients at frac 0.25)
_CKPT = ["--checkpoint_dir", "{tmp}/{path}/ck"]
CLI_STATE_RUNS = (
    ("salientgrads_checkpoint_resume", "uninterrupted",
     _CKPT + ["--comm_round", "2"],
     _CKPT + ["--comm_round", "4", "--resume"]),
    ("salientgrads_fused_checkpoint_resumed_unfused", "uninterrupted",
     _CKPT + ["--comm_round", "2", "--fuse_rounds", "2"],
     _CKPT + ["--comm_round", "4", "--resume"]),
    ("salientgrads_client_store_disk", "population",
     ["--client_store", "disk", "--client_num_in_total", "16", "--frac",
      "0.25", "--store_hot_clients", "4"], None),
)
CLI_TWINS = {"uninterrupted": ["--comm_round", "4"],
             "population": ["--client_num_in_total", "16", "--frac", "0.25"]}


def _cli_state_runs(runner, built):
    """``--checkpoint_dir`` then ``--resume``, eager and from a fused
    lineage (saved at block boundaries) resumed unfused, and ``--client_store
    disk`` over 16 clients: each run's records (the round times aside) and
    final parameters bitwise its uninterrupted twin's, the parameters on the
    card (the streamed run's cohort on the host). The CLI's seeding puts
    cuDNN in its deterministic mode (``runner.seed_everything``), so two
    runs of a twin are bitwise too: their spread is printed and must be 0.
    Returns the launches per run."""
    import tempfile

    import torch

    from neuroimagedisttraining_torch.algorithms.base import FedAlgorithm
    from neuroimagedisttraining_torch.ops import kernels

    def hist(res):
        return [{k: v for k, v in h.items() if k != "round_time_s"}
                for h in res["history"]]

    def run(tmp, flags, tag, path=""):
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = runner.main(_cli_argv("salientgrads", f"{tmp}/{tag}") + [
            f.format(tmp=tmp, path=path) for f in flags])
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dict(kernels.LAUNCHES)

    def spread(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        twins = {k: run(tmp, v, k)[0] for k, v in CLI_TWINS.items()}
        floor = {k: spread(run(tmp, v, k + "_again")[0]["state"].global_params,
                           twins[k]["state"].global_params)
                 for k, v in CLI_TWINS.items()}
        for path, twin, first, resumed in CLI_STATE_RUNS:
            res, seconds, launches = run(tmp, first, path, path)
            got = hist(res)
            if resumed is not None:
                res, s2, l2 = run(tmp, resumed, path + "_resumed", path)
                got = [h for h in got if h["round"] >= 0] + hist(res)
                seconds += s2
                launches = {k: launches[k] + l2[k] for k in launches}
            want = hist(twins[twin])
            store = "--client_store" in first
            on_card = all(p.is_cuda for p in FedAlgorithm._template(
                res["state"]).values()) and (
                built["data"].x_train.is_cuda != store)
            diff = spread(res["state"].global_params,
                          twins[twin]["state"].global_params)
            same = got == want and diff == 0.0 and floor[twin] == 0.0
            emit({"phase": "cli", "algo": "salientgrads", "run": path,
                  "flags": first, "resumed_flags": resumed,
                  "seconds": seconds, "twin": twin,
                  "records_equal": got == want, "param_diff": diff,
                  "twin_spread": floor[twin], "on_cuda": on_card,
                  "launches": launches})
            if not (same and on_card):
                raise AssertionError(
                    f"cli {path}: history {got} against its twin's {want}"
                    f" (parameters {diff} apart, twins {floor[twin]} apart;"
                    f" on the card {on_card})")
            if not all(launches[k] > 0 for k in ("masked_sgd", "threshold",
                                                  "score_mask",
                                                  "weighted_sum")):
                raise AssertionError(f"cli {path}: launches {launches}")
            out[f"cli/{path}"] = launches
    return out


#: the keys of ``bench_torch.main``'s ``extra`` on one card
BENCH_EXTRA_KEYS = (
    "rounds_per_sec_eval_every_1", "rounds_per_sec_python_loop",
    "rounds_per_sec_fused", "rounds_per_sec_eval_every_1_python_loop",
    "rounds_per_sec_eval_every_1_fused",
    "rounds_per_sec_eval_every_1_eval_cache",
    "rounds_per_sec_eval_every_1_global_only",
    "rounds_per_sec_eval_every_1_eval_cache_python_loop",
    "rounds_per_sec_eval_every_1_eval_cache_fused",
    "rounds_per_sec_eval_every_1_global_only_python_loop",
    "rounds_per_sec_eval_every_1_global_only_fused",
    "client_rounds_per_sec_per_chip", "client_samples_per_sec",
    "snip_init_s", "peak_mem_bytes", "device", "n_devices",
    "client_mesh_devices", "volume", "sample_shape", "clients",
    "samples_per_client", "local_steps", "batch_size", "compute_dtype",
    "timed_rounds", "timed_rounds_eval_every_1", "fused_warm_calls",
    "torch", "cuda")


def bench_path(dev):
    """``bench_torch.main()`` with its counters zeroed just before and read
    just after. Returns the launches per path."""
    import bench_torch as b
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS
    from neuroimagedisttraining_torch.ops import kernels

    kernels.reset_launches()
    t0 = time.perf_counter()
    rec = b.main(emit=False)
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    emit({"phase": "bench", "seconds": seconds, "record": rec,
          "launches": launches})
    extra = rec["extra"]
    rates = [rec["value"]] + [extra[k] for k in (
        "rounds_per_sec_eval_every_1", "rounds_per_sec_fused",
        "rounds_per_sec_eval_every_1_fused",
        "rounds_per_sec_eval_every_1_eval_cache",
        "rounds_per_sec_eval_every_1_global_only")]
    if not all(math.isfinite(v) and v > 0 for v in rates) or \
            rec["value"] != max(extra["rounds_per_sec_python_loop"],
                                extra["rounds_per_sec_fused"]):
        raise AssertionError(f"bench: {rec}")
    # part (d) of the mesh phase: on one card the line keeps its keys, no
    # mesh
    if sorted(rec) != ["extra", "metric", "unit", "value", "vs_baseline"] \
            or sorted(extra) != sorted(BENCH_EXTRA_KEYS) \
            or (extra["n_devices"], extra["client_mesh_devices"]) != (1, 1):
        raise AssertionError(f"bench keys: {sorted(rec)} {sorted(extra)}")
    # the Python loop: a warm round and the timed rounds, twice, the eval
    # (global and personal, every client) after the warm round and after
    # every timed round of the second run; the fused spelling: the round
    # graph's and the eval graph's warm-ups, then each timed block and its
    # warm calls (10 rounds; 8 rounds, each with the eval). Each of the
    # two cells: 1 + 8 loop rounds and a fused block of 8 (its graphs'
    # warm-ups, its warm calls), the eval after each; the eval-cache cell
    # evaluates every client's personal model in each round and its seed,
    # and only the global model in its eval, the global-only cell only
    # the global model. SNIP once per client and the dropout probe (one
    # forward, at the first round) for each of the three algorithms.
    calls = b.FUSED_WARM_CALLS + 1
    rounds = 2 + 10 + 8 + FUSED_WARMUPS + calls * (10 + 8)
    evals = 1 + 8 + FUSED_WARMUPS + calls * 8
    cell = 1 + 8 + FUSED_WARMUPS + calls * 8  # rounds, and evals, per cell
    steps = (rounds + 2 * cell) * b.N_CLIENTS * b.STEPS
    test_rows = max(4, b.SAMPLES_PER_CLIENT // 4)
    per_model = b.N_CLIENTS * -(-test_rows // min(32, test_rows))
    want = {"masked_sgd": steps, "threshold": 3, "score_mask": 3,
            "weighted_sum": rounds + 2 * cell,
            "stem_fwd": (steps + 3 * (b.N_CLIENTS + 1)
                         + evals * 2 * per_model
                         + (1 + cell + cell) * per_model + cell * per_model),
            "stem_bwd": steps + 3 * b.N_CLIENTS}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"bench launch counts {launches}, expected "
                             f"{want}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    byz = b.byzantine(emit=False)
    seconds = time.perf_counter() - t0
    byz_launches = dict(kernels.LAUNCHES)
    emit({"phase": "bench", "config": "byzantine", "seconds": seconds,
          "record": byz, "launches": byz_launches})
    rounds = 1 + byz["extra"]["timed_rounds"]
    want = {"masked_sgd": rounds * b.BYZANTINE_CLIENTS * b.STEPS,
            "weighted_sum": rounds, "stem_fwd": 0, "stem_bwd": 0}
    if not (math.isfinite(byz["value"]) and byz["value"] > 0) or any(
            byz_launches[k] != v for k, v in want.items()):
        raise AssertionError(f"bench byzantine: {byz}, launches "
                             f"{byz_launches}, want {want}")
    return {"bench": launches, "bench/byzantine": byz_launches}


#: the fed phase (``fed_path``): sites, sync rounds, buffered flushes, site
#: 2's straggle sleep in (c) (cut short once a run ends), the top-k density
#: of (c) and (d), the codec timings' repeats in (d), the time limits of the
#: launcher's run in (b) and of the phase
FED_SITES, FED_ROUNDS, FED_FLUSHES = 2, 2, 3
FED_STRAGGLE_S, FED_TOPK_DENSITY, FED_CODEC_REPS = 60.0, 0.1, 3
FED_TCP_TIMEOUT_S, FED_PHASE_LIMIT_S = 300, 120.0


def _fed_argv(tmp: str, sub: str, *extra) -> list:
    """The fed phase's command line: FedAvg at the main configuration's
    width (``--dataset synthetic_volume``: 8 clients x 40 phased bf16
    121x145x121 volumes, 10 test volumes a client, batch 8, 5 local steps,
    bf16 compute), ``FED_ROUNDS`` rounds, no fine-tune."""
    return ["--algo", "fedavg", "--dataset", "synthetic_volume",
            "--layout", "s2d", "--model", "3dcnn",
            "--client_num_in_total", str(N_CLIENTS), "--frac", "1.0",
            "--batch_size", str(BATCH), "--epochs", "1",
            "--comm_round", str(FED_ROUNDS), "--lr", "0.001",
            "--compute_dtype", "bfloat16", "--final_finetune", "0",
            "--fed_retries", "4", "--log_dir", f"{tmp}/{sub}/log",
            "--results_dir", f"{tmp}/{sub}/results"] + list(extra)


def _fed_round_split(merged_trace: str, rounds: int) -> list:
    """Per sync round, from the merged cross-process trace (its lanes on
    the aggregator's clock): the round's wall ms on the aggregator
    (``fed_round``), the sites' training ms (the union of their ``train``
    spans: a loopback site's span also holds its wait for the card's
    lock), the aggregate ms (``combine``) and the rest, the wire: framing,
    transfer, queueing and unframing on both ends."""
    with open(merged_trace) as f:
        doc = json.load(f)
    out = []
    for r in range(rounds):
        evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"
               and (e.get("args") or {}).get("trace") == f"r{r}"]

        def ms(name):
            return sum(e["dur"] for e in evs if e["name"] == name) / 1e3

        union, end = 0.0, -math.inf
        for e in sorted((e for e in evs if e["name"] == "train"),
                        key=lambda e: e["ts"]):
            lo, hi = max(e["ts"], end), e["ts"] + e["dur"]
            union += max(0.0, hi - lo)
            end = max(end, hi)
        round_ms, train_ms, combine_ms = (ms("fed_round"), union / 1e3,
                                          ms("combine"))
        out.append({"round": r, "round_ms": round_ms,
                    "site_train_ms": train_ms, "aggregate_ms": combine_ms,
                    "wire_ms": round_ms - train_ms - combine_ms})
    return out


def fed_path(dev):
    """The distributed federation (``neuroimagedisttraining_torch/fed`` over
    ``comm/``) running FedAvg at full width (:func:`_fed_argv`), one
    aggregator and ``FED_SITES`` sites each training 4 clients: (a) the
    loopback sync federation (sites as threads, ``--xtrace`` on), its
    counters zeroed just before and read just after, bitwise the in-process
    eager ``run`` of the same rounds on the same algorithm (global
    parameters, every round's ``train_loss``, the final eval), its round's
    wall ms split into site training, wire and aggregate, its launches
    exact; (b) ``scripts/torch_run_federation.py --sites 2``: three
    processes on the card over the native TCP transport, built first from
    the port's own source, every exit code 0, ``summary.json``'s
    parameters and eval bitwise (a), its rounds' ms, each process's peak
    memory; (c) the loopback buffered federation at ``--fed_buffer_k 1``
    with site 2 straggling: ``FED_FLUSHES`` flushes, site 2 absent from the
    flush trace, the ``--fed_replay`` of the trace bitwise, then one flush
    on each of the bf16, int8 and top-k codecs; (d) the four codecs on a
    full-width delta: each frame's bytes beside the wire-cost model's
    (``obs.comm.WireCostModel``), encode and decode ms on the host. cuDNN
    deterministic, as the CLI sets it. Returns the launches of (a) and of
    (c)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from neuroimagedisttraining_torch.comm import tcp
    from neuroimagedisttraining_torch.comm.message import Message
    from neuroimagedisttraining_torch.experiments import config, runner
    from neuroimagedisttraining_torch.fed import protocol, runtime, wire
    from neuroimagedisttraining_torch.obs.comm import WireCostModel
    from neuroimagedisttraining_torch.ops import kernels

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # (a) loopback sync, bitwise the in-process run
        args = config.parse_args(_fed_argv(
            tmp, "a", "--fed_role", "aggregator", "--fed_mode", "sync",
            "--fed_sites", str(FED_SITES), "--xtrace", "1"))
        runner.seed_everything(args.seed)
        t0 = time.perf_counter()
        algo, _ = runner.build_algorithm(args, "fedavg")
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        fed = runtime.run_federated(args, "fedavg", algo=algo)
        torch.cuda.synchronize(dev)
        fed_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak_a = torch.cuda.max_memory_allocated(dev)
        rounds = [r for r in fed["history"] if r["round"] >= 0]
        t0 = time.perf_counter()
        state, hist = algo.run(FED_ROUNDS, eval_every=0, finalize=False)
        ev = algo._eval_global(state.global_params)
        twin_eval = {"global_acc": float(ev["acc"]),
                     "global_loss": float(ev["loss"])}
        twin_s = time.perf_counter() - t0
        twin = {k: v.cpu().numpy() for k, v in state.global_params.items()}
        params = fed["global_params"]
        same = sorted(params) == sorted(twin) and all(
            np.array_equal(params[k], twin[k]) for k in twin)
        losses = [r["train_loss"] for r in rounds]
        twin_losses = [h["train_loss"] for h in hist if h["round"] >= 0]
        steps = FED_ROUNDS * N_CLIENTS * STEPS
        want = {"masked_sgd": steps, "stem_bwd": steps,
                "weighted_sum": FED_ROUNDS,
                # every step, the final eval's forward a client and the
                # dropout probe's
                "stem_fwd": steps + N_CLIENTS * _eval_chunks() + 1}
        rec_a = {
            "phase": "fed", "part": "a_loopback_sync", "sites": FED_SITES,
            "rounds": FED_ROUNDS, "algo_build_s": build_s,
            "federation_s": fed_s, "twin_s": twin_s,
            "round_split_ms": _fed_round_split(
                fed["fed"]["merged_trace"], FED_ROUNDS),
            "fed_wire_ms": [r.get("fed_wire_ms") for r in rounds],
            "fed_queue_ms": [r.get("fed_queue_ms") for r in rounds],
            "train_loss": losses, "twin_train_loss": twin_losses,
            "final_eval": fed["final_eval"], "twin_eval": twin_eval,
            "params_bitwise": same, "peak_mem_bytes": peak_a,
            "comm_bytes_sent": fed["fed"]["comm_bytes_sent"],
            "comm_bytes_received": fed["fed"]["comm_bytes_received"],
            "launches": launches}
        emit(rec_a)
        if not (same and losses == twin_losses
                and fed["final_eval"] == twin_eval):
            raise AssertionError("fed (a): the loopback sync federation is "
                                 "not bitwise the in-process run")
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"fed (a) launches {launches}, want {want}")

        # (b) the launcher: three processes on the card over native TCP
        t0 = time.perf_counter()
        lib = tcp.build_native(force=True)
        tcp_build_s = time.perf_counter() - t0
        fed_out = os.path.join(tmp, "b", "fed")
        cmd = [sys.executable,
               os.path.join(root, "scripts", "torch_run_federation.py"),
               "--sites", str(FED_SITES), "--out", fed_out, "--"] + \
            _fed_argv(tmp, "b", "--fed_mode", "sync", "--xtrace", "1")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=FED_TCP_TIMEOUT_S, cwd=root)
        tcp_s = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"launcher_ok"')]
        if proc.returncode != 0 or not lines:
            raise AssertionError(
                f"fed (b): the launcher exited {proc.returncode}: "
                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        launch = json.loads(lines[-1])
        with open(os.path.join(fed_out, "summary.json")) as f:
            summary = json.load(f)
        got = np.load(os.path.join(fed_out, runtime.PARAMS_FILE))
        same_b = sorted(got.files) == sorted(params) and all(
            np.array_equal(got[k], params[k]) for k in params) and \
            summary["params_sha256"] == runtime.params_digest(params)
        tcp_rounds = [r for r in summary["history"] if r["round"] >= 0]
        peaks = {"aggregator": summary["fed"].get("peak_mem_bytes")}
        for k in range(1, FED_SITES + 1):
            with open(os.path.join(fed_out, f"site{k}.jsonl")) as f:
                last = [json.loads(ln) for ln in f if ln.strip()][-1]
            peaks[f"site{k}"] = last.get("peak_mem_bytes")
        rec_b = {
            "phase": "fed", "part": "b_tcp_sync", "launcher": launch,
            "native_lib": os.path.relpath(lib, root),
            "native_src": os.path.relpath(tcp._SRC, root),
            "native_build_s": tcp_build_s, "launcher_s": tcp_s,
            "round_ms": [r.get("fed_round_ms") for r in tcp_rounds],
            "fed_wire_ms": [r.get("fed_wire_ms") for r in tcp_rounds],
            "train_loss": [r["train_loss"] for r in tcp_rounds],
            "final_eval": summary["final_eval"], "params_bitwise": same_b,
            "peak_mem_bytes": peaks,
            "comm_bytes_sent": summary["fed"]["comm_bytes_sent"]}
        emit(rec_b)
        if not (launch["aggregator_rc"] == 0
                and all(v == 0 for v in launch["site_rcs"].values())
                and same_b and summary["final_eval"] == fed["final_eval"]
                and rec_b["train_loss"] == losses):
            raise AssertionError("fed (b): the TCP federation is not "
                                 "bitwise the loopback one")

        # (c) buffered, site 2 straggling; the replay; one flush per codec
        buf = ["--fed_role", "aggregator", "--fed_mode", "buffered",
               "--fed_sites", str(FED_SITES), "--fed_buffer_k", "1",
               "--fed_site_faults", f"2:straggle=1.0:{FED_STRAGGLE_S}",
               "--agg_topk_density", str(FED_TOPK_DENSITY)]
        kernels.reset_launches()
        t0 = time.perf_counter()
        rec_run = runtime.run_federated(config.parse_args(_fed_argv(
            tmp, "c", *buf, "--comm_round", str(FED_FLUSHES))), "fedavg",
            algo=algo)
        buffered_s = time.perf_counter() - t0
        launches_c = dict(kernels.LAUNCHES)
        trace_path = rec_run["fed"]["trace_path"]
        with open(trace_path) as f:
            trace = json.load(f)
        t0 = time.perf_counter()
        rep = runtime.run_federated(config.parse_args(_fed_argv(
            tmp, "c_replay", *buf, "--comm_round", str(FED_FLUSHES),
            "--fed_replay", trace_path)), "fedavg", algo=algo)
        replay_s = time.perf_counter() - t0
        same_c = all(np.array_equal(rec_run["global_params"][k],
                                    rep["global_params"][k])
                     for k in rec_run["global_params"])
        codecs = {}
        for impl in ("bf16", "int8", "topk"):
            t0 = time.perf_counter()
            one = runtime.run_federated(config.parse_args(_fed_argv(
                tmp, f"c_{impl}", *buf, "--comm_round", "1", "--agg_impl",
                impl)), "fedavg", algo=algo)
            flushes = [r for r in one["history"] if r["round"] >= 0]
            codecs[impl] = {"seconds": time.perf_counter() - t0,
                            "flushes": len(flushes),
                            "train_loss": flushes[0]["train_loss"]
                            if flushes else None}
        members = [m for fl in trace["flushes"] for m in fl["members"]]
        rec_c = {
            "phase": "fed", "part": "c_loopback_buffered",
            "flush_trace": trace["flushes"], "buffered_s": buffered_s,
            "replay_s": replay_s, "replay_bitwise": same_c,
            "train_loss": [r["train_loss"] for r in rec_run["history"]
                           if r["round"] >= 0],
            "codec_flushes": codecs, "launches": launches_c}
        emit(rec_c)
        if not (len(trace["flushes"]) == FED_FLUSHES
                and all(site != 2 for site, _ in members) and same_c
                and rep["fed"]["replayed"]
                and all(c["flushes"] == 1 and math.isfinite(c["train_loss"])
                        for c in codecs.values())):
            raise AssertionError(f"fed (c): {rec_c}")
        if any(launches_c[k] == 0 for k in ("masked_sgd", "stem_fwd",
                                            "stem_bwd", "weighted_sum")):
            raise AssertionError(f"fed (c) launches {launches_c}")

        # (d) the codecs on a full-width delta
        init = algo.init_state().global_params
        delta = {k: params[k] - init[k].cpu().numpy() for k in params}
        model = WireCostModel.from_params(delta,
                                          topk_density=FED_TOPK_DENSITY)
        rec_d = {"phase": "fed", "part": "d_codecs",
                 "n_params": model.n_params}
        for impl in wire.WIRE_IMPLS:
            enc, dec = [], []
            for _ in range(FED_CODEC_REPS):
                t0 = time.perf_counter()
                msg = Message(protocol.MSG_FED_UPDATE, 1, 0)
                wire.encode_update(msg, delta, impl,
                                   density=FED_TOPK_DENSITY)
                raw = msg.to_bytes()
                enc.append((time.perf_counter() - t0) * 1e3)
                t0 = time.perf_counter()
                back = wire.decode_update(Message.from_bytes(raw))
                dec.append((time.perf_counter() - t0) * 1e3)
            if impl == "dense" and not all(
                    np.array_equal(back[k], delta[k]) for k in delta):
                raise AssertionError("fed (d): the dense codec is lossy")
            modeled = model.bytes_for(impl)
            rec_d[impl] = {"frame_bytes": len(raw), "model_bytes": modeled,
                           "frame_over_model": len(raw) / modeled,
                           "encode_ms": statistics.median(enc),
                           "decode_ms": statistics.median(dec)}
        emit(rec_d)
    del algo, state
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    if phase_s > FED_PHASE_LIMIT_S:
        raise AssertionError(f"fed phase took {phase_s:.1f} s, over its "
                             f"{FED_PHASE_LIMIT_S} s")
    return {"fed": launches, "fed/buffered": launches_c}


#: the serve phase: the loopback run's requests and rate, the fan-out's
#: requests, the requests of (b)'s served-answer checks, the B = 1 timings'
#: repeats, the time limits of the TCP pair and of the phase
SERVE_REQUESTS, SERVE_RPS, SERVE_FANOUT_REQUESTS = 256, 200.0, 64
SERVE_CHECK_REQUESTS, SERVE_B1_REPS = 16, 20
SERVE_TCP_TIMEOUT_S, SERVE_PHASE_LIMIT_S = 240, 180.0
#: (b)'s limit, norm-wise over the 16 requests' logits, of the card's
#: answers against the CPU's plain versions: bf16 products summed in other
#: orders (3.1e-2 is eight roundings of 2^-8; the reading was 1.15e-2 in
#: the first run on the H100); on the card a micro-batch's answers are
#: bitwise one request's at a time (cuDNN deterministic)
SERVE_CPU_RTOL = 3.1e-2
SERVE_SLO = "p99:serve_latency_ms<50@w=200"
#: the serving gauges every tick line carries
SERVE_TICK_KEYS = ("serve_latency_ms", "serve_batch_fill", "serve_rps",
                   "serve_queue_depth", "serve_hit_rate",
                   "serve_model_version", "serve_model_staleness_s",
                   "slo_health")


def _serve_argv(tmp: str, sub: str, *extra) -> list:
    """The serve phase's command line: the fed phase's FedAvg configuration
    (:func:`_fed_argv`) with int8 pushes, a disk population with 4 hot
    clients, micro-batches of 16 lingering 2 ms, ``SERVE_RPS``."""
    return _fed_argv(tmp, sub, "--serve_wire", "int8", "--serve_store",
                     "disk", "--store_hot_clients", "4", "--serve_batch",
                     "16", "--serve_linger_ms", "2", "--serve_rps",
                     str(SERVE_RPS), *extra)


def _serve_records(jsonl: str):
    """(the tick records, every record) of a serving stream."""
    with open(jsonl) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    return ([r for r in recs if isinstance(r.get("round"), int)
             and r["round"] >= 0], recs)


def _quantiles(xs) -> dict:
    """Nearest-rank p50 and p99 (and the count and the max) of ``xs``."""
    xs = sorted(xs)
    if not xs:
        return {"n": 0}

    def q(p):
        return xs[max(0, math.ceil(p * len(xs)) - 1)]

    return {"n": len(xs), "p50": q(0.5), "p99": q(0.99), "max": xs[-1]}


def _tick_summary(ticks) -> dict:
    """Latency quantiles over the ticks' ``serve_latency_ms`` (each tick's
    slowest request, what the SLO observes), its requests and the sustained
    rate from the first tick's requests to the last."""
    lat = _quantiles([r["serve_latency_ms"] for r in ticks])
    return {"ticks": len(ticks),
            "requests": sum(r["serve_requests"] for r in ticks),
            "latency_ms": lat,
            "mean_latency_ms": statistics.fmean(
                r["serve_latency_mean_ms"] for r in ticks) if ticks else None,
            "batch_fill": statistics.fmean(
                r["serve_batch_fill"] for r in ticks) if ticks else None}


def _free_ports(n: int) -> list:
    import socket

    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def serve_path(dev):
    """The serving plane (``neuroimagedisttraining_torch/serve``) on the fed
    phase's FedAvg configuration (:func:`_serve_argv`): (a) the loopback run
    through ``serve.runtime.run_serving`` (the CLI's entry): the publisher
    trains 2 rounds in this thread and pushes v0 (full) and v1, v2 (int8
    deltas) while the worker answers ``SERVE_REQUESTS`` Zipf requests at
    ``SERVE_RPS`` in threads of its own against a disk population, probing
    every 4 ticks, with ``--xtrace``, a live SLO and ``/metrics`` (scraped
    after the last round): every request served, every push adopted and
    acked, the served model bitwise its checkpoint, the tick lines'
    gauges, the drain record, every ``adopt`` span under a ``publish`` span,
    the launches exact (the worker counts its forwards); (b) the served
    answers: 16 requests of (a)'s trace at its final version, the
    micro-batch against one request at a time on the card and against the
    CPU's plain versions, then (a)'s 256 requests again at ``SERVE_RPS``
    with no training beside them, and the worker's B = 1 answer timed; (c)
    ``--serve_backend tcp``: the publisher and the worker as two processes
    on the card, exit codes 0, the worker's gate bitwise, the push frames
    equal to (a)'s (their digests); (d) ``--serve_workers 2``, 1 round, 64
    requests: both workers adopt bitwise-equal models at every version,
    equal ack watermarks. cuDNN deterministic, as the CLI sets it. At most
    ``SERVE_PHASE_LIMIT_S``. Returns the launches of (a) and (d)."""
    import copy
    import os
    import tempfile
    import threading
    import urllib.request

    import numpy as np
    import torch

    from neuroimagedisttraining_torch.comm.local import LocalRouter
    from neuroimagedisttraining_torch.experiments import config, runner
    from neuroimagedisttraining_torch.models import make_apply_fn
    from neuroimagedisttraining_torch.obs import prom, xtrace
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.serve import (publisher, runtime,
                                                    traffic)
    from neuroimagedisttraining_torch.serve.worker import PERSONAL_FIELD

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    steps = FED_ROUNDS * N_CLIENTS * STEPS
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the loopback run, launches counted
        trace_a = os.path.join(tmp, "a.trace.json")
        args = config.parse_args(_serve_argv(
            tmp, "a", "--serve_role", "worker", "--serve_backend", "local",
            "--comm_round", str(FED_ROUNDS), "--serve_requests",
            str(SERVE_REQUESTS), "--xtrace", "1", "--serve_probe_every",
            "4", "--obs_prom_port", "-1", "--slo_spec", SERVE_SLO,
            "--serve_trace", trace_a))
        runner.seed_everything(args.seed)
        t0 = time.perf_counter()
        algo, _ = runner.build_algorithm(args, "fedavg")
        torch.cuda.synchronize(dev)
        build_s = time.perf_counter() - t0
        servers, mid = [], {}
        start_prom, train = prom.maybe_prom_server, runtime._train_and_push

        def capture(fn, port):
            servers.append(start_prom(fn, port))
            return servers[-1]

        def train_then_scrape(*a, **k):
            t0 = time.perf_counter()
            out = train(*a, **k)
            mid["train_s"] = time.perf_counter() - t0
            with urllib.request.urlopen(servers[0].url, timeout=10) as r:
                mid["content_type"] = r.headers["Content-Type"]
                mid["samples"] = prom.parse_prom_text(r.read().decode())
            return out

        prom.maybe_prom_server = capture
        runtime._train_and_push = train_then_scrape
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            out = runtime.run_serving(args, "fedavg", algo=algo)
        finally:
            prom.maybe_prom_server = start_prom
            runtime._train_and_push = train
        torch.cuda.synchronize(dev)
        run_s = time.perf_counter() - t0
        launches = kernels.snapshot_launches()
        peak_a = torch.cuda.max_memory_allocated(dev)
        s = out["serve"]
        ticks, recs = _serve_records(s["jsonl"])
        # the ticks served before the last round ended (the scrape's count)
        n_during = int(mid["samples"].get("serve_batches_total", 0))
        doc = xtrace.load_doc(s["merged_trace"])
        spans = xtrace.span_index(doc)
        adopts = [e for e in spans.values() if e["name"] == "adopt"]
        parents = [spans.get(str(e["args"].get("parent")), {}).get("name")
                   for e in adopts]
        want = {k: 0 for k in launches}
        want.update(masked_sgd=steps, stem_bwd=steps, weighted_sum=FED_ROUNDS,
                    # the publisher's steps and its dropout probe, the
                    # worker's forwards (warm-up, one a client of a
                    # micro-batch, the probes)
                    stem_fwd=steps + 1 + s["forwards"])
        rec_a = {
            "phase": "serve", "part": "a_loopback", "algo_build_s": build_s,
            "run_s": run_s, "train_s": mid["train_s"],
            "requests": s["requests"], "batches": s["batches"],
            "forwards": s["forwards"], "pushes_adopted": s["pushes_adopted"],
            "model_version": s["model_version"],
            "acked_version": s["acked_version"],
            "bit_identical": s["bit_identical"], "rps": s["rps"],
            "wall_s": s["wall_s"], "hit_rate": s["hit_rate"],
            "during_training": _tick_summary(ticks[:n_during]),
            "after_training": _tick_summary(ticks[n_during:]),
            "adopt_lag_ms": sorted({r["serve_adopt_lag_ms"] for r in ticks
                                    if "serve_adopt_lag_ms" in r}),
            "probe_acc": [r["serve_probe_acc"] for r in ticks
                          if "serve_probe_acc" in r],
            "push_bytes": s["push_bytes"], "push_digests": s["push_digests"],
            "bytes_pushed": s["bytes_pushed"], "slo_health":
                (s["slo"] or {}).get("health"),
            "adopt_parents": parents, "orphan_spans":
                xtrace.validate_parentage(doc),
            "prom_content_type": mid["content_type"],
            "prom_samples": len(mid["samples"]),
            "peak_mem_bytes": peak_a, "launches": launches,
            "want_launches": want}
        emit(rec_a)
        if not (s["requests"] == SERVE_REQUESTS and s["pushes_adopted"] == 3
                and s["model_version"] == s["acked_version"] == FED_ROUNDS
                and s["bit_identical"] is True):
            raise AssertionError(f"serve (a): {rec_a}")
        if not (ticks and all(k in ticks[-1] for k in SERVE_TICK_KEYS)
                and any(r.get("serve_drained") for r in recs)
                and rec_a["probe_acc"]):
            raise AssertionError("serve (a): the tick lines lack the serving "
                                 f"gauges or the drain record: {ticks[-1:]}")
        if not (len(adopts) == 3 and parents == ["publish"] * 3
                and not rec_a["orphan_spans"]):
            raise AssertionError(f"serve (a): adopt spans' parents {parents}")
        if not (mid["content_type"] == prom.CONTENT_TYPE
                and mid["samples"].get("serve_requests_total", 0) > 0):
            raise AssertionError(f"serve (a): the /metrics scrape {mid}")
        if launches != want:
            raise AssertionError(f"serve (a) launches {launches}, want "
                                 f"{want}")

        # (b) the served answers at the final version; a window without
        # training; the B = 1 answer
        _, final = publisher.load_checkpoint(
            publisher.checkpoint_path(s["ckpt_dir"], FED_ROUNDS))
        reqs = traffic.trace_load(trace_a)
        sub = reqs[:SERVE_CHECK_REQUESTS]
        ids, smp = [c for c, _ in sub], [x for _, x in sub]
        args_b = config.parse_args(_serve_argv(
            tmp, "b", "--serve_role", "worker", "--serve_requests",
            str(SERVE_REQUESTS)))
        out_b = os.path.join(tmp, "b")
        os.makedirs(out_b, exist_ok=True)
        session = runtime._make_session(args_b, "fedavg", "b-serve", out_b,
                                        catalog=False)
        w = runtime._make_worker(args_b, algo, LocalRouter(2).manager(1),
                                 session, out_b, final)
        w.warmup()
        batched = w.serve_logits(ids, smp)
        single = torch.cat([w.serve_logits([c], [x]) for c, x in sub])
        card_rel = float((batched - single).norm() / single.norm())
        t0 = time.perf_counter()
        cpu_apply = make_apply_fn(copy.deepcopy(w.apply_fn.model).cpu(),
                                  algo.compute_dtype,
                                  channel_inject=algo.channel_inject)
        rows = w.store.gather(PERSONAL_FIELD, sorted(set(ids)))
        cpu = torch.empty_like(batched)
        with torch.inference_mode():
            for i, c in enumerate(sorted(set(ids))):
                at = [j for j, cj in enumerate(ids) if cj == c]
                params = {k: torch.from_numpy(np.array(final[k])) +
                          rows[k][i] for k in final}
                x = algo.data.x_train[c][torch.as_tensor(
                    [smp[j] for j in at], device=dev)].cpu()
                cpu[at] = cpu_apply(params, x, False, None)
        cpu_s = time.perf_counter() - t0
        cpu_rel = float((batched - cpu).norm() / cpu.norm())
        # (a)'s requests again at SERVE_RPS, nothing training beside them
        loop = threading.Thread(target=w.serve_loop, daemon=True)
        loop.start()
        t0 = time.perf_counter()
        runtime._pump_traffic(w, reqs, SERVE_RPS)
        w._on_finish(None)
        if not w.drained.wait(60) or w.error is not None:
            raise AssertionError(f"serve (b): the worker did not drain: "
                                 f"{w.error!r}")
        quiet_s = time.perf_counter() - t0
        session.finish()
        w.finish()
        quiet, _ = _serve_records(session.jsonl_path)
        # the B = 1 answer: the request's wall time (row gather, the copy
        # to the card, the sum, the forward, the logits back), and the
        # forward alone in device time
        c1, x1 = sub[0]
        walls = []
        for _ in range(SERVE_B1_REPS):
            t0 = time.perf_counter()
            w.serve_logits([c1], [x1])
            walls.append((time.perf_counter() - t0) * 1e3)
        row = w.store.gather(PERSONAL_FIELD, [c1], device=dev)
        with torch.inference_mode():
            p1 = {k: w._g_dev[k] + row[k][0] for k in w._g_dev}
            xb = algo.data.x_train[c1][x1:x1 + 1]
            fwd_ms = device_ms(lambda: w._forward(p1, xb), reps=SERVE_B1_REPS)
        rec_b = {
            "phase": "serve", "part": "b_answers",
            "requests": [list(r) for r in sub],
            "card_batched_vs_single_rel": card_rel,
            "card_bitwise": bool(torch.equal(batched, single)),
            "card_vs_cpu_rel": cpu_rel, "cpu_s": cpu_s,
            "cpu_limit": SERVE_CPU_RTOL,
            "logits": batched[:, 0].tolist(),
            "quiet_window": {**_tick_summary(quiet), "seconds": quiet_s,
                             "rps": SERVE_REQUESTS / quiet_s,
                             "hit_rate": w.drain_record()[
                                 "serve_hit_rate_total"]},
            "b1_wall_ms": _quantiles(walls), "b1_forward_device_ms": fwd_ms}
        emit(rec_b)
        if not (rec_b["card_bitwise"] and cpu_rel <= SERVE_CPU_RTOL
                and bool(torch.isfinite(batched).all())
                and w.requests_served == SERVE_REQUESTS):
            raise AssertionError(f"serve (b): {rec_b}")
        del w, rows

        # (c) the publisher and the worker as two processes over TCP
        ports = _free_ports(2)
        out_c = os.path.join(tmp, "c", "out")
        common = _serve_argv(
            tmp, "c", "--serve_backend", "tcp", "--serve_endpoints",
            ",".join(f"127.0.0.1:{p}" for p in ports), "--comm_round",
            str(FED_ROUNDS), "--serve_requests", str(SERVE_REQUESTS),
            "--serve_out", out_c, "--slo_spec", SERVE_SLO)
        procs, logs = {}, {}
        t0 = time.perf_counter()
        try:
            for role in ("worker", "publisher"):
                logs[role] = open(os.path.join(tmp, f"c_{role}.log"), "w")
                procs[role] = subprocess.Popen(
                    [sys.executable, "-m",
                     "neuroimagedisttraining_torch.experiments"] + common +
                    ["--serve_role", role], stdout=logs[role],
                    stderr=subprocess.STDOUT, cwd=root)
            rcs = {role: p.wait(timeout=SERVE_TCP_TIMEOUT_S)
                   for role, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs.values():
                f.close()
        tcp_s = time.perf_counter() - t0
        if any(rcs.values()):
            tails = {}
            for role in procs:
                with open(os.path.join(tmp, f"c_{role}.log")) as f:
                    tails[role] = f.read()[-3000:]
            raise AssertionError(f"serve (c): exit codes {rcs}: {tails}")
        summ = {}
        for role in procs:
            with open(os.path.join(
                    out_c, f"serve_summary_{role}.json")) as f:
                summ[role] = json.load(f)
        sw, sp = summ["worker"], summ["publisher"]
        tcp_ticks, _ = _serve_records(sw["jsonl"])
        rec_c = {
            "phase": "serve", "part": "c_tcp", "seconds": tcp_s, "rcs": rcs,
            "requests": sw["requests"], "pushes_adopted": sw["pushes_adopted"],
            "bit_identical": sw["bit_identical"], "rps": sw["rps"],
            "hit_rate": sw["hit_rate"], "ticks": _tick_summary(tcp_ticks),
            "frames_equal_a": sp["push_digests"] == s["push_digests"],
            "push_bytes": sp["push_bytes"],
            "peak_mem_bytes": {"publisher": sp.get("peak_mem_bytes"),
                               "worker": sw.get("peak_mem_bytes")},
            "publisher_wall_s": sp["wall_s"]}
        emit(rec_c)
        if not (sw["bit_identical"] is True and sw["pushes_adopted"] == 3
                and sw["requests"] == SERVE_REQUESTS
                and rec_c["frames_equal_a"]):
            raise AssertionError(f"serve (c): {rec_c}")

        # (d) two workers fanned out from one publisher
        args_d = config.parse_args(_serve_argv(
            tmp, "d", "--serve_role", "worker", "--serve_backend", "local",
            "--serve_workers", "2", "--comm_round", "1", "--serve_requests",
            str(SERVE_FANOUT_REQUESTS)))
        kernels.reset_launches()
        t0 = time.perf_counter()
        sd = runtime.run_serving(args_d, "fedavg", algo=algo)["serve"]
        torch.cuda.synchronize(dev)
        fan_s = time.perf_counter() - t0
        launches_d = kernels.snapshot_launches()
        ws = sd["workers"]
        want_d = {k: 0 for k in launches_d}
        want_d.update(masked_sgd=steps // FED_ROUNDS,
                      stem_bwd=steps // FED_ROUNDS, weighted_sum=1,
                      stem_fwd=steps // FED_ROUNDS + sum(
                          x["forwards"] for x in ws))
        rec_d = {"phase": "serve", "part": "d_fanout", "seconds": fan_s,
                 "workers": ws, "acked_versions": sd["acked_versions"],
                 "launches": launches_d, "want_launches": want_d}
        emit(rec_d)
        if not (len(ws) == 2 and all(x["bit_identical"] is True
                                     and x["pushes_adopted"] == 2
                                     for x in ws)
                and ws[0]["adopt_digests"] == ws[1]["adopt_digests"]
                and sorted(ws[0]["adopt_digests"]) == ["0", "1"]
                and sd["acked_versions"] == {"1": 1, "2": 1}):
            raise AssertionError(f"serve (d): {rec_d}")
        if launches_d != want_d:
            raise AssertionError(f"serve (d) launches {launches_d}, want "
                                 f"{want_d}")
    del algo
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    if phase_s > SERVE_PHASE_LIMIT_S:
        raise AssertionError(f"serve phase took {phase_s:.1f} s, over its "
                             f"{SERVE_PHASE_LIMIT_S} s")
    return {"serve": launches, "serve/fanout": launches_d}


#: the obs phase's eager rounds and fused block
OBS_ROUNDS = 2
#: the device-lane kernels the obs phase's profiled round must show, by a
#: piece of their names
OBS_TRACE_KERNELS = ("stem_fwd", "stem_bwd", "masked_sgd_kernel",
                     "weighted_sum_kernel")
#: the obs phase's CLI run: every lifted flag, faults that the guard
#: quarantines (the flight recorder's bundles) and an objective that
#: breaches (the events stream)
OBS_CLI = ["--fault_spec", "nan=0.5", "--obs", "1", "--obs_numerics", "1",
           "--obs_comm", "1", "--obs_sample_every", "1",
           "--slo_spec", "p99:train_loss<0.01", "--flight_recorder",
           "guard", "--flight_window", "4"]


class _SyncCount:
    """Counts the host-side syncs a block makes while it lives: the
    tensor-to-Python reads (``item``, ``tolist``, ``float``, ``cpu``,
    ``numpy``) and ``torch.cuda.synchronize``."""

    _TENSOR = ("item", "tolist", "__float__", "cpu", "numpy")

    def __enter__(self):
        import torch

        self.n, self.saved = 0, []

        def counted(owner, name):
            fn = getattr(owner, name)
            self.saved.append((owner, name, owner.__dict__.get(name)))

            def call(*args, **kwargs):
                self.n += 1
                return fn(*args, **kwargs)
            setattr(owner, name, call)

        for name in self._TENSOR:
            counted(torch.Tensor, name)
        counted(torch.cuda, "synchronize")
        return self

    def __exit__(self, *exc):
        for owner, name, own in reversed(self.saved):
            if own is None:  # inherited: drop the wrapper
                delattr(owner, name)
            else:
                setattr(owner, name, own)
        return False


def _obs_main_algo(dev, data, hp, shape, numerics, impl="dense"):
    from neuroimagedisttraining_torch.algorithms import SalientGrads
    from neuroimagedisttraining_torch.models import create_model

    return SalientGrads(
        create_model("3dcnn_s2d", num_classes=1, sample_shape=shape), data,
        hp, loss_type="bce", frac=1.0, seed=0, dense_ratio=0.5,
        itersnip_iterations=1, compute_dtype="bfloat16", agg_impl=impl,
        obs_numerics=numerics, device=dev)


def _obs_rounds(algo, state, session=None):
    """``OBS_ROUNDS`` eager rounds as the CLI's loop runs them (records
    fetched one round late; with ``session`` each round under its step
    span and recorded at the flush). Returns the state and the records."""
    from neuroimagedisttraining_torch.obs import trace as obs_trace
    from neuroimagedisttraining_torch.utils.records import DeferredRecords

    recs = []

    def emit_rec(rec):
        recs.append(rec)
        if session is not None:
            session.record_round(rec)

    deferred = DeferredRecords(log=emit_rec)
    for r in range(OBS_ROUNDS):
        with obs_trace.step_span("round", r):
            state, met = algo.run_round(state, r)
        deferred.push({"round": r, **met})
    deferred.flush()
    return state, recs


def _devtrace_names(profile_dir):
    """The kernel names on the device lanes of the traces under
    ``profile_dir``."""
    from neuroimagedisttraining_torch.obs import devtrace

    names = set()
    for path in devtrace.find_trace_files(profile_dir):
        for e in devtrace.load_trace_doc(path).get("traceEvents", []):
            if e.get("cat") == devtrace.KERNEL_CAT:
                names.add(str(e.get("name", "")))
    return names


def _trace_collective_ops(profile_dir):
    """The names of the host-side collective ops (PyTorch's ``nccl:*``
    records and ``record_param_comms``) in the traces under
    ``profile_dir``."""
    from neuroimagedisttraining_torch.obs import devtrace

    names = set()
    for path in devtrace.find_trace_files(profile_dir):
        for e in devtrace.load_trace_doc(path).get("traceEvents", []):
            name = str(e.get("name", ""))
            if name.startswith("nccl:") or name == "record_param_comms":
                names.add(name)
    return names


def obs_path(dev):
    """The in-process observability tier on the main configuration
    (``neuroimagedisttraining_torch/obs``): (a) SNIP and ``OBS_ROUNDS``
    eager rounds with the session and the numerics on, each round under
    its step span and recorded at its flush, held bitwise (mask, state,
    records less the numerics) to the same rounds with obs off; (b) a fused
    block of the same rounds with the numerics, each bitwise the eager
    round's, its dispatch making no more host syncs than the obs-off
    block's (``_SyncCount``), its graph's nodes beside obs off's, and the
    fused rounds/s with obs on and off (one block each, after their
    captures); (c) ``probe_aggregate`` on the dense and int8 wires (ms,
    counted FLOPs and bytes, the model's wire bytes); (d)
    ``trace_one_round`` into a profile directory: ``devtrace`` finds the
    stem's, masked SGD's and the weighted sum's kernels on the device
    lane, its ``busy_s`` beside the round's CUDA-event ms; (e)
    ``device_memory()``'s peak is ``torch.cuda.max_memory_allocated()``;
    (f) a one-rank NCCL mesh round with the session on under the profiler:
    its collectives issued through NCCL in the trace (one rank's
    communicator launches no kernel, so the collectives' device share is
    held on several cards by ``scripts/torch_obs_mesh_trace.py``), rank 0
    writing the JSONL; (g) the
    CLI on ``small3dcnn`` with every lifted flag: the JSONL, metrics JSON,
    trace, events, catalog entry, flight bundle and devtrace sidecar
    written, the run bitwise its obs-off twin. cuDNN deterministic
    throughout (two runs are held bitwise). Returns the launches per
    part."""
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.experiments import runner
    from neuroimagedisttraining_torch.obs import comm as obs_comm
    from neuroimagedisttraining_torch.obs import devtrace
    from neuroimagedisttraining_torch.obs import export as obs_export
    from neuroimagedisttraining_torch.obs import memory as obs_memory
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.ops.s2d import phased_sample_shape
    from neuroimagedisttraining_torch.utils.profiling import trace_one_round

    shape = phased_sample_shape(VOLUME)
    data, hp = _main_config(dev, shape)
    out, rec = {}, {"phase": "obs"}
    added = ("num_", "round_time_s")

    def strip(recs):
        return [{k: v for k, v in r.items() if not k.startswith(added)}
                for r in recs]

    with tempfile.TemporaryDirectory() as tmp, \
            _CudnnFlags(deterministic=True, benchmark=False):
        # (a) eager rounds, session and numerics on against obs off
        on = _obs_main_algo(dev, data, hp, shape, True)
        off = _obs_main_algo(dev, data, hp, shape, False)
        session = obs_export.ObsSession(
            jsonl_path=os.path.join(tmp, "a", "main.obs.jsonl"),
            trace_dir=os.path.join(tmp, "a", "tr"), identity="main",
            comm=True)
        try:
            kernels.reset_launches()
            s0 = on.init_state()
            s_on, recs_on = _obs_rounds(on, s0, session)
            torch.cuda.synchronize()
            out["obs/eager"] = dict(kernels.LAUNCHES)
            session.finish()
        finally:
            session.close()
        t0 = off.init_state()
        s_off, recs_off = _obs_rounds(off, t0)
        if not (_trees_equal(s0, t0, ("mask",))
                and _trees_equal(s_on, s_off, ("global_params", "mask",
                                               "personal_params"))
                and strip(recs_on) == recs_off):
            raise AssertionError("obs (a): obs on is not bitwise obs off")
        with open(session.jsonl_path) as f:
            lines = [json.loads(x) for x in f]
        num_keys = sorted(k for k in recs_on[0] if k.startswith("num_"))
        rec["a"] = {"rounds": OBS_ROUNDS, "jsonl_lines": len(lines),
                    "numerics": len(num_keys),
                    "num_update_norm": [r["num_update_norm"]
                                        for r in recs_on],
                    "spans": sorted({e["name"] for e in
                                     session.tracer.events})}
        if len(lines) != OBS_ROUNDS or not num_keys or not all(
                math.isfinite(r[k]) for r in recs_on for k in num_keys):
            raise AssertionError(f"obs (a): {rec['a']}")

        # (b) the fused block: numerics bitwise the eager rounds', no extra
        # host sync, rounds/s with obs on and off
        rates, syncs, nodes = {}, {}, {}
        for name, algo, st in (("on", on, s0), ("off", off, t0)):
            algo.run_rounds_fused(st, 0, OBS_ROUNDS)[1].materialize()
            torch.cuda.synchronize()
            with _SyncCount() as sc:
                t = time.perf_counter()
                fused, ys = algo.run_rounds_fused(st, 0, OBS_ROUNDS)
            syncs[name] = sc.n
            host = ys.materialize()
            torch.cuda.synchronize()
            rates[name] = OBS_ROUNDS / (time.perf_counter() - t)
            nodes[name] = [g.graph.nodes if g.graph is not None else None
                           for g in algo._fused.rounds.values()]
            if name == "on":
                for i, r in enumerate(recs_on):
                    bad = [k for k in on._round_metric_names
                           if float(host[k][i]) != r[k]]
                    if bad:
                        raise AssertionError(f"obs (b): round {i} {bad}")
                if not _trees_equal(fused, s_on, ("global_params",)):
                    raise AssertionError("obs (b): fused state")
        rec["b"] = {"fused_rounds_per_sec_obs_on": rates["on"],
                    "fused_rounds_per_sec_obs_off": rates["off"],
                    "dispatch_syncs_on": syncs["on"],
                    "dispatch_syncs_off": syncs["off"],
                    "graph_nodes_on": nodes["on"],
                    "graph_nodes_off": nodes["off"]}
        if syncs["on"] > syncs["off"]:
            raise AssertionError(f"obs (b): {rec['b']}")
        on.release_graphs()
        off.release_graphs()
        del off, s_off, t0

        # (c) the aggregation probe on the dense and int8 wires
        int8 = _obs_main_algo(dev, data, hp, shape, False, impl="int8")
        rec["c"] = {}
        for name, algo in (("dense", on), ("int8", int8)):
            kernels.reset_launches()
            probe = obs_comm.probe_aggregate(algo, state=s0, iters=4)
            torch.cuda.synchronize()
            out[f"obs/probe_{name}"] = dict(kernels.LAUNCHES)
            model = obs_comm.WireCostModel.from_algorithm(algo, s0)
            rec["c"][name] = {**probe,
                              "wire_bytes": model.bytes_for(name),
                              "launches": {k: v for k, v in
                                           kernels.LAUNCHES.items() if v}}
        del int8
        if out["obs/probe_dense"]["weighted_sum"] == 0 or \
                out["obs/probe_int8"]["quantize_reduce"] == 0:
            raise AssertionError(f"obs (c): {rec['c']}")

        # (d) one profiled round and its device-lane attribution
        prof = os.path.join(tmp, "prof")
        kernels.reset_launches()
        round_ms = trace_one_round(on, s0, prof)
        out["obs/profile"] = dict(kernels.LAUNCHES)
        summary = devtrace.analyze_profile_dir(prof)
        names = _devtrace_names(prof)
        found = {k: any(k in n for n in names) for k in OBS_TRACE_KERNELS}
        rec["d"] = {"round_ms_cuda_events": round_ms,
                    "present": summary["present"],
                    "busy_s": summary.get("totals", {}).get("busy_s"),
                    "agg_share": summary.get("totals", {}).get("agg_share"),
                    "kernels_found": found, "kernel_names": len(names)}
        if not summary["present"] or not all(found.values()):
            raise AssertionError(f"obs (d): {rec['d']}")

        # (e) the memory ledger's peak is the allocator's
        devs = obs_memory.device_memory()
        peak = max(d["peak_bytes_in_use"] for d in devs)
        rec["e"] = {"devices": devs,
                    "max_memory_allocated": torch.cuda.max_memory_allocated()}
        if peak != rec["e"]["max_memory_allocated"] or \
                devs[0]["platform"] != "gpu":
            raise AssertionError(f"obs (e): {rec['e']}")
        del on, s0, s_on
        torch.cuda.empty_cache()

        # (f) a one-rank NCCL mesh round with the session on
        rec["f"], out["obs/mesh"] = _obs_mesh(dev, data, hp, shape, tmp)

        # (g) the CLI with every lifted flag against its obs-off twin
        rec["g"], out["obs/cli"] = _obs_cli(tmp, runner)
    emit(rec)
    return out


def _obs_mesh(dev, data, hp, shape, tmp):
    """(f) of :func:`obs_path`: a one-rank NCCL client mesh, the session
    on, one round profiled (``trace_one_round``), its collectives' NCCL
    ops in the trace; returns its record and launches."""
    import os

    import torch

    from neuroimagedisttraining_torch.obs import devtrace
    from neuroimagedisttraining_torch.obs import export as obs_export
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.parallel.mesh import (
        make_mesh,
        shard_federated,
    )
    from neuroimagedisttraining_torch.utils.profiling import trace_one_round

    mesh = make_mesh(1, backend="nccl", rank=0, device=dev,
                     init_method="file://" + os.path.join(tmp, "rdv"),
                     timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    algo = None
    try:
        algo = _obs_main_algo(dev, shard_federated(data, mesh), hp, shape,
                              True)
        session = obs_export.ObsSession(
            jsonl_path=os.path.join(tmp, "f", "mesh.obs.jsonl"),
            identity="mesh")
        try:
            kernels.reset_launches()
            state = algo.init_state()
            prof = os.path.join(tmp, "f", "prof")
            round_ms = trace_one_round(algo, state, prof)
            state, recs = _obs_rounds(algo, state, session)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            exports = session.exports
            session.finish()
        finally:
            session.close()
        summary = devtrace.analyze_profile_dir(prof)
        names = _devtrace_names(prof)
        with open(session.jsonl_path) as f:
            lines = sum(1 for _ in f)
        res = {"backend": mesh.backend, "rank": mesh.rank,
               "round_ms_cuda_events": round_ms,
               "exports": exports, "jsonl_lines": lines,
               "nccl_kernels": sorted(n for n in names
                                      if devtrace.is_collective(n)),
               "nccl_ops": sorted(_trace_collective_ops(prof)),
               "totals": summary.get("totals"),
               "train_loss": [r["train_loss"] for r in recs]}
        if not (exports and lines == OBS_ROUNDS and summary["present"]
                and res["nccl_ops"]):
            raise AssertionError(f"obs (f): {res}")
        return res, launches
    finally:
        if algo is not None:
            algo.release_graphs()
        mesh.destroy()


def _obs_cli(tmp, runner):
    """(g) of :func:`obs_path`: the CLI on ``small3dcnn`` with every lifted
    flag (``OBS_CLI`` plus ``--trace_dir`` and ``--profile_dir``) and its
    obs-off twin; returns the record and the obs run's launches."""
    import os

    import torch

    from neuroimagedisttraining_torch.ops import kernels

    base = ["--algo", "salientgrads", "--dataset", "synthetic", "--model",
            "small3dcnn", "--comm_round", "2", "--log_dir", ""]
    root = os.path.join(tmp, "g")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = runner.main(base + OBS_CLI + [
        "--trace_dir", os.path.join(root, "tr"), "--profile_dir",
        os.path.join(root, "prof"), "--results_dir",
        os.path.join(root, "res")])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    twin = runner.main(base + ["--fault_spec", "nan=0.5", "--results_dir",
                               ""])
    ident = res["identity"]
    run_dir = os.path.join(root, "res", "synthetic")
    want = {"jsonl": os.path.join(run_dir, ident + ".obs.jsonl"),
            "metrics_json": os.path.join(run_dir, ident + ".metrics.json"),
            "events": os.path.join(run_dir, ident + ".events.jsonl"),
            "devtrace": os.path.join(run_dir, ident + ".devtrace.json"),
            "catalog": os.path.join(root, "res", "runs_index.jsonl"),
            "trace": os.path.join(root, "tr", ident + ".trace.json"),
            "flight": os.path.join(run_dir, ident + ".flight")}
    written = {k: os.path.exists(v) for k, v in want.items()}
    bundles = (sorted(os.listdir(want["flight"])) if written["flight"]
               else [])
    devtrace_totals = None
    if written["devtrace"]:
        with open(want["devtrace"]) as f:
            devtrace_totals = json.load(f)["totals"]
    added = ("num_", "round_time_s")
    same = [{k: v for k, v in h.items() if not k.startswith(added)}
            for h in res["history"]] == twin["history"] and all(
        torch.equal(res["state"].global_params[k], v)
        for k, v in twin["state"].global_params.items())
    rec = {"seconds": seconds, "written": written, "bundles": bundles,
           "devtrace_totals": devtrace_totals, "bitwise_obs_off": same}
    if not (all(written.values()) and bundles and same):
        raise AssertionError(f"obs (g): {rec}")
    return rec, launches


#: the offline phase (``offline_path``): the SalientGrads run's rounds and
#: fused block (its graph captures are the compile section's events), its
#: fault spec and SLO objective, the federation's straggle seconds, the
#: subcommands' time limit and the phase's
OFFLINE_ROUNDS, OFFLINE_BLOCK = 4, 2
OFFLINE_FAULTS, OFFLINE_SLO = "straggle=0.4", "p99:train_loss<0.01"
OFFLINE_FED_STRAGGLE_S = 1.5
OFFLINE_CMD_TIMEOUT_S, OFFLINE_PHASE_LIMIT_S = 180, 300.0
#: the card history's metric (rounds/s of a run's fused rounds)
OFFLINE_METRIC = "salientgrads_rounds_per_sec_offline_3dcnn_s2d_8clients"


def _offline_argv(tmp: str, sub: str) -> list:
    """The offline phase's training run: SalientGrads on AlexNet3DS2D at
    full width (``--dataset synthetic_volume``: 8 clients x 40 phased bf16
    121x145x121 volumes, batch 8, 5 local steps, bf16 compute), SNIP 0.5,
    ``OFFLINE_ROUNDS`` rounds in fused blocks of ``OFFLINE_BLOCK`` with the
    eval after each, no fine-tune; stragglers injected; every in-process
    obs artifact on (the round numerics, the wire model and its probe, an
    SLO objective, the catalog, host spans, one profiled round)."""
    out = f"{tmp}/{sub}"
    return ["--algo", "salientgrads", "--dataset", "synthetic_volume",
            "--layout", "s2d", "--model", "3dcnn",
            "--client_num_in_total", str(N_CLIENTS), "--frac", "1.0",
            "--batch_size", str(BATCH), "--epochs", "1",
            "--comm_round", str(OFFLINE_ROUNDS), "--lr", "0.001",
            "--compute_dtype", "bfloat16", "--final_finetune", "0",
            "--fuse_rounds", str(OFFLINE_BLOCK),
            "--fault_spec", OFFLINE_FAULTS, "--watchdog", "0",
            "--obs", "1", "--obs_numerics", "1", "--obs_comm", "1",
            "--obs_sample_every", "1", "--slo_spec", OFFLINE_SLO,
            "--obs_catalog", "1", "--trace_dir", f"{out}/tr",
            "--profile_dir", f"{out}/prof", "--results_dir",
            f"{out}/results", "--log_dir", ""]


def _offline_want() -> dict:
    """The exact launches of one :func:`_offline_argv` run: SNIP (one
    forward and backward a client, one threshold, one score mask); the
    wire probe's 2 x 4 aggregates; the profiled round and its warm-up
    round, eager (the first adds the dropout probe's forward); the fused
    rounds, whose round graph and eval graph each run ``FUSED_WARMUPS``
    times before their one capture; the final eval, eager (the fused loop
    hands none back); each eval one forward a client and chunk, global and
    personal; and the FLOP counters' two forwards of one zero sample
    (``utils.flops.per_layer_flops``: the training cost's, once, and the
    final model's inference cost)."""
    from neuroimagedisttraining_torch.algorithms.base import FUSED_WARMUPS

    steps = N_CLIENTS * STEPS
    graphed = FUSED_WARMUPS + OFFLINE_ROUNDS
    trained = (2 + graphed) * steps
    evals = graphed + 1
    return {"masked_sgd": trained, "threshold": 1, "score_mask": 1,
            "stem_bwd": N_CLIENTS + trained,
            "stem_fwd": (N_CLIENTS + 1 + trained
                         + evals * 2 * N_CLIENTS * _eval_chunks() + 2),
            "weighted_sum": 2 * 4 + 2 + graphed, "mask_apply": 0,
            "quantize_reduce": 0}


def _offline_fed_argv(tmp: str) -> list:
    """The federation the ``xtrace`` and ``watch`` subcommands read: the
    fed phase's FedAvg at full width, 2 sites, loopback sync,
    ``FED_ROUNDS`` rounds with the cross-process trace and heartbeats on
    and site 2 straggling ``OFFLINE_FED_STRAGGLE_S`` every round."""
    return _fed_argv(tmp, "fed", "--fed_role", "aggregator", "--fed_mode",
                     "sync", "--fed_sites", str(FED_SITES), "--xtrace", "1",
                     "--obs_heartbeat_every", "0.3", "--fed_site_faults",
                     f"2:straggle=1.0:{OFFLINE_FED_STRAGGLE_S}")


def _obs_cmd(root: str, *argv) -> tuple:
    """``python -m neuroimagedisttraining_torch.obs <argv>`` from the
    checkout's root: ``(exit code, stdout, stderr, wall seconds)``."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "neuroimagedisttraining_torch.obs", *argv],
        capture_output=True, text=True, cwd=root,
        timeout=OFFLINE_CMD_TIMEOUT_S)
    return (proc.returncode, proc.stdout, proc.stderr,
            time.perf_counter() - t0)


def _card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def offline_path(dev):
    """The offline observability tier (``python -m
    neuroimagedisttraining_torch.obs``) on the artifacts of full-width
    runs on the card. (a) :func:`_offline_argv` through the CLI
    (``runner.main``), its counters zeroed just before and read just
    after and held exactly (:func:`_offline_want`), then the same command
    line into another results dir (the twin), then the federation of
    :func:`_offline_fed_argv`. (b) The nine subcommands, each a process
    (a further case of one, where there is, through the same ``main`` in
    this process):
    ``analyze`` (the analysis valid; its straggler rounds from the fault
    trace exactly the rounds the port's replay of ``OFFLINE_FAULTS`` fires
    in, at least one; the phases ``train_dispatch`` and
    ``device_and_wait``; the compile section's entries and its total the
    port's kinds' sum in ``metrics.json``; the profiled round's kernels
    (``OBS_TRACE_KERNELS``) in the comm section; the numerics), ``slo``
    (``--json`` exit 0, health and event count the run's; the replayed
    events the run's ``events.jsonl`` line for line), ``tail --once`` (a
    line a record, one a round), ``ls --rebuild`` (the rebuilt line the
    live one but the fields a rebuild cannot know: the git SHA and the
    trace path), ``diff`` (the twin: ``--expect identical`` 0,
    ``--expect different`` 1), ``report`` twice (byte-identical, two
    processes),
    ``regress`` (against a card history of the two runs' rounds/s: 0 at
    their median, 1 at twice the gate's allowed drop below it,
    2 with no history),
    ``xtrace --enforce`` (site 2 named the straggler of every round) and
    ``watch --once`` (a lane per site). (c) Each subcommand's wall seconds
    and the phase's, beside the card's name and power limit. At most
    ``OFFLINE_PHASE_LIMIT_S``. Returns the launches of (a)'s three runs."""
    import contextlib
    import io
    import os
    import tempfile

    import torch

    from neuroimagedisttraining_torch.experiments import runner
    from neuroimagedisttraining_torch.obs import __main__ as obs_main
    from neuroimagedisttraining_torch.obs import analyze as obs_analyze
    from neuroimagedisttraining_torch.obs import catalog as obs_catalog
    from neuroimagedisttraining_torch.obs import compile as obs_compile
    from neuroimagedisttraining_torch.obs import events as obs_events
    from neuroimagedisttraining_torch.obs import export as obs_export
    from neuroimagedisttraining_torch.obs import health as obs_health
    from neuroimagedisttraining_torch.obs import regress as obs_regress
    from neuroimagedisttraining_torch.ops import kernels
    from neuroimagedisttraining_torch.robust import faults

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    card = _card()
    out, rec, secs = {}, {"phase": "offline", "card": card}, {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the run, its twin and the federation
        runs, want = {}, _offline_want()
        for sub in ("run", "twin"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            res = runner.main(_offline_argv(tmp, sub))
            torch.cuda.synchronize(dev)
            secs[f"train_{sub}"] = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            out["offline" if sub == "run" else "offline/twin"] = launches
            runs[sub] = res
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"offline (a) {sub} launches "
                                     f"{launches}, want {want}")
        ident = runs["run"]["identity"]
        kernels.reset_launches()
        t0 = time.perf_counter()
        fed = runner.main(_offline_fed_argv(tmp))
        torch.cuda.synchronize(dev)
        secs["train_fed"] = time.perf_counter() - t0
        out["offline/fed"] = dict(kernels.LAUNCHES)
        steps = FED_ROUNDS * N_CLIENTS * STEPS
        want_fed = {"masked_sgd": steps, "stem_bwd": steps,
                    "weighted_sum": FED_ROUNDS,
                    "stem_fwd": steps + N_CLIENTS * _eval_chunks() + 1}
        if any(out["offline/fed"][k] != v for k, v in want_fed.items()):
            raise AssertionError(f"offline (a) fed launches "
                                 f"{out['offline/fed']}, want {want_fed}")
        fed_dir = fed["fed"]["out_dir"]
        run_dir = os.path.dirname(runs["run"]["stat_path"])
        twin_dir = os.path.dirname(runs["twin"]["stat_path"])
        results = os.path.dirname(run_dir)
        stream = os.path.join(run_dir, ident + ".obs.jsonl")
        records = obs_export.read_jsonl(stream)
        rounds = [r for r in records if r["round"] >= 0]
        rec["a"] = {"identity": ident, "rounds": len(rounds),
                    "round_time_s": [r["round_time_s"] for r in rounds],
                    "train_loss": [r["train_loss"] for r in rounds],
                    "launches": out["offline"], "fed_dir_files":
                        sorted(os.listdir(fed_dir))}

        # (b) the nine subcommands, each a process (timed); the further
        # cases of a subcommand through the same ``main`` in this process
        cmds = {}

        def cmd(name, *argv, want=0):
            code, so, se, s = _obs_cmd(root, *argv)
            cmds[name] = {"argv": list(argv), "rc": code, "seconds": s}
            if code != want:
                raise AssertionError(
                    f"offline (b) {name} {argv}: exit {code}, want {want}"
                    f"\n{so[-2000:]}\n{se[-4000:]}")
            return so

        def again(*argv, want=0):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), \
                    contextlib.redirect_stderr(io.StringIO()):
                code = obs_main.main(list(argv))
            if code != want:
                raise AssertionError(f"offline (b) {argv}: exit {code}, "
                                     f"want {want}\n{buf.getvalue()[-2000:]}")
            return buf.getvalue()

        cmd("analyze", "analyze", run_dir, "--trace-dir",
            os.path.join(tmp, "run", "tr"))
        with open(os.path.join(run_dir, ident + ".analysis.json")) as f:
            a = json.load(f)
        obs_analyze.validate_analysis(a)
        spec = faults.parse_fault_spec(OFFLINE_FAULTS)
        fired = []
        for r in range(OFFLINE_ROUNDS):
            sel = obs_health.replay_client_indexes(r, N_CLIENTS, N_CLIENTS)
            if faults.fault_trace_round(spec, 0, r, sel)["straggled"].any():
                fired.append(r)
        flagged = [s["round"] for s in a["stragglers"]
                   if "fault_trace" in s["source"]]
        with open(os.path.join(run_dir, ident + ".metrics.json")) as f:
            metrics = json.load(f)
        compile_sum = sum(float(metrics[k]["value"]["sum"])
                          for k in obs_compile.COMPILE_KINDS.values()
                          if k in metrics)
        kernel_names = [k["name"] for k in
                        a["comm"].get("devtrace", {}).get("kernels", [])]
        named = {k: any(k in n for n in kernel_names)
                 for k in OBS_TRACE_KERNELS}
        rec["b_analyze"] = {
            "stragglers": a["stragglers"], "replay_fired": fired,
            "phases": sorted(a["phases"]), "compile": a["compile"],
            "compile_kinds_sum_s": compile_sum,
            "devtrace_kernels_named": named,
            "devtrace_busy_s": a["comm"].get("devtrace", {}).get("busy_s"),
            "numerics_present": a["numerics"]["present"],
            "flags": a["flags"]}
        if not (fired and flagged == fired
                and {"train_dispatch", "device_and_wait"} <= set(a["phases"])
                and a["compile"]["present"] and a["compile"]["by_entry"]
                and a["compile"]["total_s"] == compile_sum
                and all(named.values()) and a["numerics"]["present"]):
            raise AssertionError(f"offline (b) analyze: {rec['b_analyze']}")

        events = obs_export.read_jsonl(
            os.path.join(run_dir, ident + ".events.jsonl"))
        summary = json.loads(cmd("slo", "slo", run_dir, "--json"))
        replayed = [ln[2:] for ln in again("slo", run_dir).splitlines()
                    if ln.startswith("  round ")]
        live = [obs_events.format_event_line(e) for e in events]
        rec["b_slo"] = {"health": summary["health"],
                        "events_total": summary["events_total"],
                        "events_live": len(events),
                        "replayed_equal_live": replayed == live}
        if not (events and replayed == live
                and summary["events_total"] == len(events)
                and summary["health"] == rounds[-1]["slo_health"]):
            raise AssertionError(f"offline (b) slo: {rec['b_slo']}")

        tail = cmd("tail", "tail", run_dir, "--once").splitlines()
        rec["b_tail"] = {"lines": len(tail), "records": len(records)}
        if len(tail) != len(records) or len(rounds) != OFFLINE_ROUNDS:
            raise AssertionError(f"offline (b) tail: {rec['b_tail']}")

        cat = obs_catalog.catalog_path(results)
        with open(cat) as f:
            live_lines = f.read().splitlines()
        cmd("ls", "ls", results, "--rebuild", "--json")
        with open(cat) as f:
            rebuilt = f.read().splitlines()
        known = []
        for line in live_lines:
            e = json.loads(line)
            e["git_sha"] = ""
            e["artifacts"].pop("trace", None)
            known.append(json.dumps(e, sort_keys=True))
        rec["b_ls"] = {"live_lines": len(live_lines),
                       "rebuilt_equal": rebuilt == known}
        if not (len(live_lines) == 1 and rebuilt == known):
            raise AssertionError(f"offline (b) ls: {live_lines} {rebuilt}")

        twin_stream = os.path.join(twin_dir, ident + ".obs.jsonl")
        cmd("diff", "diff", stream, twin_stream, "--expect", "identical")
        again("diff", stream, twin_stream, "--expect", "different", want=1)

        # the card history: each run's rounds/s over its fused rounds'
        # wall time (the blocks' flush-to-flush seconds, captures included;
        # a block's time is split evenly over its rounds, so only the sum
        # is a wall time)
        hist = os.path.join(tmp, "history.jsonl")
        rates = []
        for d in (run_dir, twin_dir):
            recs = obs_export.read_jsonl(os.path.join(d, ident + ".obs.jsonl"))
            rates.append(OFFLINE_ROUNDS / sum(r["round_time_s"] for r in recs
                                              if r["round"] >= 0))
        for v in rates:
            obs_regress.append_history(
                hist, {"metric": OFFLINE_METRIC, "value": v,
                       "unit": "rounds/s"}, source="chip_smoke_offline",
                git_sha="", card=card)
        median = statistics.median(rates)
        # twice the gate's allowed drop below the median: a regression by
        # the gate's own band, however noisy the history
        band = obs_regress.detect_regression(rates, median)["allowed_drop"]
        cmd("regress", "regress", "--history", hist, "--metric",
            OFFLINE_METRIC, "--value", repr(median))
        again("regress", "--history", hist, "--metric", OFFLINE_METRIC,
              "--value", repr(median - 2 * band), want=1)
        again("regress", "--history", os.path.join(tmp, "none.jsonl"),
              "--metric", OFFLINE_METRIC, "--value", repr(median), want=2)
        rec["b_regress"] = {"rates": rates, "median": median,
                            "allowed_drop": band}

        html = [os.path.join(tmp, f"fleet{i}.html") for i in (1, 2)]
        cmd("report", "report", results, "--out", html[0], "--history",
            hist)
        again("report", results, "--out", html[1], "--history", hist)
        with open(html[0], "rb") as f, open(html[1], "rb") as g:
            page = f.read()
            same = page == g.read()
        rec["b_report"] = {"bytes": len(page), "byte_identical": same}
        if not (same and ident.encode() in page):
            raise AssertionError(f"offline (b) report: {rec['b_report']}")

        xt = json.loads(cmd("xtrace", "xtrace", fed_dir, "--enforce",
                            "--json"))
        frame = cmd("watch", "watch", fed_dir, "--once")
        rec["b_xtrace"] = {"straggler_counts": xt["straggler_counts"],
                           "rounds": [{k: r[k] for k in ("trace",
                                                         "total_ms",
                                                         "straggler")}
                                      for r in xt["rounds"]],
                           "orphans": len(xt["orphans"])}
        rec["b_watch"] = frame.splitlines()
        if not (xt["present"] and xt["straggler_counts"] == {
                "site2": FED_ROUNDS} and not xt["straggler_mismatches"]):
            raise AssertionError(f"offline (b) xtrace: {rec['b_xtrace']}")
        if not all(f"site{k}" in frame for k in range(1, FED_SITES + 1)):
            raise AssertionError(f"offline (b) watch: {frame}")

    # (c) the seconds
    rec["c"] = {"card": card, "seconds": secs,
                "subcommands": {k: c["seconds"] for k, c in cmds.items()},
                "subcommands_total_s": sum(c["seconds"]
                                           for c in cmds.values())}
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    rec["c"]["phase_s"] = phase_s
    emit(rec)
    if sorted(cmds) != sorted(("analyze", "slo", "tail", "ls", "diff",
                               "regress", "report", "xtrace", "watch")):
        raise AssertionError(f"offline (b): ran {sorted(cmds)}")
    if phase_s > OFFLINE_PHASE_LIMIT_S:
        raise AssertionError(f"offline phase took {phase_s:.1f} s, over its "
                             f"{OFFLINE_PHASE_LIMIT_S} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        from neuroimagedisttraining_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "setup", "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})

    build_s = kernels.build()
    emit({"phase": "build", "seconds": build_s,
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln]
                    for k, v in kernels.BUILD_LOG.items()}})

    measured = check_kernels(dev)
    # each kernel's share of its bound: bound_ms over its measured ms
    for m in measured.values():
        if isinstance(m, dict) and "bound_ms" in m:
            m["bound_share"] = m["bound_ms"] / m["ms"]
    emit({"phase": "kernels", **measured})
    emit({"phase": "bound_share", **{
        name: m["bound_share"] for name, m in measured.items()
        if isinstance(m, dict) and "bound_share" in m}})
    phase_s = {}  # each phase's seconds, printed as it ends

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn(dev)
        phase_s[name] = time.perf_counter() - t0
        emit({"phase": "seconds", "of": name, "seconds": phase_s[name]})
        return out

    timed("parity", small_parity)
    paths = {"main": timed("main", main_path)}
    for name, fn in (("wires", wires_path), ("fused", fused_path),
                     ("evalcache", evalcache_path), ("dense", dense_path),
                     ("robust", robust_path), ("train_opts", train_opts_path),
                     ("personal", personal_path), ("fomo", fomo_path),
                     ("state", state_path), ("resnet3d", resnet3d_path),
                     ("uneven", uneven_path),
                     ("determinism", determinism_path), ("mesh", mesh_path)):
        paths.update(timed(name, fn))
    cifar_paths, at_cifar = timed("cifar", cifar_path)
    paths.update(cifar_paths)
    # the CLI's seeding sets cuDNN's flags for the process: the bench
    # phase after it measures with the flags the script had before
    with _CudnnFlags():
        paths.update(timed("cli", cli_path))
        paths.update(timed("fed", fed_path))
        paths.update(timed("serve", serve_path))
        paths.update(timed("obs", obs_path))
        paths.update(timed("offline", offline_path))
    paths.update(timed("bench", bench_path))

    line = []
    for name in kernels.SOURCES:
        entry = dict(
            name=name, route="cuda",
            source=f"neuroimagedisttraining_torch/csrc/"
                   f"{kernels.SOURCES[name]}",
            replaces=REPLACES[name],
            launches=sum(p[name] for p in paths.values()),
            launches_by_path={k: p[name] for k, p in paths.items()
                              if p[name]},
            **{k: v for k, v in measured[name].items() if k != "shape"})
        if name == "threshold":
            entry["at_topk_group"] = measured["threshold_topk_group"]
        if name in at_cifar:  # the cifar path's ResNet-18-GN shapes
            entry["at_resnet18_cifar"] = at_cifar[name]
        line.append(entry)
    emit({"kernels": line})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
